"""The work of the batched serving cells, per batch, from the traffic's
shapes: #4's launches (the seven LM linears a layer, the head), #1's
(the tower a layer an image, the prefill a layer a chunk) and the model's
operations at each product's precision for `mfu.serve`.

The launches follow the adapter's batching of the traffic: the prompts
front-padded to the batch's bucket Pb, the prefill in chunks of 2
requests when B > 4 (one call otherwise), every denoise step over the
B x G answer rows, the unfused head when B x G > 128 rows."""

from __future__ import annotations

from work import counts as C


def steps_of(mix: dict) -> list[int]:
    """Tokens committed at each denoise step (one block: G over the
    steps, the first G % steps steps taking one more)."""
    g = mix["gen"]
    G, S = g["max_new_tokens"], min(g["step_per_block"], g["block_length"])
    if g["block_length"] != G:
        raise ValueError("one block per answer is the only layout counted")
    return [G // S + (1 if i < G % S else 0) for i in range(S)]


def batch_desc(batch, mix: dict, geo: dict) -> dict:
    P = [r["prefix_len"] for r in batch]
    B = len(P)
    return {"B": B, "P": P, "Pb": C.ceil_to(max(P), mix["prefix_bucket"]),
            "views": [r["views"].shape[0] for r in batch],
            "chunk": 2 if B > 4 else B, "G": mix["gen"]["max_new_tokens"],
            "steps": len(steps_of(mix))}


def linear_shapes(geo: dict) -> list[tuple[int, int]]:
    """(K, N) of one block's linears."""
    D, F = geo["D"], geo["F"]
    kvD = geo["Hkv"] * (D // geo["H"])
    return [(D, D), (D, kvD), (D, kvD), (D, D), (D, F), (D, F), (F, D)]


def w4_launches(d: dict, geo: dict) -> list[tuple[int, int, int, int]]:
    """(T, K, N, launches) of #4 in one batch."""
    chunks = -(-d["B"] // d["chunk"])
    rows = d["B"] * d["G"]
    out = [(d["chunk"] * d["Pb"], K, N, chunks * geo["L"])
           for K, N in linear_shapes(geo)]
    out += [(rows, K, N, d["steps"] * geo["L"]) for K, N in linear_shapes(geo)]
    if rows > 128:
        out.append((rows, geo["D"], geo["V"], d["steps"]))
    return out


def short_attention_launches(d: dict, geo: dict, vcfg: dict) -> list[dict]:
    """#1's launches of one batch with their live pairs and rows."""
    T = C.tower_tokens(vcfg)
    H, W = vcfg["num_attention_heads"], vcfg["hidden_size"]
    layers = vcfg["num_hidden_layers"] - 1
    out = [dict(pairs=V * T * T, H=H, hd=W // H, Hkv=H, Tq=V * T, Tk=V * T,
                n=layers) for V in d["views"]]
    hd = geo["D"] // geo["H"]
    c = d["chunk"]
    starts = list(range(0, d["B"] - c + 1, c))
    if starts[-1] + c < d["B"]:
        starts.append(d["B"] - c)
    for s in starts:
        P = d["P"][s:s + c]
        out.append(dict(pairs=sum(p * p for p in P), H=geo["H"], hd=hd,
                        Hkv=geo["Hkv"], Tq=c * d["Pb"], Tk=c * d["Pb"],
                        n=geo["L"]))
    return out


def model_seconds(d: dict, geo: dict, vcfg: dict) -> float:
    """The least time one batch's model work takes at the peaks: bf16
    products (tower, projector, attention) at 989 TFLOP/s, the W4A8 LM
    linears and head at 1,979 TOP/s, over unpadded rows."""
    bf16 = int8 = 0.0
    G, S = d["G"], d["steps"]
    for P, V in zip(d["P"], d["views"]):
        t = C.tower_forward_ops(vcfg, V)
        bf16 += (t["linear"] + t["patch"] + t["attention"]
                 + C.projector_forward_ops(vcfg, geo["D"], V)
                 + C.pool_forward_ops(vcfg, geo["D"], V))
        pre = C.lm_forward_ops(geo, P, P * P, 0)
        step = C.lm_forward_ops(geo, G, G * (P + G), G)
        int8 += pre["linear"] + S * (step["linear"] + step["head"])
        bf16 += pre["attention"] + S * step["attention"]
    return bf16 / C.PEAK["bf16"] + int8 / C.PEAK["int8"]


def window_work(descs, geo: dict, vcfg: dict) -> dict:
    """Sums over the window's batches: #4's launches and their least
    seconds, #1's, the model's least seconds."""
    w4 = {"launches": 0, "bound_s": 0.0}
    sa = {"launches": 0, "bound_s": 0.0}
    model_s = 0.0
    for d in descs:
        for T, K, N, n in w4_launches(d, geo):
            w4["launches"] += n
            w4["bound_s"] += n * C.bound_s(*C.w4_grouped(T, K, N), "int8")[0]
        for a in short_attention_launches(d, geo, vcfg):
            sa["launches"] += a["n"]
            sa["bound_s"] += a["n"] * C.bound_s(*C.attention_fwd(
                a["pairs"], a["H"], a["hd"], a["Hkv"], a["Tq"], a["Tk"]),
                "bf16")[0]
        model_s += model_seconds(d, geo, vcfg)
    return {"w4_grouped": w4, "short_attention": sa, "model_s": model_s}
