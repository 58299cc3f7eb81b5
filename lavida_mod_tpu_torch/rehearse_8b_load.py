"""8B-scale on-disk load rehearsal of the port: the counterpart of
scripts/rehearse_8b_load.py.

It writes a reference-layout checkpoint at the full LaViDaConfig()
geometry itself (LLaDA-8B and SigLIP so400m, about 16.9 GB), then runs
the port's serving path on it:

    write -> LaViDa.load (config.json sniffed) -> to_serving_layout(
    "mixed", fuse=True) -> conversation template -> BPE tokenizer ->
    generate_fused -> decode_output

and records each stage's wall, the bytes on disk, the host's resident set
after each stage with the process's peak (ru_maxrss) and the card's peak
memory.  The checkpoint is deleted in a `finally`.

What it writes:
  - model.transformer.* (llama blocks), the SigLIP tower's 27 layers (the
    loader drops the last), the mlp2x projector and model.image_newline,
    all bf16, in safetensors shards of at most 4 GiB through the port's
    own writer (tools/safetensors_io.py).  Tensors are drawn on the card
    by a seeded torch.Generator as `LaViDa.random_init` draws them
    (linears, embeddings and the position table N(0, 0.02), norms 1,
    biases 0, the newline N(0, 1/D)); a checksum of each tensor's bits
    is taken on the card as it is written;
  - a flat config.json with the fields of scripts/rehearse_8b_load.py:
    163-186 and the tower's vision_tower_config;
  - a byte-level BPE tokenizer: vocab.json (the 256 byte symbols, 54
    merges trained here on the template's text, and LLaDA's special
    tokens at their ids: <|startoftext|> 126080, <|endoftext|> = EOS
    126081, <|mdm_mask|> 126336, <|start_header_id|> 126346,
    <|end_header_id|> 126347, <|eot_id|> 126348) + merges.txt, and
    tokenizer.json with the same BPE and the special tokens as its added
    tokens, which the pure-Python loader reads them from; no chat
    template, so the llada template's own llama_3 renderer runs.

Checks, each raising: an empty or new directory and the free disk space
before writing; every loaded
tensor's checksum equal to the written one's, under the port's name for
it (the patch conv flattened, the 27th SigLIP layer absent); the sniffed
config equal to LaViDaConfig() field by field; the rendered prompt's
tokens round-tripping to its text; a 48-token prompt (and the image
marker); after the mixed layout, every generated id below the vocab and
the decoded text cut at EOS or the llada stop id where it appears (and
where the stop id is put into the answer's ids).

Usage (on a machine with a CUDA card and about 20 GB of free disk):
  python -m lavida_mod_tpu_torch.rehearse_8b_load [--path DIR] [--keep]
chip_smoke.py runs `rehearse` as one of its phases.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import resource
import shutil
import time
from pathlib import Path

import numpy as np

DEFAULT_PATH = Path(__file__).resolve().parents[1] / "rehearse_ckpt"
SHARD_BYTES = 4 << 30
SPECIALS = {"<|startoftext|>": 126080, "<|endoftext|>": 126081,
            "<|mdm_mask|>": 126336, "<|start_header_id|>": 126346,
            "<|end_header_id|>": 126347, "<|eot_id|>": 126348}
STOP_ID = 126348
# the user's question: with the empty system prompt the rendered request
# is 48 text tokens and the image marker
QUESTION = ("Describe the image in detail: the objects in the scene, their "
            "colors and where each one is.")
PROMPT_TOKENS = 48
GEN = dict(max_new_tokens=32, block_length=32, step_per_block=16)
VIT = "model.vision_tower.vision_tower.vision_model."
_VIT_LAYER = {"layer_norm1": "ln1", "layer_norm2": "ln2",
              "self_attn.q_proj": "q_proj", "self_attn.k_proj": "k_proj",
              "self_attn.v_proj": "v_proj", "self_attn.out_proj": "out_proj",
              "mlp.fc1": "fc1", "mlp.fc2": "fc2"}


def tensor_specs(cfg):
    """(checkpoint name, the port's parameter name or None when the loader
    drops it, shape, draw) of every tensor, in the order of
    scripts/rehearse_8b_load.py; draw is "normal", "ones", "zeros" or
    "newline".  The port's names are spelled out here, apart from the
    loader's own mapping, so the load check is independent of it."""
    lm, vis = cfg.llada, cfg.vision.siglip
    D, M, E = lm.d_model, lm.mlp_hidden_size, lm.embedding_size
    kvD = lm.effective_n_kv_heads * lm.head_dim
    out = [("model.transformer.wte.weight", "llada.wte.weight", (E, D),
            "normal"),
           ("model.transformer.ln_f.weight", "llada.ln_f.weight", (D,),
            "ones"),
           ("model.transformer.ff_out.weight", "llada.ff_out.weight",
            (E, D), "normal")]
    for i in range(lm.n_layers):
        b = f"transformer.blocks.{i}."
        for n in ("attn_norm", "ff_norm"):
            out.append((f"model.{b}{n}.weight", f"llada.blocks.{i}.{n}.weight",
                        (D,), "ones"))
        for n, sh in (("q_proj", (D, D)), ("k_proj", (kvD, D)),
                      ("v_proj", (kvD, D)), ("attn_out", (D, D)),
                      ("ff_proj", (M, D)), ("up_proj", (M, D)),
                      ("ff_out", (D, M))):
            out.append((f"model.{b}{n}.weight",
                        f"llada.blocks.{i}.{n}.weight", sh, "normal"))
    vD, vI, P = vis.hidden_size, vis.intermediate_size, vis.patch_size
    out += [(VIT + "embeddings.patch_embedding.weight",
             "siglip.patch_embed.weight", (vD, vis.num_channels, P, P),
             "normal"),
            (VIT + "embeddings.patch_embedding.bias",
             "siglip.patch_embed.bias", (vD,), "zeros"),
            (VIT + "embeddings.position_embedding.weight",
             "siglip.pos_embed", (vis.num_patches, vD), "normal")]
    for i in range(vis.num_hidden_layers):
        for ref, port in _VIT_LAYER.items():
            shape, draw = {"mlp.fc1": (vI, vD), "mlp.fc2": (vD, vI)}.get(
                ref, (vD, vD)), "normal"
            if ref.startswith("layer_norm"):
                shape, draw = (vD,), "ones"
            ref = f"{VIT}encoder.layers.{i}.{ref}."
            port = (f"siglip.layers.{i}.{port}." if i < vis.n_layers_used
                    else None)
            out += [(ref + "weight", port and port + "weight", shape, draw),
                    (ref + "bias", port and port + "bias", shape[:1],
                     "zeros")]
    h = cfg.vision.mm_hidden_size
    out += [("model.mm_projector.0.weight", "projector.layers.0.weight",
             (D, h), "normal"),
            ("model.mm_projector.0.bias", "projector.layers.0.bias", (D,),
             "zeros"),
            ("model.mm_projector.2.weight", "projector.layers.1.weight",
             (D, D), "normal"),
            ("model.mm_projector.2.bias", "projector.layers.1.bias", (D,),
             "zeros"),
            ("model.image_newline", "image_newline", (D,), "newline")]
    return out


def _nbytes(shape) -> int:
    return int(np.prod(shape)) * 2


def checksum(torch, t):
    """Two sums of a bf16 tensor's bits on its device, int64: plain and
    weighted by the position (mod 65521) + 1, so a reordering shows."""
    flat = t.detach().reshape(-1).view(torch.int16)
    s = torch.zeros(2, dtype=torch.int64, device=t.device)
    step = 1 << 26
    for lo in range(0, flat.numel(), step):
        c = flat[lo:lo + step].to(torch.int64)
        w = torch.arange(lo, lo + c.numel(), device=t.device) % 65521 + 1
        s[0] += c.sum()
        s[1] += (c * w).sum()
    return s


def config_json(cfg) -> dict:
    """The flat HF form of scripts/rehearse_8b_load.py:163-186, and the
    tower's geometry as a nested vision_tower_config (config.py:301)."""
    lm, vis = cfg.llada, cfg.vision
    return {
        "model_type": "llava_llada", "d_model": lm.d_model,
        "n_heads": lm.n_heads, "n_kv_heads": lm.n_kv_heads,
        "n_layers": lm.n_layers, "mlp_hidden_size": lm.mlp_hidden_size,
        "block_type": lm.block_type, "activation_type": lm.activation,
        "rope": lm.rope, "rope_theta": lm.rope_theta,
        "layer_norm_type": lm.layer_norm_type,
        "rms_norm_eps": lm.rms_norm_eps,
        "include_qkv_bias": lm.include_qkv_bias,
        "vocab_size": lm.vocab_size, "embedding_size": lm.embedding_size,
        "weight_tying": lm.weight_tying,
        "max_sequence_length": lm.max_sequence_length,
        "mask_token_id": lm.mask_token_id, "eos_token_id": lm.eos_token_id,
        "pad_token_id": lm.pad_token_id,
        "mm_hidden_size": vis.mm_hidden_size,
        "mm_projector_type": vis.projector_type,
        "image_aspect_ratio": vis.image_aspect_ratio,
        "image_grid_pinpoints": [list(p) for p in vis.grid_pinpoints],
        "mm_patch_merge_type": vis.mm_patch_merge_type,
        "vision_tower_config": dataclasses.asdict(vis.siglip),
    }


def _train_merges(texts, n_merges: int) -> list[tuple[str, str]]:
    """Greedy byte-level BPE merges over the pre-tokenized `texts`: the
    most frequent adjacent pair (ties to the first seen), n_merges times."""
    from .data.tokenizer import PRETOKENIZE_REGEX, bytes_to_unicode
    from .data.tokenizer import compile_pattern

    b2u, pat = bytes_to_unicode(), compile_pattern(PRETOKENIZE_REGEX)
    words = collections.Counter(
        tuple(b2u[b] for b in w.encode("utf-8"))
        for t in texts for w in pat.findall(t))
    merges = []
    for _ in range(n_merges):
        pairs: collections.Counter = collections.Counter()
        for w, n in words.items():
            for p in zip(w, w[1:]):
                pairs[p] += n
        if not pairs:
            break
        best = max(pairs, key=pairs.get)
        merges.append(best)
        joined = collections.Counter()
        for w, n in words.items():
            out, i = [], 0
            while i < len(w):
                if w[i:i + 2] == best:
                    out.append(best[0] + best[1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            joined[tuple(out)] += n
        words = joined
    return merges


def write_tokenizer(path: str, n_merges: int = 54) -> None:
    """vocab.json + merges.txt (256 byte symbols, merges trained on the
    template's text) and tokenizer.json carrying the same BPE and LLaDA's
    special tokens."""
    from .data.conversation import get_conv_template
    from .data.tokenizer import bytes_to_unicode

    conv = get_conv_template("llada")
    conv.system = ""
    conv.append_message(conv.roles[0], "\n" + QUESTION)
    text = conv.get_prompt()
    for s in SPECIALS:
        text = text.replace(s, " ")
    merges = _train_merges([text] * 4, n_merges)
    vocab = {u: i for i, u in enumerate(bytes_to_unicode().values())}
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab.update(SPECIALS)      # in the model's vocab too, at their ids
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        f.writelines(f"{a} {b}\n" for a, b in merges)
    added = [{"id": i, "content": s, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for s, i in SPECIALS.items()]
    with open(os.path.join(path, "tokenizer.json"), "w",
              encoding="utf-8") as f:
        json.dump({
            "version": "1.0", "truncation": None, "padding": None,
            "added_tokens": added, "normalizer": {"type": "NFC"},
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "Split", "pattern": {"Regex": (
                    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                    r"|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)"
                    r"|\s+")}, "behavior": "Isolated", "invert": False},
                {"type": "ByteLevel", "add_prefix_space": False,
                 "trim_offsets": False, "use_regex": False}]},
            "post_processor": None,
            "decoder": {"type": "ByteLevel", "add_prefix_space": False,
                        "trim_offsets": False, "use_regex": False},
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": None,
                      "end_of_word_suffix": None, "fuse_unk": False,
                      "byte_fallback": False, "ignore_merges": False,
                      "vocab": vocab,
                      "merges": [[a, b] for a, b in merges]},
        }, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"eos_token": "<|endoftext|>"}, f)


def synthesize(torch, path: str, cfg, device, seed: int = 0) -> dict:
    """Write the checkpoint; returns {checkpoint name: checksum} (device
    tensors) and the bytes of tensor data written."""
    from .tools.safetensors_io import save_file

    specs = tensor_specs(cfg)
    shards, cur, size = [], [], 0
    for spec in specs:
        n = _nbytes(spec[2])
        if cur and size + n > SHARD_BYTES:
            shards.append(cur)
            cur, size = [], 0
        cur.append(spec)
        size += n
    shards.append(cur)
    gen = torch.Generator(device=device).manual_seed(seed)
    sums, total = {}, 0
    for i, shard in enumerate(shards):
        tensors = {}
        for name, _, shape, draw in shard:
            t = torch.empty(shape, dtype=torch.bfloat16, device=device)
            if draw == "normal":
                t.normal_(0.0, 0.02, generator=gen)
            elif draw == "newline":
                t.normal_(0.0, cfg.llada.d_model ** -0.5, generator=gen)
            else:
                t.fill_(1.0 if draw == "ones" else 0.0)
            tensors[name] = t
            sums[name] = checksum(torch, t)
        total += save_file(tensors, os.path.join(
            path, f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"),
            metadata={"format": "pt"})
        del tensors
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config_json(cfg), f)
    write_tokenizer(path)
    return {"sums": sums, "bytes": total}


def host_rss_gib() -> tuple[float, float]:
    """(resident set now, from /proc/self/statm; the process's lifetime
    peak, ru_maxrss) of this process in GiB."""
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return pages * os.sysconf("SC_PAGE_SIZE") / 2**30, peak / 2**20


def hd_views(cfg, seed: int = 0, size=(640, 640)):
    """Seeded preprocessed views of one HD image: the base view and the
    anyres tiles (4 at 640 x 640), as chip_smoke's bench_request."""
    from .data.anyres import anyres_grid_shape

    S = cfg.vision.siglip.image_size
    nw, nh = anyres_grid_shape(size, cfg.vision.grid_pinpoints, S)
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (1 + nw * nh, 3, S, S)).astype(np.float32), size


def build_prompt(tokenizer):
    """The llada template (no system prompt) around "<image>\\n" +
    QUESTION -> (rendered text, ids with the -200 marker)."""
    from .data.conversation import get_conv_template
    from .data.prompts import tokenizer_image_token

    conv = get_conv_template("llada")
    conv.system = ""
    conv.append_message(conv.roles[0], "<image>\n" + QUESTION)
    text = conv.get_prompt()
    return text, tokenizer_image_token(text, tokenizer), conv.stop_token_ids


def rehearse(torch, device, path=DEFAULT_PATH, keep: bool = False,
             log=print, cfg=None) -> dict:
    """Write, load, lay out and serve one request twice; returns the
    stages, the measurements and the answer.  Raises on any failed check.
    `cfg` (default LaViDaConfig()) is for the tests' small geometry; the
    peaks of device memory are read on a CUDA device only (the current
    one)."""
    from .config import GenerationConfig, LaViDaConfig, as_port_config
    from .data.tokenizer import load_tokenizer
    from .models.lavida import LaViDa

    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30 if cuda else None

    cfg = as_port_config(cfg) or LaViDaConfig()
    specs = tensor_specs(cfg)
    need = sum(_nbytes(s[2]) for s in specs)
    path = Path(path)
    if path.exists() and any(path.iterdir()):
        raise RuntimeError(f"{path} is not empty: the rehearsal writes into, "
                           f"and then deletes, a directory of its own")
    path.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(path).free
    if free < need + (1 << 30):
        raise RuntimeError(
            f"{path}: {free / 1e9:.2f} GB free, the checkpoint needs "
            f"{need / 1e9:.2f} GB and 1.07 GB to spare: "
            f"{(need + (1 << 30) - free) / 1e9:.2f} GB short")
    out = {"layers": cfg.llada.n_layers, "disk_free_gb": free / 1e9}
    try:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        rss = {"start": host_rss_gib()}
        t0 = time.perf_counter()
        written = synthesize(torch, str(path), cfg, device)
        sync()
        out["write_s"] = time.perf_counter() - t0
        rss["write"] = host_rss_gib()
        out["bytes_on_disk"] = sum(f.stat().st_size for f in path.iterdir())
        out["tensor_bytes"] = written["bytes"]
        log(f"[ckpt] wrote {len(specs)} tensors, {written['bytes'] / 1e9:.3f}"
            f" GB of bf16 in {len(list(path.glob('*.safetensors')))} "
            f"shards ({out['bytes_on_disk'] / 1e9:.3f} GB on disk with the "
            f"header, config and tokenizer) in {out['write_s']:.2f} s")

        t0 = time.perf_counter()
        model = LaViDa.load(str(path), device=device)
        sync()
        out["load_s"] = time.perf_counter() - t0
        rss["load"] = host_rss_gib()
        if model.cfg != cfg:
            bad = [f for f in ("llada", "vision", "tokenizer_model_max_length",
                               "train_seq_cutoff")
                   if getattr(model.cfg, f) != getattr(cfg, f)]
            raise AssertionError(f"sniffed config differs in {bad}: "
                                 f"{dataclasses.asdict(model.cfg)}")
        params = dict(model.named_parameters())
        got = {name: checksum(torch, params[port])
               for name, port, _, _ in specs if port is not None}
        want = {k: written["sums"][k] for k in got}
        bad = [k for k in got if not torch.equal(got[k], want[k])]
        dropped = [n for n, port, _, _ in specs if port is None]
        if bad or len(got) != len(params):
            raise AssertionError(f"loaded tensors differ from the written "
                                 f"ones: {bad[:4]} ({len(bad)}); "
                                 f"{len(got)} of {len(params)} checked")
        out["peak_device_gib_load"] = peak_gib()
        log(f"[ckpt] LaViDa.load in {out['load_s']:.2f} s: the config "
            f"sniffed from config.json equals the written one field by "
            f"field; {len(got)} tensors bit-equal to the written ones "
            f"(checksums on {device.type}), the {len(dropped)} tensors of "
            f"SigLIP's last layer dropped")

        t0 = time.perf_counter()
        model.to_serving_layout("mixed", fuse=True)
        sync()
        out["layout_s"] = time.perf_counter() - t0
        rss["layout"] = host_rss_gib()

        tokenizer = load_tokenizer(str(path), prefer_pure=True)
        text, ids, stop_ids = build_prompt(tokenizer)
        plain = tokenizer.encode(text)
        if tokenizer.decode(plain, skip_special_tokens=False) != text:
            raise AssertionError("the rendered prompt does not round-trip "
                                 "through the tokenizer")
        if len(ids) - 1 != PROMPT_TOKENS or (ids == -200).sum() != 1:
            raise AssertionError(f"prompt of {len(ids)} ids, want "
                                 f"{PROMPT_TOKENS} and the image marker")
        views, size = hd_views(cfg)
        gen = GenerationConfig(**GEN)
        walls = []
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            tokens = model.generate_fused(ids, [views], [size], gen)
            answer = model.decode_output(tokens, tokenizer, stop_ids)
            walls.append(time.perf_counter() - t0)
        out["first_request_s"], out["warm_request_s"] = walls
        rss["requests"] = host_rss_gib()
        vocab = cfg.llada.vocab_size
        if tokens.shape != (GEN["max_new_tokens"],) or \
                not ((tokens >= 0) & (tokens < vocab)).all():
            raise AssertionError(f"generated ids out of the vocab: {tokens}")
        ends = [list(tokens).index(s) for s in (STOP_ID, cfg.llada.eos_token_id)
                if s in tokens]
        cut = min(ends) if ends else None
        # the cut, on this answer and on the same ids with the stop id put
        # at position 5 (random weights seldom generate it)
        stopped = tokens.copy()
        stopped[5] = STOP_ID
        for row, at in ((tokens, cut),
                        (stopped, 5 if cut is None else min(5, cut))):
            if model.decode_output(row, tokenizer, stop_ids) != \
                    tokenizer.decode(row[:at], skip_special_tokens=True).strip():
                raise AssertionError("the answer is not cut at the stop id")
        out.update(tokens=tokens.tolist(), answer=answer,
                   prompt_ids=len(ids), views=views.shape[0],
                   peak_device_gib=peak_gib(), rss_gib=rss)
        log(f"[ckpt] to_serving_layout('mixed', fuse=True) in "
            f"{out['layout_s']:.2f} s; prompt: the llada template, "
            f"{len(ids) - 1} text tokens + the image marker, round-trips "
            f"through the tokenizer; request (image {size} -> "
            f"{views.shape[0]} views, gen 32, 16 steps): first "
            f"{walls[0] * 1e3:.1f} ms, warm {walls[1] * 1e3:.1f} ms; ids "
            f"{tokens.tolist()}; cut at "
            f"{cut if cut is not None else 'none (no stop id or EOS)'}; answer "
            f"{answer!r}")
        del model
        return out
    finally:
        if not keep:
            shutil.rmtree(path, ignore_errors=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", default=str(DEFAULT_PATH))
    ap.add_argument("--keep", action="store_true",
                    help="leave the checkpoint on disk")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("the rehearsal needs a CUDA device")
    out = rehearse(torch, torch.device("cuda", 0), args.path, args.keep)
    print(json.dumps({k: v for k, v in out.items() if k != "tokens"}))


if __name__ == "__main__":
    main()
