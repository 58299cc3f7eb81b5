#!/usr/bin/env python3
"""Time kernel wrappers of a checkout on one CUDA card, beside the PyTorch
call that computes the same function:

    python3 lavida_mod_tpu_torch/kernel_times.py [CHECKOUT] [--only w4_grouped|kv8|vit_mlp]

CHECKOUT is the root of a tree whose `lavida_mod_tpu_torch` package is
timed (default: the tree holding this file), so two versions of the
kernels can be timed in turns on one card, one process each.  It times
five groups (`--only w4_grouped` the last alone), and with `--only kv8`
or `--only vit_mlp` a sixth or a seventh alone:

  short_attention  per shape of one mixed request (26 SigLIP + 32 prefill
                   launches), against SDPA with the same mask;
  w8a8_matmul      32 of each of the mixed prefill's four shapes, against
                   torch._int_mm + the f32 epilogue;
  prefix_flash     the training attention of one stage-1 step at full
                   LLaDA-8B ([8, 1152, 32, 128], prefix lengths near 1010,
                   a valid tail; 64 forward launches with the remat
                   recompute, 32 dq, 32 dkv), the forward against SDPA's
                   forward and dq + dkv against SDPA's whole autograd
                   backward, both with the same boolean mask;
  w4 fused decode  #5 w4_qkv_norm, #6 w4_matmul_res and #7 w4_ffn_fused
                   at one mixed request's shapes (32 rows; 512 calls of
                   each at the layers' shapes, 16 of #5 at the head's), no
                   library call; #5 also at the B = 4 batch's fused head
                   (128 rows, outside the request's sums); #6 also with
                   its weights cold in L2 (cycled through 8 copies, 71
                   MB; outside the sums); #5, #6 and #7 also split by
                   their own kernels from the profiler (`kernel_split`);
  w4_matmul_grouped  #4 at the batched int4 path's shapes: the decode of a
                   B = 4 batch ([128, 4096] x 4096, x 12288 and [128,
                   12288] x 4096: 4 / 2 / 1 calls per layer and step, x 32
                   layers x 16 steps) and of a B = 8 batch (256 rows), the
                   B = 8 head ([256, 4096] x 126464, 16 calls), each warm
                   and cold in L2 (cycled through weight copies of more
                   than 60 MB), and the B = 4 prefill ([4608, K] x N, 4 /
                   2 / 1 calls per layer, 32 layers); sums per B = 4 and
                   B = 8 batch with the decode cold, as a batch's 32
                   layers find it; the decode and the prefill split by
                   kernel (the row quantization and the GEMM).
  kv8_decode_attention  #8 at the kv8 batches' shapes (q [B, 32, 32, 128]
                   over S = 1184 keys, each batch row front-padded as
                   generate_batch pads, B = 4 and 8; 512 launches per
                   batch), cold in L2 (cycled through 4 caches, as a
                   batch's 32 layers each read their own) and warm, each
                   with its bound; beside it, as a yardstick of the same
                   shape and not the same function, the bf16-cache
                   `dense_attention` that the path without kv8 runs (twice
                   the cache bytes), also cold; and #8 at Dream-7B's GQA
                   (28 / 4 heads, B = 4), outside the sums; first, the
                   largest error against the plain version at each of
                   chip_smoke.py's #8 cases (KV8_CASES).
  fused_vit_mlp    #9 at the batched path's call (one image: M = 3645 =
                   5 views x 729 rows, D = 1152, F = 4304; 104 launches
                   per B = 4 batch), at 20 views at once (M = 14580) and
                   at a ragged M 77 / D 256 / F 520, each with its weights
                   cold in L2 (cycled through 3 copies, 59 MB, as a
                   batch's 26 layers each read their own) and warm, with
                   its bound (4 M D F operations at 989 TFLOP/s) and its
                   largest error against the plain version; split by its
                   three launches (LN, fc1, fc2: the time each adds under
                   PDL, `kernel_split`); beside it, as yardsticks that
                   the path never calls, the port's unfused chain (x +
                   fc2(gelu_tanh(fc1(layer_norm(x)))): cuBLAS GEMMs and
                   eager elementwise kernels, models/siglip.py) and its
                   two F.linear products alone.

Each is timed three ways:

  device         CUDA events over 20 calls while a spin kernel holds the
                 stream, so the calls are timed by their kernels alone;
  back to back   CUDA events over 20 calls as the host issues them: the
                 larger of the host's and the card's time per call;
  host           the host's time per call, enqueued without a sync;

then their sums over the request or step, and as its last line one JSON
object.  chip_smoke.py takes its timers (`cuda_ms`, `host_us`) from here.
"""

from __future__ import annotations

import json
import os
import sys
import time

TIME_ITERS = 20


def cuda_ms(fn, iters: int = TIME_ITERS, hold: bool = True) -> float:
    """Mean time of fn() in ms over `iters` calls (CUDA events), after
    warm-up.  With `hold`, a spin kernel holds the stream while the host
    enqueues the timed calls, so a call whose host side is slower than its
    kernels is timed by its kernels (device time); without, the calls are
    timed back to back as the host issues them."""
    import torch

    for _ in range(min(3, iters)):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold:  # about 2e9 spin cycles a second on an H100
        torch.cuda._sleep(int((1.5 * iters * host_s + 1e-3) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 50) -> float:
    """Host time per call of fn() in microseconds, calls enqueued back to
    back without a sync (what a host-bound caller pays per launch)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def three_times(fn) -> dict:
    return {"ms": cuda_ms(fn), "ms_back_to_back": cuda_ms(fn, hold=False),
            "host_us": host_us(fn)}


# the stage-1 step's attention (chip_smoke.py phase 9): prefix lengths and
# valid keys per row, launches per step of fwd, dq and dkv
STAGE1_PLEN = [1010 - 9 * i for i in range(4)] * 2
STAGE1_LAUNCHES = (64, 32, 32)


def stage1_attention_inputs(torch, dev, gen, B=8, T=1152, H=32, hd=128):
    """q, k, v, dout [B, T, H, hd] bf16, plen [B] and kv_valid [B, T] int32
    of the stage-1 shape, and the [B, 1, T, T] boolean mask SDPA takes."""
    q, k, v, dout = (torch.randn(B, T, H, hd, device=dev,
                                 generator=gen).bfloat16() for _ in range(4))
    pl = torch.tensor(STAGE1_PLEN[:B], dtype=torch.int32, device=dev)
    pos = torch.arange(T, device=dev)
    valid = (pos[None] < pl[:, None] + 48).int()
    see = (((pos[None, None, :] < pl[:, None, None])
            | (pos[None, :, None] >= pl[:, None, None]))
           & valid.bool()[:, None, :])
    return q, k, v, dout, pl, valid, see[:, None]


def main(argv: list[str]) -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    only = None
    if "--only" in argv:
        i = argv.index("--only")
        only = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
        if only not in ("w4_grouped", "kv8", "vit_mlp"):
            raise ValueError(f"--only {only}: the groups are w4_grouped, "
                             f"kv8 and vit_mlp")
    tree = os.path.abspath(argv[0] if argv else os.path.dirname(here))
    # import the checkout's package, not a sibling of this file
    sys.path[:] = [tree] + [p for p in sys.path
                            if os.path.abspath(p or ".") != here]
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_times.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from lavida_mod_tpu_torch.ops import prefix_flash as tpf
    from lavida_mod_tpu_torch.ops import quant as tq
    from lavida_mod_tpu_torch.ops import w8a8 as t8
    from lavida_mod_tpu_torch.ops.short_attention import short_attention

    pkg = os.path.dirname(sys.modules["lavida_mod_tpu_torch"].__file__)
    if os.path.dirname(pkg) != tree:
        raise RuntimeError(f"lavida_mod_tpu_torch came from {pkg}, not {tree}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    name = torch.cuda.get_device_name(0)
    print(f"[times] lavida_mod_tpu_torch of {tree} on {name}")
    rows, sums = [], {}

    def record(kernel, shape, per, mine, lib):
        rows.append({"kernel": kernel, "shape": shape, "per_request": per,
                     "kernel_times": mine, "library_times": lib})
        s = sums.setdefault(kernel, {"kernel": {}, "library": {}})
        for side, t in (("kernel", mine), ("library", lib or {})):
            for k, val in t.items():
                s[side][k] = s[side].get(k, 0.0) + per * val
        lib_text = "none" if lib is None else (
            f"device {lib['ms']:.4f} ms, back to back "
            f"{lib['ms_back_to_back']:.4f} ms, host {lib['host_us']:.1f} us")
        print(f"[times] {kernel} {shape} x {per}: kernel device "
              f"{mine['ms']:.4f} ms, back to back "
              f"{mine['ms_back_to_back']:.4f} ms, host {mine['host_us']:.1f} "
              f"us; library {lib_text}")

    if only == "w4_grouped":
        out = time_w4_grouped(torch, dev, gen, record, name)
        print(json.dumps({"tree": tree, "device": name, "shapes": rows,
                          "w4_grouped": out}))
        return
    if only == "kv8":
        out = time_kv8(torch, dev, gen, record, name)
        print(json.dumps({"tree": tree, "device": name, "shapes": rows,
                          "kv8": out}))
        return
    if only == "vit_mlp":
        out = time_vit_mlp(torch, dev, gen, record, name)
        print(json.dumps({"tree": tree, "device": name, "shapes": rows,
                          "vit_mlp": out}))
        return
    with torch.no_grad():
        for shape, kv, valid, per in [((5, 729, 16, 72), (5, 729, 16, 72),
                                       None, 26),
                                      ((1, 1056, 32, 128), (1, 1088, 32, 128),
                                       1056, 32)]:
            q = torch.randn(*shape, device=dev, generator=gen).bfloat16()
            k, v = (torch.randn(*kv, device=dev, generator=gen).bfloat16()
                    for _ in range(2))
            sq = skv = mask = None
            if valid is not None:   # the prefill's filled-rows mask
                sq = torch.ones(shape[:2], dtype=torch.int32, device=dev)
                skv = (torch.arange(kv[1], device=dev) < valid).int()[None]
                mask = sq[:, None, :, None] == skv[:, None, None, :]
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            record("short_attention", f"q{shape} kv{kv}", per,
                   three_times(lambda: short_attention(q, k, v, sq, skv)),
                   three_times(lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, attn_mask=mask)))
        for T, K, N in [(1056, 4096, 12288), (1056, 4096, 4096),
                        (1056, 4096, 24576), (1056, 12288, 4096)]:
            x = torch.randn(T, K, device=dev, generator=gen).bfloat16()
            w, sc = tq.quantize_linear(
                torch.randn(N, K, device=dev, generator=gen) * 0.02)
            x8, sx = t8.act_quant(x, t8.ACT_FORMULA_W8)
            wt = w.t()
            try:
                torch._int_mm(x8, wt)
            except RuntimeError:      # a build that takes row-major only
                wt = wt.contiguous()
            record("w8a8_matmul", f"[{T},{K}]x[{K},{N}]", 32,
                   three_times(lambda: t8.w8a8_matmul(x8, sx, w, sc)),
                   three_times(lambda: (torch._int_mm(x8, wt).float()
                                        * sx * sc).bfloat16()))
    # the stage-1 step's training attention
    q, k, v, dout, pl, valid, mask = stage1_attention_inputs(
        torch, dev, gen)
    o, lse = tpf.prefix_flash_fwd(q, k, v, pl, valid)
    delta = tpf.attention_delta(dout, o)
    args = (q, k, v, pl, valid, dout, lse, delta)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    dot = dout.transpose(1, 2)
    shape = f"q{tuple(q.shape)} plen {STAGE1_PLEN}"
    nf, nb = STAGE1_LAUNCHES[:2]    # dq and dkv launch as often
    with torch.no_grad():
        record("prefix_flash_fwd", shape, nf,
               three_times(lambda: tpf.prefix_flash_fwd(q, k, v, pl,
                                                        valid)),
               three_times(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, attn_mask=mask)))
    # SDPA computes dq, dk and dv in one backward: it stands beside
    # dq + dkv, once per step's 32 launches of each
    lib_bwd = three_times(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))
    record("prefix_flash_dq+dkv", shape, nb,
           {key: a + b for (key, a), b in zip(
               three_times(lambda: tpf.prefix_flash_dq(*args)).items(),
               three_times(lambda: tpf.prefix_flash_dkv(*args)).values())},
           lib_bwd)
    splits = time_w4_decode(torch, dev, gen, record)
    grouped = time_w4_grouped(torch, dev, gen, record, name)
    for kernel, s in sums.items():
        if kernel.startswith("w4_matmul_grouped"):
            continue              # summed per batch by time_w4_grouped
        a, b = s["kernel"], s["library"]
        what = ("stage-1 step" if kernel.startswith("prefix_flash")
                else "mixed request")
        lib_text = "none" if not b else (
            f"device {b['ms']:.4f} ms, back to back "
            f"{b['ms_back_to_back']:.4f} ms, host {b['host_us'] / 1e3:.4f} "
            f"ms")
        print(f"[times] {kernel} per {what}: kernel device "
              f"{a['ms']:.4f} ms, back to back {a['ms_back_to_back']:.4f} "
              f"ms, host {a['host_us'] / 1e3:.4f} ms; library {lib_text} "
              f"({name})")
    print(json.dumps({"tree": tree, "device": name, "shapes": rows,
                      "per_request": sums, "splits": splits,
                      "w4_grouped": grouped}))


def added_times(torch, prof) -> dict:
    """{kernel name: [added ms, ms, launches]} over the CUDA kernels of a
    torch.profiler trace.  `ms` runs from a kernel's start to its end; a
    kernel launched with programmatic dependent launch starts while the
    one before it runs and waits inside, so `added ms` counts only the
    time from the later of its start and the end of every kernel before
    it to its end: what it adds to the device's busy time, which is the
    sum of the added times (the union of the kernels' intervals)."""
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    split, done = {}, float("-inf")
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        r = split.setdefault(e.name, [0.0, 0.0, 0])
        r[0] += max(end - max(start, done), 0) / 1e3
        r[1] += (end - start) / 1e3
        r[2] += 1
        done = max(done, end)
    return split


def kernel_split(torch, fn, calls: int = 20) -> dict:
    """{kernel name: (added ms, ms)} per call of fn(), from torch.profiler
    over `calls` calls (`added_times`)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {k: (added / calls, ms / calls)
            for k, (added, ms, _) in added_times(torch, prof).items()}


def time_w4_decode(torch, dev, gen, record) -> dict:
    """#5, #6 and #7 at one mixed request's decode shapes (#5 also at the
    B = 4 head, #6 also cold in L2); returns {call: device time per call
    split by kernel} of each #5 and #6 call and of #7."""
    from lavida_mod_tpu_torch.ops import quant as tq
    from lavida_mod_tpu_torch.ops import w4_fused as tw

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    def w4(K, N):
        packed, scales, _ = tq.quantize_linear4(randn(N, K, scale=0.02))
        return packed[:N // 8].contiguous(), scales[:, :N].contiguous()

    T, D, H = 32, 4096, 12288
    x = randn(T, D).bfloat16()
    nw = (1 + randn(D, scale=0.1)).bfloat16()
    splits = {}
    with torch.no_grad():
        for rows, N, per in [(T, 3 * D, 512), (T, 126464, 16),
                             (128, 126464, 0)]:
            w = w4(D, N)
            xr = randn(rows, D).bfloat16()
            shape = f"[{rows},{D}]x[{D},{N}]"

            def qkv():
                return tw.w4_qkv_norm(xr, nw, *w, 1e-5)

            record("w4_qkv_norm", shape, per, three_times(qkv), None)
            splits[f"w4_qkv_norm {shape}"] = kernel_split(torch, qkv)
        res = randn(T, D).bfloat16()
        # one copy of the weights stays in L2 from call to call; eight
        # (71 MB) do not, as a request's 32 layers do not
        copies = [w4(D, D)]
        copies += [tuple(t.clone() for t in copies[0]) for _ in range(7)]
        for n, what, per in [(1, "", 512), (8, " cold (8 weight copies)", 0)]:
            it = iter(range(1 << 62))

            def mres(n=n, it=it):
                return tw.w4_matmul_res(x, res, *copies[next(it) % n])

            shape = f"[{T},{D}]x[{D},{D}]{what}"
            record("w4_matmul_res", shape, per, three_times(mres), None)
            splits[f"w4_matmul_res {shape}"] = kernel_split(torch, mres)
        w = w4(D, 2 * H) + w4(H, D)

        def ffn():
            return tw.w4_ffn_fused(x, nw, *w, 1e-5)

        record("w4_ffn_fused", f"[{T},{D}] H {H} Hd {H}", 512,
               three_times(ffn), None)
        splits[f"w4_ffn_fused [{T},{D}] H {H}"] = kernel_split(torch, ffn)
    for call, split in splits.items():
        for key, (added, ms) in sorted(split.items(),
                                       key=lambda kv: -kv[1][0]):
            print(f"[times] {call} split: adds {added:.4f} ms per call, "
                  f"runs {ms:.4f} ms from launch to end  {key[:100]}")
    return splits


# #4's linears per layer: (K, N, calls per layer and forward)
W4_LINEARS = [(4096, 4096, 4), (4096, 12288, 2), (12288, 4096, 1)]
W4_LAYERS, W4_STEPS = 32, 16
W4_COLD_BYTES = 60e6          # weight copies cycled past the 50 MB L2


def time_w4_grouped(torch, dev, gen, record, card) -> dict:
    """#4 at the batched int4 path's shapes (module note): device time per
    call warm and cold, sums per B = 4 and B = 8 batch (decode cold), each
    call's bound (the larger of its bytes over 3.35 TB/s and its int8
    operations over 1,979 TOP/s), and the row quantization / GEMM split
    of the B = 4 decode's first linear (cold) and of the prefill's."""
    from lavida_mod_tpu_torch.ops import quant as tq
    from lavida_mod_tpu_torch.ops import w4_grouped as tg

    def bound_ms(T, K, N):
        nbytes = 2 * T * K + K * N // 2 + K // 128 * N * 4 + 2 * T * N
        return max(nbytes / 3.35e12, 2 * T * K * N / 1979e12) * 1e3

    # (T, K, N, calls per B = 4 batch, per B = 8 batch, regime)
    cases = []
    for K, N, per in W4_LINEARS:
        cases.append((128, K, N, per * W4_LAYERS * W4_STEPS, 0, "decode"))
        cases.append((256, K, N, 0, per * W4_LAYERS * W4_STEPS, "decode"))
    cases.append((256, 4096, 126464, 0, W4_STEPS, "decode"))   # B = 8 head
    for K, N, per in W4_LINEARS:
        cases.append((4608, K, N, per * W4_LAYERS, 0, "prefill"))
    sums = {"b4": {"decode": 0.0, "prefill": 0.0, "bound_decode": 0.0,
                   "bound_prefill": 0.0},
            "b8_decode_and_head": {"decode": 0.0, "bound_decode": 0.0}}
    weights, out = {}, {"calls": [], "splits": {}}
    with torch.no_grad():
        for T, K, N, per4, per8, kind in cases:
            if (K, N) not in weights:
                packed, scales, _ = tq.quantize_linear4(
                    torch.randn(N, K, device=dev, generator=gen) * 0.02)
                copies = 1 if kind == "prefill" else max(1, -(-int(
                    W4_COLD_BYTES) // (packed.numel() + 4 * scales.numel())))
                weights[(K, N)] = [(packed, scales)] + [
                    (packed.clone(), scales.clone()) for _ in range(copies - 1)]
            ws = weights[(K, N)]
            x = torch.randn(T, K, device=dev, generator=gen).bfloat16()
            shape = f"[{T},{K}]x[{K},{N}]"
            times = {}
            for temp, n in [("warm", 1), ("cold", len(ws))]:
                if temp == "cold" and n == 1:   # the prefill; the head's
                    continue                       # 275 MB never fit L2
                it = iter(range(1 << 62))

                def call(n=n, it=it):
                    return tg.w4_matmul_grouped(x, *ws[next(it) % n])

                t = three_times(call)
                times[temp] = t
                record(f"w4_matmul_grouped {kind}",
                       f"{shape} {temp} ({n} weight copies)", 0, t, None)
                if (T, K, N, temp) in [(128, 4096, 4096, "cold"),
                                       (4608, 4096, 12288, "warm")]:
                    out["splits"][f"{shape} {temp}"] = kernel_split(torch, call)
            b = bound_ms(T, K, N)
            ms = times.get("cold", times["warm"])["ms"]
            print(f"[times] w4_matmul_grouped {kind} {shape}: device "
                  f"{ms:.4f} ms per call ({'cold' if 'cold' in times else 'warm'}),"
                  f" bound {b:.4f} ms ({100 * b / ms:.1f} % of it)")
            out["calls"].append({"shape": [T, K, N], "regime": kind,
                                 "per_b4": per4, "per_b8": per8,
                                 "bound_ms": b, **{k: v for k, v in times.items()}})
            sums["b4"][kind] += per4 * ms
            sums["b4"][f"bound_{kind}"] += per4 * b
            if per8:
                sums["b8_decode_and_head"]["decode"] += per8 * ms
                sums["b8_decode_and_head"]["bound_decode"] += per8 * b
        del weights
    for call, split in out["splits"].items():
        for key, (added, ms) in sorted(split.items(), key=lambda kv: -kv[1][0]):
            print(f"[times] w4_matmul_grouped {call} split: adds {added:.4f} "
                  f"ms per call, runs {ms:.4f} ms from launch to end  "
                  f"{key[:100]}")
    s4, s8 = sums["b4"], sums["b8_decode_and_head"]
    print(f"[times] w4_matmul_grouped per B = 4 batch: decode {s4['decode']:.2f}"
          f" ms (bound {s4['bound_decode']:.2f}), prefill {s4['prefill']:.2f} "
          f"ms (bound {s4['bound_prefill']:.2f}), sum "
          f"{s4['decode'] + s4['prefill']:.2f} ms; per B = 8 batch, decode and"
          f" head {s8['decode']:.2f} ms (bound {s8['bound_decode']:.2f}) "
          f"({card})")
    out["sums"] = sums
    return out



KV8_CACHES = 4     # caches cycled for a cold read: 4 x 40 MB at B = 4
KV8_LAUNCHES = 32 * 16   # per batch: 32 layers x 16 decode steps
# chip_smoke.py's #8 cases, (B, T, H, Hkv, hd, S, pad0): the B = 4 and B = 8
# kv8 batches, a ragged GQA case, G = 16, a long cache (many key chunks),
# Dream-7B's GQA and a batch row with every key masked; batch row b > 0 is
# front-padded by (37 b) % (S / 4) keys, row 0 by pad0 (-1: all of them)
KV8_CASES = [(4, 32, 32, 32, 128, 1184, None), (8, 32, 32, 32, 128, 1184, None),
             (1, 13, 8, 2, 64, 77, None), (2, 32, 16, 1, 128, 300, None),
             (2, 32, 8, 8, 128, 16384, 700), (4, 32, 28, 4, 128, 1184, None),
             (2, 32, 32, 32, 128, 1184, -1)]


def kv8_case_inputs(torch, randn, B, T, H, Hkv, hd, S, pad0):
    """q, k8, ks, v8, vs and the [B, S] bool mask of a KV8_CASES case, drawn
    with `randn(*shape)` (a tensor on the card)."""
    from lavida_mod_tpu_torch.ops import kv8_attention as tk

    q = randn(B, T, H, hd).bfloat16()
    k8, ks = tk.quantize_kv(randn(B, S, Hkv, hd).bfloat16())
    v8, vs = tk.quantize_kv(randn(B, S, Hkv, hd).bfloat16())
    valid = torch.ones(B, S, dtype=torch.bool, device=q.device)
    for b in range(B):
        valid[b, :(37 * b) % (S // 4)] = False
    if pad0 is not None:
        valid[0, :S if pad0 < 0 else pad0] = False
    return q, k8, ks, v8, vs, valid


def time_kv8(torch, dev, gen, record, card) -> dict:
    """#8 at the kv8 batches' shapes (module note): device time per call
    cold and warm, per batch (512 launches) cold, each call's bound (its
    cache, scales, mask, q and out bytes over 3.35 TB/s), and the bf16-cache
    dense_attention of the same shape beside it."""
    from lavida_mod_tpu_torch.ops import kv8_attention as tk
    from lavida_mod_tpu_torch.ops.attention import dense_attention, make_bias

    out = {"calls": [], "per_batch": {}, "errors": []}
    # the largest error against the plain version at chip_smoke's cases
    # (a tree whose wrapper refuses a case says so)
    for case in KV8_CASES:
        args = kv8_case_inputs(torch, lambda *shape: torch.randn(
            *shape, device=dev, generator=gen), *case)
        try:
            got = tk.kv8_decode_attention(*args)
        except ValueError as e:
            print(f"[times] kv8_decode_attention case {case}: refused ({e})")
            out["errors"].append({"case": case, "refused": str(e)})
            continue
        err = (got.float() - tk.kv8_decode_attention_reference(*args)
               .float()).abs().max().item()
        print(f"[times] kv8_decode_attention case {case}: max error {err:.3e} "
              f"against the plain version (limit 6e-3)")
        out["errors"].append({"case": case, "max_abs_err": err})
        del args, got
    T, hd, S = 32, 128, 1184
    with torch.no_grad():
        for B, H, Hkv, summed in [(4, 32, 32, True), (8, 32, 32, True),
                                  (4, 28, 4, False)]:
            q = torch.randn(B, T, H, hd, device=dev, generator=gen).bfloat16()
            valid = torch.ones(B, S, dtype=torch.bool, device=dev)
            for b in range(B):   # front padding, as generate_batch's
                valid[b, :(37 * b) % (S // 4)] = False
            kv = [(torch.randn(B, S, Hkv, hd, device=dev, generator=gen)
                   .bfloat16(), torch.randn(B, S, Hkv, hd, device=dev,
                                            generator=gen).bfloat16())
                  for _ in range(KV8_CACHES)]
            caches = [(*tk.quantize_kv(k), *tk.quantize_kv(v))
                      for k, v in kv]
            bias = make_bias(kv_valid=valid)
            nbytes = 2 * B * Hkv * S * (hd + 4) + 4 * q.numel() + B * S
            bound = nbytes / 3.35e12 * 1e3
            shape = f"q[{B},{T},{H},{hd}] Hkv {Hkv} S {S}"
            times = {}
            for temp, n in [("cold", KV8_CACHES), ("warm", 1)]:
                it = iter(range(1 << 62))

                def call(n=n, it=it):
                    k8, ks, v8, vs = caches[next(it) % n]
                    return tk.kv8_decode_attention(q, k8, ks, v8, vs, valid)

                def dense(n=n, it=iter(range(1 << 62))):
                    k, v = kv[next(it) % n]
                    return dense_attention(q, k, v, bias=bias)

                times[temp] = three_times(call)
                times[f"dense_{temp}"] = three_times(dense)
                record("kv8_decode_attention", f"{shape} {temp} ({n} caches)",
                       0, times[temp], times[f"dense_{temp}"])
            ms = times["cold"]["ms"]
            print(f"[times] kv8_decode_attention {shape}: device {ms:.4f} ms "
                  f"per call cold, {times['warm']['ms']:.4f} warm, bound "
                  f"{bound:.4f} ms ({100 * bound / ms:.1f} % of it cold); "
                  f"bf16 dense_attention {times['dense_cold']['ms']:.4f} ms "
                  f"cold ({card})")
            out["calls"].append({"shape": [B, T, H, Hkv, hd, S],
                                 "bound_ms": bound, **times})
            if summed:
                per = {k: KV8_LAUNCHES * t["ms"] for k, t in times.items()}
                per["bound"] = KV8_LAUNCHES * bound
                out["per_batch"][f"b{B}"] = per
                print(f"[times] kv8_decode_attention per B = {B} kv8 batch "
                      f"({KV8_LAUNCHES} launches): cold {per['cold']:.2f} ms,"
                      f" warm {per['warm']:.2f} ms, bound {per['bound']:.2f} "
                      f"ms; bf16 dense_attention cold {per['dense_cold']:.2f}"
                      f" ms ({card})")
            del kv, caches
    return out


VIT_LAUNCHES = 4 * 26   # per B = 4 batch: 26 SigLIP layers x 4 images
VIT_COPIES = 3          # weight copies cycled for a cold read: 3 x 19.8 MB
# (M, D, F, launches per B = 4 batch): one image, 20 views, a ragged case
VIT_CASES = [(3645, 1152, 4304, VIT_LAUNCHES), (14580, 1152, 4304, 0),
             (77, 256, 520, 0)]


def vit_mlp_bound_ms(M, D, F):
    """The least time of one #9 call: its 4 M D F operations at 989 TFLOP/s
    or its bytes (x and out, the weights, the biases and LN's affine) at
    3.35 TB/s, whichever is longer."""
    nbytes = 4 * M * D + 4 * D * F + 2 * (F + 3 * D)
    return max(4 * M * D * F / 989e12, nbytes / 3.35e12) * 1e3


def time_vit_mlp(torch, dev, gen, record, card) -> dict:
    """#9 at the batched path's shapes (module note): device time per call
    cold and warm, per B = 4 batch, the bound, the split by launch, the
    unfused chain and the two F.linear products beside it."""
    import torch.nn.functional as F
    from lavida_mod_tpu_torch.ops import vit_mlp as tv
    from lavida_mod_tpu_torch.ops.activations import gelu_tanh
    from lavida_mod_tpu_torch.ops.norms import layer_norm

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen)
                * scale).bfloat16()

    out = {"calls": [], "splits": {}, "per_batch": {}}
    with torch.no_grad():
        for M, D, Fd, per in VIT_CASES:
            x = randn(M, D)
            ws = [((1 + randn(D, scale=0.1)).bfloat16(), randn(D, scale=0.1),
                   randn(Fd, D, scale=0.03), randn(Fd, scale=0.1),
                   randn(D, Fd, scale=0.03), randn(D, scale=0.1))
                  for _ in range(VIT_COPIES)]
            err = (tv.fused_vit_mlp(x, *ws[0]).float()
                   - tv.fused_vit_mlp_reference(x, *ws[0]).float()
                   ).abs().max().item()
            h = randn(M, Fd)      # fc2's input for the products alone
            shape = f"M {M} D {D} F {Fd}"
            times = {}
            for temp, n in [("cold", VIT_COPIES), ("warm", 1)]:
                def cycle(n=n, it=iter(range(1 << 62))):
                    return ws[next(it) % n]

                def call():
                    return tv.fused_vit_mlp(x, *cycle())

                def chain():
                    g, b, w1, b1, w2, b2 = cycle()
                    return x + F.linear(gelu_tanh(F.linear(
                        layer_norm(x, g, b, 1e-6), w1, b1)), w2, b2)

                def linears():
                    _, _, w1, b1, w2, b2 = cycle()
                    return F.linear(x, w1, b1), F.linear(h, w2, b2)

                times[temp] = three_times(call)
                times[f"chain_{temp}"] = three_times(chain)
                times[f"linears_{temp}"] = three_times(linears)
                record("fused_vit_mlp", f"{shape} {temp} ({n} weight copies)",
                       0, times[temp], None)
                if M == 3645 or temp == "warm":
                    out["splits"][f"{shape} {temp}"] = kernel_split(torch, call)
            b = vit_mlp_bound_ms(M, D, Fd)
            ms = times["cold"]["ms"]
            print(f"[times] fused_vit_mlp {shape}: device {ms:.4f} ms per "
                  f"call cold, {times['warm']['ms']:.4f} warm, bound {b:.4f} "
                  f"ms ({100 * b / ms:.1f} % of it cold); max error "
                  f"{err:.3e} against the plain version (limit 5e-2); "
                  f"yardsticks the path never calls: the unfused chain "
                  f"{times['chain_cold']['ms']:.4f} ms cold, "
                  f"{times['chain_warm']['ms']:.4f} warm, its two F.linear "
                  f"products {times['linears_cold']['ms']:.4f} cold, "
                  f"{times['linears_warm']['ms']:.4f} warm ({card})")
            out["calls"].append({"shape": [M, D, Fd], "bound_ms": b,
                                 "max_abs_err": err, **times})
            if per:
                sums = {k: per * t["ms"] for k, t in times.items()}
                sums["bound"] = per * b
                out["per_batch"]["b4"] = sums
                print(f"[times] fused_vit_mlp per B = 4 batch ({per} "
                      f"launches): cold {sums['cold']:.2f} ms, warm "
                      f"{sums['warm']:.2f} ms, bound {sums['bound']:.2f} ms; "
                      f"unfused chain cold {sums['chain_cold']:.2f} ms, "
                      f"F.linear products cold {sums['linears_cold']:.2f} ms "
                      f"({card})")
            del ws, x, h
    for call, split in out["splits"].items():
        for key, (added, ms) in sorted(split.items(), key=lambda kv: -kv[1][0]):
            print(f"[times] fused_vit_mlp {call} split: adds {added:.4f} ms "
                  f"per call, runs {ms:.4f} ms from launch to end  "
                  f"{key[:100]}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
