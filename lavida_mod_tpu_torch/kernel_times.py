#!/usr/bin/env python3
"""Time kernel wrappers of a checkout on one CUDA card, beside the PyTorch
call that computes the same function:

    python3 lavida_mod_tpu_torch/kernel_times.py [CHECKOUT]
        [--only w4_grouped|kv8|vit_mlp|short_f32|w4_matmul]

CHECKOUT is the root of a tree whose `lavida_mod_tpu_torch` package is
timed (default: the tree holding this file), so two versions of the
kernels can be timed in turns on one card, one process each.  It times
five groups (`--only w4_grouped` the last alone), and with `--only kv8`,
`--only vit_mlp`, `--only short_f32` or `--only w4_matmul` a sixth,
seventh, eighth or ninth alone:

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
                   (28 / 4 heads, B = 4), outside the sums; each shape
                   also over the int4 cache (--kv4: #8's int4 instance,
                   half the cache bytes), cold and warm, with its bound;
                   first, the largest error against the plain version at
                   each of chip_smoke.py's #8 cases (KV8_CASES), over the
                   int8 and the int4 cache.
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
  short_attention_f32  #1's f32 instance at the SHIRG-LoRA harness's
                   tower ([4, 1024, 16, 72], 26 launches per step) and at
                   a ragged GQA case ([2, 77, 8, 72] over 131 keys, the
                   last 5 rows seeing no key), beside SDPA in f32 (TF32
                   off), each with its largest error against the plain
                   version and two bounds: the 3xTF32 floor (3 x 4 B H T
                   keys hd operations at 495 TFLOP/s, or the bytes) and
                   the FFMA figure (4 B H T keys hd at 67 TFLOP/s).
  w4_matmul        #11 (per-channel int4, no path launches it) at the TPU
                   status note's decode shape ([32, 4096] x 12288), the
                   prefill's rows ([1056, 4096] x 12288) and a ragged
                   [5, 4304] x 1000, each cold in L2 (cycled through
                   weight copies of 100 MB or more) and warm, with its
                   bound by bytes and by operations, its largest error
                   against the plain version and the plain version's
                   time; beside it tinygemm (torch._weight_int4pack_mm on
                   the same codes, scale in bf16), cold and warm, or the
                   error with which it refuses the shape, and, as a
                   yardstick of the same shape and not the same function,
                   dense bf16 torch.matmul over the dequantized weights
                   (four times the weight bytes).

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
        if only not in ("w4_grouped", "kv8", "vit_mlp", "short_f32",
                        "w4_matmul"):
            raise ValueError(f"--only {only}: the groups are w4_grouped, "
                             f"kv8, vit_mlp, short_f32 and w4_matmul")
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
    if only == "w4_matmul":
        out = time_w4_matmul(torch, dev, gen, record, name)
        print(json.dumps({"tree": tree, "device": name, "shapes": rows,
                          "w4_matmul": out}))
        return
    if only == "short_f32":
        out = time_short_f32(torch, dev, gen, record, name)
        print(json.dumps({"tree": tree, "device": name, "shapes": rows,
                          "short_f32": out}))
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


def kv8_case_inputs(torch, randn, B, T, H, Hkv, hd, S, pad0, bits=8):
    """q, k8, ks, v8, vs and the [B, S] bool mask of a KV8_CASES case, drawn
    with `randn(*shape)` (a tensor on the card); the cache of `bits`-bit
    codes (4: packed int4)."""
    from lavida_mod_tpu_torch.ops import kv8_attention as tk

    q = randn(B, T, H, hd).bfloat16()
    k8, ks = tk.quantize_kv(randn(B, S, Hkv, hd).bfloat16(), bits)
    v8, vs = tk.quantize_kv(randn(B, S, Hkv, hd).bfloat16(), bits)
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
    for case, bits in [(c, b) for b in (8, 4) for c in KV8_CASES]:
        try:
            args = kv8_case_inputs(torch, lambda *shape: torch.randn(
                *shape, device=dev, generator=gen), *case, bits=bits)
            got = tk.kv8_decode_attention(*args)
        except (ValueError, NotImplementedError) as e:
            print(f"[times] kv8_decode_attention int{bits} case {case}: "
                  f"refused ({e})")
            out["errors"].append({"case": case, "bits": bits,
                                  "refused": str(e)})
            continue
        ref = tk.kv8_decode_attention_reference(*args)
        err = (got.float() - ref.float()).abs().max().item()
        ok = torch.allclose(got.float(), ref.float(), atol=6e-3, rtol=6e-3)
        print(f"[times] kv8_decode_attention int{bits} case {case}: max "
              f"error {err:.3e} against the plain version, within atol = "
              f"rtol = 6e-3: {ok}")
        out["errors"].append({"case": case, "bits": bits,
                              "max_abs_err": err, "within_band": ok})
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
            try:
                caches4 = [(*tk.quantize_kv(k, 4), *tk.quantize_kv(v, 4))
                           for k, v in kv]
            except (ValueError, NotImplementedError) as e:
                print(f"[times] kv8_decode_attention: no int4 cache ({e})")
                caches4 = None
            bias = make_bias(kv_valid=valid)
            nbytes = 2 * B * Hkv * S * (hd + 4) + 4 * q.numel() + B * S
            bound = nbytes / 3.35e12 * 1e3
            bound4 = (nbytes - B * Hkv * S * hd) / 3.35e12 * 1e3
            shape = f"q[{B},{T},{H},{hd}] Hkv {Hkv} S {S}"
            times = {}
            for temp, n in [("cold", KV8_CACHES), ("warm", 1)]:
                it = iter(range(1 << 62))

                def call(n=n, it=it):
                    k8, ks, v8, vs = caches[next(it) % n]
                    return tk.kv8_decode_attention(q, k8, ks, v8, vs, valid)

                def call4(n=n, it=iter(range(1 << 62))):
                    k4, ks, v4, vs = caches4[next(it) % n]
                    return tk.kv8_decode_attention(q, k4, ks, v4, vs, valid)

                def dense(n=n, it=iter(range(1 << 62))):
                    k, v = kv[next(it) % n]
                    return dense_attention(q, k, v, bias=bias)

                times[temp] = three_times(call)
                times[f"dense_{temp}"] = three_times(dense)
                record("kv8_decode_attention", f"{shape} {temp} ({n} caches)",
                       0, times[temp], times[f"dense_{temp}"])
                if caches4 is not None:
                    times[f"int4_{temp}"] = three_times(call4)
                    record("kv8_decode_attention_int4",
                           f"{shape} {temp} ({n} caches)", 0,
                           times[f"int4_{temp}"], None)
            ms = times["cold"]["ms"]
            print(f"[times] kv8_decode_attention {shape}: device {ms:.4f} ms "
                  f"per call cold, {times['warm']['ms']:.4f} warm, bound "
                  f"{bound:.4f} ms ({100 * bound / ms:.1f} % of it cold); "
                  f"bf16 dense_attention {times['dense_cold']['ms']:.4f} ms "
                  f"cold ({card})")
            if caches4 is not None:
                ms4 = times["int4_cold"]["ms"]
                print(f"[times] kv8_decode_attention int4 {shape}: device "
                      f"{ms4:.4f} ms per call cold, "
                      f"{times['int4_warm']['ms']:.4f} warm, bound "
                      f"{bound4:.4f} ms ({100 * bound4 / ms4:.1f} % of it "
                      f"cold); the int8 kernel {ms:.4f} ms cold ({card})")
            out["calls"].append({"shape": [B, T, H, Hkv, hd, S],
                                 "bound_ms": bound, "int4_bound_ms": bound4,
                                 **times})
            if summed:
                per = {k: KV8_LAUNCHES * t["ms"] for k, t in times.items()}
                per["bound"] = KV8_LAUNCHES * bound
                per["int4_bound"] = KV8_LAUNCHES * bound4
                out["per_batch"][f"b{B}"] = per
                print(f"[times] kv8_decode_attention per B = {B} kv8 batch "
                      f"({KV8_LAUNCHES} launches): cold {per['cold']:.2f} ms,"
                      f" warm {per['warm']:.2f} ms, bound {per['bound']:.2f} "
                      f"ms; bf16 dense_attention cold {per['dense_cold']:.2f}"
                      f" ms ({card})")
                if caches4 is not None:
                    print(f"[times] kv8_decode_attention int4 per B = {B} "
                          f"kv4 batch: cold {per['int4_cold']:.2f} ms, warm "
                          f"{per['int4_warm']:.2f} ms, bound "
                          f"{per['int4_bound']:.2f} ms ({card})")
            del kv, caches, caches4
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


# #1's f32 instance: (name, q shape, kv shape, segments, launches per
# SHIRG-LoRA harness step)
SHORT_F32_CASES = [
    ("shirg_lora_tower", (4, 1024, 16, 72), (4, 1024, 16, 72), None, 26),
    ("ragged_pad_gqa", (2, 77, 8, 72), (2, 131, 2, 72), "pad", 0),
]
TF32_FLOPS, F32_FLOPS, HBM_BPS = 495e12, 67e12, 3.35e12


def short_f32_bounds_ms(ops, nbytes):
    """(3xTF32 floor, FFMA figure) in ms of one f32 attention call: its
    operations three times at the dense TF32 rate, or once at the f32 rate
    outside the tensor cores, against its bytes at 3.35 TB/s."""
    t_bytes = nbytes / HBM_BPS
    return (max(3 * ops / TF32_FLOPS, t_bytes) * 1e3,
            max(ops / F32_FLOPS, t_bytes) * 1e3)


def short_f32_inputs(torch, dev, gen, qs, ks, kind):
    """q, k, v f32 and the segment ids of a SHORT_F32_CASES case; "pad":
    keys valid up to min(T, S - 3), the last 5 query rows matching no key."""
    q = torch.randn(*qs, device=dev, generator=gen)
    k, v = (torch.randn(*ks, device=dev, generator=gen) for _ in range(2))
    sq = skv = None
    if kind == "pad":
        B, T, S = qs[0], qs[1], ks[1]
        sq = torch.ones(B, T, dtype=torch.int32, device=dev)
        sq[:, -5:] = 2
        skv = (torch.arange(S, device=dev) < min(T, S - 3)).int()[None]
        skv = skv.expand(B, S).contiguous()
    return q, k, v, sq, skv


def time_short_f32(torch, dev, gen, record, card) -> dict:
    """#1's f32 instance at SHORT_F32_CASES beside SDPA in f32 (module
    note): device, back-to-back and host time per call, the bounds, the
    largest error against the plain version, and the sums per harness
    step."""
    import torch.nn.functional as F
    from lavida_mod_tpu_torch.ops.short_attention import (
        short_attention, short_attention_reference)

    out = {"calls": [], "per_step": {}}
    with torch.no_grad():
        for name, qs, ks, kind, per in SHORT_F32_CASES:
            q, k, v, sq, skv = short_f32_inputs(torch, dev, gen, qs, ks, kind)
            err = (short_attention(q, k, v, sq, skv)
                   - short_attention_reference(q, k, v, sq, skv)
                   ).abs().max().item()
            mask = None if sq is None else (sq[:, None, :, None]
                                            == skv[:, None, None, :])
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            G = qs[2] // ks[2]
            if G > 1:
                kt, vt = (t.repeat_interleave(G, 1) for t in (kt, vt))
            mine = three_times(lambda: short_attention(q, k, v, sq, skv))
            lib = three_times(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
            shape = f"{name} q{qs} kv{ks}"
            record("short_attention_f32", shape, per, mine, lib)
            B, T, H, hd = qs
            keys = ks[1] if skv is None else int(skv[0].sum())
            tc, ffma = short_f32_bounds_ms(
                4 * B * H * T * keys * hd,
                4 * (2 * q.numel() + k.numel() + v.numel()))
            ms = mine["ms"]
            print(f"[times] short_attention_f32 {shape}: device {ms:.4f} ms "
                  f"({ms / lib['ms']:.2f}x SDPA's {lib['ms']:.4f}), 3xTF32 "
                  f"floor {tc:.4f} ms ({100 * tc / ms:.1f} % of it), FFMA "
                  f"figure {ffma:.4f} ms; max error {err:.3e} against the "
                  f"plain version (limit 2e-5 + 2e-5 |o|) ({card})")
            out["calls"].append({"shape": shape, "bound_ms": tc,
                                 "ffma_bound_ms": ffma, "max_abs_err": err,
                                 "kernel": mine, "sdpa": lib})
            if per:
                out["per_step"] = {"kernel_ms": per * ms,
                                   "sdpa_ms": per * lib["ms"],
                                   "bound_ms": per * tc,
                                   "ffma_bound_ms": per * ffma}
                print(f"[times] short_attention_f32 per harness step ({per} "
                      f"launches): {per * ms:.2f} ms, SDPA "
                      f"{per * lib['ms']:.2f} ms, 3xTF32 floor "
                      f"{per * tc:.2f} ms ({card})")
    return out



# #11: (name, T, K, N)
W4MM_CASES = [("decode", 32, 4096, 12288), ("prefill", 1056, 4096, 12288),
              ("ragged", 5, 4304, 1000)]
W4MM_COLD_BYTES = 100e6   # weight copies cycled past the 50 MB L2 (3 or more)


def int4pack_library(torch, x, codes, scale):
    """torch._weight_int4pack_mm (tinygemm) on #11's codes [K, N] and per-
    channel scale: q = code + 8, the scale repeated over 128-row groups in
    bf16, zero points 0, so that (q - 8) * scale is the weight.  Returns
    (fn, its output, the packed weights) or (None, the reason there is no
    such call, None): the error it raises where it refuses the shape."""
    K, N = codes.shape
    if not hasattr(torch, "_weight_int4pack_mm"):
        return None, "torch has no _weight_int4pack_mm", None
    try:
        q = (codes.t() + 8).to(torch.int32)
        wpack = torch._convert_weight_to_int4pack(
            (q[:, ::2] << 4 | q[:, 1::2]).to(torch.uint8).contiguous(), 8)
        sz = torch.zeros(-(-K // 128), N, 2, dtype=torch.bfloat16,
                         device=x.device)
        sz[..., 0] = scale.bfloat16()

        def fn(w=wpack):
            return torch._weight_int4pack_mm(x, w, 128, sz)

        out = fn()
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, (f"torch._weight_int4pack_mm refused: "
                      f"{str(e).splitlines()[0][:200]}"), None
    return fn, out, wpack


def w4mm_bounds_ms(T, K, N):
    """(bytes, operations) bounds in ms of one #11 call: x, the packed
    weights, the scales and out once each at 3.35 TB/s; 2 T K N bf16
    operations at 989 TFLOP/s."""
    nbytes = 2 * T * K + K * N // 2 + 4 * N + 2 * T * N
    return nbytes / 3.35e12 * 1e3, 2 * T * K * N / 989e12 * 1e3


def time_w4_matmul(torch, dev, gen, record, card) -> dict:
    """#11 at W4MM_CASES (module note): device time per call cold and
    warm, the bounds, the error, the plain version, tinygemm and the dense
    bf16 yardstick."""
    from lavida_mod_tpu_torch.ops import w4_matmul as t4

    out = {"calls": []}
    with torch.no_grad():
        for name, T, K, N in W4MM_CASES:
            x = torch.randn(T, K, device=dev, generator=gen).bfloat16()
            codes = torch.randint(-8, 8, (K, N), device=dev, generator=gen)
            packed = ((codes[1::2] & 0xF) << 4 | (codes[0::2] & 0xF)).to(
                torch.uint8).view(torch.int8).contiguous()
            scale = torch.rand(N, device=dev, generator=gen) * 0.01 + 0.005
            x2 = t4.split_even_odd(x)
            copies = max(3, -(-int(W4MM_COLD_BYTES) // (packed.numel() + 4 * N)))
            ws = [(packed, scale)] + [(packed.clone(), scale.clone())
                                      for _ in range(copies - 1)]
            ref = t4.w4_matmul_reference(x2, packed, scale).float()
            err = (t4.w4_matmul(x2, packed, scale).float() - ref).abs().max().item()
            shape = f"{name} [{T},{K}]x[{K},{N}]"
            times = {}
            for temp, n in (("cold", copies), ("warm", 1)):
                def call(n=n, it=iter(range(1 << 62))):
                    return t4.w4_matmul(x2, *ws[next(it) % n])

                times[temp] = three_times(call)
                record("w4_matmul", f"{shape} {temp} ({n} weight copies)", 0,
                       times[temp], None)
            times["plain_ms"] = cuda_ms(
                lambda: t4.w4_matmul_reference(x2, packed, scale), 5)
            fn, lib, wpack = int4pack_library(torch, x, codes, scale)
            lib_note = lib if fn is None else None
            if fn is not None:
                rel = ((lib.float() - ref).norm() / ref.norm()).item()
                if rel < 2e-2:    # its bf16 scale rounds: not exact
                    lcopies = [wpack] + [wpack.clone() for _ in range(copies - 1)]

                    def lcall(it=iter(range(1 << 62))):
                        return fn(lcopies[next(it) % copies])

                    times["tinygemm_cold"] = three_times(lcall)
                    times["tinygemm_warm"] = three_times(fn)
                    lib_note = f"relative err {rel:.2e}"
                    del lcopies
                else:
                    lib_note = (f"tinygemm's layout gave relative err "
                                f"{rel:.2e}")
            # the yardstick: dense bf16 weights, four times the bytes (one
            # copy already 100 MB at the decode and prefill shapes)
            wdeq = (codes.float() * scale).bfloat16()
            times["dense_bf16"] = three_times(lambda: x @ wdeq)
            bb, bo = w4mm_bounds_ms(T, K, N)
            b = max(bb, bo)
            lib_text = (f"tinygemm cold {times['tinygemm_cold']['ms']:.4f} ms, "
                        f"warm {times['tinygemm_warm']['ms']:.4f} ms "
                        f"({lib_note})" if "tinygemm_cold" in times
                        else f"tinygemm none: {lib_note}")
            print(f"[times] w4_matmul {shape}: device cold "
                  f"{times['cold']['ms']:.4f} ms, warm "
                  f"{times['warm']['ms']:.4f} ms, back to back cold "
                  f"{times['cold']['ms_back_to_back']:.4f} ms; bound "
                  f"{b:.4f} ms ({'bytes' if bb > bo else 'operations'}; "
                  f"bytes {bb:.4f}, operations {bo:.4f}; cold at "
                  f"{100 * b / times['cold']['ms']:.1f} %, warm at "
                  f"{100 * b / times['warm']['ms']:.1f} %); max err "
                  f"{err:.3e}; plain {times['plain_ms']:.4f} ms; {lib_text};"
                  f" yardstick the path never calls: dense bf16 matmul "
                  f"{times['dense_bf16']['ms']:.4f} ms ({card})")
            out["calls"].append({"name": name, "shape": [T, K, N],
                                 "copies": copies, "bound_ms": b,
                                 "bound_bytes_ms": bb, "bound_ops_ms": bo,
                                 "max_abs_err": err, "library": lib_note,
                                 **times})
            del ws, wdeq, codes, packed, lib, wpack
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
