#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (lavida_mod_tpu_torch) on one
NVIDIA GPU.  Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one printed line or more each; any failure raises, so the script
exits non-zero and never prints the final line:
  1. device: a CUDA card is required (no CPU fallback); its name and power
     limit as nvidia-smi reports them; TF32 off for matmuls and cuDNN.
  2. build: nvcc compiles the port's CUDA kernels from csrc/, one compiler
     per source, in parallel (timed); ptxas's registers and spills per
     kernel, and the register count that the setmaxnreg of
     short_attention, prefix_flash, w4_matmul_grouped's prefill kernel and
     fused_vit_mlp's GEMM needs held in every instance
     (kernels.check_registers).
  3. kernels vs their plain PyTorch versions on the card, at the main
     paths' shapes plus a ragged/odd case each: max error and time of each
     (on the device alone, and back to back as the host issues the calls)
     (short_attention, gather_rows; w8a8_matmul, w4_qkv_norm,
     w4_matmul_res, w4_ffn_fused; w4_matmul; w4_matmul_grouped,
     kv8_decode_attention, fused_vit_mlp), the time of one PyTorch call that
     computes the same function where there is one, each kernel's bound
     (the larger of its bytes over 3.35 TB/s and its operations over the
     peak for their type: 989 TFLOP/s bf16, 1,979 TOP/s int8), its share
     of the bound and its ratio to the library call.  short_attention also
     at the edges of its wgmma design (S = 1, S shorter than one stage, S a
     tile multiple + 1, hd 16 / 48 / 72 / 80 / 96 / 128, G = 1, 4 and 7, rows
     whose first K/V tiles are all masked), w8a8_matmul at T = 1, K = 16,
     K = 4304 and N = 1000 / 1001 / 1 (bit-exact), and the host time per
     call of both (their wrappers pass TMA tensor maps, cached per buffer)
     beside the library call's; then both kernels summed over one mixed
     request against SDPA and torch._int_mm + epilogue, device time and
     back to back.  w4_ffn_fused at 8 / 16 / 24 / 32 / 40 rows of the 8B
     decode shape and a padded down K, each twice with new data at the
     same addresses, and 20 calls chained back to back without a sync,
     each matched to its plain version; w4_qkv_norm at [q|k|v], the head
     at 32 and 128 rows and a ragged width, and 20 chained calls of [32,
     4096] x 4096 likewise; w4_matmul_res at [32, 4096] x 4096 and a
     narrow width, and 20 chained calls, all exact.  w4_matmul, which no path
     launches, at [32, 4096] x 12288, [1056, 4096] x 12288 and [5, 4304] x
     1000, within one bf16 ulp of its plain version, beside
     torch._weight_int4pack_mm on the same codes.  w4_matmul_grouped's two
     kernels, each bit-exact: the decode kernel (T <= 256) at 32 x B rows
     for B = 1, 2, 3, 4, 5, 7, 8 of the three LLaDA linears, the B = 8 head,
     a tiny and a Dream width; the prefill kernel (T > 256) at 4608 and
     2304 rows of the three, a ragged 1153 rows of [K 12288] x 4096 and a
     Dream width at 300 rows ([300, 18944] x 3584).  kv8_decode_attention
     within 6e-3 of its plain version at the B = 4 and B = 8 kv8 batches'
     shapes, a ragged GQA case, G = 16, S = 16384 (many key chunks),
     Dream-7B's G = 7 and a batch row with every key masked.
     fused_vit_mlp within 5e-2 of its plain version at one image (M =
     3645), 20 views (M = 14580) and a ragged M 77 / D 256 / F 520, its
     error printed beside its first design's, the port's unfused chain
     timed beside it as a yardstick, and at one image the time each of
     its three launches (LN, fc1, fc2) adds.
  4. the bf16 main path at full width: LaViDaConfig() (LLaDA-8B + SigLIP
     so400m) in bf16 with random weights made on the card from seed 0,
     three requests through LaViDa.generate_fused (gen 32, 16 steps, prefix
     cache), each checked for shape, no mask token left, and exactly 26 + 32
     short_attention launches and 1 gather_rows launch.
  5. the mixed main path (bench.py's default serving layout): the same
     model through to_serving_layout("mixed", fuse=True) on the card (int8
     prefill tree + fused int4 decode tree, the bf16 linears freed), three
     requests with the same checks and, per request, 128 w8a8_matmul,
     528 w4_qkv_norm, 512 w4_matmul_res and 512 w4_ffn_fused launches;
     request walls, phase times, peak memory, weight bytes per tree and
     the device-busy share of one profiled request, and w4_qkv_norm's,
     w4_matmul_res's and w4_ffn_fused's device time in it split by their
     two, two and four kernels (528, 512 and 512 launches of each
     asserted); one decode layer at B = 1 timed through the fused plan.
  6. output checks on a small input: a tiny model in bf16 on the card
     against the same weights in f32 on the CPU (plain path), and a tiny
     mixed-layout model on the card against the same quantized weights on
     the CPU (plain versions of the fused w4 kernels).
  7. the batched int4 main path (the serve worker's --int4 --decode-batch
     N, bench.py --batch): a new LaViDaConfig() model from seed 0 through
     to_serving_layout("int4", fuse=False), then eval.adapter.
     generate_batch on B = 4 requests of four image sizes with the int8 KV
     cache off and on, and on B = 8 requests through the chunked prefill:
     walls per batch and per image, stage walls, peak memory, launches per
     kernel asserted per batch (w4_matmul_grouped's decode and prefill
     kernels apart), the profiler's device-busy share of one
     batch; one decode layer at B = 1 timed through the unfused layout.
  8. a tiny int4 + kv8 + fused-ViT-MLP model on the card against the same
     weights on the CPU.
  9. the training attention kernels (prefix_flash_fwd, prefix_flash_dq,
     prefix_flash_dkv) against their plain versions on the card at the
     stage-1 shape (8 doubled rows x 1152 tokens, 32 heads, hd 128, prefix
     lengths near 1010, a kv_valid tail) and a ragged GQA case (28 / 4
     heads, T 200, prefix length 0 and >= T): errors, kernel (device time
     and back to back), plain and library times (SDPA forward; SDPA's
     autograd backward for dq + dkv, both also back to back) and bounds
     (4 / 6 / 8 x the visible (query, key) pairs x Hq x hd operations);
     then at the stage-1 shape the forward against SDPA's forward and dq +
     dkv against SDPA's whole backward, per launch and per step, each with
     its share of the bound and its ratio to the library call.
 10. stage-1 pretraining at full LaViDa-LLaDA-8B (LaViDaConfig(), 32 LLaDA
     and 26 SigLIP layers, random bf16 weights from seed 0 on the card):
     make_freeze_optimizer("mm_mlp_adapter", lr 1e-3, pretrain_stage1.sh's
     warmup ratio 0.03 over 100 steps), the mixed-precision step with
     whole-layer remat, ce_chunk 512 and prefix_flash attention, B = 4
     samples of one bench-shaped image, an 8-token prompt and a 40-token
     caption, T bucketed to 128 and views to 8; one warm-up step and three
     timed steps: a finite loss, the launches per step asserted (2 x 32
     prefix_flash_fwd, 32 dq, 32 dkv, 1 gather_rows, 2 x 26
     short_attention: grad_norm covers every leaf, as JAX's, so the frozen
     tower runs under autograd and its remat recomputes each layer), the
     projector and image_newline moved after the first step with a nonzero
     LR, every LLaDA and SigLIP weight bit-identical (checksums); step
     wall, data tokens per second, peak memory, the profiler's device-busy
     share of one step, device time by kernel and by kernel kind
     (lavida_mod_tpu_torch/step_times.py, which times the stage-1 step of
     any checkout the same way) and #10's device time.
 11. stage-2 finetuning at full width with the LLaDA depth cut to 4 layers
     (the only cut; SigLIP keeps 26): every part tunable, lr 2e-5, tower lr
     2e-6, grad_accum 2 (finetune_stage2.sh), B = 2, two microsteps make one
     update: every group moved after the update and not before, the
     short-attention VJP ran, nothing is NaN.
 12. a tiny LaViDa trained one stage-2 microstep on the card (bf16 compute,
     kernels) and on the CPU (plain versions) from the same f32 masters
     with the same injected mask: loss, trainable gradients and updated
     masters within stated bands.
Then the card's name and power limit, one JSON line of per-kernel results,
and as the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np

from lavida_mod_tpu_torch.kernel_times import (KV8_CASES, added_times, cuda_ms,
                                                host_us, kernel_split,
                                                kv8_case_inputs)
from lavida_mod_tpu_torch.step_times import print_by_kind

SIGLIP_LAYERS = 26   # so400m's 27 layers less the dropped last one
LLADA_LAYERS = 32
LLADA_LINEARS = 7    # q, k, v, attn_out, ff_proj, up_proj, ff_out
# fused_vit_mlp's largest error against its plain version at phase 3's
# cases (by M), as its first design (mma.sync on a cp.async ring) read it
# on an NVIDIA H100 80GB HBM3
VIT_FIRST_DESIGN_ERR = {3645: 3.125e-2, 14580: 3.125e-2, 77: 3.906e-3}
# H100 SXM published peaks (dense): HBM bytes/s, bf16 flop/s, int8 op/s
HBM_BPS, BF16_FLOPS, INT8_OPS = 3.35e12, 989e12, 1979e12


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def bound_ms(ops: float, nbytes: float, int8: bool = False):
    """(least time in ms, "bytes" or "operations") of one launch."""
    t_ops = ops / (INT8_OPS if int8 else BF16_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BPS * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes")


class Results:
    """Per-kernel sums over one main-path run's launches: the kernel's,
    the plain version's and the library call's time, and the bound."""

    def __init__(self):
        self.k = {}

    def add(self, name, shape, per, err, kernel, plain_ms, library_ms, ops,
            nbytes, int8=False, note="", weight=None, library_b2b=None):
        """`kernel` calls the kernel's wrapper: timed on the device alone
        (`ms`) and back to back as the host issues it (`ms_back_to_back`,
        the larger of the host's and the card's time per call; the library
        call's, `library_b2b`, where it is given).  `per` is
        the launches of one main-path run at this shape; the sums weigh
        the shape by `weight` (default `per`)."""
        ms, b2b = cuda_ms(kernel), cuda_ms(kernel, hold=False)
        b, by = bound_ms(ops, nbytes, int8)
        lib = "none" if library_ms is None else (
            f"{library_ms:.4f} ms (kernel {ms / library_ms:.2f}x its time)")
        print(f"[kernels] {name} {shape}: err {err:.3e}{note}, kernel "
              f"{ms:.4f} ms (back to back {b2b:.4f} ms), plain "
              f"{plain_ms:.4f} ms, library {lib}, bound {b:.4f} ms ({by}; "
              f"kernel at {100 * b / ms:.1f} % of it)")
        w = per if weight is None else weight
        r = self.k.setdefault(name, {
            "max_abs_err": 0.0, "ms": 0.0, "ms_back_to_back": 0.0,
            "plain_ms": 0.0,
            "library_ms": None if library_ms is None else 0.0,
            "bound_ms": 0.0, "bound_by": by, "per_shape": [], "_by": {}})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += w * ms
        r["ms_back_to_back"] += w * b2b
        if library_b2b is not None:
            r["library_ms_back_to_back"] = (r.get("library_ms_back_to_back", 0.0)
                                            + w * library_b2b)
        r["plain_ms"] += w * plain_ms
        if library_ms is not None and r["library_ms"] is not None:
            r["library_ms"] += w * library_ms
        r["bound_ms"] += w * b
        r["_by"][by] = r["_by"].get(by, 0.0) + w * b
        r["bound_by"] = max(r["_by"], key=r["_by"].get)
        r["per_shape"].append({"shape": shape, "per_run": per, "ms": ms,
                               "ms_back_to_back": b2b, "plain_ms": plain_ms,
                               "library_ms": library_ms,
                               "bound_ms": b, "err": err})

    def get(self, name):
        r = dict(self.k[name])
        r.pop("_by")
        return r

    def summary(self, name, what, card):
        """One line of the sums: kernel against library call and bound."""
        r = self.k[name]
        lib = r["library_ms"]
        vs = "" if not lib else f" (kernel {r['ms'] / lib:.2f}x its time)"
        if "library_ms_back_to_back" in r:
            vs += (f", back to back {r['library_ms_back_to_back']:.4f} ms "
                   f"(kernel {r['ms_back_to_back'] / r['library_ms_back_to_back']:.2f}"
                   f"x its time)")
        print(f"[kernels] {name} summed over {what}: kernel {r['ms']:.4f} "
              f"ms (back to back {r['ms_back_to_back']:.4f} ms), library "
              f"{lib if lib is None else f'{lib:.4f} ms'}{vs}, "
              f"bound {r['bound_ms']:.4f} ms (kernel at "
              f"{100 * r['bound_ms'] / r['ms']:.1f} % of it) ({card})")


def bench_request(n_text: int, image_size, rng):
    """(input_ids, views, image_size) of one request: a seeded prompt with
    the image marker after 8 text tokens (the bench.py protocol) and
    seeded preprocessed views for the image's anyres tiling."""
    from lavida_mod_tpu_torch.config import LaViDaConfig
    from lavida_mod_tpu_torch.data.anyres import anyres_grid_shape

    vcfg = LaViDaConfig().vision
    nw, nh = anyres_grid_shape(image_size, vcfg.grid_pinpoints,
                               vcfg.siglip.image_size)
    S = vcfg.siglip.image_size
    views = rng.uniform(-1, 1, (1 + nw * nh, 3, S, S)).astype(np.float32)
    text = rng.integers(3, 30000, size=n_text)
    ids = np.concatenate([text[:8], [-200], text[8:]])
    return ids, views, image_size


def phase_kernels(torch, device, res):
    """short_attention and gather_rows against their plain versions and
    the library calls at the bf16 path's shapes."""
    import torch.nn.functional as F

    from lavida_mod_tpu_torch import kernels
    from lavida_mod_tpu_torch.config import LaViDaConfig
    from lavida_mod_tpu_torch.models.multimodal import build_gather_plan
    from lavida_mod_tpu_torch.ops.gather import (gather_rows,
                                                 gather_rows_reference)
    from lavida_mod_tpu_torch.ops.short_attention import (
        short_attention, short_attention_reference)

    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device=device, generator=gen).to(
            torch.bfloat16)

    def segments(kind, B, T, S):
        """None; "valid": keys valid up to min(T, S - 3) (the prefill's
        padded tail); "pad": that, and the last 5 query rows match no key
        (a finite average over the S keys); "late": every query's first 260
        keys (two whole 128-key tiles and more) are masked, and every 5th
        query sees only those."""
        if kind is None:
            return None, None
        sq = torch.ones(B, T, dtype=torch.int32, device=device)
        if kind == "late":
            kv = torch.arange(S, device=device) >= 260
            sq[:, ::5] = 0
        else:
            kv = torch.arange(S, device=device) < min(T, S - 3)
            if kind == "pad":
                sq[:, -5:] = 2
        return sq, kv.to(torch.int32)[None].expand(B, S).contiguous()

    # (name, q shape, kv shape, segments, launches per request); after the
    # two main shapes the edges of the wgmma design: S = 1, S shorter than
    # one 128-key stage, S one past a tile multiple, hd 16 / 48 / 72 / 80 /
    # 96 / 128 (16, 80 and 96 end in a narrow box, 72 and 48 are padded in
    # shared memory), G = 1, 4 and 7, rows whose first K/V tiles are all
    # masked
    cases = [
        ("siglip", (5, 729, 16, 72), (5, 729, 16, 72), None, SIGLIP_LAYERS),
        ("prefill", (1, 1056, 32, 128), (1, 1088, 32, 128), "valid",
         LLADA_LAYERS),
        ("gqa_odd", (2, 77, 8, 128), (2, 131, 2, 128), "pad", 0),
        ("gqa_odd_hd72", (1, 65, 4, 72), (1, 63, 2, 72), "pad", 0),
        ("s1", (1, 37, 4, 64), (1, 1, 4, 64), None, 0),
        ("s1_g4", (1, 37, 4, 128), (1, 1, 1, 128), "pad", 0),
        ("short_hd16", (2, 50, 4, 16), (2, 50, 4, 16), None, 0),
        ("tile_plus1_g7_hd48", (2, 65, 14, 48), (2, 129, 2, 48), None, 0),
        ("g7_hd80", (1, 200, 7, 80), (1, 257, 1, 80), "pad", 0),
        ("g4_hd96", (2, 300, 8, 96), (2, 333, 2, 96), "pad", 0),
        ("late_g4_hd72", (1, 130, 8, 72), (1, 300, 2, 72), "late", 0),
        ("late_g1_hd128", (1, 129, 4, 128), (1, 300, 4, 128), "late", 0),
    ]
    for name, qs, ks, kind, per_request in cases:
        q, k, v = randn(*qs), randn(*ks), randn(*ks)
        sq, skv = segments(kind, qs[0], qs[1], ks[1])
        out = short_attention(q, k, v, sq, skv)
        torch.cuda.synchronize()
        ref = short_attention_reference(q, k, v, sq, skv)
        # p is rounded to bf16 per streamed tile (the plain version rounds
        # its single-pass p) and the online rescaling reorders the sums.
        # Read on an H100: 1.95e-3 - 3.9e-3 (one bf16 ulp of |o| < 1); the
        # limit is 2-3x that, plus two ulps of a large |o|
        torch.testing.assert_close(out.float(), ref.float(), atol=8e-3,
                                   rtol=8e-3)
        err = (out.float() - ref.float()).abs().max().item()
        o_abs = ref.float().abs()
        note = (f" (limit 8e-3 + 8e-3 |o|; |o| mean {o_abs.mean().item():.3f}"
                f", max {o_abs.max().item():.3f})")
        plain_ms = cuda_ms(
            lambda: short_attention_reference(q, k, v, sq, skv))
        lib_ms = lib_b2b = None
        if per_request:
            # one library call of the same function on the same inputs:
            # SDPA with the segment mask as a boolean attention mask
            mask = None if sq is None else (
                sq[:, None, :, None] == skv[:, None, None, :])
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)

            lib_ms = cuda_ms(sdpa)
            # the wrapper passes three to six TMA tensor maps per call
            host = host_us(lambda: short_attention(q, k, v, sq, skv))
            lib_b2b = cuda_ms(sdpa, hold=False)
            note += (f"; host per call {host:.1f} us, SDPA's "
                     f"{host_us(sdpa):.1f} us; SDPA back to back "
                     f"{lib_b2b:.4f} ms")
        B, T, H, hd = qs
        keys = ks[1] if skv is None else int(skv[0].sum())
        res.add("short_attention", f"{name} q{qs} kv{ks}", per_request, err,
                lambda: short_attention(q, k, v, sq, skv), plain_ms, lib_ms,
                4 * B * H * T * keys * hd,
                2 * (q.numel() + k.numel() + v.numel() + q.numel()),
                note=note, library_b2b=lib_b2b)

    ids, views, size = bench_request(48, (640, 640),
                                     np.random.default_rng(0))
    idx, text_ids, _, _ = build_gather_plan(LaViDaConfig(), [ids],
                                            [[views.shape[0]]], [[size]])
    # the splice table: 980 vision tokens, newline, text slots, zero row
    table = randn(views.shape[0] * 196 + 1 + text_ids.shape[1] + 1, 4096)
    out = gather_rows(table, idx[0])
    torch.cuda.synchronize()
    ref = gather_rows_reference(table, torch.as_tensor(idx[0], device=device))
    if not torch.equal(out, ref):
        raise AssertionError("gather_rows differs from table[idx]")
    odd = randn(50, 13)                   # 26-byte rows: the narrow path
    odd_idx = np.arange(49, -1, -3)
    if not torch.equal(gather_rows(odd, odd_idx),
                       odd[torch.as_tensor(odd_idx, device=device)]):
        raise AssertionError("gather_rows differs on 13-wide bf16 rows")
    # both timed from the host plan: range check / upload included
    g_plain = cuda_ms(lambda: gather_rows_reference(
        table, torch.as_tensor(idx[0]).to(device)))
    # the kernel alone, and the library call, on an index on the card
    idx_dev = torch.as_tensor(idx[0], device=device)
    out = torch.empty_like(ref)
    lib = kernels.library()
    stream = torch.cuda.current_stream(device).cuda_stream
    g_kernel = cuda_ms(lambda: kernels.check(lib.lavida_gather_rows(
        table.data_ptr(), idx_dev.data_ptr(), 8, out.data_ptr(),
        idx.shape[1], table.shape[1] * 2, stream), "gather_rows"))
    g_lib = cuda_ms(lambda: torch.index_select(table, 0, idx_dev))
    T = idx.shape[1]
    res.add("gather_rows", f"splice table{tuple(table.shape)} idx[{T}]", 1,
            0.0, lambda: gather_rows(table, idx[0]), g_plain, g_lib, 0, 2 * T * 4096 * 2 + 8 * T,
            note=f" (exact; kernel alone {g_kernel:.4f} ms)")


def bench_requests(rng):
    """The three bench-protocol requests of the main paths."""
    first = bench_request(48, (640, 640), rng)
    return [first, bench_request(48, (1100, 380), rng),
            (np.concatenate([first[0][:9], first[0][9:30]]), first[1],
             first[2])]


GEN = dict(max_new_tokens=32, block_length=32, step_per_block=16,
           prefix_lm=True, remasking="low_confidence")
STEPS = GEN["step_per_block"]


def phase_main_path(torch, device, card):
    """Three full-width requests through generate_fused, bf16 layout."""
    from lavida_mod_tpu_torch.config import GenerationConfig, LaViDaConfig
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.models.multimodal import build_gather_plan
    from lavida_mod_tpu_torch.ops.gather import gather_rows
    from lavida_mod_tpu_torch.ops.short_attention import short_attention

    cfg = LaViDaConfig()
    t0 = time.perf_counter()
    model = LaViDa.random_init(cfg, 0, torch.bfloat16, device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[main] LaViDaConfig() bf16 random init on {card}: "
          f"{n_params / 1e9:.3f} B params in "
          f"{time.perf_counter() - t0:.2f} s")
    gen = GenerationConfig(**GEN)
    requests = bench_requests(np.random.default_rng(0))
    first = requests[0]
    model.generate_fused(first[0], [first[1]], [first[2]], gen)  # warm-up
    torch.cuda.synchronize()

    short_attention.launches = 0
    gather_rows.launches = 0
    walls = []
    for i, (ids, views, size) in enumerate(requests):
        a0, g0 = short_attention.launches, gather_rows.launches
        idx, _, _, _ = build_gather_plan(cfg, [ids], [[views.shape[0]]],
                                         [[size]])
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.generate_fused(ids, [views], [size], gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        walls.append(wall)
        peak = torch.cuda.max_memory_allocated() / 2**30
        da = short_attention.launches - a0
        dg = gather_rows.launches - g0
        print(f"[main] request {i}: image {size} -> {views.shape[0]} views, "
              f"{len(ids) - 1} text tokens, P={idx.shape[1]}, G=32: "
              f"wall {wall * 1e3:.1f} ms, peak {peak:.2f} GiB, "
              f"launches short_attention {da} gather_rows {dg} "
              f"({card}); tokens {out.tolist()}")
        if out.shape != (32,):
            raise AssertionError(f"output shape {out.shape}")
        if (out == cfg.llada.mask_token_id).any():
            raise AssertionError("mask tokens left in the output")
        if da != SIGLIP_LAYERS + LLADA_LAYERS or dg != 1:
            raise AssertionError(f"launches short_attention {da} "
                                 f"gather_rows {dg}, want 58 and 1")
    counts = {"short_attention": short_attention.launches,
              "gather_rows": gather_rows.launches}
    return model, requests, counts, walls


def phase_small_reference(torch, device):
    """A tiny model in bf16 on the card against the same weights in f32 on
    the CPU, which runs the plain versions the CPU tests hold to the JAX
    package."""
    from lavida_mod_tpu_torch.config import GenerationConfig
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.models.multimodal import (build_gather_plan,
                                                        multimodal_embeds)
    from lavida_mod_tpu_torch.predict import tiny_config

    cfg = tiny_config()
    cpu = LaViDa.random_init(cfg, 0, torch.float32, "cpu")
    with torch.no_grad():
        for p in cpu.parameters():       # diverse tokens, as in the tests
            if p.dim() >= 2:
                p.mul_(10.0)
    gpu = LaViDa(cfg, device=device, dtype=torch.bfloat16)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(3)
    views = rng.standard_normal((5, 3, 56, 56)).astype(np.float32)
    ids = np.array([5, 6, -200, 7, 8, 9])
    idx, text_ids, _, _ = build_gather_plan(cfg, [ids], [[5]], [[(100, 60)]])
    with torch.no_grad():
        outs = []
        for m in (cpu, gpu):
            pix = torch.as_tensor(views, device=m.device)
            prefix = multimodal_embeds(m, pix, text_ids, idx)
            logits, _ = m.llada(prefix, use_flash=True)
            outs.append(logits.float().cpu())
    rel = ((outs[1] - outs[0]).abs().max() / outs[0].abs().max()).item()
    gen = GenerationConfig(max_new_tokens=16, block_length=8)
    a = cpu.generate_fused(ids, [views], [(100, 60)], gen)
    b = gpu.generate_fused(ids, [views], [(100, 60)], gen)
    agree = float((a == b).mean())
    print(f"[check] tiny model, bf16 on the card vs f32 on the CPU: "
          f"prefix-forward logits max|diff|/max|ref| {rel:.3e} (limit "
          f"5e-2), generated tokens agree {agree:.2f}")
    if not np.isfinite(rel) or rel > 5e-2:
        raise AssertionError(f"tiny-model logits differ: {rel}")


def _w4_weights(torch, tq, randn, K, N):
    packed, scales, _ = tq.quantize_linear4(randn(N, K, scale=0.02))
    return packed[:N // 8].contiguous(), scales[:, :N].contiguous()


def _w4_bytes(K, N):
    """Bytes of a grouped int4 weight: codes and f32 group scales."""
    return K * N // 2 + (K // 128) * N * 4


def _rel(out, ref):
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def phase_quant_kernels(torch, device, res):
    """The four kernels of the mixed layout against their plain versions
    at every shape of its main path (summed over one request's launches),
    plus a ragged/odd case each; w4_qkv_norm also at the batched path's
    fused head ([128, 4096] x 126464, once per decode step)."""
    from lavida_mod_tpu_torch.ops import quant as tq
    from lavida_mod_tpu_torch.ops import w4_fused as tw
    from lavida_mod_tpu_torch.ops import w8a8 as t8

    gen = torch.Generator(device=device).manual_seed(1)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=device, generator=gen) * scale

    # w8a8: the prefill's four linears at T = 1056, 32 layers; bit-exact;
    # then the wgmma tiles' edges: one row, one 16-byte K slice, ragged K
    # (4304 = 33 slices + 80 bytes), ragged and odd N
    for T, K, N, per in [(1056, 4096, 12288, LLADA_LAYERS),
                         (1056, 4096, 4096, LLADA_LAYERS),
                         (1056, 4096, 24576, LLADA_LAYERS),
                         (1056, 12288, 4096, LLADA_LAYERS),
                         (77, 4304, 1000, 0), (1, 4096, 4096, 0),
                         (7, 16, 24, 0), (33, 4304, 1001, 0), (1, 16, 1, 0)]:
        x = randn(T, K).bfloat16()
        q, sc = tq.quantize_linear(randn(N, K, scale=0.02))
        x8, sx = t8.act_quant(x, t8.ACT_FORMULA_W8)
        out = t8.w8a8_matmul(x8, sx, q, sc)
        torch.cuda.synchronize()
        ref = t8.w8a8_matmul_reference(x8, sx, q, sc)
        if not torch.equal(out, ref):
            raise AssertionError(f"w8a8_matmul differs at {(T, K, N)}")
        lib_ms, lib_b2b, note = None, None, " (exact)"
        if per:
            # the int8 product in one library call (cuBLASLt through
            # torch._int_mm), then the f32 scale epilogue as a second op
            qt = q.t()
            try:
                torch._int_mm(x8, qt)
            except RuntimeError:      # a build that takes row-major only
                qt = qt.contiguous()

            def library():
                return (torch._int_mm(x8, qt).float() * sx * sc).bfloat16()

            lib_ms = cuda_ms(library)
            # the wrapper passes two TMA tensor maps per call
            host = host_us(lambda: t8.w8a8_matmul(x8, sx, q, sc))
            lib_b2b = cuda_ms(library, hold=False)
            note += (f"; host per call {host:.1f} us, the library's "
                     f"{host_us(library):.1f} us; library back to back "
                     f"{lib_b2b:.4f} ms")
        res.add("w8a8_matmul", f"[{T},{K}]x[{K},{N}]", per, 0.0,
                lambda: t8.w8a8_matmul(x8, sx, q, sc),
                cuda_ms(lambda: t8.w8a8_matmul_reference(x8, sx, q, sc), 5),
                lib_ms, 2 * T * K * N, T * K + N * K + 4 * (T + N) + 2 * T * N,
                int8=True, note=note, library_b2b=lib_b2b)

    # w4_qkv_norm: [q|k|v] per layer per step and the head per step
    # (mixed path, 32 rows), the batched path's fused head (128 rows)
    for T, D, N, per in [(32, 4096, 12288, LLADA_LAYERS * STEPS),
                         (32, 4096, 126464, STEPS),
                         (128, 4096, 126464, 0), (40, 384, 160, 0)]:
        x = randn(T, D).bfloat16()
        nw = (1 + randn(D, scale=0.1)).bfloat16()
        packed, scales = _w4_weights(torch, tq, randn, D, N)
        out = tw.w4_qkv_norm(x, nw, packed, scales, 1e-5)
        torch.cuda.synchronize()
        ref = tw.w4_qkv_norm_reference(x, nw, packed, scales, 1e-5)
        err = _rel(out, ref)
        # the norm's sum of squares reduces in another order: an int8
        # code on a rounding boundary may move by one
        if not err < 1e-2:
            raise AssertionError(f"w4_qkv_norm {(T, D, N)}: {err}")
        res.add("w4_qkv_norm", f"[{T},{D}]x[{D},{N}]", per, err,
                lambda: tw.w4_qkv_norm(x, nw, packed, scales, 1e-5),
                cuda_ms(lambda: tw.w4_qkv_norm_reference(
                    x, nw, packed, scales, 1e-5), 3), None, 2 * T * D * N,
                2 * T * D + 2 * D + _w4_bytes(D, N) + 2 * T * N, int8=True,
                note=" (relative, limit 1e-2)")
    # 20 calls back to back, each on the output of the one before ([32,
    # 4096] x 4096), no sync between them: each matched to its plain version
    nw = (1 + randn(4096, scale=0.1)).bfloat16()
    w = _w4_weights(torch, tq, randn, 4096, 4096)
    chain = [randn(32, 4096).bfloat16()]
    for _ in range(20):
        chain.append(tw.w4_qkv_norm(chain[-1], nw, *w, 1e-5))
    torch.cuda.synchronize()
    err = max(_rel(out, tw.w4_qkv_norm_reference(x, nw, *w, 1e-5))
              for x, out in zip(chain[:-1], chain[1:]))
    if not err < 1e-2:
        raise AssertionError(f"w4_qkv_norm back to back: {err}")
    print(f"[kernels] w4_qkv_norm 20 chained calls without a sync: max "
          f"err {err:.3e} (relative, limit 1e-2)")

    for T, K, N, per in [(32, 4096, 4096, LLADA_LAYERS * STEPS),
                         (5, 384, 96, 0)]:
        a, r = randn(T, K).bfloat16(), randn(T, N).bfloat16()
        packed, scales = _w4_weights(torch, tq, randn, K, N)
        out = tw.w4_matmul_res(a, r, packed, scales)
        torch.cuda.synchronize()
        ref = tw.w4_matmul_res_reference(a, r, packed, scales)
        if not torch.equal(out, ref):
            raise AssertionError(f"w4_matmul_res differs at {(T, K, N)}")
        res.add("w4_matmul_res", f"[{T},{K}]x[{K},{N}]", per, 0.0,
                lambda: tw.w4_matmul_res(a, r, packed, scales),
                cuda_ms(lambda: tw.w4_matmul_res_reference(
                    a, r, packed, scales), 5), None, 2 * T * K * N,
                2 * T * K + _w4_bytes(K, N) + 4 * T * N, int8=True,
                note=" (exact)")
    # 20 calls back to back, each output the next one's `a` ([32, 4096] x
    # 4096), no sync between them: each equal to its plain version
    w = _w4_weights(torch, tq, randn, 4096, 4096)
    r = randn(32, 4096).bfloat16()
    chain = [randn(32, 4096).bfloat16()]
    for _ in range(20):
        chain.append(tw.w4_matmul_res(chain[-1], r, *w))
    torch.cuda.synchronize()
    if not all(torch.equal(out, tw.w4_matmul_res_reference(a, r, *w))
               for a, out in zip(chain[:-1], chain[1:])):
        raise AssertionError("w4_matmul_res back to back differs")
    print("[kernels] w4_matmul_res 20 chained calls without a sync: exact")

    # w4_ffn_fused: the decode FFN at 8 / 16 / 24 / 32 rows (32 on the
    # main path, once per layer per step), 40 (two 32-row slices) and a
    # padded down K; each case twice with new data at the same addresses
    weights = {}
    for T, D, H, Hd, per in [(8, 4096, 12288, 12288, 0),
                             (16, 4096, 12288, 12288, 0),
                             (24, 4096, 12288, 12288, 0),
                             (32, 4096, 12288, 12288, LLADA_LAYERS * STEPS),
                             (40, 4096, 12288, 12288, 0),
                             (24, 256, 384, 512, 0)]:
        if (D, H, Hd) not in weights:
            up_p, up_s = _w4_weights(torch, tq, randn, D, 2 * H)
            dn_p, dn_s, _ = tq.quantize_linear4(torch.nn.functional.pad(
                randn(D, H, scale=0.02), (0, Hd - H)))
            weights[D, H, Hd] = ((1 + randn(D, scale=0.1)).bfloat16(),
                                 up_p, up_s, dn_p[:D // 8].contiguous(),
                                 dn_s[:, :D].contiguous())
        x = torch.empty(T, D, dtype=torch.bfloat16, device=device)
        args = (x, *weights[D, H, Hd], 1e-5)
        err = 0.0
        for _ in range(2):
            x.copy_(randn(T, D))
            out = tw.w4_ffn_fused(*args)
            torch.cuda.synchronize()
            err = max(err, _rel(out, tw.w4_ffn_fused_reference(*args)))
            if not err < 2e-2:
                raise AssertionError(f"w4_ffn_fused {(T, D, H, Hd)}: {err}")
        res.add("w4_ffn_fused", f"[{T},{D}] H {H} Hd {Hd}", per, err,
                lambda: tw.w4_ffn_fused(*args),
                cuda_ms(lambda: tw.w4_ffn_fused_reference(*args), 5), None,
                2 * T * D * 2 * H + 2 * T * Hd * D,
                4 * T * D + 2 * D + _w4_bytes(D, 2 * H) + _w4_bytes(Hd, D),
                int8=True, note=" (relative, limit 2e-2)")
    # 20 calls back to back, each on the output of the one before, no sync
    # between them: each matched to its plain version afterwards
    chain = [randn(32, 4096).bfloat16()]
    for _ in range(20):
        chain.append(tw.w4_ffn_fused(chain[-1], *weights[4096, 12288, 12288],
                                     1e-5))
    torch.cuda.synchronize()
    err = max(_rel(out, tw.w4_ffn_fused_reference(
        x, *weights[4096, 12288, 12288], 1e-5))
        for x, out in zip(chain[:-1], chain[1:]))
    if not err < 2e-2:
        raise AssertionError(f"w4_ffn_fused back to back: {err}")
    print(f"[kernels] w4_ffn_fused 20 chained calls without a sync: max "
          f"err {err:.3e} (relative, limit 2e-2)")


def _int4pack_library(torch, x, codes, scale):
    """torch._weight_int4pack_mm (tinygemm) on the same codes and per-
    channel scale: q = code + 8, the scale repeated over 128-row groups in
    bf16, zero points 0, so that (q - 8) * scale is the weight.  Returns
    (fn, its output) or (None, the reason there is no such call)."""
    K, N = codes.shape
    if not hasattr(torch, "_weight_int4pack_mm") or K % 128:
        return None, "no torch._weight_int4pack_mm for this shape"
    q = (codes.t() + 8).to(torch.int32)
    try:
        wpack = torch._convert_weight_to_int4pack(
            (q[:, ::2] << 4 | q[:, 1::2]).to(torch.uint8).contiguous(), 8)
        sz = torch.zeros(K // 128, N, 2, dtype=torch.bfloat16,
                         device=x.device)
        sz[..., 0] = scale.bfloat16()

        def fn():
            return torch._weight_int4pack_mm(x, wpack, 128, sz)

        out = fn()
    except RuntimeError as e:
        return None, (f"torch._weight_int4pack_mm refused: "
                      f"{str(e).splitlines()[0][:200]}")
    return fn, out


def phase_w4_matmul(torch, device, res):
    """Kernel #11 against its plain version at the TPU status note's decode
    shape, the prefill's rows and a ragged case.  No path launches it, so
    its sums are one call at each of the first two shapes."""
    from lavida_mod_tpu_torch.ops import w4_matmul as t4

    gen = torch.Generator(device=device).manual_seed(3)
    for T, K, N, weight in [(32, 4096, 12288, 1), (1056, 4096, 12288, 1),
                            (5, 4304, 1000, 0)]:
        x = torch.randn(T, K, device=device, generator=gen).bfloat16()
        codes = torch.randint(-8, 8, (K, N), device=device, generator=gen)
        packed = ((codes[1::2] & 0xF) << 4 | (codes[0::2] & 0xF)).to(
            torch.uint8).view(torch.int8).contiguous()
        scale = torch.rand(N, device=device, generator=gen) * 0.01 + 0.005
        x2 = t4.split_even_odd(x)
        out = t4.w4_matmul(x2, packed, scale)
        torch.cuda.synchronize()
        ref = t4.w4_matmul_reference(x2, packed, scale)
        # one bf16 ulp of the larger side, plus the bound on two f32 orders
        # of the same dot (2 K 2^-24 sum|x w| scale) for near-cancelling
        # outputs: the kernel sums the lo and hi products in one accumulator
        lo, hi = t4.unpack_nibbles(packed)
        sabs = (x2[0].float().abs() @ lo.abs().float()
                + x2[1].float().abs() @ hi.abs().float()) * scale
        big = torch.maximum(out.float().abs(), ref.float().abs())
        ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big)[1] - 8)
        diff = (out.float() - ref.float()).abs()
        if (diff > ulp + 2 * K * 2.0 ** -24 * sabs).any():
            raise AssertionError(f"w4_matmul beyond 1 bf16 ulp at {(T, K, N)}")
        del lo, hi, sabs
        lib_ms, note = None, " (within 1 bf16 ulp)"
        if weight:
            fn, got = _int4pack_library(torch, x, codes, scale)
            if fn is None:
                note += f"; library none: {got}"
            else:
                lib_err = _rel(got, ref)
                if lib_err < 2e-2:   # its bf16 scale rounds: not exact
                    lib_ms = cuda_ms(fn)
                    note += f"; library relative err {lib_err:.2e}"
                else:
                    note += (f"; library none: tinygemm's layout gave "
                             f"relative err {lib_err:.2e}")
        res.add("w4_matmul", f"[{T},{K}]x[{K},{N}]", 0, diff.max().item(),
                lambda: t4.w4_matmul(x2, packed, scale),
                cuda_ms(lambda: t4.w4_matmul_reference(x2, packed, scale), 5),
                lib_ms, 2 * T * K * N, 2 * T * K + K * N // 2 + 4 * N + 2 * T * N,
                note=note, weight=weight)
        del codes


def phase_batch_kernels(torch, device, res):
    """The three kernels of the batched int4 path against their plain
    versions at its shapes (summed over one B = 4 batch's launches; the
    B = 8 shapes and a ragged case checked too)."""
    from lavida_mod_tpu_torch.ops import kv8_attention as tk
    from lavida_mod_tpu_torch.ops import quant as tq
    from lavida_mod_tpu_torch.ops import vit_mlp as tv
    from lavida_mod_tpu_torch.ops import w4_grouped as tg

    gen = torch.Generator(device=device).manual_seed(2)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=device, generator=gen) * scale

    # w4_matmul_grouped at B = 4: the prefill (T = 4 x 1152 rows, the
    # bench image's bucket) and the decode steps (T = 4 x 32); at B = 8 the
    # chunk-2 prefill (2304 rows), the decode (256) and its unfused head;
    # the decode kernel also at every other multiple of 32 rows it serves
    # (B = 1, 2, 3, 5, 7), a tiny width (3 k-blocks of 2 groups) and a Dream
    # width (K = 18944: 37 k-blocks of 4 groups, the codes without the K
    # pad); the prefill kernel also at a ragged 1153 rows of the down
    # projection and at the Dream width (300 rows).  Summed per regime:
    # T <= 256 rows the decode kernel, more the prefill kernel.
    lin = [(4096, 4096, 4), (4096, 12288, 2), (12288, 4096, 1)]
    cases = [(T, K, N, per * (1 if T > 256 else STEPS))
             for T in (4608, 128) for K, N, per in lin]
    cases += [(T, K, N, 0) for T in (2304, 256, 32, 64, 96, 160, 224)
              for K, N, _ in lin]
    cases += [(256, 4096, 126464, 0), (77, 768, 576, 0), (64, 18944, 3584, 0),
              (1153, 12288, 4096, 0), (300, 18944, 3584, 0)]
    weights = {}
    for T, K, N, per in cases:
        if (K, N) not in weights:
            if K % 4096 and K > 8192:     # no K pad: codes drawn directly
                codes = torch.randint(-8, 8, (K, N), device=device,
                                      generator=gen, dtype=torch.int8)
                weights[(K, N)] = (tq.pack_w4_frag(codes), torch.rand(
                    K // 128, N, device=device, generator=gen) * 0.01 + 1e-4)
            else:
                weights[(K, N)] = _w4_weights(torch, tq, randn, K, N)
        packed, scales = weights[(K, N)]
        x = randn(T, K).bfloat16()
        regime = tg.regime(T)
        before = getattr(tg.w4_matmul_grouped, f"{regime}_launches")
        out = tg.w4_matmul_grouped(x, packed, scales)
        torch.cuda.synchronize()
        if getattr(tg.w4_matmul_grouped, f"{regime}_launches") != before + 1:
            raise AssertionError(f"w4_matmul_grouped at {T} rows did not "
                                 f"take the {regime} kernel")
        ref = tg.w4_matmul_grouped_reference(x, packed, scales)
        if not torch.equal(out, ref):
            raise AssertionError(f"w4_matmul_grouped differs at {(T, K, N)}")
        res.add(f"w4_matmul_grouped_{regime}", f"[{T},{K}]x[{K},{N}]",
                per * LLADA_LAYERS,
                0.0, lambda: tg.w4_matmul_grouped(x, packed, scales),
                cuda_ms(lambda: tg.w4_matmul_grouped_reference(
                    x, packed, scales), 2 if T > 1000 else 3), None,
                2 * T * K * N, 2 * T * K + _w4_bytes(K, N) + 2 * T * N,
                int8=True, note=" (exact)")
    del weights

    # kv8_decode_attention: q [B, 32, 32, 128] over S = 1152 + 32 keys,
    # each batch row front-padded by its own amount; GQA and ragged cases,
    # a long cache (many key chunks), Dream-7B's GQA (28 / 4 heads: row
    # blocks and chunks) and a batch row with every key masked (-1: it
    # averages over all S, as the TPU kernel's row does); KV8_CASES
    for (B, T, H, Hkv, hd, S, pad0), per in zip(KV8_CASES,
                                                (1, 0, 0, 0, 0, 0, 0)):
        q, k8, ks, v8, vs, valid = kv8_case_inputs(torch, randn, B, T, H,
                                                   Hkv, hd, S, pad0)
        out = tk.kv8_decode_attention(q, k8, ks, v8, vs, valid)
        torch.cuda.synchronize()
        ref = tk.kv8_decode_attention_reference(q, k8, ks, v8, vs, valid)
        torch.testing.assert_close(out.float(), ref.float(), atol=6e-3,
                                   rtol=6e-3)
        err = (out.float() - ref.float()).abs().max().item()
        keys = int(valid.sum())
        res.add("kv8_decode_attention", f"q[{B},{T},{H},{hd}] Hkv {Hkv} S {S}"
                + ("" if pad0 is None else f" row 0 masked {pad0}"),
                per * LLADA_LAYERS * STEPS, err,
                lambda: tk.kv8_decode_attention(q, k8, ks, v8, vs, valid),
                cuda_ms(lambda: tk.kv8_decode_attention_reference(
                    q, k8, ks, v8, vs, valid), 5 if S < 8192 else 2), None,
                4 * H * T * keys * hd,
                2 * B * Hkv * S * (hd + 4) + 4 * q.numel() + B * S,
                note=" (limit 6e-3)")

    # fused_vit_mlp: one image (5 views x 729 tokens) per call in the
    # adapter path, 26 layers x 4 images per batch; 20 views at once is
    # bench's batched encode; a ragged case.  Beside each: its error next to
    # the first (mma.sync) design's on the same inputs, and the port's
    # unfused chain as a yardstick that the path never calls; at one image
    # the time each of the three launches adds
    import torch.nn.functional as tF
    from lavida_mod_tpu_torch.ops.activations import gelu_tanh
    from lavida_mod_tpu_torch.ops.norms import layer_norm

    D, F = 1152, 4304
    w = [randn(F, D, scale=0.03).bfloat16(), randn(F, scale=0.1).bfloat16(),
         randn(D, F, scale=0.03).bfloat16(), randn(D, scale=0.1).bfloat16()]
    for M, per in [(3645, 4 * SIGLIP_LAYERS), (14580, 0), (77, 0)]:
        x = randn(M, D).bfloat16()
        ln = ((1 + randn(D, scale=0.1)).bfloat16(),
              randn(D, scale=0.1).bfloat16())
        Dm, Fm = (256, 520) if M == 77 else (D, F)
        if M == 77:
            x = x[:, :Dm].contiguous()
            args = (x, ln[0][:Dm], ln[1][:Dm], w[0][:Fm, :Dm].contiguous(),
                    w[1][:Fm], w[2][:Dm, :Fm].contiguous(), w[3][:Dm])
        else:
            args = (x, *ln, *w)
        out = tv.fused_vit_mlp(*args)
        torch.cuda.synchronize()
        ref = tv.fused_vit_mlp_reference(*args)
        torch.testing.assert_close(out.float(), ref.float(), atol=5e-2,
                                   rtol=5e-2)
        err = (out.float() - ref.float()).abs().max().item()
        res.add("fused_vit_mlp", f"M {M} D {Dm} F {Fm}", per, err,
                lambda: tv.fused_vit_mlp(*args),
                cuda_ms(lambda: tv.fused_vit_mlp_reference(*args), 3), None,
                4 * M * Dm * Fm, 4 * M * Dm + 4 * Dm * Fm + 2 * (Fm + 3 * Dm),
                note=" (limit 5e-2)")
        xa, g, b, w1, b1, w2, b2 = args
        chain_ms = cuda_ms(lambda: xa + tF.linear(gelu_tanh(tF.linear(
            layer_norm(xa, g, b, 1e-6), w1, b1)), w2, b2))
        print(f"[kernels] fused_vit_mlp M {M} D {Dm} F {Fm}: max error "
              f"{err:.3e} against the plain version, the first (mma.sync) "
              f"design's {VIT_FIRST_DESIGN_ERR[M]:.3e} on these inputs; "
              f"yardstick, never called by the path: the unfused chain "
              f"(cuBLAS GEMMs, eager elementwise) {chain_ms:.4f} ms")
        if per:
            for name, (added, ms) in sorted(
                    kernel_split(torch, lambda: tv.fused_vit_mlp(*args)).items(),
                    key=lambda kv: -kv[1][0]):
                print(f"[kernels] fused_vit_mlp M {M} split by launch: adds "
                      f"{added:.4f} ms, runs {ms:.4f} ms  {name[:90]}")


def _tree_bytes(modules) -> int:
    seen, n = set(), 0
    for m in modules:
        for t in list(m.parameters()) + list(m.buffers()):
            if t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                n += t.numel() * t.element_size()
    return n


def _phase_times(torch, model, request, gen):
    """(vision + splice, prefill, [decode step]) of one request in ms, host
    clock with a sync after each phase."""
    from lavida_mod_tpu_torch.generation.diffusion import (
        build_control_table, denoise_cached)
    from lavida_mod_tpu_torch.models import multimodal

    ids, views, size = request
    cfg, device = model.cfg, model.device
    G, mask_id = gen.max_new_tokens, cfg.llada.mask_token_id
    k_table, block_end = build_control_table(
        np.full((1, G), mask_id, np.int64), 0, G, gen, mask_id)
    k_table = torch.as_tensor(k_table, device=device)
    block_end = torch.as_tensor(block_end, device=device)
    times = []
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx, text_ids, _, _ = multimodal.build_gather_plan(
            cfg, [ids], [[views.shape[0]]], [[size]])
        prefix = multimodal.multimodal_embeds(
            model, torch.as_tensor(views, device=device), text_ids, idx)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        P, lc = prefix.shape[1], cfg.llada
        shape = (1, P + G, lc.effective_n_kv_heads, lc.head_dim)
        cache = [(prefix.new_zeros(shape), prefix.new_zeros(shape))
                 for _ in model.llada.blocks]
        model.llada(prefix, kv_cache=cache, kv_write_index=0,
                    use_cache=True, return_logits=False, use_flash=True,
                    act_int8=model.mixed)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        x = torch.full((1, G), mask_id, dtype=torch.long, device=device)
        gen_rng = torch.Generator(device=device).manual_seed(0)
        steps = []
        for i in range(k_table.shape[0]):
            t0 = time.perf_counter()
            x = denoise_cached(model.llada, x, cache, k_table[i:i + 1],
                               block_end[i:i + 1], None, gen_rng,
                               gen.temperature, gen.remasking)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
    return [t * 1e3 for t in times], [t * 1e3 for t in steps]


def _profile_busy(torch, run):
    """Device time of run() from torch.profiler and its wall: (busy ms,
    wall ms, top kernels, every kernel as (name, ms, count), every kernel's
    added time as kernel_times.added_times gives it) or None when the
    trace shows no device time.  Busy is the union of the kernels'
    intervals: kernels launched with programmatic dependent launch
    overlap the one before them."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    added = added_times(torch, prof)
    busy = sum(r[0] for r in added.values())
    if busy <= 0:
        return None
    rows.sort(key=lambda r: -r[1])
    return busy, wall, rows[:12], rows, added


def _print_profile(tag, prof, what, card):
    if prof is None:
        print(f"[{tag}] torch.profiler: no device time in the trace; "
              f"device-busy share not measured")
        return None
    busy, wall, top = prof[:3]
    print(f"[{tag}] torch.profiler over {what}: device busy {busy:.1f} ms "
          f"of a {wall:.1f} ms wall ({100 * busy / wall:.1f} %, profiler "
          f"on) ({card})")
    for key, ms, n in top:
        print(f"[{tag}]   {ms:9.3f} ms  {n:6d} x  {key[:90]}")
    return busy / wall


def _decode_layer_ms(torch, llada, P: int = 1088):
    """One decode layer at B = 1 (32 rows over a [1, P + 32] bf16 cache),
    block 0's forward as the decode loop calls it: (CUDA-event time per
    call over back-to-back calls, which the host's enqueue sets when it is
    slower than the card; device time per call, the profiler's sum over
    the kernels of 20 calls; launches per call)."""
    from lavida_mod_tpu_torch.ops.attention import make_bias

    cfg, device = llada.cfg, llada.wte.weight.device
    G, S = 32, P + 32
    gen = torch.Generator(device=device).manual_seed(5)
    x = torch.randn(1, G, cfg.d_model, generator=gen,
                    device=device).bfloat16()
    shape = (1, S, cfg.effective_n_kv_heads, cfg.head_dim)
    past = (torch.randn(*shape, generator=gen, device=device).bfloat16(),
            torch.randn(*shape, generator=gen, device=device).bfloat16())
    sin, cos = llada._rope_tables(max(cfg.max_sequence_length, S), device)
    positions = torch.arange(P, S, device=device)
    bias = make_bias(kv_valid=torch.ones(1, S, dtype=torch.bool,
                                         device=device))
    block = llada.blocks[0]

    def run():
        block(x, sin=sin, cos=cos, positions=positions, bias=bias,
              layer_past=past, kv_write_index=P, use_flash=False, q_seg=None,
              kv_seg=None)

    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        event_ms = cuda_ms(run, hold=False)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                run()
            torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3 / 20
    launches = sum(e.count for e in rows) / 20
    return event_ms, device_ms, launches


# the kernels of w4_qkv_norm, w4_matmul_res and w4_ffn_fused
# (csrc/w4_fused.cu), one launch each per call of 32 rows
SPLIT_KERNELS = {"w4_qkv_norm": ("qkv_norm_kernel", "qkv_kernel"),
                 "w4_matmul_res": ("res_quant_kernel", "res_kernel"),
                 "w4_ffn_fused": ("ffn_norm_kernel", "ffn_up_kernel",
                                  "ffn_quant_kernel", "ffn_down_kernel")}


def phase_mixed_path(torch, model, requests, card):
    """The bf16 model of phase 4 through to_serving_layout("mixed", fuse=
    True) on the card, then three requests through generate_fused."""
    from lavida_mod_tpu_torch.config import GenerationConfig
    from lavida_mod_tpu_torch.models.multimodal import build_gather_plan
    from lavida_mod_tpu_torch.ops import w4_fused as tw
    from lavida_mod_tpu_torch.ops import w8a8 as t8
    from lavida_mod_tpu_torch.ops.gather import gather_rows
    from lavida_mod_tpu_torch.ops.short_attention import short_attention

    bf16_bytes = _tree_bytes([model.llada])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.to_serving_layout("mixed", fuse=True)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    llada = model.llada
    prefill_bytes = _tree_bytes([b.prefill for b in llada.blocks])
    decode_bytes = _tree_bytes([getattr(b, n) for b in llada.blocks
                                for n in b.linear_names] + [llada.ff_out])
    shared_bytes = _tree_bytes([llada.wte, llada.ln_f] + [
        m for b in llada.blocks for m in (b.attn_norm, b.ff_norm)])
    print(f"[mixed] to_serving_layout('mixed', fuse=True) on the card in "
          f"{quant_s:.2f} s (peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB); LM weights: bf16 {bf16_bytes / 1e9:.3f} GB -> int8 prefill "
          f"tree {prefill_bytes / 1e9:.3f} GB + int4 decode tree "
          f"{decode_bytes / 1e9:.3f} GB + shared embedding/norms "
          f"{shared_bytes / 1e9:.3f} GB ({card})")
    if not all(b.fused_plan(32, False) for b in llada.blocks) \
            or not llada.head_fusable(32):
        raise AssertionError("the fused decode plan does not engage")

    gen = GenerationConfig(**GEN)
    first = requests[0]
    model.generate_fused(first[0], [first[1]], [first[2]], gen)  # warm-up
    torch.cuda.synchronize()
    ops = {"short_attention": short_attention, "gather_rows": gather_rows,
           "w8a8_matmul": t8.w8a8_matmul, "w4_qkv_norm": tw.w4_qkv_norm,
           "w4_matmul_res": tw.w4_matmul_res,
           "w4_ffn_fused": tw.w4_ffn_fused}
    want = {"short_attention": SIGLIP_LAYERS + LLADA_LAYERS,
            "gather_rows": 1, "w8a8_matmul": 4 * LLADA_LAYERS,
            "w4_qkv_norm": (LLADA_LAYERS + 1) * STEPS,
            "w4_matmul_res": LLADA_LAYERS * STEPS,
            "w4_ffn_fused": LLADA_LAYERS * STEPS}
    for op in ops.values():
        op.launches = 0
    walls, peaks = [], []
    for i, (ids, views, size) in enumerate(requests):
        before = {k: op.launches for k, op in ops.items()}
        idx, _, _, _ = build_gather_plan(model.cfg, [ids],
                                         [[views.shape[0]]], [[size]])
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.generate_fused(ids, [views], [size], gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        walls.append(wall)
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        got = {k: op.launches - before[k] for k, op in ops.items()}
        print(f"[mixed] request {i}: image {size} -> {views.shape[0]} "
              f"views, P={idx.shape[1]}, G=32: wall {wall * 1e3:.1f} ms, "
              f"peak {peaks[-1]:.2f} GiB, launches {got} ({card}); tokens "
              f"{out.tolist()}")
        if out.shape != (32,):
            raise AssertionError(f"output shape {out.shape}")
        if (out == model.cfg.llada.mask_token_id).any():
            raise AssertionError("mask tokens left in the output")
        if got != want:
            raise AssertionError(f"launches {got}, want {want}")
    counts = {k: op.launches for k, op in ops.items()}

    phases, steps = _phase_times(torch, model, first, gen)
    print(f"[mixed] phases of request 0, host clock with a sync after "
          f"each: vision + splice {phases[0]:.2f} ms, prefill "
          f"{phases[1]:.2f} ms, decode steps {len(steps)} x "
          f"{np.mean(steps):.2f} ms (min {min(steps):.2f}, max "
          f"{max(steps):.2f}) ({card})")
    prof = _profile_busy(
        torch, lambda: model.generate_fused(first[0], [first[1]], [first[2]],
                                            gen))
    _print_profile("mixed", prof, "request 0", card)
    # #5's, #6's and #7's device time, split by their own kernels
    for op, names in SPLIT_KERNELS.items() if prof is not None else ():
        parts = {k: [0.0, 0.0, 0] for k in names}
        for key, (added, ms, n) in prof[4].items():
            for k in names:
                if k in key:
                    parts[k] = [a + b for a, b in zip(parts[k], (added, ms, n))]
        print(f"[mixed] {op} device time of request 0: "
              f"{sum(v[0] for v in parts.values()):.3f} ms = " + ", ".join(
                  f"{k} {added:.3f} ms ({n} launches; {ms:.3f} ms from "
                  f"launch to end)" for k, (added, ms, n) in parts.items())
              + f" ({card})")
        if any(n != want[op] for _, _, n in parts.values()):
            raise AssertionError(f"{op} kernels launched {parts}")
    layer_ms = _decode_layer_ms(torch, llada)
    print(f"[mixed] one decode layer at B = 1 (32 rows, fused plan: "
          f"w4_qkv_norm + w4_matmul_res + w4_ffn_fused): {layer_ms[0]:.4f} "
          f"ms per call back to back, device {layer_ms[1]:.4f} ms in "
          f"{layer_ms[2]:.0f} kernels ({card})")
    return counts, walls, peaks, layer_ms


def phase_small_mixed(torch, device):
    """A tiny mixed-layout model (fused plan and head engaged) on the card
    against the same quantized weights on the CPU, where the fused w4 ops
    run their plain versions."""
    import copy

    from lavida_mod_tpu_torch.config import GenerationConfig
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.predict import tiny_mixed_config

    cfg = tiny_mixed_config()
    cpu = LaViDa.random_init(cfg, 0, torch.bfloat16, "cpu")
    with torch.no_grad():
        for p in cpu.llada.parameters():  # diverse tokens, as in the tests
            if p.dim() >= 2:
                p.mul_(10.0)
    cpu.to_serving_layout("mixed", fuse=True)
    gpu = copy.deepcopy(cpu).to(device)
    mask = cfg.llada.mask_token_id
    x = torch.full((1, 32), mask, dtype=torch.long)
    with torch.no_grad():
        outs = [m.llada(m.llada.embed_tokens(x.to(m.device)))[0].float().cpu()
                for m in (cpu, gpu)]
    rel = ((outs[1] - outs[0]).abs().max() / outs[0].abs().max()).item()
    rng = np.random.default_rng(3)
    views = rng.standard_normal((5, 3, 56, 56)).astype(np.float32)
    ids = np.array([5, 6, -200, 7, 8, 9])
    gen = GenerationConfig(max_new_tokens=32, block_length=32,
                           step_per_block=16)
    a = cpu.generate_fused(ids, [views], [(100, 60)], gen)
    b = gpu.generate_fused(ids, [views], [(100, 60)], gen)
    agree = float((a == b).mean())
    print(f"[check] tiny mixed model (fused plan), kernels on the card vs "
          f"plain versions on the CPU: decode logits max|diff|/max|ref| "
          f"{rel:.3e} (limit 5e-2), generated tokens agree {agree:.2f}")
    if not np.isfinite(rel) or rel > 5e-2:
        raise AssertionError(f"tiny mixed-model logits differ: {rel}")


# the batched path: image sizes of B = 4 and of B = 8
BATCH_SIZES = [(640, 640), (800, 600), (1024, 512), (448, 896)]
BATCH8_SIZES = BATCH_SIZES + [(1100, 380), (512, 1024), (384, 384),
                              (900, 700)]


class _RegimeCount:
    """The launches of one of w4_matmul_grouped's two kernels, read and
    reset as `.launches` like a wrapper's count."""

    def __init__(self, fn, regime):
        self.fn, self.attr = fn, f"{regime}_launches"

    @property
    def launches(self):
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, n):
        setattr(self.fn, self.attr, n)


def _batch_ops():
    from lavida_mod_tpu_torch.ops import kv8_attention as tk
    from lavida_mod_tpu_torch.ops import vit_mlp as tv
    from lavida_mod_tpu_torch.ops import w4_fused as tw
    from lavida_mod_tpu_torch.ops import w4_grouped as tg
    from lavida_mod_tpu_torch.ops import w8a8 as t8
    from lavida_mod_tpu_torch.ops.gather import gather_rows
    from lavida_mod_tpu_torch.ops.short_attention import short_attention

    return {"short_attention": short_attention, "gather_rows": gather_rows,
            "w8a8_matmul": t8.w8a8_matmul, "w4_qkv_norm": tw.w4_qkv_norm,
            "w4_matmul_res": tw.w4_matmul_res,
            "w4_ffn_fused": tw.w4_ffn_fused,
            "w4_matmul_grouped": tg.w4_matmul_grouped,
            "w4_matmul_grouped_decode": _RegimeCount(tg.w4_matmul_grouped,
                                                     "decode"),
            "w4_matmul_grouped_prefill": _RegimeCount(tg.w4_matmul_grouped,
                                                      "prefill"),
            "kv8_decode_attention": tk.kv8_decode_attention,
            "fused_vit_mlp": tv.fused_vit_mlp}


def _want_batch(B, kv8, chunk):
    """Launches of one batch: 7 linears x 32 layers per prefill call and
    per decode step; the head fused into w4_qkv_norm up to 128 decode rows
    (B = 4), else one more grouped matmul per step; 26 SigLIP layers of
    attention and MLP per image; one prefill attention per layer and
    chunk.  The grouped matmuls of the decode (32 B <= 256 rows) take its
    decode kernel, the prefill's (over 1000 rows a chunk) its prefill
    kernel."""
    calls = -(-B // chunk)
    head_fused = B * 32 <= 128
    want = {k: 0 for k in _batch_ops()}
    want["w4_matmul_grouped_decode"] = (LLADA_LINEARS * LLADA_LAYERS * STEPS
                                        + (0 if head_fused else STEPS))
    want["w4_matmul_grouped_prefill"] = LLADA_LINEARS * LLADA_LAYERS * calls
    want["w4_matmul_grouped"] = (want["w4_matmul_grouped_decode"]
                                 + want["w4_matmul_grouped_prefill"])
    want["w4_qkv_norm"] = STEPS if head_fused else 0
    want["short_attention"] = SIGLIP_LAYERS * B + LLADA_LAYERS * calls
    want["fused_vit_mlp"] = SIGLIP_LAYERS * B
    want["kv8_decode_attention"] = LLADA_LAYERS * STEPS if kv8 else 0
    return want


def phase_batched_path(torch, device, card):
    """LaViDaConfig() from seed 0 through to_serving_layout("int4",
    fuse=False), then generate_batch at B = 4 (kv8 off and on) and B = 8
    (chunked prefill)."""
    from lavida_mod_tpu_torch.config import GenerationConfig, LaViDaConfig
    from lavida_mod_tpu_torch.eval.adapter import generate_batch
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.ops.quant import Int4Linear

    cfg = LaViDaConfig()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LaViDa.random_init(cfg, 0, torch.bfloat16, device)
    model.to_serving_layout("int4", fuse=False)
    torch.cuda.synchronize()
    llada = model.llada
    blk = llada.blocks[0]
    if not (all(isinstance(getattr(b, n), Int4Linear) for b in llada.blocks
                for n in b.linear_names) and blk.cfg.block_type == "llama"
            and not blk.fused_plan(32, False) and llada.head_fusable(128)
            and not llada.head_fusable(256)
            and model._vision_fused_mlp()):
        raise AssertionError("the batched int4 layout is not as expected")
    print(f"[batch] LaViDaConfig() bf16 random init + to_serving_layout("
          f"'int4', fuse=False) on the card in {time.perf_counter() - t0:.2f}"
          f" s (peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB); "
          f"LM weights {_tree_bytes([llada]) / 1e9:.3f} GB ({card})")

    gen = GenerationConfig(**GEN)
    rng = np.random.default_rng(4)
    req8 = [bench_request(48, s, rng) for s in BATCH8_SIZES]
    reqs8 = [(ids, [views], [size]) for ids, views, size in req8]
    reqs4 = reqs8[:4]
    ops = _batch_ops()
    generate_batch(model, reqs4, gen)                      # warm-up
    torch.cuda.synchronize()
    counts, walls = {}, {}
    for name, reqs, kv8, chunk in [("b4", reqs4, False, 4),
                                   ("b4_kv8", reqs4, True, 4),
                                   ("b8_chunked", reqs8, False, 2)]:
        B = len(reqs)
        for op in ops.values():
            op.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, stage = generate_batch(model, reqs, gen, kv8=kv8)
        wall = time.perf_counter() - t0
        got = {k: op.launches for k, op in ops.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = _want_batch(B, kv8, chunk)
        views = sum(r[1][0].shape[0] for r in reqs)
        print(f"[batch] {name}: B={B}, {views} views, G=32: wall "
              f"{wall * 1e3:.1f} ms ({wall * 1e3 / B:.1f} ms per image), "
              f"stages encode {stage['encode'] * 1e3:.1f} ms generate "
              f"{stage['generate'] * 1e3:.1f} ms, peak {peak:.2f} GiB "
              f"({card}); launches {got}")
        print(f"[batch] {name} tokens of request 0: {out[0].tolist()}")
        if out.shape != (B, 32):
            raise AssertionError(f"output shape {out.shape}")
        if (out == cfg.llada.mask_token_id).any():
            raise AssertionError("mask tokens left in the output")
        if got != want:
            raise AssertionError(f"launches {got}, want {want}")
        counts[name], walls[name] = got, (wall, B, peak)

    share = _print_profile("batch", _profile_busy(
        torch, lambda: generate_batch(model, reqs4, gen, kv8=True)),
        "one B = 4 kv8 batch", card)
    layer_ms = _decode_layer_ms(torch, llada)
    print(f"[batch] one decode layer at B = 1 (32 rows, unfused int4: seven "
          f"w4_matmul_grouped + norms, SwiGLU, dense attention): "
          f"{layer_ms[0]:.4f} ms per call back to back, device "
          f"{layer_ms[1]:.4f} ms in {layer_ms[2]:.0f} kernels ({card})")
    return model, counts, walls, share, layer_ms


def phase_small_batch(torch, device):
    """A tiny int4 (unfused) + kv8 + fused-ViT-MLP model on the card
    against the same weights on the CPU, where every op runs its plain
    version."""
    import copy

    from lavida_mod_tpu_torch.config import (GenerationConfig,
                                             tiny_siglip_config)
    from lavida_mod_tpu_torch.data.anyres import anyres_grid_shape
    from lavida_mod_tpu_torch.eval.adapter import generate_batch
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.predict import tiny_mixed_config

    cfg = tiny_mixed_config()
    sig = tiny_siglip_config(hidden_size=128, intermediate_size=200)
    cfg = cfg.replace(vision=cfg.vision.replace(siglip=sig,
                                                mm_hidden_size=128))
    cpu = LaViDa.random_init(cfg, 0, torch.bfloat16, "cpu")
    with torch.no_grad():
        for p in cpu.llada.parameters():  # diverse tokens, as in the tests
            if p.dim() >= 2:
                p.mul_(4.0)
    cpu.to_serving_layout("int4", fuse=False)
    gpu = copy.deepcopy(cpu).to(device)
    rng = np.random.default_rng(5)
    reqs = []
    for size in ((100, 60), (60, 100), (112, 112)):
        nw, nh = anyres_grid_shape(size, cfg.vision.grid_pinpoints, 56)
        views = rng.standard_normal((1 + nw * nh, 3, 56, 56)).astype(
            np.float32)
        ids = np.concatenate([[5, 6, -200], rng.integers(3, 400, 4)])
        reqs.append((ids, [views], [size]))
    x = torch.full((3, 32), cfg.llada.mask_token_id, dtype=torch.long)
    with torch.no_grad():
        outs = [m.llada(m.llada.embed_tokens(x.to(m.device)))[0].float().cpu()
                for m in (cpu, gpu)]
    rel = ((outs[1] - outs[0]).abs().max() / outs[0].abs().max()).item()
    gen = GenerationConfig(max_new_tokens=32, block_length=32,
                           step_per_block=16)
    a, _ = generate_batch(cpu, reqs, gen, kv8=True)
    b, _ = generate_batch(gpu, reqs, gen, kv8=True)
    agree = float((a == b).mean())
    print(f"[check] tiny int4 + kv8 + fused-ViT-MLP model, kernels on the "
          f"card vs plain versions on the CPU: decode logits max|diff|/"
          f"max|ref| {rel:.3e} (limit 5e-2), B=3 kv8 generate_batch tokens "
          f"agree {agree:.2f}")
    if not np.isfinite(rel) or rel > 5e-2:
        raise AssertionError(f"tiny int4 model logits differ: {rel}")
    if (b == cfg.llada.mask_token_id).any():
        raise AssertionError("mask tokens left in the tiny batch output")


def phase_train_kernels(torch, device, res):
    """The three prefix-LM flash attention kernels against their plain
    versions, SDPA and their bounds at the stage-1 shape (per step: 2 x 32
    forward launches, with the checkpoint's recompute, 32 dq, 32 dkv) and
    a ragged GQA case."""
    import torch.nn.functional as F

    from lavida_mod_tpu_torch.ops import prefix_flash as tpf

    gen = torch.Generator(device=device).manual_seed(9)
    # (name, B, T, Hq, Hkv, prefix lengths, valid keys, per-step launches)
    plen1 = [1010 - 9 * i for i in range(4)] * 2
    cases = [("stage1", 8, 1152, 32, 32, plen1, [p + 48 for p in plen1],
              (2 * LLADA_LAYERS, LLADA_LAYERS, LLADA_LAYERS)),
             ("gqa_ragged", 2, 200, 28, 4, [0, 250], [193, 200], (0, 0, 0))]
    hd = 128
    for name, B, T, Hq, Hkv, plen, nvalid, per in cases:
        q = torch.randn(B, T, Hq, hd, generator=gen, device=device).bfloat16()
        k, v = (torch.randn(B, T, Hkv, hd, generator=gen,
                            device=device).bfloat16() for _ in range(2))
        dout = torch.randn(B, T, Hq, hd, generator=gen,
                           device=device).bfloat16()
        pl = torch.tensor(plen, dtype=torch.int32, device=device)
        valid = (torch.arange(T, device=device)[None]
                 < torch.tensor(nvalid, device=device)[:, None]).int()
        o, lse = tpf.prefix_flash_fwd(q, k, v, pl, valid)
        torch.cuda.synchronize()
        o_ref, lse_ref = tpf.prefix_flash_fwd_reference(q, k, v, pl, valid)
        # p is rounded to bf16 per 128-key tile against the running max (the
        # plain version once against the row max); sums run in another order.
        # Read on an H100: o within 2.0e-3 (stage1) and 3.9e-3 (gqa_ragged,
        # one bf16 ulp at |o| >= 0.5); dq, dk, dv within 1.3e-3 - 2.9e-3 of
        # the tensor's max.
        torch.testing.assert_close(o.float(), o_ref.float(), atol=8e-3,
                                   rtol=0)
        torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=1e-4)
        delta = tpf.attention_delta(dout, o_ref)
        args = (q, k, v, pl, valid, dout, lse_ref, delta)
        dq = tpf.prefix_flash_dq(*args)
        dk, dv = tpf.prefix_flash_dkv(*args)
        torch.cuda.synchronize()
        dq_ref = tpf.prefix_flash_dq_reference(*args)
        dk_ref, dv_ref = tpf.prefix_flash_dkv_reference(*args)
        errs = {"o": (o.float() - o_ref.float()).abs().max().item(),
                "dq": _rel(dq, dq_ref), "dk": _rel(dk, dk_ref),
                "dv": _rel(dv, dv_ref)}
        for n in ("dq", "dk", "dv"):
            if not errs[n] < 8e-3:
                raise AssertionError(f"prefix_flash {n} at {name}: "
                                     f"{errs[n]} (limit 8e-3 of max)")
        del o_ref, dq_ref, dk_ref, dv_ref
        # the library: SDPA with the same boolean mask, and its autograd
        # backward (dq, dk and dv in one call)
        qpos = torch.arange(T, device=device)
        see = ((qpos[None, None, :] < pl[:, None, None])
               | (qpos[None, :, None] >= pl[:, None, None])) \
            & valid.bool()[:, None, :]
        mask = see[:, None]
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        gqa = dict(enable_gqa=True) if Hq != Hkv else {}
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, **gqa)
        lib_fwd, lib_fwd_b2b = cuda_ms(sdpa, 10), cuda_ms(sdpa, 10,
                                                          hold=False)
        with torch.enable_grad():
            out = sdpa()
        dot = dout.transpose(1, 2)

        def sdpa_bwd():
            return torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)

        lib_bwd, lib_bwd_b2b = cuda_ms(sdpa_bwd, 10), cuda_ms(sdpa_bwd, 10,
                                                              hold=False)
        # the bound counts the (query, key) pairs this run's masks leave
        # visible: keys past the valid tail and, for a query inside the
        # prefix, keys past the prefix need no work
        flops = int(see.sum()) * Hq * hd
        del out, qt, kt, vt, mask, see
        io = 2 * (q.numel() + k.numel() + v.numel()) + 4 * B * T
        rows = 4 * B * Hq * T
        shape = f"{name} q[{B},{T},{Hq},{hd}] kv heads {Hkv}"
        res.add("prefix_flash_fwd", shape, per[0], max(errs["o"], 0.0),
                lambda: tpf.prefix_flash_fwd(q, k, v, pl, valid),
                cuda_ms(lambda: tpf.prefix_flash_fwd_reference(
                    q, k, v, pl, valid), 3), lib_fwd, 4 * flops,
                io + 2 * q.numel() + rows, note=" (o abs, limit 8e-3)",
                library_b2b=lib_fwd_b2b)
        res.add("prefix_flash_dq", shape, per[1], errs["dq"],
                lambda: tpf.prefix_flash_dq(*args),
                cuda_ms(lambda: tpf.prefix_flash_dq_reference(*args), 3),
                lib_bwd, 6 * flops, io + 4 * q.numel() + 2 * rows,
                note=" (relative, limit 8e-3; library = SDPA's whole "
                     "backward)", library_b2b=lib_bwd_b2b)
        res.add("prefix_flash_dkv", shape, per[2],
                max(errs["dk"], errs["dv"]),
                lambda: tpf.prefix_flash_dkv(*args),
                cuda_ms(lambda: tpf.prefix_flash_dkv_reference(*args), 3),
                lib_bwd, 8 * flops,
                io + 2 * q.numel() + 2 * rows + 2 * (k.numel() + v.numel()),
                note=" (relative, limit 8e-3; library = SDPA's whole "
                     "backward)", library_b2b=lib_bwd_b2b)
        del q, k, v, dout, dq, dk, dv, o, args
        torch.cuda.empty_cache()


def prefix_flash_summary(res, card):
    """#10 at the stage-1 shape, per launch and per step: the forward
    against SDPA's forward, dq + dkv against SDPA's whole backward, each
    beside its bound, device time and back to back."""
    fwd, dq, dkv = (res.get(n)["per_shape"][0] for n in (
        "prefix_flash_fwd", "prefix_flash_dq", "prefix_flash_dkv"))
    bwd = {k: dq[k] + dkv[k] for k in ("ms", "ms_back_to_back", "bound_ms")}
    for what, r, lib_name in (("forward", fwd, "SDPA's forward"),
                              ("dq + dkv", bwd, "SDPA's whole backward")):
        lib = fwd["library_ms"] if r is fwd else dq["library_ms"]
        print(f"[kernels] prefix_flash {what} at the stage-1 shape, per "
              f"launch: {r['ms']:.4f} ms (back to back "
              f"{r['ms_back_to_back']:.4f} ms), {lib_name} {lib:.4f} ms "
              f"(kernel {r['ms'] / lib:.2f}x its time), bound "
              f"{r['bound_ms']:.4f} ms (kernel at "
              f"{100 * r['bound_ms'] / r['ms']:.1f} % of it) ({card})")
    for name in ("prefix_flash_fwd", "prefix_flash_dq", "prefix_flash_dkv"):
        res.summary(name, "one stage-1 step (64 fwd with the remat "
                    "recompute, 32 dq, 32 dkv)", card)


TRAIN_TEXT, TRAIN_CAPTION = 8, 40


def train_batch(cfg, sizes, rng, seq_bucket=128, view_bucket=8):
    """A stage-1/2 batch as train.py's make_batch builds it (train.py:
    319-357): one image per sample between an 8-token prompt and a 40-token
    caption that carries the labels, the plan padded to a multiple of
    seq_bucket and the views to a multiple of view_bucket (zero views)."""
    from lavida_mod_tpu_torch.data.anyres import anyres_grid_shape
    from lavida_mod_tpu_torch.models.multimodal import build_gather_plan

    S = cfg.vision.siglip.image_size
    ids, labels, views, n_views = [], [], [], []
    for size in sizes:
        nw, nh = anyres_grid_shape(size, cfg.vision.grid_pinpoints, S)
        views.append(rng.uniform(-1, 1, (1 + nw * nh, 3, S, S)).astype(
            np.float32))
        n_views.append([views[-1].shape[0]])
        text = rng.integers(3, min(30000, cfg.llada.mask_token_id),
                            TRAIN_TEXT + TRAIN_CAPTION)
        row = np.concatenate([text[:TRAIN_TEXT], [-200], text[TRAIN_TEXT:]])
        lab = row.copy()
        lab[:TRAIN_TEXT + 1] = -100
        ids.append(row)
        labels.append(lab)
    plan = (cfg, ids, n_views, [[s] for s in sizes], labels)
    T = build_gather_plan(*plan)[0].shape[1]
    gather_idx, text_ids, _, labels = build_gather_plan(
        *plan, pad_to=-(-T // seq_bucket) * seq_bucket)
    pix = np.concatenate(views)
    NV = -(-pix.shape[0] // view_bucket) * view_bucket
    pix = np.concatenate([pix, np.zeros((NV - pix.shape[0],) + pix.shape[1:],
                                        np.float32)])
    return {"pixel_values": pix, "text_ids": text_ids,
            "gather_idx": gather_idx, "labels": labels}


def _train_ops():
    from lavida_mod_tpu_torch.ops import prefix_flash as tpf
    from lavida_mod_tpu_torch.ops.gather import gather_rows
    from lavida_mod_tpu_torch.ops.short_attention import short_attention

    return {"prefix_flash_fwd": tpf.prefix_flash_fwd,
            "prefix_flash_dq": tpf.prefix_flash_dq,
            "prefix_flash_dkv": tpf.prefix_flash_dkv,
            "gather_rows": gather_rows, "short_attention": short_attention}


def _checksums(torch, modules):
    """Per parameter: the sum of its bf16 bit patterns, the f64 sum of its
    squares and the bit sum of a strided subset (a change of any weight
    moves them)."""
    out = []
    with torch.no_grad():
        for m in modules:
            for p in m.parameters():
                bits = p.detach().reshape(-1).view(torch.int16)
                out.append(torch.stack([
                    bits.sum(dtype=torch.int64).double(),
                    p.detach().double().square().sum(),
                    bits[::97].sum(dtype=torch.int64).double()]))
    return torch.stack(out).cpu()


STAGE1_STEPS = 100


def phase_stage1(torch, device, card):
    """Stage-1 pretraining steps at full LaViDa-LLaDA-8B."""
    from lavida_mod_tpu_torch.config import LaViDaConfig
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.train.step import (init_train_state,
                                                 make_freeze_optimizer,
                                                 make_multimodal_train_step)

    cfg = LaViDaConfig()
    t0 = time.perf_counter()
    model = LaViDa.random_init(cfg, 0, torch.bfloat16, device)
    opt = make_freeze_optimizer(
        "mm_mlp_adapter", lr=1e-3,
        warmup_steps=int(0.03 * STAGE1_STEPS), total_steps=STAGE1_STEPS)
    state = init_train_state(model, opt, torch.bfloat16)
    step = make_multimodal_train_step(
        cfg, opt, remat="whole_layer", ce_chunk=512,
        attention_impl="prefix_flash")
    torch.cuda.synchronize()
    n_train = sum(m.numel() for m in state.masters.values())
    print(f"[stage1] LaViDaConfig() bf16 random init + train state on the "
          f"card in {time.perf_counter() - t0:.2f} s: "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params,"
          f" {n_train / 1e6:.3f} M trainable (projector + image_newline, "
          f"f32 masters) ({card})")
    rng = np.random.default_rng(10)
    batch = train_batch(cfg, BATCH_SIZES, rng)
    B, T = batch["labels"].shape
    gen = torch.Generator(device=device).manual_seed(0)
    frozen = [model.llada, model.siglip]
    sums0 = _checksums(torch, frozen)
    tunable = {n: m.clone() for n, m in state.masters.items()}
    ops = _train_ops()
    # the frozen tower runs under autograd (grad_norm covers every leaf):
    # its layers' remat recompute launches short_attention again
    want = {"prefix_flash_fwd": 2 * LLADA_LAYERS,
            "prefix_flash_dq": LLADA_LAYERS,
            "prefix_flash_dkv": LLADA_LAYERS, "gather_rows": 1,
            "short_attention": 2 * SIGLIP_LAYERS}

    m = step(state, batch, gen)                 # warm-up: the LR is 0 here
    torch.cuda.synchronize()
    if not all(torch.equal(state.masters[n], t) for n, t in tunable.items()):
        raise AssertionError("a master moved at LR 0")
    for op in ops.values():
        op.launches = 0
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], [m["loss"].item()]
    for i in range(3):
        before = {k: op.launches for k, op in ops.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, batch, gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        got = {k: op.launches - before[k] for k, op in ops.items()}
        losses.append(m["loss"].item())
        nv = batch["pixel_values"].shape[0]
        print(f"[stage1] step {i + 1}: B={B} T={T} ({nv} views): wall "
              f"{walls[-1] * 1e3:.1f} ms, loss "
              f"{losses[-1]:.4f}, acc_mask {m['acc_mask'].item():.4f}, "
              f"grad_norm {m['grad_norm'].item():.4e}, launches {got} "
              f"({card})")
        if got != want:
            raise AssertionError(f"launches {got}, want {want}")
        if i == 0:
            moved = {n.split(".")[0] for n, t in tunable.items()
                     if not torch.equal(state.masters[n], t)}
            if moved != {"projector", "image_newline"}:
                raise AssertionError(f"after the first step with a nonzero "
                                     f"LR only {moved} moved")
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = {k: op.launches for k, op in ops.items()}
    if not np.isfinite(losses).all():
        raise AssertionError(f"losses {losses}")
    if not torch.equal(_checksums(torch, frozen), sums0):
        raise AssertionError("a frozen LLaDA or SigLIP weight changed")
    wall = float(np.mean(walls))
    print(f"[stage1] 3 steps: wall {wall * 1e3:.1f} ms per step (min "
          f"{min(walls) * 1e3:.1f}), {B * T / wall:.0f} data tokens/s (B x T"
          f" = {B * T}), peak {peak:.2f} GiB; frozen LLaDA + SigLIP weights "
          f"bit-identical, projector + image_newline moved ({card})")
    prof = _profile_busy(torch, lambda: step(state, batch, gen))
    share = _print_profile("stage1", prof, "one step", card)
    attn = None
    if prof is not None:
        print_by_kind("stage1", prof[3], "the profiled step")
        attn = {k: sum(ms for key, ms, _ in prof[3] if f"prefix_flash_{k}_"
                       in key) for k in ("fwd", "dq", "dkv")}
        print(f"[stage1] #10 device time in the profiled step: fwd "
              f"{attn['fwd']:.2f} ms, dq {attn['dq']:.2f} ms, dkv "
              f"{attn['dkv']:.2f} ms, total {sum(attn.values()):.2f} ms; "
              f"step wall {wall * 1e3:.1f} ms, peak {peak:.2f} GiB ({card})")
    del state, model, step
    torch.cuda.empty_cache()
    return counts, {"wall_ms": wall * 1e3, "tokens_per_s": B * T / wall,
                    "peak_gib": peak, "busy": share, "B": B, "T": T,
                    "prefix_flash_ms": attn}


def phase_stage2(torch, device, card):
    """Stage-2 finetuning at full width, LLaDA depth cut to 4 layers."""
    from lavida_mod_tpu_torch.config import LaViDaConfig
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.ops.short_attention import short_attention
    from lavida_mod_tpu_torch.train.step import (init_train_state,
                                                 make_freeze_optimizer,
                                                 make_multimodal_train_step)

    full = LaViDaConfig()
    cfg = full.replace(llada=full.llada.replace(n_layers=4))
    torch.cuda.reset_peak_memory_stats()
    model = LaViDa.random_init(cfg, 1, torch.bfloat16, device)
    total = 10          # finetune_stage2.sh's warmup ratio 0.03 -> 0 steps
    opt = make_freeze_optimizer(
        "mm_mlp_adapter,mm_vision_tower,mm_language_model", lr=2e-5,
        vision_tower_lr=2e-6, grad_accum=2,
        warmup_steps=int(0.03 * total), total_steps=total)
    state = init_train_state(model, opt, torch.bfloat16)
    step = make_multimodal_train_step(
        cfg, opt, remat="whole_layer", ce_chunk=512,
        attention_impl="prefix_flash")
    n_train = sum(m.numel() for m in state.masters.values())
    print(f"[stage2] cut: LLaDA depth {full.llada.n_layers} -> "
          f"{cfg.llada.n_layers} layers (the only cut; widths, vocabulary "
          f"and the 26 SigLIP layers as LaViDaConfig()): {n_train / 1e9:.3f}"
          f" B trainable params, f32 masters + Adam moments + f32 "
          f"accumulator ({card})")

    def group_sums():
        out = {}
        with torch.no_grad():
            for n, m in state.masters.items():
                g = opt.label(n)
                out[g] = out.get(g, 0.0) + m.double().sum().item()
        return out

    rng = np.random.default_rng(11)
    gen = torch.Generator(device=device).manual_seed(1)
    sums0 = group_sums()
    vjp0 = short_attention.backward_calls
    metrics = []
    for i, sizes in enumerate((BATCH_SIZES[:2], BATCH_SIZES[2:])):
        batch = train_batch(cfg, sizes, rng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append({k: v.item() for k, v in
                        step(state, batch, gen).items()})
        torch.cuda.synchronize()
        sums = group_sums()
        moved = {g for g in sums if sums[g] != sums0[g]}
        print(f"[stage2] microstep {i + 1}: B=2 T={batch['labels'].shape[1]}"
              f" wall {(time.perf_counter() - t0) * 1e3:.1f} ms, {metrics[-1]}"
              f", groups moved {sorted(moved)} ({card})")
        if i == 0 and moved:
            raise AssertionError(f"{moved} moved before the update")
    if moved != {"base", "projector", "vision_tower"}:
        raise AssertionError(f"after the update only {moved} moved")
    vjp = short_attention.backward_calls - vjp0
    if vjp != 2 * SIGLIP_LAYERS:
        raise AssertionError(f"short_attention VJP ran {vjp} times")
    finite = all(np.isfinite(v) for m in metrics for v in m.values()) and all(
        bool(torch.isfinite(m).all()) for m in state.masters.values())
    if not finite:
        raise AssertionError("NaN or inf in the stage-2 step")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[stage2] one update (2 microsteps): every group moved, the "
          f"short-attention VJP ran {vjp} times, no NaN; peak {peak:.2f} GiB"
          f" ({card})")
    del state, model, step
    torch.cuda.empty_cache()
    return peak


def phase_small_train(torch, device):
    """One stage-2 microstep of a tiny LaViDa on the card (bf16 compute,
    kernels) and on the CPU (plain versions), same masters, same mask."""
    from lavida_mod_tpu_torch.models.lavida import LaViDa
    from lavida_mod_tpu_torch.models.multimodal import multimodal_embeds
    from lavida_mod_tpu_torch.predict import tiny_config
    from lavida_mod_tpu_torch.train.loss import diffusion_loss
    from lavida_mod_tpu_torch.train.step import (init_train_state,
                                                 make_freeze_optimizer,
                                                 make_multimodal_train_step)

    cfg = tiny_config()
    lr = 1e-3
    ref = LaViDa.random_init(cfg, 0, torch.float32, "cpu").state_dict()
    batch = train_batch(cfg, [(100, 60), (112, 112)],
                        np.random.default_rng(12), view_bucket=1)
    mask = torch.from_numpy(np.random.default_rng(13).random(
        batch["labels"].shape) < 0.5)
    out = {}
    for dev in ("cpu", device):
        model = LaViDa(cfg, "cpu", torch.float32)
        model.load_state_dict(ref)
        model.to(dev)
        opt = make_freeze_optimizer(
            "mm_mlp_adapter,mm_vision_tower,mm_language_model", lr=lr,
            warmup_steps=0, total_steps=10)
        state = init_train_state(model, opt, torch.bfloat16)
        pix = torch.as_tensor(batch["pixel_values"], device=dev)
        emb = multimodal_embeds(model, pix, batch["text_ids"],
                                batch["gather_idx"], remat=True)
        loss, _ = diffusion_loss(model.llada, emb,
                                 torch.as_tensor(batch["labels"]),
                                 masked_indices=mask,
                                 attention_impl="prefix_flash")
        loss.backward()
        params = dict(model.named_parameters())
        grads = {n: params[n].grad.float().cpu() for n in state.masters}
        model.zero_grad(set_to_none=True)
        step = make_multimodal_train_step(cfg, opt, remat=True,
                                          attention_impl="prefix_flash")
        m = step(state, batch, masked_indices=mask)
        out[str(dev)] = (m["loss"].item(), grads,
                         {n: t.cpu() for n, t in state.masters.items()})
    (l_cpu, g_cpu, m_cpu), (l_gpu, g_gpu, m_gpu) = out["cpu"], out[str(device)]
    worst = max((_rel(g_gpu[n], g_cpu[n]), n) for n in g_cpu
                if not n.endswith("k_proj.bias"))
    far = sum(int(((m_gpu[n] - m_cpu[n]).abs() > lr / 100).sum())
              for n in m_cpu)
    total = sum(t.numel() for t in m_cpu.values())
    dmax = max((m_gpu[n] - m_cpu[n]).abs().max().item() for n in m_cpu)
    # A first Adam update moves each element by about lr * sign(g), so an
    # element whose tiny gradient takes the other sign on the card lands
    # 2 lr away: dmax cannot be held below 2 lr, the count beyond lr / 100
    # bounds how many do.  Read on an H100: loss 1e-5 relative, worst
    # gradient 8.5e-3, 0.63 % of elements beyond lr / 100.
    print(f"[check] tiny LaViDa stage-2 microstep, kernels on the card vs "
          f"plain versions on the CPU (bf16 compute, f32 masters, same "
          f"mask): loss {l_gpu:.5f} vs {l_cpu:.5f} (limit 1e-4 relative); "
          f"worst gradient {worst[0]:.3e} of max ({worst[1]}, limit 3e-2); "
          f"masters max |diff| {dmax:.3e} (limit 2 lr), {far} of {total} "
          f"beyond lr / 100 (limit 2 %)")
    if not abs(l_gpu - l_cpu) < 1e-4 * abs(l_cpu) or not worst[0] < 3e-2 \
            or not dmax <= 2.002 * lr or far > 0.02 * total:
        raise AssertionError("the tiny training step differs on the card")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none found")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t_start = time.perf_counter()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    from lavida_mod_tpu_torch import kernels

    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.library()       # raises if a register count is off
    print(f"[build] {lib_path.name} in {time.perf_counter() - t0:.2f} s; "
          f"registers at entry as the designs need: "
          f"{kernels.REGISTERS_AT_ENTRY}")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        # "== <source>" heads each source's kernels
        if line.startswith("== ") or "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    res = Results()
    with torch.no_grad():
        phase_kernels(torch, device, res)
        phase_quant_kernels(torch, device, res)
        phase_w4_matmul(torch, device, res)
        phase_batch_kernels(torch, device, res)
        phase_train_kernels(torch, device, res)
    res.summary("short_attention", "one mixed request (26 SigLIP + 32 "
                "prefill launches)", card)
    res.summary("w8a8_matmul", "one mixed request (128 launches)", card)
    prefix_flash_summary(res, card)
    torch.cuda.empty_cache()
    model, requests, counts, walls = phase_main_path(torch, device, card)
    mixed_counts, mixed_walls, peaks, fused_layer_ms = phase_mixed_path(
        torch, model, requests, card)
    del model
    torch.cuda.empty_cache()
    phase_small_reference(torch, device)
    phase_small_mixed(torch, device)
    model, batch_counts, batch_walls, share, unfused_layer_ms = \
        phase_batched_path(torch, device, card)
    del model
    torch.cuda.empty_cache()
    phase_small_batch(torch, device)
    train_counts, stage1 = phase_stage1(torch, device, card)
    stage2_peak = phase_stage2(torch, device, card)
    phase_small_train(torch, device)
    print(f"[batch] #4 design point, one decode layer at B = 1, device "
          f"time: fused plan {fused_layer_ms[1]:.4f} ms vs unfused grouped "
          f"int4 {unfused_layer_ms[1]:.4f} ms; back to back "
          f"{fused_layer_ms[0]:.4f} vs {unfused_layer_ms[0]:.4f} ms ({card})")

    def entry(name, source, replaces, launches, **extra):
        return {"name": name, "route": "cuda",
                "source": f"lavida_mod_tpu_torch/csrc/{source}",
                "replaces": f"lavida_mod_tpu/ops/{replaces}",
                "launches": launches, **res.get(name), **extra}

    b4, b4k, b8 = (batch_counts[k] for k in ("b4", "b4_kv8", "b8_chunked"))
    entries = [
        entry("short_attention", "short_attention.cu",
              "short_attention.py:78", counts["short_attention"],
              launches_mixed_path=mixed_counts["short_attention"],
              launches_batch_b4=b4["short_attention"]),
        entry("gather_rows", "gather_rows.cu", "pallas_gather.py:26",
              counts["gather_rows"],
              launches_mixed_path=mixed_counts["gather_rows"]),
        entry("w8a8_matmul", "w8a8_matmul.cu", "pallas_w8.py:53",
              mixed_counts["w8a8_matmul"]),
        entry("w4_qkv_norm", "w4_fused.cu", "w4_fused.py:80",
              mixed_counts["w4_qkv_norm"],
              launches_batch_b4=b4["w4_qkv_norm"]),
        entry("w4_matmul_res", "w4_fused.cu", "w4_fused.py:250",
              mixed_counts["w4_matmul_res"]),
        entry("w4_ffn_fused", "w4_fused.cu", "w4_fused.py:322",
              mixed_counts["w4_ffn_fused"]),
        entry("w4_matmul_grouped_decode", "w4_grouped.cu",
              "pallas_w4.py:129", b4["w4_matmul_grouped_decode"],
              launches_batch_b8=b8["w4_matmul_grouped_decode"]),
        entry("w4_matmul_grouped_prefill", "w4_grouped.cu",
              "pallas_w4.py:129", b4["w4_matmul_grouped_prefill"],
              launches_batch_b8=b8["w4_matmul_grouped_prefill"]),
        entry("kv8_decode_attention", "kv8_attention.cu",
              "kv8_attention.py:98", b4k["kv8_decode_attention"]),
        entry("fused_vit_mlp", "vit_mlp.cu", "vit_mlp.py:63",
              b4["fused_vit_mlp"], launches_batch_b8=b8["fused_vit_mlp"]),
        entry("prefix_flash_fwd", "prefix_flash.cu", "prefix_flash.py:53",
              train_counts["prefix_flash_fwd"]),
        entry("prefix_flash_dq", "prefix_flash.cu", "prefix_flash.py:143",
              train_counts["prefix_flash_dq"]),
        entry("prefix_flash_dkv", "prefix_flash.cu", "prefix_flash.py:179",
              train_counts["prefix_flash_dkv"]),
        entry("w4_matmul", "w4_matmul.cu", "pallas_w4.py:49", 0),
    ]
    bw = {k: (round(w * 1e3, 1), round(w * 1e3 / B, 1), round(p, 2))
          for k, (w, B, p) in batch_walls.items()}
    busy1 = ("not measured" if stage1["busy"] is None
             else f"{100 * stage1['busy']:.1f} %")
    attn1 = ("not measured" if stage1["prefix_flash_ms"] is None
             else f"{sum(stage1['prefix_flash_ms'].values()):.2f} ms")
    print("[result] kernel ms / plain_ms / library_ms / bound_ms: summed "
          "over one run's launches (bf16 path: 26 SigLIP + 32 prefill "
          "short_attention, 1 gather_rows per request; mixed path: 128 "
          "w8a8_matmul, 16 x 33 w4_qkv_norm, 16 x 32 w4_matmul_res and "
          "w4_ffn_fused per request; batched path, one B = 4 batch: 7 x 32 "
          "x 16 w4_matmul_grouped decode (128 rows) and 7 x 32 prefill "
          "(4608 rows), 32 x 16 kv8_decode_attention, 4 x 26 "
          "fused_vit_mlp; w4_matmul, which no path launches: one call at "
          "the decode and one at the prefill shape); launches: each path's "
          "run; request walls bf16 "
          f"{[round(w * 1e3, 1) for w in walls]} ms, mixed "
          f"{[round(w * 1e3, 1) for w in mixed_walls]} ms, mixed peak "
          f"{[round(p, 2) for p in peaks]} GiB; batches (wall ms, ms per "
          f"image, peak GiB) {bw}; device busy of a B = 4 kv8 batch "
          f"{'not measured' if share is None else f'{100 * share:.1f} %'}; "
          f"training (prefix_flash ms summed over one stage-1 step: 2 x 32 "
          f"fwd, 32 dq, 32 dkv; launches over 3 steps): stage-1 step "
          f"{stage1['wall_ms']:.1f} ms, {stage1['tokens_per_s']:.0f} data "
          f"tokens/s, peak {stage1['peak_gib']:.2f} GiB, device busy "
          f"{busy1}, #10 device time {attn1}; stage-2 (4 LLaDA layers) peak "
          f"{stage2_peak:.2f} GiB; "
          f"whole script {time.perf_counter() - t_start:.1f} s on {card}")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
