#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (lavida_mod_tpu_torch) on one
NVIDIA GPU.  Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one printed line or more each; any failure raises, so the script
exits non-zero and never prints the final line:
  1. device: a CUDA card is required (no CPU fallback); its name and power
     limit as nvidia-smi reports them; TF32 off for matmuls and cuDNN.
  2. build: nvcc compiles the port's CUDA kernels from csrc/, one compiler
     per source, in parallel (timed).
  3. kernels vs their plain PyTorch versions on the card, at the main
     paths' shapes plus a ragged/odd case each: max error and time of each
     (short_attention, gather_rows; w8a8_matmul, w4_qkv_norm,
     w4_matmul_res, w4_ffn_fused).
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
     the device-busy share of one profiled request.
  6. output checks on a small input: a tiny model in bf16 on the card
     against the same weights in f32 on the CPU (plain path), and a tiny
     mixed-layout model on the card against the same quantized weights on
     the CPU (plain versions of the four new kernels).
Then one JSON line of per-kernel results, and as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np

SIGLIP_LAYERS = 26   # so400m's 27 layers less the dropped last one
LLADA_LAYERS = 32
TIME_ITERS = 20


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters: int = TIME_ITERS) -> float:
    """Mean device time of fn() in ms over `iters` launches (CUDA events),
    after warm-up."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bench_request(n_text: int, image_size, rng):
    """(input_ids, views, image_size) of one request: a seeded prompt with
    the image marker after 8 text tokens (the bench.py protocol) and
    seeded preprocessed views for the image's anyres tiling."""
    from lavida_mod_tpu.config import LaViDaConfig
    from lavida_mod_tpu.data.anyres import anyres_grid_shape

    vcfg = LaViDaConfig().vision
    nw, nh = anyres_grid_shape(image_size, vcfg.grid_pinpoints,
                               vcfg.siglip.image_size)
    S = vcfg.siglip.image_size
    views = rng.uniform(-1, 1, (1 + nw * nh, 3, S, S)).astype(np.float32)
    text = rng.integers(3, 30000, size=n_text)
    ids = np.concatenate([text[:8], [-200], text[8:]])
    return ids, views, image_size


def phase_kernels(torch, device):
    """Each kernel against its plain version at the slice's shapes."""
    from lavida_mod_tpu.config import LaViDaConfig
    from lavida_mod_tpu_torch import kernels
    from lavida_mod_tpu_torch.models.multimodal import build_gather_plan
    from lavida_mod_tpu_torch.ops.gather import (gather_rows,
                                                 gather_rows_reference)
    from lavida_mod_tpu_torch.ops.short_attention import (
        short_attention, short_attention_reference)

    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device=device, generator=gen).to(
            torch.bfloat16)

    def seg(B, n, valid_rows):
        return (torch.arange(n, device=device) < valid_rows).to(
            torch.int32)[None].expand(B, n).contiguous()

    # (name, q shape, kv shape, masked, launches per request)
    cases = [
        ("siglip", (5, 729, 16, 72), (5, 729, 16, 72), False,
         SIGLIP_LAYERS),
        ("prefill", (1, 1056, 32, 128), (1, 1088, 32, 128), True,
         LLADA_LAYERS),
        ("gqa_odd", (2, 77, 8, 128), (2, 131, 2, 128), True, 0),
        ("gqa_odd_hd72", (1, 65, 4, 72), (1, 63, 2, 72), True, 0),
    ]
    attn = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "per_shape": []}
    for name, qs, ks, masked, per_request in cases:
        q, k, v = randn(*qs), randn(*ks), randn(*ks)
        sq = skv = None
        if masked:
            sq = seg(qs[0], qs[1], qs[1])
            skv = seg(ks[0], ks[1], min(qs[1], ks[1] - 3))
            if name.startswith("gqa_odd"):
                sq[:, -5:] = 2      # rows matching no key: finite average
        out = short_attention(q, k, v, sq, skv)
        torch.cuda.synchronize()
        ref = short_attention_reference(q, k, v, sq, skv)
        # p is rounded to bf16 per streamed tile (the plain version rounds
        # its single-pass p) and the online rescaling reorders the sums
        torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                                   rtol=2e-2)
        err = (out.float() - ref.float()).abs().max().item()
        ms = cuda_ms(lambda: short_attention(q, k, v, sq, skv))
        plain_ms = cuda_ms(
            lambda: short_attention_reference(q, k, v, sq, skv))
        print(f"[kernels] short_attention {name} q{qs} kv{ks} "
              f"masked={masked}: max_abs_err {err:.3e}, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
        attn["max_abs_err"] = max(attn["max_abs_err"], err)
        attn["ms"] += per_request * ms
        attn["plain_ms"] += per_request * plain_ms
        attn["per_shape"].append({"shape": name, "ms": ms,
                                  "plain_ms": plain_ms, "max_abs_err": err})

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
    g_ms = cuda_ms(lambda: gather_rows(table, idx[0]))
    g_plain = cuda_ms(lambda: gather_rows_reference(
        table, torch.as_tensor(idx[0]).to(device)))
    # the kernel alone, on an index already on the card
    idx_dev = torch.as_tensor(idx[0], device=device)
    out = torch.empty_like(ref)
    lib = kernels.library()
    stream = torch.cuda.current_stream(device).cuda_stream
    g_kernel = cuda_ms(lambda: kernels.check(lib.lavida_gather_rows(
        table.data_ptr(), idx_dev.data_ptr(), 8, out.data_ptr(),
        idx.shape[1], table.shape[1] * 2, stream), "gather_rows"))
    g_plain_dev = cuda_ms(lambda: gather_rows_reference(table, idx_dev))
    print(f"[kernels] gather_rows table{tuple(table.shape)} "
          f"idx[{idx.shape[1]}]: exact; from the host plan: wrapper "
          f"{g_ms:.4f} ms, plain {g_plain:.4f} ms; index on the card: "
          f"kernel {g_kernel:.4f} ms, plain {g_plain_dev:.4f} ms")
    gather = {"max_abs_err": 0.0, "ms": g_ms, "plain_ms": g_plain,
              "per_shape": [{"shape": "splice", "ms": g_ms,
                             "plain_ms": g_plain, "max_abs_err": 0.0,
                             "kernel_only_ms": g_kernel,
                             "plain_device_index_ms": g_plain_dev}]}
    return attn, gather


def bench_requests(rng):
    """The three bench-protocol requests of the main paths."""
    first = bench_request(48, (640, 640), rng)
    return [first, bench_request(48, (1100, 380), rng),
            (np.concatenate([first[0][:9], first[0][9:30]]), first[1],
             first[2])]


GEN = dict(max_new_tokens=32, block_length=32, step_per_block=16,
           prefix_lm=True, remasking="low_confidence")


def phase_main_path(torch, device, card):
    """Three full-width requests through generate_fused, bf16 layout."""
    from lavida_mod_tpu.config import GenerationConfig, LaViDaConfig
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
    from lavida_mod_tpu.config import GenerationConfig
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


def phase_quant_kernels(torch, device):
    """The four kernels of the mixed layout against their plain versions
    at every shape of its main path, plus a ragged/odd case each.  Returns
    {name: result} with ms / plain_ms summed over one request's launches."""
    from lavida_mod_tpu_torch.ops import quant as tq
    from lavida_mod_tpu_torch.ops import w4_fused as tw
    from lavida_mod_tpu_torch.ops import w8a8 as t8

    gen = torch.Generator(device=device).manual_seed(1)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=device, generator=gen) * scale

    def w4(K, N):
        packed, scales, _ = tq.quantize_linear4(randn(N, K, scale=0.02))
        return packed[:N // 8].contiguous(), scales[:, :N].contiguous()

    def rel(out, ref):
        return ((out.float() - ref.float()).abs().max()
                / ref.float().abs().max()).item()

    results = {}

    def record(name, shape, per_request, err, ms, plain_ms, limit, note=""):
        print(f"[kernels] {name} {shape}: max|diff|/max|ref| {err:.3e} "
              f"(limit {limit}){note}, kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms")
        r = results.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0,
                                      "plain_ms": 0.0, "per_shape": []})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += per_request * ms
        r["plain_ms"] += per_request * plain_ms
        r["per_shape"].append({"shape": shape, "ms": ms,
                               "plain_ms": plain_ms, "rel_err": err})

    # w8a8: the prefill's four linears at T = 1056, 32 layers; bit-exact
    for T, K, N, per in [(1056, 4096, 12288, LLADA_LAYERS),
                         (1056, 4096, 4096, LLADA_LAYERS),
                         (1056, 4096, 24576, LLADA_LAYERS),
                         (1056, 12288, 4096, LLADA_LAYERS),
                         (77, 4304, 1000, 0)]:
        x = randn(T, K).bfloat16()
        q, sc = tq.quantize_linear(randn(N, K, scale=0.02))
        x8, sx = t8.act_quant(x, t8.ACT_FORMULA_W8)
        out = t8.w8a8_matmul(x8, sx, q, sc)
        torch.cuda.synchronize()
        ref = t8.w8a8_matmul_reference(x8, sx, q, sc)
        if not torch.equal(out, ref):
            raise AssertionError(f"w8a8_matmul differs at {(T, K, N)}")
        record("w8a8_matmul", f"[{T},{K}]x[{K},{N}]", per, rel(out, ref),
               cuda_ms(lambda: t8.w8a8_matmul(x8, sx, q, sc)),
               cuda_ms(lambda: t8.w8a8_matmul_reference(x8, sx, q, sc), 5),
               "exact")

    steps = GEN["step_per_block"]
    # w4_qkv_norm: [q|k|v] per layer per step, and the head per step
    for T, D, N, per in [(32, 4096, 12288, LLADA_LAYERS * steps),
                         (32, 4096, 126464, steps), (40, 384, 160, 0)]:
        x = randn(T, D).bfloat16()
        nw = (1 + randn(D, scale=0.1)).bfloat16()
        packed, scales = w4(D, N)
        out = tw.w4_qkv_norm(x, nw, packed, scales, 1e-5)
        torch.cuda.synchronize()
        ref = tw.w4_qkv_norm_reference(x, nw, packed, scales, 1e-5)
        err = rel(out, ref)
        # the norm's sum of squares reduces in another order: an int8
        # code on a rounding boundary may move by one
        if not err < 1e-2:
            raise AssertionError(f"w4_qkv_norm {(T, D, N)}: {err}")
        record("w4_qkv_norm", f"[{T},{D}]x[{D},{N}]", per, err,
               cuda_ms(lambda: tw.w4_qkv_norm(x, nw, packed, scales, 1e-5)),
               cuda_ms(lambda: tw.w4_qkv_norm_reference(
                   x, nw, packed, scales, 1e-5), 5), 1e-2)

    for T, K, N, per in [(32, 4096, 4096, LLADA_LAYERS * steps),
                         (5, 384, 96, 0)]:
        a, res = randn(T, K).bfloat16(), randn(T, N).bfloat16()
        packed, scales = w4(K, N)
        out = tw.w4_matmul_res(a, res, packed, scales)
        torch.cuda.synchronize()
        ref = tw.w4_matmul_res_reference(a, res, packed, scales)
        if not torch.equal(out, ref):
            raise AssertionError(f"w4_matmul_res differs at {(T, K, N)}")
        record("w4_matmul_res", f"[{T},{K}]x[{K},{N}]", per, 0.0,
               cuda_ms(lambda: tw.w4_matmul_res(a, res, packed, scales)),
               cuda_ms(lambda: tw.w4_matmul_res_reference(
                   a, res, packed, scales), 5), "exact")

    for T, D, H, Hd, per in [(32, 4096, 12288, 12288, LLADA_LAYERS * steps),
                             (24, 256, 384, 512, 0)]:
        x = randn(T, D).bfloat16()
        nw = (1 + randn(D, scale=0.1)).bfloat16()
        up_p, up_s = w4(D, 2 * H)
        dn_p, dn_s, _ = tq.quantize_linear4(torch.nn.functional.pad(
            randn(D, H, scale=0.02), (0, Hd - H)))
        dn_p, dn_s = dn_p[:D // 8].contiguous(), dn_s[:, :D].contiguous()
        args = (x, nw, up_p, up_s, dn_p, dn_s, 1e-5)
        out = tw.w4_ffn_fused(*args)
        torch.cuda.synchronize()
        err = rel(out, tw.w4_ffn_fused_reference(*args))
        if not err < 2e-2:
            raise AssertionError(f"w4_ffn_fused {(T, D, H, Hd)}: {err}")
        record("w4_ffn_fused", f"[{T},{D}] H {H} Hd {Hd}", per, err,
               cuda_ms(lambda: tw.w4_ffn_fused(*args)),
               cuda_ms(lambda: tw.w4_ffn_fused_reference(*args), 5), 2e-2)
    return results


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


def _profile_busy(torch, model, request, gen):
    """Device time of one request from torch.profiler and its wall: (busy
    ms, wall ms, top kernels) or None when the trace shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    ids, views, size = request
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate_fused(ids, [views], [size], gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(r[1] for r in rows)
    if busy <= 0:
        return None
    rows.sort(key=lambda r: -r[1])
    return busy, wall, rows[:12]


def phase_mixed_path(torch, model, requests, card):
    """The bf16 model of phase 4 through to_serving_layout("mixed", fuse=
    True) on the card, then three requests through generate_fused."""
    from lavida_mod_tpu.config import GenerationConfig
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
            "w4_qkv_norm": (LLADA_LAYERS + 1) * GEN["step_per_block"],
            "w4_matmul_res": LLADA_LAYERS * GEN["step_per_block"],
            "w4_ffn_fused": LLADA_LAYERS * GEN["step_per_block"]}
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
    prof = _profile_busy(torch, model, first, gen)
    if prof is None:
        print("[mixed] torch.profiler: no device time in the trace; "
              "device-busy share not measured")
    else:
        busy, wall, top = prof
        print(f"[mixed] torch.profiler over request 0: device busy "
              f"{busy:.1f} ms of a {wall:.1f} ms wall ({100 * busy / wall:.1f}"
              f" %, profiler on) ({card})")
        for key, ms, n in top:
            print(f"[mixed]   {ms:9.3f} ms  {n:6d} x  {key[:90]}")
    return counts, walls, peaks, phases, steps


def phase_small_mixed(torch, device):
    """A tiny mixed-layout model (fused plan and head engaged) on the card
    against the same quantized weights on the CPU, where the four new ops
    run their plain versions."""
    import copy

    from lavida_mod_tpu.config import GenerationConfig
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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none found")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    from lavida_mod_tpu_torch import kernels

    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.library()
    print(f"[build] {lib_path.name} in {time.perf_counter() - t0:.2f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    with torch.no_grad():
        attn, gather = phase_kernels(torch, device)
        quant = phase_quant_kernels(torch, device)
    torch.cuda.empty_cache()
    model, requests, counts, walls = phase_main_path(torch, device, card)
    mixed_counts, mixed_walls, peaks, phases, steps = phase_mixed_path(
        torch, model, requests, card)
    del model
    torch.cuda.empty_cache()
    phase_small_reference(torch, device)
    phase_small_mixed(torch, device)

    def entry(name, source, replaces, launches, res):
        return {"name": name, "route": "cuda",
                "source": f"lavida_mod_tpu_torch/csrc/{source}",
                "replaces": f"lavida_mod_tpu/ops/{replaces}",
                "launches": launches, **res}

    entries = [
        entry("short_attention", "short_attention.cu",
              "short_attention.py:78", counts["short_attention"], attn),
        entry("gather_rows", "gather_rows.cu", "pallas_gather.py:26",
              counts["gather_rows"], gather),
        entry("w8a8_matmul", "w8a8_matmul.cu", "pallas_w8.py:53",
              mixed_counts["w8a8_matmul"], quant["w8a8_matmul"]),
        entry("w4_qkv_norm", "w4_fused.cu", "w4_fused.py:80",
              mixed_counts["w4_qkv_norm"], quant["w4_qkv_norm"]),
        entry("w4_matmul_res", "w4_fused.cu", "w4_fused.py:250",
              mixed_counts["w4_matmul_res"], quant["w4_matmul_res"]),
        entry("w4_ffn_fused", "w4_fused.cu", "w4_fused.py:322",
              mixed_counts["w4_ffn_fused"], quant["w4_ffn_fused"]),
    ]
    for e in entries[:2]:
        e["launches_mixed_path"] = mixed_counts[e["name"]]
    print("[result] kernel ms/plain_ms: summed over one request's launches "
          "(bf16 path: 26 SigLIP + 32 prefill short_attention, 1 "
          "gather_rows; mixed path: 128 w8a8_matmul, 16 x 33 w4_qkv_norm, "
          "16 x 32 w4_matmul_res and w4_ffn_fused); launches: each "
          "path's three requests; request walls bf16 "
          f"{[round(w * 1e3, 1) for w in walls]} ms, mixed "
          f"{[round(w * 1e3, 1) for w in mixed_walls]} ms, mixed peak "
          f"{[round(p, 2) for p in peaks]} GiB on {card}")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))

if __name__ == "__main__":
    main()
