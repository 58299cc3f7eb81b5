#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (lavida_mod_tpu_torch) on one
NVIDIA GPU.  Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one printed line or more each; any failure raises, so the script
exits non-zero and never prints the final line:
  1. device: a CUDA card is required (no CPU fallback); its name and power
     limit as nvidia-smi reports them; TF32 off for matmuls and cuDNN.
  2. build: nvcc compiles the port's CUDA kernels from csrc/ (timed).
  3. kernels vs their plain PyTorch versions on the card, at the main
     path's shapes plus a GQA/odd-length case: max error and time of each.
  4. the main path at full width: LaViDaConfig() (LLaDA-8B + SigLIP
     so400m) in bf16 with random weights made on the card from seed 0,
     three requests through LaViDa.generate_fused (gen 32, 16 steps, prefix
     cache), each checked for shape, no mask token left, and exactly 26 + 32
     short_attention launches and 1 gather_rows launch.
  5. output check on a small input: a tiny model in bf16 on the card
     against the same weights in f32 on the CPU (plain path).
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


def phase_main_path(torch, device, card):
    """Three full-width requests through generate_fused."""
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
    gen = GenerationConfig(max_new_tokens=32, block_length=32,
                           step_per_block=16, prefix_lm=True,
                           remasking="low_confidence")
    rng = np.random.default_rng(0)
    first = bench_request(48, (640, 640), rng)
    requests = [first, bench_request(48, (1100, 380), rng),
                (np.concatenate([first[0][:9], first[0][9:30]]), first[1],
                 first[2])]
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
    del model
    torch.cuda.empty_cache()
    return counts, walls


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
    counts, walls = phase_main_path(torch, device, card)
    phase_small_reference(torch, device)

    entries = [
        {"name": "short_attention", "route": "cuda",
         "source": "lavida_mod_tpu_torch/csrc/short_attention.cu",
         "replaces": "lavida_mod_tpu/ops/short_attention.py:78",
         "launches": counts["short_attention"], **attn},
        {"name": "gather_rows", "route": "cuda",
         "source": "lavida_mod_tpu_torch/csrc/gather_rows.cu",
         "replaces": "lavida_mod_tpu/ops/pallas_gather.py:26",
         "launches": counts["gather_rows"], **gather},
    ]
    print("[result] kernel ms/plain_ms: summed over one request's launches "
          "(26 SigLIP + 32 prefill short_attention, 1 gather_rows); "
          f"request walls {[round(w * 1e3, 1) for w in walls]} ms on {card}")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
