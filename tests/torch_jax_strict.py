"""Run JAX reference code in a child process with XLA's excess precision off.

XLA on the CPU removes a round trip f32 -> bf16 -> f32 when it can
(`--xla_allow_excess_precision`, on by default), so a JAX function that
rounds an intermediate to bf16 and computes on is evaluated without that
rounding.  The port rounds where the code says so, as the CUDA kernels do.
With the flag off the two agree bit for bit; the flag is read once per
process, so the references are computed in a child process, never in the
test process (tests/conftest.py has set up JAX there already).

`strict_jax(code, tmp_path, inputs)` runs `code` in `python -c` with JAX on
the CPU; the code reads the numpy arrays of `inputs` from the dict `IN`,
fills a dict `OUT` with numpy arrays, and `strict_jax` returns it.

Whole generations are compared teacher-forced: `JAX_STEPS` (code for the
child) records JAX's token buffer before every denoise step and that
step's logits, and `teacher_forced` runs the port's step from each of
them, so a last-bit difference that reorders a near-tie of the commits
cannot cascade into the rest of the loop.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]

_PRELUDE = """
import numpy as np
with np.load(__in_path__) as _z:
    IN = {k: _z[k] for k in _z.files}
OUT = {}
"""

_EPILOGUE = """
np.savez(__out_path__, **OUT)
"""


# The JAX side of a teacher-forced comparison, as code for the strict child:
# `jax_steps` replays the prealloc branch of the JAX decode
# (_generate_cached_fused_body, or generate_chunked_prefill's chunk
# prefills with `chunk`), kv8 (True: int8, 4: int4) quantized at decode
# entry, one denoise step
# at a time, and returns the token buffer before and after every step
# [steps + 1, B, G] and every step's logits [steps, B, G, V] (and, with
# keep_cache, the decode-entry cache: the arrays of each layer's tuple in
# order, codes as int8, bf16 as f32).  jit_kv4=False quantizes an int4
# cache op by op (the quotient) instead of as the jitted decode does;
# replay [steps + 1, B, G] runs step i from replay[i] instead.
JAX_STEPS = """
def jax_steps(dec_p, lc, prefix, gen, prefix_valid=None, kv8=False,
              pre_p=None, act_int8=False, chunk=None, keep_cache=False,
              jit_kv4=True, replay=None):
    import jax, jax.numpy as jnp, numpy as np
    from lavida_mod_tpu.generation import diffusion as jd
    from lavida_mod_tpu.models import llada as jl
    from lavida_mod_tpu.ops import sampling as js
    from lavida_mod_tpu.ops.kv8_attention import quantize_kv
    pre_p = dec_p if pre_p is None else pre_p
    B, P, _ = prefix.shape
    G = gen.max_new_tokens
    Hkv, hd = lc.effective_n_kv_heads, lc.head_dim
    kvv = None if prefix_valid is None else jnp.concatenate(
        [prefix_valid, jnp.ones((B, G), bool)], axis=1)
    if chunk:
        starts = list(range(0, B - chunk + 1, chunk))
        if starts[-1] + chunk < B:
            starts.append(B - chunk)
        cache = jd._alloc_kv_buffers(lc.n_layers, B, P + G, Hkv, hd,
                                     prefix.dtype)
        for lo in starts:
            cache = jd._chunk_prefill_prealloc(
                cache, pre_p, lc, prefix[lo:lo + chunk],
                None if prefix_valid is None else prefix_valid[lo:lo + chunk],
                jnp.int32(lo), True, act_int8=act_int8)
    else:
        z = jnp.zeros((B, P + G, Hkv, hd), prefix.dtype)
        _, cache = jl.forward(
            pre_p, lc, prefix, kv_cache=[(z, z)] * lc.n_layers,
            kv_write_index=jnp.asarray(0, jnp.int32), kv_valid=kvv,
            self_valid=prefix_valid, use_cache=True, return_logits=False,
            use_flash=True, act_int8=act_int8)
    import lavida_mod_tpu.ops.kv8_attention as jkv
    write_rows = jkv.write_rows
    if kv8 == 4 and jit_kv4:
        # JAX's decode quantizes the int4 cache inside jit, where XLA
        # multiplies by f32(1 / 7) where op-by-op JAX divides by 7; on the
        # int4 grid one code apart moves this model's logits by tens of
        # percent, so the steps quantize as the decode does (the port's
        # int4 path takes the same product)
        quantize_kv = jax.jit(quantize_kv, static_argnums=1)
        jkv.write_rows = jax.jit(write_rows)
    if kv8:
        bits = 4 if kv8 == 4 else 8
        cache = [(*quantize_kv(k, bits), *quantize_kv(v, bits))
                 for k, v in cache]
    cache0 = [np.asarray(a).astype(np.float32 if a.dtype == jnp.bfloat16
                                   else np.int8 if a.dtype == jnp.int4
                                   else a.dtype)
              for layer in cache for a in layer] if keep_cache else None
    mask = lc.mask_token_id
    x = jnp.full((B, G), mask, jnp.int32)
    k_table, block_end = jd.build_control_table(np.asarray(x), 0, G, gen,
                                                mask)
    positions = jnp.arange(P, P + G, dtype=jnp.int32)
    key = jax.random.PRNGKey(0)
    xs, logits_all = [np.asarray(x)], []
    for i in range(k_table.shape[0]):
        key, sk = jax.random.split(key)
        if replay is not None:
            x = jnp.asarray(replay[i])
        logits, cache = jl.forward(
            dec_p, lc, jl.embed_tokens(dec_p, x), positions=positions,
            kv_cache=cache, kv_valid=kvv, kv_write_index=P, use_cache=True)
        x = js.denoise_commit(
            x, logits, x == mask, jnp.asarray(k_table[i]),
            jnp.asarray(block_end[i]), temperature=gen.temperature,
            remasking=gen.remasking, key=sk)
        xs.append(np.asarray(x))
        logits_all.append(np.asarray(logits))
    jkv.write_rows = write_rows
    if keep_cache:
        return np.stack(xs), np.stack(logits_all), cache0
    return np.stack(xs), np.stack(logits_all)
"""


def teacher_forced(model, prefix, gen, xs, jax_logits, *, prefix_valid=None,
                   kv8=False, chunk=None, band=0.05, cache=None, step=None):
    """The port's half of a teacher-forced comparison.  `model` is a port
    LaViDa; prefix [B, P, D] the prefix embeddings to prefill from (JAX's,
    so both start from the same input); xs / jax_logits what `jax_steps`
    recorded.  The port prefills its cache as its
    generate path does (or starts from `cache`, a decode-entry cache given
    as the port holds it), then runs ONE decode step from each of JAX's
    buffers x_t, so a difference cannot cascade (`step`, x [B, G] ->
    logits [B, G, V], replaces that decode step, e.g. by the no-cache
    forward).  At every step:
      - the port's logits are within `band` of max |JAX logit| (a number,
        or one per step);
      - each row commits the positions JAX commits, and the same tokens
        there, except at a near-tie: where the k-th and (k+1)-th largest
        confidences of the row are within 4 * delta of each other in log
        space (delta = the row's largest |logit difference|, which moves a
        log-softmax value by at most 2 * delta), or, for a token, where the
        top two logits are within 2 * delta.
    Returns the near-tie exceptions as (step, row, gap, bound) tuples (gap
    the log-confidence or logit gap, bound 4 or 2 * delta); raises on any
    other difference."""
    import torch

    from lavida_mod_tpu_torch.generation import diffusion as td
    from lavida_mod_tpu_torch.ops import sampling as ts

    lm = model.llada
    B, P, _ = prefix.shape
    G = gen.max_new_tokens
    mask = lm.cfg.mask_token_id
    if cache is None and step is None:
        cache = td.prefill_cache(lm, prefix, G, prefix_valid, model.mixed,
                                 kv8, chunk)
    kvv = None if prefix_valid is None else torch.cat(
        [prefix_valid, torch.ones(B, G, dtype=torch.bool)], dim=1)
    k_table, block_end = td.build_control_table(
        np.full((B, G), mask, np.int64), 0, G, gen, mask)
    assert len(xs) == k_table.shape[0] + 1
    exceptions = []
    for i in range(k_table.shape[0]):
        x = torch.as_tensor(xs[i]).long()
        with torch.no_grad():
            if step is not None:
                logits = step(x)
            else:
                logits, _ = lm(lm.embed_tokens(x),
                               positions=torch.arange(P, P + G),
                               kv_cache=cache, kv_valid=kvv,
                               kv_write_index=P, use_cache=True)
        ref = torch.as_tensor(jax_logits[i]).float()
        rel = ((logits - ref).abs().max() / ref.abs().max()).item()
        assert rel < (band if np.isscalar(band) else band[i]), (i, rel)
        new = ts.denoise_commit(x, logits, x == mask,
                                torch.as_tensor(k_table[i]).long(),
                                int(block_end[i]))
        want = torch.as_tensor(xs[i + 1]).long()
        for b in range(B):
            delta = (logits[b] - ref[b]).abs().max().item()
            got_set, want_set = new[b] != x[b], want[b] != x[b]
            if not torch.equal(got_set, want_set):
                masked = (x[b] == mask) & (torch.arange(G) < int(block_end[i]))
                conf = torch.softmax(ref[b], -1).amax(-1)[masked]
                k = int(k_table[i, b])
                top = torch.sort(conf.log(), descending=True).values
                gap = (top[k - 1] - top[k]).item() if k < len(top) else 0.0
                assert gap <= 4 * delta, (i, b, gap, delta)
                exceptions.append((i, b, round(gap, 4), round(4 * delta, 4)))
                continue
            for t in torch.nonzero(got_set & (new[b] != want[b]))[:, 0]:
                top2 = torch.topk(ref[b, t], 2).values
                gap = (top2[0] - top2[1]).item()
                assert gap <= 2 * delta, (i, b, t)
                exceptions.append((i, b, round(gap, 4), round(2 * delta, 4)))
    return exceptions


def strict_jax(code: str, tmp_path: pathlib.Path, inputs: dict | None = None,
               timeout: int = 600) -> dict:
    src, out = tmp_path / "strict_in.npz", tmp_path / "strict_out.npz"
    np.savez(src, **(inputs or {}))
    script = (_PRELUDE + textwrap.dedent(code) + _EPILOGUE).replace(
        "__out_path__", repr(str(out))).replace("__in_path__", repr(str(src)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_allow_excess_precision=false"
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"JAX reference failed:\n{proc.stderr[-4000:]}")
    with np.load(out) as z:
        return {k: z[k] for k in z.files}
