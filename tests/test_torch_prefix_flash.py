"""The port's prefix-LM flash attention (lavida_mod_tpu_torch.ops.
prefix_flash, kernel #10) against the JAX package's three Pallas kernels
run in interpret mode on the CPU.

On CPU tensors the port runs its plain versions: the forward (o, lse) and
the autograd Function's dq, dk, dv are held to `prefix_flash_attention`
(and its `_fwd` for the lse) at the JAX tests' own tolerances in f32
(tests/test_prefix_flash.py: 2e-5 forward, 3e-4 gradients), and within a
stated band in bf16.  The JAX side runs in a strict child
(tests/torch_jax_strict.py) with `_INTERPRET[0] = True`, all cases in one
process.  Its blocks are 128 rows, so the case with 130 masked leading keys
gives every row a first K/V block with no visible key (the CUDA kernels'
128-key tiles are checked on such rows by the cuda cases).

The `-k cuda` cases compare the CUDA kernels with the plain versions on
the card and skip without one:
    python -m pytest --noconftest -k cuda tests/test_torch_prefix_flash.py
"""

import numpy as np
import pytest
import torch

from lavida_mod_tpu_torch.ops import prefix_flash as tpf
from torch_jax_strict import strict_jax

torch.set_num_threads(2)

# name: (B, T, Hq, Hkv, hd, plen per row, valid keys per row, bf16)
CASES = {
    "mha_ragged": (2, 200, 4, 4, 64, [0, 64], [200, 150], False),
    "gqa_plen_past_T": (2, 256, 4, 2, 64, [37, 300], [256, 230], False),
    "gqa_first_block_masked": (2, 160, 4, 2, 32, [0, 140], [160, 150], False),
    "gqa_bf16": (2, 200, 4, 2, 64, [50, 0], [200, 170], True),
    # batch row 1 sees no key: its rows divide by the padded key count
    "blind_row": (2, 200, 4, 2, 64, [0, 50], [200, 0], False),
    "blind_row_long": (2, 600, 2, 1, 32, [100, 30], [550, 0], False),
}
# cases the JAX side runs at its default 512-row blocks (S > 512 pads to a
# multiple of 512, not of 128); the others at 128
DEFAULT_BLOCKS = ("blind_row_long",)


def _inputs(name):
    B, T, Hq, Hkv, hd, plen, nvalid, bf16 = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    arr = {n: rng.standard_normal(s).astype(np.float32) for n, s in (
        ("q", (B, T, Hq, hd)), ("k", (B, T, Hkv, hd)), ("v", (B, T, Hkv, hd)),
        ("do", (B, T, Hq, hd)))}
    if bf16:   # bf16-representable values: both sides start from the same
        arr = {n: torch.from_numpy(a).bfloat16().float().numpy()
               for n, a in arr.items()}
    valid = np.arange(T)[None] < np.asarray(nvalid)[:, None]
    if name == "gqa_first_block_masked":
        valid[:, :130] = False
    arr["valid"] = valid
    arr["plen"] = np.asarray(plen, np.int32)
    return arr


_JAX = """
import jax, jax.numpy as jnp
from lavida_mod_tpu.ops import prefix_flash as pf
pf._INTERPRET[0] = True
for name, bf16, blk in NAMES:
    dt = jnp.bfloat16 if bf16 else jnp.float32
    q, k, v, do = (jnp.asarray(IN[name + n], dt) for n in ("q", "k", "v", "do"))
    plen, valid = jnp.asarray(IN[name + "plen"]), jnp.asarray(IN[name + "valid"])
    f = lambda q, k, v: pf.prefix_flash_attention(
        q, k, v, plen, valid, block_q=blk, block_k=blk)
    o, vjp = jax.vjp(f, q, k, v)
    dq, dk, dv = vjp(do)
    B, T, Hq, hd = q.shape
    bq = min(blk, -(-T // 128) * 128)
    Tp = -(-T // bq) * bq
    pad = lambda a: jnp.pad(a, ((0, 0), (0, Tp - T)) + ((0, 0),) * (a.ndim - 2))
    _, lse = pf._fwd(pad(q).transpose(0, 2, 1, 3), pad(k).transpose(0, 2, 1, 3),
                     pad(v).transpose(0, 2, 1, 3), plen,
                     pad(valid).astype(jnp.int32)[:, None, :],
                     scale=hd ** -0.5, bq=bq, bk=bq)
    for n, a in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv),
                 ("lse", lse[:, :, 0, :T])):
        OUT[name + n] = np.asarray(a.astype(jnp.float32))
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    inputs = {name + n: a for name in CASES
              for n, a in _inputs(name).items()}
    names = [(name, CASES[name][-1], 512 if name in DEFAULT_BLOCKS else 128)
             for name in CASES]
    return strict_jax(f"NAMES = {names!r}\n" + _JAX,
                      tmp_path_factory.mktemp("prefix_flash"), inputs)


def _port(name):
    a = _inputs(name)
    dt = torch.bfloat16 if CASES[name][-1] else torch.float32
    q, k, v = (torch.from_numpy(a[n]).to(dt).requires_grad_()
               for n in ("q", "k", "v"))
    plen, valid = torch.from_numpy(a["plen"]), torch.from_numpy(a["valid"])
    o = tpf.prefix_flash_attention(q, k, v, plen, valid)
    o.backward(torch.from_numpy(a["do"]).to(dt))
    _, lse = tpf.prefix_flash_fwd(q.detach(), k.detach(), v.detach(), plen,
                                  valid)
    return {"o": o, "lse": lse, "dq": q.grad, "dk": k.grad, "dv": v.grad}


@pytest.mark.parametrize("name", [n for n in CASES if not CASES[n][-1]])
def test_f32_matches_jax_kernels(jax_ref, name):
    got = _port(name)
    for n in ("o", "lse"):
        np.testing.assert_allclose(got[n].detach().numpy(), jax_ref[name + n],
                                   atol=2e-5, rtol=2e-5, err_msg=n)
    for n in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[n].numpy(), jax_ref[name + n],
                                   atol=3e-4, rtol=3e-4, err_msg=n)


def test_bf16_within_band_of_jax_kernels(jax_ref):
    """bf16: the TPU kernel rounds p per 128-key block against its running
    max, the plain version once against the row max, and both round ds;
    outputs agree within 2 % of each tensor's largest magnitude, the lse
    (f32 from exact bf16 products) within 1e-4."""
    name = "gqa_bf16"
    got = _port(name)
    np.testing.assert_allclose(got["lse"].numpy(), jax_ref[name + "lse"],
                               atol=1e-4, rtol=1e-4)
    for n in ("o", "dq", "dk", "dv"):
        ref = jax_ref[name + n]
        err = np.abs(got[n].detach().float().numpy() - ref).max()
        assert err <= 0.02 * np.abs(ref).max(), (n, err)


def test_plain_matches_dense_masked_softmax():
    """The plain forward is masked softmax attention: against the port's
    dense_attention with make_bias's prefix mask, and a row whose keys are
    all hidden gets the sum of v over the padded key count (T = 70 pads to
    128, as the TPU wrapper's zero pad keys do)."""
    from lavida_mod_tpu_torch.ops.attention import dense_attention, make_bias

    g = torch.Generator().manual_seed(0)
    B, T, Hq, Hkv, hd = 2, 70, 4, 2, 16
    q, k, v = (torch.randn(B, T, h, hd, generator=g)
               for h in (Hq, Hkv, Hkv))
    plen = torch.tensor([10, 0])
    valid = torch.arange(T)[None] < torch.tensor([[70], [60]])
    bias = make_bias(kv_valid=valid, prefix_lengths=plen,
                     q_positions=torch.arange(T), kv_positions=torch.arange(T))
    o, lse = tpf.prefix_flash_fwd(q, k, v, plen, valid)
    torch.testing.assert_close(o, dense_attention(q, k, v, bias=bias),
                               atol=2e-6, rtol=2e-6)
    assert lse.shape == (B, Hq, T)
    o, _ = tpf.prefix_flash_fwd(q, k, v, plen, torch.zeros(B, T, dtype=bool))
    assert tpf.padded_keys(T) == 128
    torch.testing.assert_close(
        o, (v.sum(1, keepdim=True) / 128).repeat_interleave(Hq // Hkv, 2)
        .expand(B, T, Hq, hd), atol=2e-6, rtol=2e-6)


def test_cpu_does_not_launch_kernels():
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 9, 2, 8, generator=g).requires_grad_()
               for _ in range(3))
    before = (tpf.prefix_flash_fwd.launches, tpf.prefix_flash_dq.launches,
              tpf.prefix_flash_dkv.launches)
    tpf.prefix_flash_attention(q, k, v, torch.tensor([4])).sum().backward()
    assert q.grad is not None and k.grad is not None and v.grad is not None
    assert (tpf.prefix_flash_fwd.launches, tpf.prefix_flash_dq.launches,
            tpf.prefix_flash_dkv.launches) == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


# (B, T, S, Hq, Hkv, hd, plen per row, keys valid up to, keys hidden from
# the start): the edges of the Hopper design (128-row query and key tiles,
# 64-row query tiles in dkv, tiles skipped where no row sees a key)
CUDA_CASES = [
    # the stage-1 shape, cut in B: the valid tail ends mid-tile, the query
    # tiles below plen see no key tile past it
    (2, 1152, 1152, 32, 32, 128, [1010, 1003], [1058, 1051], 0),
    (2, 200, 200, 28, 4, 128, [0, 250], [193, 200], 0),   # G 7, plen 0, >= T
    # hd 72; rows below plen see no key (every valid key lies past it)
    (1, 150, 150, 4, 2, 72, [30], [143], 70),
    (2, 77, 77, 4, 1, 16, [5, 77], [70, 70], 0),          # hd 16, G 4
    (3, 300, 300, 8, 8, 64, [127, 128, 129], [290, 300, 257], 0),
    (2, 1, 1, 4, 4, 128, [0, 1], [1, 1], 0),              # T = S = 1
    (2, 1, 200, 4, 1, 128, [0, 5], [200, 150], 0),        # T = 1, G 4
    (1, 333, 190, 14, 2, 40, [100], [185], 0),            # T > S, hd 40, G 7
    (1, 130, 130, 2, 2, 32, [50], [0], 0),                # no row sees a key
    (1, 256, 256, 4, 4, 96, [64], [256], 0),              # hd 96
    # batch row 1 sees no key: divided by the padded count 1024 (S > 512)
    (2, 600, 600, 4, 2, 64, [100, 30], [590, 0], 0),
]


@pytest.mark.parametrize("B,T,S,Hq,Hkv,hd,plen,n_valid,masked_head",
                         CUDA_CASES)
def test_kernels_match_plain_on_cuda(cuda, B, T, S, Hq, Hkv, hd, plen,
                                     n_valid, masked_head):
    """Each case twice: the second time with new data at the same addresses
    (the wrappers take their TMA maps from a cache keyed by address)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.empty(B, T, Hq, hd, device=cuda, dtype=torch.bfloat16)
    dout = torch.empty_like(q)
    k, v = (torch.empty(B, S, Hkv, hd, device=cuda, dtype=torch.bfloat16)
            for _ in range(2))
    plen = torch.tensor(plen, dtype=torch.int32, device=cuda)
    kpos = torch.arange(S, device=cuda)[None]
    valid = ((kpos < torch.tensor(n_valid, device=cuda)[:, None])
             & (kpos >= masked_head)).int()
    for _ in range(2):
        for t in (q, k, v, dout):
            t.copy_(torch.randn(t.shape, generator=g, device=cuda))
        launches = (tpf.prefix_flash_fwd.launches,
                    tpf.prefix_flash_dq.launches,
                    tpf.prefix_flash_dkv.launches)
        o, lse = tpf.prefix_flash_fwd(q, k, v, plen, valid)
        o_ref, lse_ref = tpf.prefix_flash_fwd_reference(q, k, v, plen, valid)
        delta = tpf.attention_delta(dout, o_ref)
        args = (q, k, v, plen, valid, dout, lse_ref, delta)
        dq = tpf.prefix_flash_dq(*args)
        dk, dv = tpf.prefix_flash_dkv(*args)
        torch.cuda.synchronize()
        assert (tpf.prefix_flash_fwd.launches, tpf.prefix_flash_dq.launches,
                tpf.prefix_flash_dkv.launches) == tuple(n + 1
                                                        for n in launches)
        # p is rounded to bf16 per key tile against the running max (the
        # plain version once against the row max); sums run in another
        # order.  A row that sees no key averages v over the S keys in both.
        torch.testing.assert_close(o.float(), o_ref.float(), atol=2e-2,
                                   rtol=2e-2)
        torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=1e-4)
        dk_ref, dv_ref = tpf.prefix_flash_dkv_reference(*args)
        for name, got, ref in (("dq", dq,
                                tpf.prefix_flash_dq_reference(*args)),
                               ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
            if S == 1 and name != "dv":
                # one key: p = 1 and dP = delta, so dS is 0 in exact
                # arithmetic and dq, dk are both sides' rounding noise
                # (read on an H100: 1e-6)
                assert max(got.float().abs().max(),
                           ref.float().abs().max()) < 1e-4, name
                continue
            # within 2e-2 of the tensor's largest magnitude; exact zeros
            # where no pair is visible
            err = (got.float() - ref.float()).abs().max()
            assert err <= 2e-2 * ref.float().abs().max(), (name, err)


def test_kernels_take_no_kv_valid_on_cuda(cuda):
    """kv_valid=None means every key is valid, on the card as on the CPU."""
    g = torch.Generator(device=cuda).manual_seed(1)
    B, T, Hq, Hkv, hd = 2, 100, 4, 2, 64
    q, dout = (torch.randn(B, T, Hq, hd, generator=g, device=cuda).bfloat16()
               for _ in range(2))
    k, v = (torch.randn(B, T, Hkv, hd, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    plen = torch.tensor([30, 0], dtype=torch.int32, device=cuda)
    ones = torch.ones(B, T, dtype=torch.int32, device=cuda)
    o, lse = tpf.prefix_flash_fwd(q, k, v, plen)
    o_ref, lse_ref = tpf.prefix_flash_fwd(q, k, v, plen, ones)
    delta = tpf.attention_delta(dout, o_ref)
    rest = (dout, lse_ref, delta)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    assert torch.equal(tpf.prefix_flash_dq(q, k, v, plen, None, *rest),
                       tpf.prefix_flash_dq(q, k, v, plen, ones, *rest))
    for got, ref in zip(tpf.prefix_flash_dkv(q, k, v, plen, None, *rest),
                        tpf.prefix_flash_dkv(q, k, v, plen, ones, *rest)):
        assert torch.equal(got, ref)
