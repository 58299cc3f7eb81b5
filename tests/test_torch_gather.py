"""The port's row gather (lavida_mod_tpu_torch.ops.gather) against the JAX
package's Pallas kernel run in interpret mode on the CPU: exact.

On a CPU table the wrapper runs its plain version; the CUDA kernel is
checked against it by the test that needs a card (skipped without one)
and by chip_smoke.py.

jax is imported only by the test that compares with it, so the CUDA
tests also run on a GPU machine without jax:
    python -m pytest --noconftest -k cuda tests/test_torch_gather.py
"""

import numpy as np
import pytest
import torch

from lavida_mod_tpu_torch.ops.gather import gather_rows

torch.set_num_threads(2)


@pytest.mark.parametrize("D", [128, 1024])
@pytest.mark.parametrize("T", [1, 7, 33])
def test_plain_matches_jax_kernel(D, T):
    jnp = pytest.importorskip("jax.numpy")
    from lavida_mod_tpu.ops.pallas_gather import gather_rows as j_gather

    rng = np.random.default_rng(D + T)
    table = rng.standard_normal((50, D)).astype(np.float32)
    idx = rng.integers(0, 50, size=T).astype(np.int32)
    out_j = np.asarray(j_gather(jnp.asarray(table), jnp.asarray(idx),
                                interpret=True))
    np.testing.assert_array_equal(
        gather_rows(torch.from_numpy(table), idx).numpy(), out_j)


@pytest.mark.parametrize("idx_kind", ["numpy64", "numpy32", "tensor"])
def test_host_plan_types(idx_kind):
    table = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    idx = np.array([9, 0, 3, 3])
    idx = {"numpy64": idx, "numpy32": idx.astype(np.int32),
           "tensor": torch.from_numpy(idx)}[idx_kind]
    out = gather_rows(table, idx)
    assert torch.equal(out, table[torch.as_tensor(np.asarray(idx))])


@pytest.mark.parametrize("bad", [np.array([0, 10]), np.array([-1, 2])])
def test_out_of_range_plan_raises(bad):
    with pytest.raises(IndexError):
        gather_rows(torch.zeros(10, 4), bad)


def test_rejects_non_plan_index():
    with pytest.raises(ValueError):
        gather_rows(torch.zeros(10, 4), np.array([0.5, 1.0]))
    with pytest.raises(ValueError):
        gather_rows(torch.zeros(10, 4), np.zeros((2, 2), np.int64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vjp_matches_jax_gather_rows_ad(dtype):
    """The scatter-add backward against jax.vjp of the TPU version's
    custom-VJP gather (`gather_rows_ad`, interpret mode) with duplicate
    indices: f32 accumulation, then the table's dtype; equal."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from lavida_mod_tpu.ops.pallas_gather import gather_rows_ad

    rng = np.random.default_rng(7)
    table = rng.standard_normal((20, 128)).astype(np.float32)
    idx = np.concatenate([rng.integers(0, 20, 40), [3, 3, 3, 3, 11, 11]])
    g = rng.standard_normal((len(idx), 128)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    _, vjp = jax.vjp(lambda t: gather_rows_ad(t, jnp.asarray(idx, jnp.int32),
                                              interpret=True),
                     jnp.asarray(table, jdt))
    ref = np.asarray(vjp(jnp.asarray(g, jdt))[0].astype(jnp.float32))
    tdt = getattr(torch, dtype)
    t = torch.from_numpy(table).to(tdt).requires_grad_()
    gather_rows(t, idx).backward(torch.from_numpy(g).to(tdt))
    assert t.grad.dtype == tdt
    np.testing.assert_array_equal(t.grad.float().numpy(), ref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("N,D,dtype", [
    (1031, 4096, torch.bfloat16),   # the splice table
    (50, 13, torch.bfloat16),       # 26-byte rows: narrow vectors
    (30, 6, torch.float32),
])
def test_kernel_matches_plain_on_cuda(cuda, N, D, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    table = torch.randn(N, D, generator=g, device=cuda).to(dtype)
    idx = np.random.default_rng(0).integers(0, N, size=1056)
    before = gather_rows.launches
    out = gather_rows(table, idx)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert torch.equal(out, table[torch.as_tensor(idx, device=cuda)])
