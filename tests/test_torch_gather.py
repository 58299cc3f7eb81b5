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
