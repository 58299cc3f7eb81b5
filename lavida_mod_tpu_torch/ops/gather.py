"""Row gather `table[idx]`: the port of lavida_mod_tpu/ops/pallas_gather.py
(`gather_rows`, the Pallas TPU kernel that streams the multimodal splice).

The indices are a host plan (`models.multimodal.build_gather_plan` makes
them in numpy), so `gather_rows` range-checks them on the host, where the
check costs no device sync, and uploads them with the launch.  A table on
a CUDA device launches the hand-written kernel in `csrc/gather_rows.cu`; a
table on the CPU takes `gather_rows_reference`, the plain PyTorch version.
There is no fallback from one to the other.

Differentiable in the table (`_GatherRows`): the backward is the TPU
version's VJP (`_gather_rows_ad_for`, pallas_gather.py:95-111), a
scatter-add of the output gradient into a zero table accumulated in f32
(`index_add_`, duplicate indices add up) and cast to the table's dtype, on
the CPU as on the card.  JAX's CPU path differentiates a plain `table[idx]`
instead, whose transpose adds duplicates in the table's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels


def gather_rows_reference(table: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: table [N, D], idx [T] -> [T, D]."""
    return table[idx]


def _host_index(idx, n_rows: int) -> torch.Tensor:
    """The plan as a CPU int32/int64 tensor, every entry in [0, n_rows)."""
    if isinstance(idx, np.ndarray):
        idx = torch.from_numpy(np.ascontiguousarray(idx))
    if not isinstance(idx, torch.Tensor) or idx.is_cuda:
        raise TypeError("gather_rows: idx must be a host plan (numpy array "
                        "or CPU tensor), checked before upload")
    if idx.dim() != 1 or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"gather_rows: idx must be 1-D int32/int64, got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n_rows):
        raise IndexError(f"gather_rows: index out of [0, {n_rows}): "
                         f"[{int(idx.min())}, {int(idx.max())}]")
    return idx


def _forward(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if not table.is_cuda:
        return gather_rows_reference(table, idx)
    if not table.is_contiguous() or table.data_ptr() % 16:
        raise ValueError("gather_rows: table must be contiguous and "
                         "16-byte aligned")
    T, D = idx.shape[0], table.shape[1]
    out = torch.empty((T, D), dtype=table.dtype, device=table.device)
    if T == 0 or D == 0:
        return out
    idx_dev = idx.to(table.device, non_blocking=True)
    err = kernels.library().lavida_gather_rows(
        table.data_ptr(), idx_dev.data_ptr(), idx_dev.element_size(),
        out.data_ptr(), T, D * table.element_size(),
        torch.cuda.current_stream(table.device).cuda_stream)
    kernels.check(err, "gather_rows")
    gather_rows.launches += 1
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.idx, ctx.shape, ctx.dtype = idx, table.shape, table.dtype
        return _forward(table, idx)

    @staticmethod
    def backward(ctx, g):
        dtable = torch.zeros(ctx.shape, dtype=torch.float32, device=g.device)
        dtable.index_add_(0, ctx.idx.to(g.device), g.float())
        return dtable.to(ctx.dtype), None


def gather_rows(table: torch.Tensor, idx) -> torch.Tensor:
    """table [N, D] (any dtype) gathered at the host plan idx [T] (numpy or
    CPU tensor, int32 or int64, every entry in [0, N)).  Returns [T, D] on
    the table's device; differentiable in the table."""
    if table.dim() != 2:
        raise ValueError(f"gather_rows: table must be 2-D, got "
                         f"{tuple(table.shape)}")
    return _GatherRows.apply(table, _host_index(idx, table.shape[0]))


gather_rows.launches = 0
