"""The device mesh: the port of lavida_mod_tpu/parallel/mesh.py on
torch.distributed.

One `DeviceMesh` with the dims

  dp    pure data parallel (the gradient all-reduce)
  fsdp  parameter sharding (ZeRO-3's counterpart): weights sharded at rest
        and gathered per layer as the forward consumes them, their
        gradients reduce-scattered back
  tp    Megatron tensor parallel over attention heads / the MLP hidden

over the ranks of the process group (one card each under NCCL, or CPU
processes under gloo).  `maybe_init_distributed` brings the group up from
the torchrun environment.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

AXES = ("dp", "fsdp", "tp")


def maybe_init_distributed(device="cuda") -> bool:
    """init_process_group from the torchrun environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT, LOCAL_RANK): NCCL for a cuda `device` (the
    rank's card, LOCAL_RANK), gloo for the CPU.  Does nothing at world size
    1 or when a group exists; returns whether it brought one up.  A failed
    bring-up raises (JAX's swallows every exception, mesh.py:28-42)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://")
    return True


def make_mesh(dp: int = 1, fsdp: Optional[int] = None, tp: int = 1,
              devices: Optional[Sequence[int]] = None,
              device_type: Optional[str] = None):
    """A (dp, fsdp, tp) DeviceMesh over `devices` (ranks; default every
    rank of the group, or the one process when there is none).  fsdp=None
    absorbs the ranks left.  The AssertionErrors are JAX's
    (mesh.py:45-65).  device_type: "cuda" under NCCL, "cpu" otherwise,
    unless given."""
    import torch.distributed as dist

    if devices is None:
        devices = range(dist.get_world_size() if dist.is_initialized()
                        else 1)
    devices = list(devices)
    n = len(devices)
    if fsdp is None:
        assert n % (dp * tp) == 0, (n, dp, tp)
        fsdp = n // (dp * tp)
    assert dp * fsdp * tp == n, (dp, fsdp, tp, n)
    from torch.distributed.device_mesh import DeviceMesh

    if device_type is None:
        device_type = ("cuda" if dist.is_initialized()
                       and dist.get_backend() == "nccl" else "cpu")
    return DeviceMesh(device_type,
                      torch.tensor(devices).reshape(dp, fsdp, tp),
                      mesh_dim_names=AXES)
