"""Numerical-safety utilities, ported from lavida_mod_tpu/utils/debug.py.

The reference guards against NaN / Inf in attention biases
(modeling_llada.py:168-176 ensure_finite_) and counts NaNs in debug mode
(generate.py:163-165).  `count_nonfinite` takes a tensor, a module's
parameters or any nest of dicts, lists and tuples of tensors, as JAX's
takes a pytree.
"""

from __future__ import annotations

import torch


def ensure_finite(x: torch.Tensor, neg_inf: float = -1e30) -> torch.Tensor:
    """-inf and NaN replaced by a large negative value and zero, +inf by
    3e38 (the bias sanitization: an all -inf row gives NaN in SDPA-style
    kernels)."""
    x = torch.where(torch.isneginf(x), torch.tensor(neg_inf, dtype=x.dtype,
                                                    device=x.device), x)
    return torch.nan_to_num(x, nan=0.0, posinf=3e38, neginf=neg_inf)


def _leaves(tree):
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def count_nonfinite(tree) -> torch.Tensor:
    """Non-finite elements over every floating tensor of `tree` (0-d
    tensor, a debug metric)."""
    counts = [(~torch.isfinite(t.float())).sum() for t in _leaves(tree)
              if t.is_floating_point()]
    return sum(counts) if counts else torch.zeros((), dtype=torch.int32)


def assert_all_finite(tree, name: str = "tree") -> None:
    """Host-side check (tests, debugging); raises when anything is not
    finite."""
    n = int(count_nonfinite(tree))
    if n:
        raise AssertionError(f"{name} contains {n} non-finite values")
