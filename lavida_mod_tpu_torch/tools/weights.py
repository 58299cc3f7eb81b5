"""Weight tools (reference llava/model/apply_delta.py, make_delta.py,
consolidate.py): the port's copy of lavida_mod_tpu/tools/weights.py, on
state dicts of torch tensors read and written by the port's own
safetensors code (tools/safetensors_io.py).

CLI:
  python -m lavida_mod_tpu_torch.tools.weights apply-delta --base B --delta D --target T
  python -m lavida_mod_tpu_torch.tools.weights make-delta  --base B --target T --delta D
  python -m lavida_mod_tpu_torch.tools.weights consolidate --src S --dst D
"""

from __future__ import annotations

import argparse
import os

import torch

from .safetensors_io import save_file


def load_state(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of the checkpoint shards under `path` (safetensors, or
    pytorch_model*.bin read as float32), copied into memory."""
    from ..models.lavida import close_checkpoint, load_state_shards

    state = load_state_shards(path)
    try:
        return {k: ref.load().clone() for k, ref in state.items()}
    finally:
        close_checkpoint(state)


def save_state(state: dict[str, torch.Tensor], path: str) -> None:
    os.makedirs(path, exist_ok=True)
    save_file(state, os.path.join(path, "model.safetensors"))


def _overlap(a: torch.Tensor, b: torch.Tensor) -> tuple:
    return tuple(slice(0, min(x, y)) for x, y in zip(a.shape, b.shape))


def apply_delta(base: dict, delta: dict) -> dict:
    """target = base + delta; keys only in delta pass through, and a
    vocab-extended delta adds the base over their overlap
    (apply_delta.py:20-40)."""
    out = {}
    for k, d in delta.items():
        b = base.get(k)
        if b is None:
            out[k] = d
        elif b.shape != d.shape:
            out[k] = d.clone()
            sl = _overlap(b, d)
            out[k][sl] = out[k][sl] + b[sl]
        else:
            out[k] = b + d
    return out


def make_delta(base: dict, target: dict) -> dict:
    """delta = target - base, the inverse of `apply_delta`."""
    out = {}
    for k, t in target.items():
        b = base.get(k)
        if b is None:
            out[k] = t
        elif b.shape != t.shape:
            out[k] = t.clone()
            sl = _overlap(b, t)
            out[k][sl] = out[k][sl] - b[sl]
        else:
            out[k] = t - b
    return out


def consolidate(src: str, dst: str) -> None:
    """Merge a sharded checkpoint into one safetensors file
    (consolidate.py)."""
    save_state(load_state(src), dst)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("command",
                    choices=["apply-delta", "make-delta", "consolidate"])
    ap.add_argument("--base")
    ap.add_argument("--delta")
    ap.add_argument("--target")
    ap.add_argument("--src")
    ap.add_argument("--dst")
    args = ap.parse_args(argv)
    if args.command == "apply-delta":
        save_state(apply_delta(load_state(args.base),
                               load_state(args.delta)), args.target)
    elif args.command == "make-delta":
        save_state(make_delta(load_state(args.base),
                              load_state(args.target)), args.delta)
    else:
        consolidate(args.src, args.dst)


if __name__ == "__main__":
    main()
