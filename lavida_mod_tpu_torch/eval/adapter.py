"""Batched generation: the port of the body of
lavida_mod_tpu/eval/adapter.py::LavidaEvalModel.generate_until_batch
(adapter.py:245-318), the path of the serve worker's `--decode-batch N`
and of bench.py's throughput mode.

`generate_batch` takes requests already tokenized (ids with -200 image
markers) and preprocessed (one [V, C, S, S] view stack per image); the
conversation template, tokenizer and `decode_output` of the JAX adapter
stay out of the port.  Per request it runs `LaViDa.encode_prompt` (one
vision encode per image, the fused ViT-MLP kernel by the model's policy);
the prefixes are front-padded to a common multiple of the bucket with a
`valid` mask, then one generation serves the batch:
  - B > 4: `generate_chunked_prefill` with chunk 2 (adapter.py:284-302);
  - else `diffusion.generate`, in the mixed layout with the int8 tree
    prefilling (adapter.py:303-318).
The prefill attention is the short-attention kernel throughout (the JAX
adapter's use_flash_prefill on the TPU).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import GenerationConfig, as_port_config
from ..generation import diffusion


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate_batch(
    model,
    requests: Sequence[tuple],
    gen: Optional[GenerationConfig] = None,
    *,
    prefix_bucket: Optional[int] = 128,
    kv8: bool = False,
    generator: Optional[torch.Generator] = None,
) -> tuple[np.ndarray, dict]:
    """requests: (input_ids, [views per image], [(width, height) per
    image]) each.  Returns (ids [B, G], walls {"encode": s, "generate":
    s}); the walls end in a device synchronize."""
    gen = as_port_config(gen) or GenerationConfig()
    device = model.device
    t0 = time.perf_counter()
    prefixes = [model.encode_prompt(ids, views, sizes)[0]
                for ids, views, sizes in requests]
    _sync(device)
    t_enc = time.perf_counter()
    bucket = prefix_bucket or 128
    Pb = max(-(-p.shape[0] // bucket) * bucket for p in prefixes)
    B, D = len(prefixes), prefixes[0].shape[-1]
    batch = prefixes[0].new_zeros(B, Pb, D)
    valid = torch.zeros(B, Pb, dtype=torch.bool, device=device)
    for b, p in enumerate(prefixes):
        batch[b, Pb - p.shape[0]:] = p          # front-pad (masked)
        valid[b, Pb - p.shape[0]:] = True
    del prefixes
    kw = dict(prefix_valid=valid, generator=generator,
              act_int8_prefill=model.mixed, kv8=kv8)
    if B > 4:
        out = diffusion.generate_chunked_prefill(model.llada, batch, gen,
                                                 chunk=2, **kw)
    else:
        out = diffusion.generate(model.llada, batch, gen, **kw)
    out = out.cpu().numpy()
    t_gen = time.perf_counter()
    return out, {"encode": t_enc - t0, "generate": t_gen - t_enc}
