"""Monte-Carlo log-likelihood for multiple-choice evaluation, ported from
lavida_mod_tpu/generation/log_likelihood.py (reference
llada/log_likelyhood.py:7-96 and the multimodal entry llava_llada.py:
300-325).

A round (`_mc_round`, :37-133) is split in two, so that a test can feed
one the draws of the JAX package:
  - `draw_round`: one k ~ U{1..Ta} from a torch.Generator, the stratified
    mask counts `mask_counts(k, Ta, b)` (log_likelyhood.py:10-16), and a
    random permutation of the Ta answer positions per row (the ranks;
    row i masks the positions of rank < x_i, exactly x_i of them);
  - `mc_round`: the answer rows embedded with the mask embedding where
    masked, after the prefix; the bidirectional forward with hidden states
    only, in chunks of `forward_chunk` rows (rows are independent, so
    chunking is exact); the head on the answer positions in 64-token
    chunks, log-softmax in f32 (no [b, Ta, V] tensor); the loss
    sum(nll / p_mask) / b over the masked positions.
`get_log_likelihood` averages mc_num // batch_size rounds and negates.

Weights: the caller's model as it is laid out; `prefill_tree` runs the
mixed layout's int8 tree weight-only (the JAX adapter passes that tree),
`act_int8` with int8 activations.  The draws come from torch generators,
so the estimate is the JAX package's in distribution, and its value only
with the draws injected.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.llada import LLaDA


def _fma32(a, b, c) -> np.float32:
    """f32(a * b + c) rounded once: a product of two f32 values is exact
    in f64, and so, at these magnitudes, is its sum with an f32."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def mask_counts(k: int, Ta: int, b: int) -> np.ndarray:
    """The stratified mask counts [b] of one round:
    round(linspace(k, k + (b - 1) * Ta / b, b)), wrapped to [1, Ta]
    (log_likelihood.py:52-57), in f32 with ties to even.

    Where a point lands on .5, its count depends on the f32 rounding of
    each point, so this computes them as XLA's CPU backend compiles the
    jitted `_mc_round` (tests/test_torch_log_likelihood.py holds them
    equal to JAX's for every k, 1 <= b <= 64): point i of stop
    s = f32(k) + f32((b - 1) * (Ta / b)) is f32(i) * (s * r) + k * c_i with
    r = f32(1 / (b - 1)) and c_i = f32(1 - f32(i * r)), the two products
    fused into one FMA (the first one's factor at i = 1 alone when
    b <= 13, where the loop is unrolled), and the last point is s.  For
    b > 64 it is the same expression, which can land one count away from
    XLA's at an exact .5 point (b = 100, 128, 200 and 256 do): still
    stratified counts in [1, Ta], and the estimate matches the JAX
    package's only in distribution in any case."""
    f32 = np.float32
    start = f32(k)
    stop = f32(start + f32((b - 1) * (Ta / b)))
    out = np.empty(b, np.float32)
    div = b - 1
    if div:
        r = f32(f32(1) / f32(div))
        sr = f32(stop * r)
        for i in range(div):
            c = f32(f32(1) - f32(f32(i) * r))
            if i == 0:
                out[i] = start
            elif i == 1 and b <= 13:
                out[i] = _fma32(start, c, sr)
            else:
                out[i] = _fma32(f32(i), sr, f32(start * c))
    out[-1] = stop
    x = np.round(out).astype(np.int64)      # numpy rounds half to even
    return (x - 1) % Ta + 1


def draw_round(generator: torch.Generator, Ta: int, b: int,
               device) -> tuple[torch.Tensor, torch.Tensor]:
    """(counts [b] long, ranks [b, Ta] long) of one round: k ~ U{1..Ta}
    and the stratified counts on the host, and per row a random
    permutation of 0..Ta-1 (argsort of uniforms) from `generator`, which
    lives on `device`."""
    k = int(torch.randint(1, Ta + 1, (1,), generator=generator,
                          device=generator.device).item())
    counts = torch.as_tensor(mask_counts(k, Ta, b), device=device)
    u = torch.rand(b, Ta, generator=generator, device=generator.device)
    return counts, torch.argsort(u, dim=-1).to(device)


@torch.no_grad()
def mc_round(model: LLaDA, prefix_embeds: torch.Tensor,
             answer: torch.Tensor, counts: torch.Tensor,
             ranks: torch.Tensor, use_flash: bool = False,
             act_int8: bool = False, prefill_tree: bool = False,
             forward_chunk: int = 8) -> torch.Tensor:
    """One round's weighted loss (a 0-d f32 tensor) for prefix_embeds
    [1, P, D], answer [Ta] ids, counts [b] and ranks [b, Ta]."""
    P, D = prefix_embeds.shape[1:]
    b, Ta = ranks.shape
    is_mask = ranks < counts[:, None]                     # [b, Ta]
    mask_id = model.cfg.mask_token_id
    ans = answer[None].expand(b, Ta)
    mask_embed = model.embed_tokens(answer.new_tensor([mask_id]))[0]
    ans_embeds = torch.where(is_mask[..., None], mask_embed,
                             model.embed_tokens(ans))
    embeds = torch.cat([prefix_embeds.expand(b, P, D),
                        ans_embeds.to(prefix_embeds.dtype)], dim=1)
    fb = forward_chunk if b % forward_chunk == 0 else b
    h = torch.cat([model(embeds[i:i + fb], use_flash=use_flash,
                         return_logits=False, act_int8=act_int8,
                         prefill_tree=prefill_tree)[0][:, P:]
                   for i in range(0, b, fb)])              # [b, Ta, D]
    c = min(64, Ta)
    nll = torch.empty(b, Ta, dtype=torch.float32, device=h.device)
    for lo in range(0, Ta, c):
        lg = model.head(h[:, lo:lo + c], prefill_tree or act_int8)
        lp = torch.log_softmax(lg, dim=-1)
        nll[:, lo:lo + c] = -torch.gather(
            lp, -1, ans[:, lo:lo + c, None])[..., 0]
    p_mask = (counts.to(torch.float32) / Ta)[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    return torch.where(is_mask, nll / p_mask, zero).sum() / b


@torch.no_grad()
def get_log_likelihood(
    model: LLaDA,
    prefix_embeds: torch.Tensor,
    answer,
    mc_num: int = 128,
    batch_size: int = 16,
    generator: Optional[torch.Generator] = None,
    use_flash: Optional[bool] = None,
    act_int8: bool = False,
    prefill_tree: bool = False,
    forward_chunk: Optional[int] = None,
) -> float:
    """log p(answer | prefix) by MC estimation (the negative expected
    weighted cross-entropy), get_log_likelihood (log_likelihood.py:
    136-181).  use_flash=None: the full-sequence attention through the
    short-attention kernel on the card (no score tensor in memory), dense
    on the CPU -- as the JAX package resolves it to its TPU.
    forward_chunk=None: 8 rows, 4 under act_int8.  generator: the draws'
    (default seed 0 on the CPU).  The counts of a round are JAX's to the
    last bit for batch_size <= 64 (`mask_counts`)."""
    device = prefix_embeds.device
    if use_flash is None:
        use_flash = device.type == "cuda"
    if forward_chunk is None:
        forward_chunk = 4 if act_int8 else 8
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    answer = torch.as_tensor(np.asarray(answer), device=device).long()
    rounds = max(mc_num // batch_size, 1)
    total = 0.0
    for _ in range(rounds):
        counts, ranks = draw_round(generator, answer.shape[0], batch_size,
                                   device)
        total += float(mc_round(model, prefix_embeds, answer, counts, ranks,
                                use_flash, act_int8, prefill_tree,
                                forward_chunk))
    return -total / rounds
