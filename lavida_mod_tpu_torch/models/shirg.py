"""SHIRG-Fovea high-resolution vision-token selection: the port of
lavida_mod_tpu/models/shirg.py (the reference's siglip_shirg.py mixin).

  2-view pipeline (siglip_shirg.py:46-215):
    global 448^2 -> 1024 tokens -> 2x2 avg pool -> 256
    foveal 448^2 -> 1024 tokens -> top-K 724
    concat -> 980 tokens -> the projector

The tower reads 448^2 views, a 32 x 32 patch grid against so400m's 27 x 27
position table, which `SigLIP` resizes bicubically (models/siglip.py).

Selection (`shirg_scores`, the seven methods of shirg.py:145-201) is plain
tensor math on the tower's device.  `topk_select` orders the scores with a
stable descending sort: `jax.lax.top_k` returns equal scores in ascending
index, and `entropy` / `full` gate a whole image to 1e-6 (724 exact
ties), where `torch.topk` promises no order.  The gather of the selected
rows is plain indexing (the JAX package takes its row-gather kernel only on
a TPU at 1024 | D, which SigLIP's 1152 never is, shirg.py:211-222).

`merge_similar_tokens` (shirg.py:226-284) is a sequential scan over the K
selected rows whose state is only the `kept` mask: the similarity pairs
(`(sim * triu) > threshold`, multiplied before compared) are computed on the
device, the scan runs on the host in numpy over those K x K booleans, and
the merged rows (each the mean of its group of ORIGINAL rows) come from one
f64 product on the device, cast to f32 and divided by the group size.  Then
the kept rows compact to the front and the tail repeats the last kept row.

Randomness (`random`, the merge's pad noise) comes from a torch.Generator;
`noise` injects the `random` method's scores.  `process_shirg_2view`
imports PIL when it is called.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

SHIRG_GLOBAL_TOKENS = 256
SHIRG_FOVEAL_TOKENS = 724
SHIRG_TOTAL_TOKENS = SHIRG_GLOBAL_TOKENS + SHIRG_FOVEAL_TOKENS  # 980
SHIRG_VIEW = 448


def shirg_token_count(n_patches: int) -> int:
    """Tokens `shirg_encode` returns for views of n_patches patches: the
    pooled global grid plus the foveal top-k (980 at 1024 patches)."""
    g = int(round(math.sqrt(n_patches))) // 2
    k = SHIRG_FOVEAL_TOKENS if n_patches == 1024 else min(
        n_patches, SHIRG_FOVEAL_TOKENS)
    return g * g + k


# ---------------------------------------------------------------------------
# host-side preprocessing
# ---------------------------------------------------------------------------

def process_shirg_2view(image, processor) -> np.ndarray:
    """PIL image -> [2, C, 448, 448] f32: the LANCZOS global resize and the
    centre-crop foveal view (shirg.py:48-80)."""
    from PIL import Image

    size = SHIRG_VIEW
    global_view = image.resize((size, size), Image.LANCZOS)
    w, h = image.size
    cx, cy = w // 2, h // 2
    left = max(0, cx - size // 2)
    top = max(0, cy - size // 2)
    right = min(w, left + size)
    bottom = min(h, top + size)
    if right - left < size:
        left = max(0, right - size)
    if bottom - top < size:
        top = max(0, bottom - size)
    foveal = image.crop((left, top, right, bottom))
    if foveal.size != (size, size):
        foveal = foveal.resize((size, size), Image.LANCZOS)
    proc448 = type(processor)(
        size=size, image_mean=tuple(processor.image_mean),
        image_std=tuple(processor.image_std),
        rescale_factor=processor.rescale_factor)
    return np.stack([proc448(global_view), proc448(foveal)], axis=0)


# ---------------------------------------------------------------------------
# scoring components
# ---------------------------------------------------------------------------

def _minmax(x: torch.Tensor) -> torch.Tensor:
    lo = x.amin(dim=-1, keepdim=True)
    hi = x.amax(dim=-1, keepdim=True)
    return (x - lo) / (hi - lo + 1e-8)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


def edge_prior(tokens: torch.Tensor) -> torch.Tensor:
    """Sobel magnitude over the channel-mean token grid, min-max
    normalized (shirg.py:96-118).  tokens [B, N, D], N a square."""
    B, N, D = tokens.shape
    g = int(round(math.sqrt(N)))
    if g * g != N:
        raise ValueError(f"edge_prior: {N} tokens are no square grid")
    grid = tokens.mean(dim=-1).reshape(B, g, g).float()
    p = torch.nn.functional.pad(grid[:, None], (1, 1, 1, 1),
                                mode="replicate")[:, 0]

    def shift(dy, dx):
        return p[:, 1 + dy:1 + dy + g, 1 + dx:1 + dx + g]

    gx = (-shift(-1, -1) + shift(-1, 1)
          - 2 * shift(0, -1) + 2 * shift(0, 1)
          - shift(1, -1) + shift(1, 1))
    gy = (-shift(-1, -1) - 2 * shift(-1, 0) - shift(-1, 1)
          + shift(1, -1) + 2 * shift(1, 0) + shift(1, 1))
    return _minmax(torch.sqrt(gx * gx + gy * gy).reshape(B, N))


def distance_penalty(tokens: torch.Tensor) -> torch.Tensor:
    """Mean off-diagonal cosine similarity, min-max normalized
    (shirg.py:121-127)."""
    N = tokens.shape[1]
    tn = _normalize(tokens.float())
    sim = torch.einsum("bnd,bmd->bnm", tn, tn)
    return _minmax((sim.sum(dim=-1) - 1.0) / (N - 1))


def radial_weight(n: int, sigma: float, device=None) -> torch.Tensor:
    """Anti-centre-bias weight over a square grid of n tokens,
    mean-normalized; ones when n is no square (shirg.py:130-142)."""
    g = int(round(math.sqrt(n)))
    if g * g != n:
        return torch.ones(n, device=device)
    y = torch.arange(g, dtype=torch.float32, device=device)[:, None]
    x = torch.arange(g, dtype=torch.float32, device=device)[None, :]
    c = g / 2 - 0.5
    d2 = (y - c) ** 2 + (x - c) ** 2
    dnorm = torch.sqrt(d2 / ((g / 2) ** 2 + (g / 2) ** 2))
    w = (1.0 - torch.exp(-((dnorm / sigma) ** 2))).reshape(n)
    return w / w.mean()


def shirg_scores(tokens: torch.Tensor,
                 text_embeddings: Optional[torch.Tensor] = None,
                 method: str = "base", params: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, N, D] -> selection scores [B, N] f32 (shirg.py:145-201).
    `random`: `noise` [B, N] if given, else uniform draws from
    `generator`."""
    p = params or {}
    B, N, D = tokens.shape
    tf = tokens.float()
    tn = _normalize(tf)
    attn = _minmax(torch.einsum("bnd,bd->bn", tn, tn[:, 0]))
    if text_embeddings is not None and text_embeddings.shape[-1] == D:
        te = _normalize(text_embeddings.float()).mean(dim=1)
        sim = torch.einsum("bnd,bd->bn", tn, te)
    else:
        sim = torch.linalg.vector_norm(tf, dim=-1)
    sim = _minmax(sim)

    if method == "random":
        if noise is not None:
            return noise.to(device=tokens.device, dtype=torch.float32)
        return torch.rand(B, N, generator=generator, device=tokens.device)
    if method == "base":
        return 0.7 * attn + 0.3 * sim
    if method == "entropy":
        tau = p.get("entropy_threshold", 0.12)
        gate = (attn.std(dim=-1, correction=0, keepdim=True) <= tau).float()
        return (0.7 * attn + 0.3 * sim) * gate
    if method == "edge":
        ew = p.get("edge_weight", 0.25)
        return 0.4 * attn + (0.35 - ew) * sim + ew * edge_prior(tokens)
    if method == "edge_only":
        ew = p.get("edge_weight", 0.8)
        return (1.0 - ew) * sim + ew * edge_prior(tokens)
    if method == "custom":
        aw = p.get("attention_weight", 0.0)
        sw = p.get("similarity_weight", 0.2)
        ew = p.get("edge_weight", 0.8)
        tot = max(aw + sw + ew, 1e-8)
        return ((aw / tot) * attn + (sw / tot) * sim
                + (ew / tot) * edge_prior(tokens))
    if method == "full":
        tau = p.get("entropy_threshold", 0.12)
        gate = (attn.std(dim=-1, correction=0, keepdim=True) <= tau).float()
        ep = edge_prior(tokens)
        dp = distance_penalty(tokens)
        rw = radial_weight(N, p.get("radial_sigma", 0.65),
                           tokens.device)[None]
        raw = 0.4 * attn + 0.25 * sim - 0.1 * dp + 0.25 * ep
        return raw * gate * rw
    raise ValueError(f"unknown SHIRG method: {method}")


def topk_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The k best of each row [B, N] after the +1e-6 budget epsilon
    (shirg.py:209-210), in descending score and, among equal scores, in
    ascending index, as jax.lax.top_k orders them."""
    order = torch.sort(scores + 1e-6, dim=-1, descending=True,
                       stable=True).indices
    return order[:, :k]


def topk_select(tokens: torch.Tensor, scores: torch.Tensor,
                k: int) -> torch.Tensor:
    """[B, N, D] + [B, N] -> the k selected rows [B, k, D] in score order
    (shirg.py:204-223)."""
    idx = topk_indices(scores, k)
    return torch.gather(tokens, 1, idx[..., None].expand(-1, -1,
                                                        tokens.shape[-1]))


def merge_plan(pairs: np.ndarray):
    """The merge scan over one sample's K x K `pairs` booleans
    (shirg.py:254-276): (groups [K, K] bool, row i the rows token i
    absorbs and itself where it absorbs any, else i alone; src [K], the
    merged row each output position takes; live [K], positions before
    the padded tail)."""
    K = pairs.shape[0]
    kept = np.ones(K, bool)
    groups = np.zeros((K, K), bool)
    for i in range(K):
        similar = pairs[i] & kept if kept[i] else np.zeros(K, bool)
        groups[i] = similar
        groups[i, i] = True
        kept &= ~similar
    order = np.argsort(~kept, kind="stable")
    u = int(kept.sum())
    pos = np.arange(K)
    src = np.where(pos < u, order[np.minimum(pos, K - 1)], order[u - 1])
    return groups, src, pos < u


def merge_similar_tokens(tokens: torch.Tensor, threshold: float = 0.9,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    """Greedy in-order cosine merge of the selected rows [B, K, D] to
    exactly K rows (shirg.py:226-284): row i absorbs every still-kept
    j > i with sim(i, j) > threshold as their mean; the kept rows compact
    to the front and the tail repeats the last kept row.  `generator`:
    add the reference's 1e-6 gaussian noise to the pad rows."""
    B, K, D = tokens.shape
    tokf = tokens.float()
    tn = tokf / torch.clamp_min(
        torch.linalg.vector_norm(tokf, dim=-1, keepdim=True), 1e-12)
    triu = torch.triu(torch.ones(K, K, device=tokens.device), diagonal=1)
    pairs = ((tn @ tn.transpose(1, 2)) * triu > threshold).cpu().numpy()
    outs = []
    for b in range(B):
        groups, src, live = merge_plan(pairs[b])
        g = torch.as_tensor(groups, device=tokens.device)
        total = (g.double() @ tokf[b].double()).float()
        merged = total / g.sum(dim=1, keepdim=True).float()
        out = merged[torch.as_tensor(src, device=tokens.device)]
        if generator is not None:
            noise = 1e-6 * torch.randn(K, D, generator=generator,
                                       device=tokens.device)
            dead = torch.as_tensor(~live, device=tokens.device)[:, None]
            out = torch.where(dead, out + noise, out)
        outs.append(out.to(tokens.dtype))
    return torch.stack(outs)


# ---------------------------------------------------------------------------
# the full SHIRG encode
# ---------------------------------------------------------------------------

def shirg_select(model, feats: torch.Tensor,
                 text_embeddings: Optional[torch.Tensor] = None,
                 method: str = "base",
                 selection_params: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None,
                 timings: Optional[dict] = None) -> torch.Tensor:
    """One sample's tower features [2, N, D] (global, foveal) -> projected
    tokens [256 + k, D_lm] (shirg.py:309-337): the global view 2x2-pooled,
    the foveal top-k (k 724 at N = 1024), the optional merge (only with
    `merge_similar` and method "full"), then the projector.  `timings`:
    host-clock seconds of scores + top-k and of the merge, each after a
    device sync."""
    g_feat, f_feat = feats[0:1], feats[1:2]
    B, N, D = g_feat.shape
    gsz = int(round(math.sqrt(N)))
    go = gsz // 2
    grid = g_feat.reshape(B, gsz, gsz, D)
    pooled = grid[:, :go * 2, :go * 2].reshape(B, go, 2, go, 2, D).mean(
        dim=(2, 4)).reshape(B, go * go, D)
    k = SHIRG_FOVEAL_TOKENS if f_feat.shape[1] == 1024 else min(
        f_feat.shape[1], SHIRG_FOVEAL_TOKENS)
    t0 = _clock(timings, feats)
    scores = shirg_scores(f_feat, text_embeddings, method, selection_params,
                          generator, noise)
    selected = topk_select(f_feat, scores, k)
    t1 = _clock(timings, feats)
    sp = selection_params or {}
    if sp.get("merge_similar", False) and method == "full":
        selected = merge_similar_tokens(selected,
                                        sp.get("merge_threshold", 0.9))
    t2 = _clock(timings, feats)
    if timings is not None:
        timings["select_s"] = timings.get("select_s", 0.0) + t1 - t0
        timings["merge_s"] = timings.get("merge_s", 0.0) + t2 - t1
    tokens = torch.cat([pooled, selected], dim=1)
    return model.projector(tokens)[0]


def _clock(timings, t: torch.Tensor) -> float:
    if timings is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)
    return time.perf_counter()


def shirg_encode(model, views, text_embeddings=None, method: str = "base",
                 selection_params: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None,
                 fused_mlp: bool = False,
                 noise: Optional[torch.Tensor] = None,
                 timings: Optional[dict] = None) -> torch.Tensor:
    """The 2-view SHIRG pipeline (shirg.py:287-337) on a LaViDa `model`:
    views [2, C, 448, 448] -> [980, D_lm], or a batch [B, 2, C, 448, 448]
    -> [B, 980, D_lm], its 2B views through the tower in one call and each
    sample selected on its own (the JAX training step's per-sample vmap).
    `fused_mlp` (kernel #9) stays the caller's choice, off by default: the
    LoRA training step differentiates through this encode
    (shirg.py:303-305).  `noise` [B, N] ([N] unbatched): the `random`
    method's scores.  `timings`: host seconds of the tower (`tower_s`),
    scores + top-k (`select_s`) and the merge (`merge_s`)."""
    views = torch.as_tensor(views, device=model.device)
    batched = views.dim() == 5
    if not batched:
        views = views[None]
        noise = None if noise is None else noise[None]
    B = views.shape[0]
    t0 = _clock(timings, views)
    feats = model.siglip(views.reshape(B * 2, *views.shape[2:]),
                         fused_mlp=fused_mlp)
    t1 = _clock(timings, feats)
    if timings is not None:
        timings["tower_s"] = timings.get("tower_s", 0.0) + t1 - t0
    feats = feats.reshape(B, 2, *feats.shape[1:])
    out = torch.stack([shirg_select(
        model, feats[b],
        None if text_embeddings is None else text_embeddings[b:b + 1],
        method, selection_params, generator,
        None if noise is None else noise[b:b + 1], timings)
        for b in range(B)])
    return out if batched else out[0]
