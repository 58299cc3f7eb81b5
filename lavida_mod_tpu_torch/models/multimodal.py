"""Multimodal composition: vision encode -> project -> pool, then the anyres
merge and the token splice as ONE row gather.  Ported from
lavida_mod_tpu/models/multimodal.py (reference llava_arch.py).

`merge_anyres_indices` and `build_gather_plan` are numpy copies of the JAX
package's host planners: that module imports jax, so the port cannot
import them.  tests/test_torch_models.py holds the copies equal to the
originals.

Pipeline (as the JAX package): the projector runs BEFORE pooling
(llava_arch.py:235-281 then :490-533): tower [V, 729, 1152] -> projector
[V, 729, 4096] -> bilinear 2x2 pool [V, 196, 4096].  The anyres merge
("spatial_unpad", llava_arch.py:548-678) and the splice of each image
block at its -200 marker are expressed as indices into one flat table
    [ all vision tokens ; image_newline ; text-token embeds ; zero row ]
so the whole splice is one `gather_rows` call (`multimodal_embeds`, the
path of `generate_fused`).  The multi-dispatch path of `encode_prompt` is
ported too: `encode_image` (multimodal.py:122-144) encodes one image and
merges its views (`merge_anyres`, :89-119), and `splice_embeddings`
(:162-210) concatenates text embeddings and image blocks at the -200
markers; tests/test_torch_batch.py holds the two paths equal.

`multimodal_embeds` is the splice of the training step too: it is
differentiable from the tower through the projector, the pool and
`image_newline` to the gathered rows (gather_rows' scatter-add VJP), with
`remat` passed to the tower.  A tower with no trainable parameter runs
without autograd recording it (stage-1 pretraining).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..config import LaViDaConfig, VisionConfig
from ..constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from ..data.anyres import anyres_grid_shape, unpad_slice
from ..ops.gather import gather_rows
from ..ops.pooling import pool_2d


def encode_views(model, pixel_values: torch.Tensor, pool: bool = True,
                 fused_mlp: bool = False, remat: bool = False
                 ) -> torch.Tensor:
    """[V, C, S, S] -> projected (and pooled) features [V, T', D_lm].
    `model` is a `LaViDa` (its siglip, projector and cfg are used);
    fused_mlp runs the tower's MLP halves through `fused_vit_mlp`; remat
    checkpoints the tower's layers.  A frozen tower is not recorded."""
    tower_grad = torch.is_grad_enabled() and any(
        p.requires_grad for p in model.siglip.parameters())
    with torch.set_grad_enabled(tower_grad):
        feats = model.siglip(pixel_values, fused_mlp=fused_mlp, remat=remat)
    feats = model.projector(feats)
    if not pool:
        return feats
    vcfg = model.cfg.vision
    return pool_2d(feats, vcfg.spatial_pool_mode, vcfg.spatial_pool_stride)


def merge_anyres(features: torch.Tensor, image_size: tuple[int, int],
                 cfg: VisionConfig, image_newline: torch.Tensor
                 ) -> torch.Tensor:
    """The anyres "spatial_unpad" merge of one image's pooled views
    [V, T, D] (V = 1 base + nh*nw tiles): base tokens, then the unpadded
    tile grid row by row, each row closed by the newline; a single view
    gets one trailing newline.  -> [n_tokens, D]."""
    V, T, D = features.shape
    g = int(round(T ** 0.5))
    nl = image_newline.to(features.dtype)
    if V == 1:
        return torch.cat([features[0], nl[None]])
    nw, nh = anyres_grid_shape(image_size, cfg.grid_pinpoints,
                               cfg.siglip.image_size)
    if nh * nw != V - 1:
        raise ValueError(f"{V} views for a {nh}x{nw} tile grid")
    grid = features[1:].reshape(nh, nw, g, g, D).permute(0, 2, 1, 3, 4)
    grid = grid.reshape(nh * g, nw * g, D)
    rs, cs = unpad_slice(image_size, (nh * g, nw * g))
    grid = grid[rs, cs]
    H, W = grid.shape[:2]
    grid = torch.cat([grid, nl.expand(H, 1, D)], dim=1)
    return torch.cat([features[0], grid.reshape(H * (W + 1), D)])


def encode_image(model, views: torch.Tensor,
                 image_size: Optional[tuple[int, int]] = None,
                 fused_mlp: bool = False) -> torch.Tensor:
    """One image's views [V, C, S, S] -> its merged token block [n, D_lm].
    A single view under the square / pad aspect modes is the tower and
    projector only (unpooled, no newline), as in the reference."""
    vcfg = model.cfg.vision
    if views.shape[0] == 1 and vcfg.image_aspect_ratio in ("square", "pad"):
        return encode_views(model, views, pool=False, fused_mlp=fused_mlp)[0]
    feats = encode_views(model, views, fused_mlp=fused_mlp)
    if image_size is None and views.shape[0] != 1:
        raise ValueError("an anyres image needs its size")
    return merge_anyres(feats, image_size or (vcfg.siglip.image_size,) * 2,
                        vcfg, model.image_newline)


def splice_embeddings(model, input_ids: np.ndarray,
                      image_features: Sequence[torch.Tensor]
                      ) -> torch.Tensor:
    """One sample's ids [T] with -200 markers, each replaced by the next
    image's block [n_i, D] -> embeddings [T', D] (unpadded)."""
    input_ids = np.asarray(input_ids)
    img_pos = np.where(input_ids == IMAGE_TOKEN_INDEX)[0]
    if len(img_pos) != len(image_features):
        raise ValueError(f"{len(img_pos)} image tokens vs "
                         f"{len(image_features)} images")
    device = model.image_newline.device
    segments, prev = [], 0

    def text(ids):
        if len(ids):
            segments.append(model.llada.embed_tokens(
                torch.as_tensor(ids, dtype=torch.long, device=device)))

    for feats, pos in zip(image_features, img_pos):
        text(input_ids[prev:pos])
        segments.append(feats)
        prev = pos + 1
    text(input_ids[prev:])
    return torch.cat(segments)


def merge_anyres_indices(
    image_size: tuple[int, int],
    cfg: VisionConfig,
    n_views: int,
    pooled_grid: int,
    view_offset: int,
    newline_index: int,
) -> np.ndarray:
    """One image's merged token block as indices into the flat table: the
    base view's tokens, then the unpadded tile grid row by row, each row
    closed by the newline (a single view gets one trailing newline)."""
    g = pooled_grid
    T = g * g
    base = view_offset * T + np.arange(T, dtype=np.int64)
    if n_views == 1:
        return np.concatenate([base, [newline_index]])
    nw, nh = anyres_grid_shape(image_size, cfg.grid_pinpoints,
                               cfg.siglip.image_size)
    if nh * nw != n_views - 1:
        raise ValueError(f"{n_views} views for a {nh}x{nw} tile grid")
    rs, cs = unpad_slice(image_size, (nh * g, nw * g))
    rows = []
    for h in range(rs.start, rs.stop):
        row = []
        for w in range(cs.start, cs.stop):
            view = 1 + (h // g) * nw + (w // g)
            row.append((view_offset + view) * T + (h % g) * g + (w % g))
        row.append(newline_index)
        rows.append(row)
    grid = np.asarray(rows, np.int64).reshape(-1)
    return np.concatenate([base, grid])


def build_gather_plan(
    cfg: LaViDaConfig,
    batch_input_ids: Sequence[np.ndarray],
    batch_n_views: Sequence[Sequence[int]],
    batch_image_sizes: Sequence[Sequence[tuple[int, int]]],
    batch_labels: Optional[Sequence[np.ndarray]] = None,
    pad_to: Optional[int] = None,
    pad_front: bool = False,
):
    """Host-side splice plan.  Returns (gather_idx [B, T], text_ids
    [B, T_text], valid [B, T], labels [B, T] or None); gather_idx indexes
    the flat table described in the module docstring.  `pad_to` pads the
    plan (at the front with pad_front, the serving convention) with the
    zero row, marked invalid."""
    g = -(-cfg.vision.siglip.num_patches_per_side
          // cfg.vision.spatial_pool_stride)
    T_pooled = g * g
    n_total_views = sum(v for row in batch_n_views for v in row)
    newline_index = n_total_views * T_pooled
    text_base = newline_index + 1

    B = len(batch_input_ids)
    T_text = max(len(ids) for ids in batch_input_ids)
    text_ids = np.zeros((B, T_text), np.int64)

    rows, row_labels = [], []
    view_offset = 0
    for b, ids in enumerate(batch_input_ids):
        ids = np.asarray(ids)
        labels = (np.asarray(batch_labels[b]) if batch_labels is not None
                  else None)
        img_pos = np.where(ids == IMAGE_TOKEN_INDEX)[0]
        if len(img_pos) != len(batch_n_views[b]):
            raise ValueError(f"sample {b}: {len(img_pos)} image markers vs "
                             f"{len(batch_n_views[b])} images")
        idx_row: list[int] = []
        lab_row: list[int] = []
        prev = 0
        text_ids[b, :len(ids)] = np.where(ids == IMAGE_TOKEN_INDEX, 0, ids)
        for k, pos in enumerate(img_pos):
            for t in range(prev, pos):
                idx_row.append(text_base + b * T_text + t)
                if labels is not None:
                    lab_row.append(labels[t])
            block = merge_anyres_indices(
                batch_image_sizes[b][k], cfg.vision, batch_n_views[b][k],
                g, view_offset, newline_index)
            idx_row.extend(block.tolist())
            if labels is not None:
                lab_row.extend([IGNORE_INDEX] * len(block))
            view_offset += batch_n_views[b][k]
            prev = pos + 1
        for t in range(prev, len(ids)):
            idx_row.append(text_base + b * T_text + t)
            if labels is not None:
                lab_row.append(labels[t])
        if cfg.tokenizer_model_max_length:
            idx_row = idx_row[:cfg.tokenizer_model_max_length]
            lab_row = lab_row[:cfg.tokenizer_model_max_length]
        rows.append(idx_row)
        row_labels.append(lab_row)

    T = int(pad_to or max(len(r) for r in rows))
    pad_index = text_base + B * T_text
    gather_idx = np.full((B, T), pad_index, np.int64)
    valid = np.zeros((B, T), bool)
    out_labels = (np.full((B, T), IGNORE_INDEX, np.int64)
                  if batch_labels is not None else None)
    for b, r in enumerate(rows):
        n = min(len(r), T)
        sl = slice(T - n, T) if pad_front else slice(0, n)
        gather_idx[b, sl] = r[:n]
        valid[b, sl] = True
        if out_labels is not None:
            out_labels[b, sl] = row_labels[b][:n]
    return gather_idx, text_ids, valid, out_labels


def multimodal_embeds(
    model,
    pixel_values: torch.Tensor,
    text_ids: np.ndarray,
    gather_idx: np.ndarray,
    fused_mlp: bool = False,
    remat: bool = False,
) -> torch.Tensor:
    """Encode all views [N, C, S, S], build the flat table and splice it
    with ONE gather_rows call at the host plan gather_idx [B, T].  text_ids
    [B, T_text] is the plan's text table.  Returns [B, T, D_lm] on the
    model's device, differentiable (multimodal.py:346-410)."""
    nl = model.image_newline
    D = nl.shape[-1]
    if pixel_values.shape[0] > 0:
        flat = encode_views(model, pixel_values, fused_mlp=fused_mlp,
                            remat=remat).reshape(-1, D)
    else:
        flat = nl.new_zeros((0, D))
    text = torch.as_tensor(np.asarray(text_ids), device=nl.device)
    text_emb = model.llada.embed_tokens(text).reshape(-1, D)
    table = torch.cat([flat, nl[None].to(flat.dtype),
                       text_emb.to(flat.dtype), flat.new_zeros((1, D))])
    B, T = gather_idx.shape
    return gather_rows(table, np.asarray(gather_idx).reshape(-1)).view(
        B, T, D)
