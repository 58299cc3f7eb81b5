"""Anyres HD tiling geometry — host-side, pure functions: a copy of
lavida_mod_tpu/data/anyres.py.

Behavior-parity with reference llava/mm_utils.py: best-resolution selection
(:119-149), resize+center-pad (:152-188), patch division (:191-210), grid
shape (:213-240), anyres processing (:244-297), and the unpad geometry of
llava_arch.py:154-186 expressed as a pure slice computation so the device
code can use static slice bounds.

All sizes follow the reference's (width, height) PIL convention.
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence

import numpy as np


def select_best_resolution(
    original_size: tuple[int, int],
    possible_resolutions: Iterable[tuple[int, int]],
) -> tuple[int, int]:
    """Min-waste grid fit (mm_utils.py:119-149). Sizes are (width, height)."""
    ow, oh = original_size
    best = None
    best_eff = 0
    best_waste = float("inf")
    for w, h in possible_resolutions:
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        eff = min(dw * dh, ow * oh)
        waste = w * h - eff
        if eff > best_eff or (eff == best_eff and waste < best_waste):
            best_eff, best_waste, best = eff, waste, (w, h)
    return best


def fit_within(original_size, target_resolution) -> tuple[int, int, int, int]:
    """Return (new_w, new_h, paste_x, paste_y) for aspect-preserving resize
    centered in target (mm_utils.py:152-188 semantics, ceil + min clamp)."""
    ow, oh = original_size
    tw, th = target_resolution
    scale_w, scale_h = tw / ow, th / oh
    if scale_w < scale_h:
        nw = tw
        nh = min(math.ceil(oh * scale_w), th)
    else:
        nh = th
        nw = min(math.ceil(ow * scale_h), tw)
    return nw, nh, (tw - nw) // 2, (th - nh) // 2


def resize_and_pad_image(image, target_resolution):
    """PIL path (exact reference behavior incl. default resample)."""
    from PIL import Image

    nw, nh, px, py = fit_within(image.size, target_resolution)
    resized = image.resize((nw, nh))
    out = Image.new("RGB", tuple(target_resolution), (0, 0, 0))
    out.paste(resized, (px, py))
    return out


def divide_to_patches(image, patch_size: int) -> list:
    """Row-major patch crops (mm_utils.py:191-210)."""
    patches = []
    w, h = image.size
    for i in range(0, h, patch_size):
        for j in range(0, w, patch_size):
            patches.append(image.crop((j, i, j + patch_size, i + patch_size)))
    return patches


def anyres_grid_shape(
    image_size: tuple[int, int],
    grid_pinpoints: Sequence[tuple[int, int]],
    patch_size: int,
) -> tuple[int, int]:
    """(num_patch_width, num_patch_height) (mm_utils.py:213-240)."""
    w, h = select_best_resolution(image_size, grid_pinpoints)
    return w // patch_size, h // patch_size


def process_anyres_image(image, processor, grid_pinpoints) -> np.ndarray:
    """PIL image -> [1 + n_tiles, C, S, S] float array (mm_utils.py:244-297):
    base view is a plain square resize of the *original* image (the
    reference's acknowledged squash at :285-292), tiles come from the padded
    best-resolution canvas."""
    best = select_best_resolution(image.size, grid_pinpoints)
    padded = resize_and_pad_image(image, best)
    tiles = divide_to_patches(padded, processor.size)
    base = image.resize((processor.size, processor.size))
    views = [processor(base)] + [processor(t) for t in tiles]
    return np.stack(views, axis=0)


def unpad_slice(
    original_size: tuple[int, int], current_hw: tuple[int, int]
) -> tuple[slice, slice]:
    """The (row, col) slices that remove letterbox padding from a
    [H, W] feature grid (llava_arch.py unpad_image :154-186)."""
    ow, oh = original_size
    ch, cw = current_hw
    if ow / oh > cw / ch:
        scale = cw / ow
        nh = int(oh * scale)
        pad = (ch - nh) // 2
        return slice(pad, ch - pad), slice(0, cw)
    else:
        scale = ch / oh
        nw = int(ow * scale)
        pad = (cw - nw) // 2
        return slice(0, ch), slice(pad, cw - pad)
