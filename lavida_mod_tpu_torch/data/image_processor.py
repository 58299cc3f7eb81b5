"""SigLIP image preprocessing, host-side: a copy of
lavida_mod_tpu/data/image_processor.py, for predict's --image.

Parity with reference SigLipImageProcessor (siglip_base.py:38-72): RGB
convert, bicubic resize to 384x384, rescale 1/255, normalize mean/std 0.5.
Kept PIL-exact because logit parity with the torch reference depends on the
resize kernel (SURVEY.md §7 "image preprocessing parity"); the output feeds
the jitted device pipeline as a plain array.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..config import VisionConfig
from .anyres import process_anyres_image


class SigLIPImageProcessor:
    """Callable: PIL.Image -> np.float32 [C, S, S]."""

    def __init__(
        self,
        size: int = 384,
        image_mean: Sequence[float] = (0.5, 0.5, 0.5),
        image_std: Sequence[float] = (0.5, 0.5, 0.5),
        rescale_factor: float = 1 / 255,
    ):
        self.size = size
        self.image_mean = np.asarray(image_mean, np.float32)
        self.image_std = np.asarray(image_std, np.float32)
        self.rescale_factor = rescale_factor

    def __call__(self, image) -> np.ndarray:
        from PIL import Image

        if image.mode != "RGB":
            image = image.convert("RGB")
        if image.size != (self.size, self.size):
            image = image.resize((self.size, self.size), Image.BICUBIC)
        arr = np.asarray(image, np.float32) * self.rescale_factor  # [H, W, C]
        arr = (arr - self.image_mean) / self.image_std
        return arr.transpose(2, 0, 1)  # CHW, matching the torch pipeline


def process_images(
    images: list,
    processor: SigLIPImageProcessor,
    vision_cfg: VisionConfig,
) -> list[np.ndarray]:
    """Dispatch per aspect-ratio mode (mm_utils.py:410-470).

    Returns one array per image: [n_views, C, S, S] for anyres,
    [1, C, S, S] for square.
    """
    mode = vision_cfg.image_aspect_ratio
    out = []
    for im in images:
        if mode.startswith("anyres"):
            out.append(
                process_anyres_image(im, processor, vision_cfg.grid_pinpoints)
            )
        elif mode == "pad":
            out.append(_expand2square(im, processor)[None])
        else:  # square resize
            out.append(processor(im)[None])
    return out


def _expand2square(image, processor: SigLIPImageProcessor) -> np.ndarray:
    from PIL import Image

    bg = tuple(int(x * 255) for x in processor.image_mean)
    w, h = image.size
    if w == h:
        return processor(image)
    s = max(w, h)
    sq = Image.new("RGB", (s, s), bg)
    sq.paste(image, ((s - w) // 2, (s - h) // 2))
    return processor(sq)
