"""Anyres geometry and image preprocessing, host-side (numpy + PIL)."""
from .anyres import (  # noqa: F401
    anyres_grid_shape,
    divide_to_patches,
    process_anyres_image,
    resize_and_pad_image,
    select_best_resolution,
    unpad_slice,
)
from .image_processor import SigLIPImageProcessor, process_images  # noqa: F401
