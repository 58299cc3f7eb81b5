"""Video frame extraction (reference llava/utils.py:25-72
process_video_with_decord).

decord/pyav are absent from this environment (the reference degrades to a
printed warning in the same situation, llava/utils.py:21-23); PIL covers
multi-frame containers (GIF/animated WebP/TIFF), and a pre-extracted frame
directory works for everything else.  Output: a list of PIL frames the
multimodal pipeline treats as views of one "video" image.

The port's copy of lavida_mod_tpu/data/video.py (`av` and PIL imported
inside the functions that use them).  tests/test_torch_video.py holds it
equal to the original.
"""

from __future__ import annotations

import os
from typing import Sequence


def sample_frame_indices(total: int, num_frames: int) -> list[int]:
    if total <= num_frames:
        return list(range(total))
    step = total / num_frames
    return [min(int(i * step), total - 1) for i in range(num_frames)]


def load_video_frames_av(path: str, num_frames: int = 8) -> list:
    """pyav decode path (the reference's decord equivalent,
    llava/utils.py:25-72: uniform frame sampling over the container).
    Raises ImportError when `av` is absent — load_video_frames falls back
    to PIL/frame-dir exactly as the reference degrades without decord."""
    import av
    from PIL import Image

    with av.open(path) as container:
        stream = container.streams.video[0]
        total = stream.frames or sum(1 for _ in container.decode(stream))
        container.seek(0)
        want = set(sample_frame_indices(total, num_frames))
        frames = [
            Image.fromarray(f.to_ndarray(format="rgb24"))
            for i, f in enumerate(container.decode(stream)) if i in want
        ]
    return frames


def load_video_frames(path: str, num_frames: int = 8) -> list:
    """Video file (pyav when available) OR GIF/animated-image file OR
    directory of frame images -> PIL frames."""
    from PIL import Image, ImageSequence

    if path.lower().endswith((".mp4", ".avi", ".mov", ".mkv", ".webm")):
        try:
            return load_video_frames_av(path, num_frames)
        except ImportError:
            raise ImportError(
                f"decoding {path!r} needs the `av` (pyav) package, which "
                "is not installed; pre-extract frames to a directory or "
                "use an animated-image container"
            )
    if os.path.isdir(path):
        files = sorted(
            f for f in os.listdir(path)
            if f.lower().endswith((".png", ".jpg", ".jpeg", ".webp"))
        )
        idx = sample_frame_indices(len(files), num_frames)
        return [
            Image.open(os.path.join(path, files[i])).convert("RGB")
            for i in idx
        ]
    im = Image.open(path)
    frames = [f.convert("RGB") for f in ImageSequence.Iterator(im)]
    idx = sample_frame_indices(len(frames), num_frames)
    return [frames[i] for i in idx]


def frames_to_views(frames: Sequence, processor) -> "np.ndarray":
    """Frames -> [F, C, S, S] square views (video path skips anyres; the
    reference pools each frame with get_2dPool like a base view)."""
    import numpy as np

    return np.stack([processor(f) for f in frames], axis=0)
