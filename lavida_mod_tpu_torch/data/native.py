"""ctypes bridge to the repository's host C++ (`csrc/image_prep.cpp`, the
image resample + normalize, and `csrc/bpe.cpp`, the BPE merge engine): the
port of lavida_mod_tpu/data/native.py.  Host code, not a device kernel.

Each library is built at first use with g++ (the flags of csrc/Makefile)
into the port's `build/` directory (gitignored), never into `csrc/`, under
a name keyed by the source, the flags and the host CPU's feature flags
(`-march=native` code must not be loaded on another CPU).  The build
writes a temporary file and renames it, so concurrent processes never load
a half-written library.  Every entry point falls back to Python (None)
when the compiler or the library is unavailable, as the JAX package's do.

`load_bpe_native(vocab, merges)` is what `ByteLevelBPE` takes when it is
built (data/tokenizer.py): the merge rules projected through the vocab,
(id(l), id(r)) -> (id(l+r), rank), one C call per encode.  The image
entry points give the PIL pipeline's output to the uint8 quantization
boundary (PIL quantizes after each resample pass; so does the library).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LDFLAGS = ("-shared", "-lpthread")

FILTER_BILINEAR = 0
FILTER_BICUBIC = 1
FILTER_LANCZOS = 2

_libs: dict[str, Optional[ctypes.CDLL]] = {}


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return b""


def library_path(name: str) -> Path:
    """Where lib<name>.so of the current source, flags and CPU lives."""
    h = hashlib.sha256(" ".join(CXXFLAGS + LDFLAGS).encode())
    h.update((CSRC / f"{name}.cpp").read_bytes())
    h.update(_cpu_flags())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cpp unless built; raises when g++ fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXXFLAGS, str(CSRC / f"{name}.cpp"), "-o",
                        tmp, *LDFLAGS], check=True, capture_output=True,
                       timeout=300)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load(name: str) -> Optional[ctypes.CDLL]:
    """lib<name> built and loaded once per process, or None."""
    if name in _libs:
        return _libs[name]
    lib = None
    try:
        lib = ctypes.CDLL(str(build(name)))
    except (OSError, subprocess.SubprocessError):
        lib = None
    if lib is not None and name == "image_prep":
        lib.prep_view.restype = ctypes.c_int
        lib.prep_pad_view.restype = ctypes.c_int
    elif lib is not None:
        lib.bpe_new.restype = ctypes.c_void_p
        lib.bpe_new.argtypes = [ctypes.c_int] + [
            ctypes.POINTER(ctypes.c_int)] * 4
        lib.bpe_free.argtypes = [ctypes.c_void_p]
        lib.bpe_free.restype = None
        lib.bpe_apply.restype = ctypes.c_int
        lib.bpe_apply.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
    _libs[name] = lib
    return lib


def native_available() -> bool:
    return _load("image_prep") is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def prep_view_native(
    image: np.ndarray,                  # uint8 [H, W, C]
    out_size: tuple[int, int],          # (h, w)
    filter_id: int = FILTER_BICUBIC,
    rescale: float = 1 / 255,
    mean: Sequence[float] = (0.5, 0.5, 0.5),
    std: Sequence[float] = (0.5, 0.5, 0.5),
) -> Optional[np.ndarray]:
    """Resample + normalize -> float32 [C, h, w]; None if native unavailable."""
    lib = _load("image_prep")
    if lib is None:
        return None
    image = np.ascontiguousarray(image, np.uint8)
    h, w, c = image.shape
    oh, ow = out_size
    dst = np.empty((c, oh, ow), np.float32)
    m = (ctypes.c_double * c)(*mean[:c])
    s = (ctypes.c_double * c)(*std[:c])
    rc = lib.prep_view(_ptr(image, ctypes.c_uint8), h, w, c,
                       _ptr(dst, ctypes.c_float), oh, ow, filter_id,
                       ctypes.c_double(rescale), m, s)
    return dst if rc == 0 else None


def prep_pad_view_native(
    image: np.ndarray,
    target: tuple[int, int],            # (h, w) canvas
    inner: tuple[int, int],             # (h, w) resized content
    paste: tuple[int, int],             # (y, x)
    filter_id: int = FILTER_BICUBIC,
    rescale: float = 1 / 255,
    mean: Sequence[float] = (0.5, 0.5, 0.5),
    std: Sequence[float] = (0.5, 0.5, 0.5),
) -> Optional[np.ndarray]:
    lib = _load("image_prep")
    if lib is None:
        return None
    image = np.ascontiguousarray(image, np.uint8)
    h, w, c = image.shape
    th, tw = target
    nh, nw = inner
    py, px = paste
    dst = np.empty((c, th, tw), np.float32)
    m = (ctypes.c_double * c)(*mean[:c])
    s = (ctypes.c_double * c)(*std[:c])
    rc = lib.prep_pad_view(_ptr(image, ctypes.c_uint8), h, w, c,
                           _ptr(dst, ctypes.c_float), th, tw, nh, nw, py, px,
                           filter_id, ctypes.c_double(rescale), m, s)
    return dst if rc == 0 else None


class NativeBPE:
    """Integer-domain BPE merge table + one-call-per-encode bridge
    (csrc/bpe.cpp).  The merge rules are ByteLevelBPE.ranks projected
    through the vocab: (id(l), id(r)) -> (id(l+r), rank)."""

    def __init__(self, lib, ctx):
        self._lib = lib
        self._ctx = ctx

    def __del__(self):
        if getattr(self, "_ctx", None):
            self._lib.bpe_free(self._ctx)
            self._ctx = None

    def apply(self, words: Sequence[Sequence[int]]) -> list:
        if not words:
            return []
        flat = np.asarray([v for w in words for v in w], dtype=np.int32)
        ends = np.cumsum([len(w) for w in words]).astype(np.int32)
        out = np.empty_like(flat)
        n = self._lib.bpe_apply(self._ctx, _ptr(flat, ctypes.c_int),
                                len(flat), _ptr(ends, ctypes.c_int),
                                len(ends), _ptr(out, ctypes.c_int))
        return out[:n].tolist()


def load_bpe_native(vocab: dict, merges) -> Optional[NativeBPE]:
    lib = _load("bpe")
    if lib is None:
        return None
    lhs, rhs, mrg, rank = [], [], [], []
    for i, (l, r) in enumerate(merges):
        li, ri, mi = vocab.get(l), vocab.get(r), vocab.get(l + r)
        if li is None or ri is None or mi is None:
            continue
        lhs.append(li)
        rhs.append(ri)
        mrg.append(mi)
        rank.append(i)
    arrs = [np.asarray(v, np.int32) for v in (lhs, rhs, mrg, rank)]
    ctx = lib.bpe_new(len(lhs), *(_ptr(a, ctypes.c_int) for a in arrs))
    if not ctx:
        return None
    return NativeBPE(lib, ctx)
