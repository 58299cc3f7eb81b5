"""The safetensors format, read and written by the port itself (the card
machine has no `safetensors` package).

A file is an 8-byte little-endian header length N, N bytes of JSON
{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{str: str}} padded with spaces to a multiple of 8, then the raw
little-endian bytes of every tensor, each at its offsets from the end of
the header.

`SafetensorsFile` reads the header and memory-maps the data tensor by
tensor: `get(name)` is a CPU tensor over a mapping of its own bytes (no
copy), which is unmapped when the tensor is dropped.  So streaming a
large file tensor by tensor into the device keeps the process's resident
memory near one tensor.  One mapping of the whole file would not: where
madvise(MADV_DONTNEED) does not give a private file mapping's pages back
(some sandboxed kernels ignore it), every page read stays resident until
the whole file is unmapped.  `save_file` writes tensors
(CPU or CUDA, each copied to the host one at a time) in the layout of
the `safetensors` package: tensors ordered by dtype as its Dtype enum
ranks them (I64, F64, F32, I32, BF16, F16, I16, I8, U8, BOOL), then by
name; the header's entries in the order of their offsets.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Mapping, Optional

import torch

DTYPES: dict[str, torch.dtype] = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I8": torch.int8, "U8": torch.uint8,
    "I16": torch.int16, "I32": torch.int32, "I64": torch.int64,
    "BOOL": torch.bool,
}
NAMES: dict[torch.dtype, str] = {v: k for k, v in DTYPES.items()}


class SafetensorsFile:
    """One .safetensors file: its header read, `keys()`, `get(name)` and
    `metadata`; close() (or a `with` block) closes the file, and a tensor
    already taken stays valid."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "rb")
        try:
            (n,) = struct.unpack("<Q", self._file.read(8))
            header = json.loads(self._file.read(n))
            size = os.fstat(self._file.fileno()).st_size
            self.metadata: dict = header.pop("__metadata__", None) or {}
            self._base = 8 + n
            self.entries: dict[str, tuple[str, tuple, int, int]] = {}
            for name, e in header.items():
                begin, end = e["data_offsets"]
                shape = tuple(int(s) for s in e["shape"])
                if e["dtype"] not in DTYPES:
                    raise ValueError(f"{path}: {name} has dtype "
                                     f"{e['dtype']}, not one of "
                                     f"{sorted(DTYPES)}")
                numel = 1
                for s in shape:
                    numel *= s
                want = numel * DTYPES[e["dtype"]].itemsize
                if end - begin != want or self._base + end > size:
                    raise ValueError(f"{path}: {name} spans bytes [{begin}, "
                                     f"{end}), its shape {shape} needs "
                                     f"{want}")
                self.entries[name] = (e["dtype"], shape, begin, end)
        except Exception:
            self._file.close()
            raise

    def keys(self):
        return self.entries.keys()

    def get(self, name: str) -> torch.Tensor:
        """The tensor over a mapping of its own bytes (copy-on-write, so
        the tensor is writable and the file never changes).  The mapping
        lives as long as the tensor: drop the tensor and its pages leave
        the process.  A copy only where the bytes are not aligned to the
        element size."""
        dt, shape, begin, end = self.entries[name]
        dtype = DTYPES[dt]
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        start = self._base + begin
        lo = start - start % mmap.ALLOCATIONGRANULARITY
        mm = mmap.mmap(self._file.fileno(), self._base + end - lo,
                       offset=lo, access=mmap.ACCESS_COPY)
        if start % dtype.itemsize:
            raw = torch.frombuffer(mm, dtype=torch.uint8, count=end - begin,
                                   offset=start - lo).clone()
            return raw.view(dtype).reshape(shape)
        return torch.frombuffer(mm, dtype=dtype,
                                count=(end - begin) // dtype.itemsize,
                                offset=start - lo).reshape(shape)

    def close(self) -> None:
        self._file.close()

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_file(path: str, device="cpu") -> dict[str, torch.Tensor]:
    """Every tensor of `path`, copied out of its mapping to `device`."""
    with SafetensorsFile(path) as f:
        out = {k: f.get(k).to(device, copy=True) for k in f.keys()}
    return out


# the rank of each dtype in the `safetensors` package's Dtype enum, by which
# it orders a file's tensors (highest first, then by name)
_RANK = {"BOOL": 0, "U8": 1, "I8": 2, "I16": 5, "F16": 7, "BF16": 8,
         "I32": 9, "F32": 11, "F64": 12, "I64": 13}


def _order(tensors: Mapping[str, torch.Tensor]) -> list[str]:
    return sorted(tensors,
                  key=lambda k: (-_RANK[NAMES[tensors[k].dtype]], k))


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[dict] = None) -> int:
    """Write `tensors` to `path` in the `safetensors` package's layout;
    returns the bytes of tensor data written.  Each tensor is copied to
    the host on its own as it is written."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    bad = [k for k, t in tensors.items() if t.dtype not in NAMES]
    if bad:
        raise ValueError(f"{bad[0]}: dtype {tensors[bad[0]].dtype} has no "
                         f"safetensors name")
    names = _order(tensors)
    off = 0
    for k in names:
        t = tensors[k]
        n = t.numel() * t.element_size()
        header[k] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [off, off + n]}
        off += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for k in names:
            t = tensors[k].detach().to("cpu").contiguous()
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)
    return off
