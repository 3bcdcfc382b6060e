"""Reader of the safetensors checkpoint format, with no package behind it.

A file is an 8-byte little-endian header length N, N bytes of JSON, then
the tensors' raw little-endian bytes.  The header maps each tensor's name
to {"dtype", "shape", "data_offsets": [begin, end]} (offsets from the end
of the header); an optional "__metadata__" entry holds strings and is
skipped.  BF16, F16 and F32 tensors are read, each as a float32 numpy
array: BF16 by widening its raw 16 bits into the high half of a float32,
which is exact.  Any other dtype is refused by name, never cast.

`SafetensorsSource` reads a checkpoint of several files through the
`keys()` / `collect()` surface the exporter uses.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, List

import numpy as np

# dtype name -> the little-endian numpy type of its raw items
_DTYPES = {"BF16": np.dtype("<u2"), "F16": np.dtype("<f2"),
           "F32": np.dtype("<f4")}


def _extract_layer_number(key: str) -> int:
    """The layer index of "model.layers.<n>.…", 0 for any other key."""
    parts = key.split(".")
    for i, part in enumerate(parts):
        if part == "layers":
            return int(parts[i + 1])
    return 0


class SafetensorsFile:
    """One memory-mapped safetensors file."""

    def __init__(self, path: str):
        self.path = path
        self.data = np.memmap(path, dtype=np.uint8, mode="r")
        if self.data.size < 8:
            raise ValueError(f"{path}: not a safetensors file")
        (n,) = struct.unpack("<Q", self.data[:8].tobytes())
        if 8 + n > self.data.size:
            raise ValueError(f"{path}: header of {n} bytes past the end")
        header = json.loads(self.data[8:8 + n].tobytes())
        self._base = 8 + n
        self.entries: Dict[str, dict] = {
            k: v for k, v in header.items() if k != "__metadata__"}

    def keys(self) -> List[str]:
        """The tensors' names, sorted (as `safetensors.safe_open` lists
        them)."""
        return sorted(self.entries)

    def get(self, key: str) -> np.ndarray:
        """The tensor `key` as a new contiguous float32 array."""
        e = self.entries[key]
        dtype = _DTYPES.get(e["dtype"])
        if dtype is None:
            raise ValueError(f"{self.path}: tensor {key} has dtype "
                             f"{e['dtype']}; only {sorted(_DTYPES)} are read")
        begin, end = e["data_offsets"]
        shape = tuple(e["shape"])
        n = int(np.prod(shape, dtype=np.int64))
        if end - begin != n * dtype.itemsize:
            raise ValueError(f"{self.path}: tensor {key} spans {end - begin}"
                             f" bytes for shape {shape} {e['dtype']}")
        raw = self.data[self._base + begin:self._base + end].view(dtype)
        if e["dtype"] == "BF16":
            out = raw.astype(np.uint32)
            out <<= 16
            out = out.view(np.float32)
        else:
            out = raw.astype(np.float32)
        return out.reshape(shape)


class SafetensorsSource:
    """A checkpoint of one or more safetensors files."""

    def __init__(self, paths: List[str]):
        self.files = [SafetensorsFile(p) for p in paths]

    def keys(self) -> List[str]:
        return [k for f in self.files for k in f.keys()]

    def collect(self, pattern: str, m_type: str = "model.layers",
                splits: int = 0, split_idx: int = -1) -> List[np.ndarray]:
        """Every tensor whose name holds both substrings, file by file and
        in layer order within a file (names in sorted order within a
        layer), as float32; with `splits`, only rows
        [split_idx, split_idx + 1) x (rows / splits) of each."""
        out = []
        for f in self.files:
            keys = [k for k in f.keys() if pattern in k and m_type in k]
            for key in sorted(keys, key=_extract_layer_number):
                w = f.get(key)
                if splits > 0:
                    size = w.shape[0] // splits
                    w = np.ascontiguousarray(
                        w[split_idx * size:(split_idx + 1) * size])
                out.append(w)
        return out
