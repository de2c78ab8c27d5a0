"""Native checkpoint IO: safetensors / raw-.bin reading through the C++
loader (csrc/weight_loader.cc) — parallel pread + threaded dtype cast and
transpose.

This is the host-side equivalent of the reference's C++/CUDA weight loader
(reference: src/utils/weight_utils.cu:132-229 — serial fread, H2D copy,
`typeConversion` cast kernel). The safetensors container format is parsed
here (8-byte little-endian header length, JSON header, raw data section);
the byte movement and numeric conversion run in C++ worker threads. Falls
back to numpy when the native library is unavailable.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any

import numpy as np

from llm_inference_engine.native import dtype_code, load_native

__all__ = ["SafeTensorsFile", "read_bin_tensor", "cast_array",
           "transpose_cast"]

_ST_DTYPES = {
    "F32": "float32", "F16": "float16", "BF16": "bfloat16",
    "I8": "int8", "I32": "int32", "I64": "int64", "U8": "uint8",
    "BOOL": "bool",
}


def _np_dtype(name: str):
    if name == "bfloat16":
        import ml_dtypes
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


def _read_bytes(path: str, offset: int, nbytes: int) -> np.ndarray:
    lib = load_native()
    out = np.empty(nbytes, np.uint8)
    if lib is not None:
        rc = lib.llm_read_file(os.fsencode(path), offset, nbytes,
                               out.ctypes.data)
        if rc == 0:
            return out
    with open(path, "rb") as f:
        f.seek(offset)
        f.readinto(memoryview(out))
    return out


def cast_array(src: np.ndarray, out_dtype) -> np.ndarray:
    """dtype conversion via the threaded native caster (numpy fallback)."""
    out_dtype = _np_dtype(np.dtype(out_dtype).name)
    if src.dtype == out_dtype:
        return src
    lib = load_native()
    try:
        din, dout = dtype_code(src.dtype), dtype_code(out_dtype)
    except ValueError:
        lib = None
    if lib is None or not src.flags.c_contiguous:
        return src.astype(out_dtype)
    out = np.empty(src.shape, out_dtype)
    lib.llm_cast(src.ctypes.data, din, out.ctypes.data, dout, src.size)
    return out


def transpose_cast(src: np.ndarray, out_dtype=None) -> np.ndarray:
    """[rows, cols] -> contiguous [cols, rows] with optional dtype cast —
    the HF [out, in] -> engine [in, out] canonicalization, done blocked and
    multithreaded in C++."""
    assert src.ndim == 2
    out_dtype = _np_dtype(np.dtype(out_dtype or src.dtype).name)
    lib = load_native()
    try:
        din, dout = dtype_code(src.dtype), dtype_code(out_dtype)
    except ValueError:
        lib = None
    if lib is None or not src.flags.c_contiguous:
        return np.ascontiguousarray(src.T).astype(out_dtype)
    rows, cols = src.shape
    out = np.empty((cols, rows), out_dtype)
    lib.llm_transpose_cast(src.ctypes.data, din, out.ctypes.data, dout,
                           rows, cols)
    return out


class SafeTensorsFile:
    """Minimal safetensors reader (header parsed in Python, data moved by
    the native loader). API: names, info(name) -> (dtype_name, shape),
    get(name, dtype=None, transpose=False)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (hlen,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(hlen))
        self._data_start = 8 + hlen
        self._entries: dict[str, tuple[str, tuple[int, ...], int, int]] = {}
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            start, end = meta["data_offsets"]
            self._entries[name] = (
                _ST_DTYPES[meta["dtype"]], tuple(meta["shape"]), start, end)

    @property
    def names(self):
        return set(self._entries)

    def info(self, name: str):
        dt, shape, _, _ = self._entries[name]
        return dt, shape

    def get(self, name: str, dtype: Any = None,
            transpose: bool = False) -> np.ndarray:
        dt, shape, start, end = self._entries[name]
        raw = _read_bytes(self.path, self._data_start + start, end - start)
        arr = raw.view(_np_dtype(dt)).reshape(shape)
        if transpose:
            return transpose_cast(arr, dtype or dt)
        if dtype is not None:
            return cast_array(arr, dtype)
        return arr


def read_bin_tensor(path: str, shape, src_dtype="float32",
                    out_dtype=None) -> np.ndarray:
    """Read one raw little-endian tensor file (the reference's per-tensor
    .bin checkpoint format, weight_utils.cu:132-187) with native IO."""
    nbytes = int(np.prod(shape)) * _np_dtype(src_dtype).itemsize
    raw = _read_bytes(path, 0, nbytes)
    arr = raw.view(_np_dtype(src_dtype)).reshape(shape)
    return cast_array(arr, out_dtype) if out_dtype else arr
