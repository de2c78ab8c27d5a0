"""ctypes bindings + on-demand build of the native C++ library (csrc/).

The reference engine's host-side runtime is C++ (tokenizer, weight loader,
sampling loop — see SURVEY.md §2); this module is the bridge to this
repo's C++ equivalents:

- ``csrc/tokenizer.cc`` — trie + score-ordered-heap BPE encode/decode
  (reference: src/models/tokenizer.h:57-348);
- ``csrc/weight_loader.cc`` — parallel pread + threaded dtype cast and
  [out, in] -> [in, out] transpose (reference: src/utils/weight_utils.cu:132-229).

The library is built lazily with g++ (or loaded from a previous build, or
from $LLM_NATIVE_LIB); every consumer has a pure-Python fallback, so the
framework degrades gracefully when no C++ toolchain exists.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

__all__ = ["load_native", "native_available", "DT_F32", "DT_F16", "DT_BF16",
           "DT_I8", "dtype_code"]

DT_F32, DT_F16, DT_BF16, DT_I8 = 0, 1, 2, 3

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_REPO, "csrc")
_LIB_PATH = os.path.join(_CSRC, "build", "libllm_native.so")
_SOURCES = ("tokenizer.cc", "weight_loader.cc")

_lock = threading.Lock()
_lib = None
_load_failed = False


def dtype_code(dtype) -> int:
    """np/jnp dtype -> native code."""
    import numpy as np
    name = np.dtype(dtype).name  # ml_dtypes registers bfloat16 with numpy
    codes = {"float32": DT_F32, "float16": DT_F16, "bfloat16": DT_BF16,
             "int8": DT_I8}
    if name not in codes:
        raise ValueError(f"unsupported native dtype {dtype}")
    return codes[name]


def _build() -> str | None:
    """Compile csrc/ into libllm_native.so with g++ directly (no cmake
    configure step; csrc/CMakeLists.txt exists for standalone builds)."""
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        return None
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    srcs = [os.path.join(_CSRC, s) for s in _SOURCES]
    newest_src = max(os.path.getmtime(s) for s in srcs)
    if (os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= newest_src):
        return _LIB_PATH
    # one temporary per process: parallel test workers may all build at
    # once, and each rename must find its own file
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = [gxx, "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp,
           *srcs, "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=180)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired):
        return None
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.llm_tok_new.restype = c.c_void_p
    lib.llm_tok_new.argtypes = [c.c_int32] * 4
    lib.llm_tok_free.argtypes = [c.c_void_p]
    lib.llm_tok_add_piece.argtypes = [c.c_void_p, c.c_char_p, c.c_int32,
                                      c.c_int32, c.c_float]
    lib.llm_tok_encode.restype = c.c_int32
    lib.llm_tok_encode.argtypes = [c.c_void_p, c.c_char_p, c.c_int32,
                                   c.c_int32, c.c_int32,
                                   c.POINTER(c.c_int32), c.c_int32]
    lib.llm_tok_decode.restype = c.c_int32
    lib.llm_tok_decode.argtypes = [c.c_void_p, c.POINTER(c.c_int32),
                                   c.c_int32, c.c_char_p, c.c_int32]
    lib.llm_read_file.restype = c.c_int32
    lib.llm_read_file.argtypes = [c.c_char_p, c.c_int64, c.c_int64,
                                  c.c_void_p]
    lib.llm_cast.argtypes = [c.c_void_p, c.c_int32, c.c_void_p, c.c_int32,
                             c.c_int64]
    lib.llm_transpose_cast.argtypes = [c.c_void_p, c.c_int32, c.c_void_p,
                                       c.c_int32, c.c_int64, c.c_int64]
    return lib


def load_native() -> ctypes.CDLL | None:
    """The shared library, building it on first use. None if unavailable
    (no toolchain / build failed / LLM_NATIVE=0)."""
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed or os.environ.get("LLM_NATIVE", "1") == "0":
        return None
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        path = os.environ.get("LLM_NATIVE_LIB") or _build()
        if path is None or not os.path.exists(path):
            _load_failed = True
            return None
        try:
            _lib = _bind(ctypes.CDLL(path))
        except OSError:
            _load_failed = True
            return None
    return _lib


def native_available() -> bool:
    return load_native() is not None
