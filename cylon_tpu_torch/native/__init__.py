"""Host-side C++ helpers for string keys (port of ``cylon_tpu/native``).

``strhash.cpp`` (a copy of the reference's) hashes UTF-8 values with
MurmurHash64A and builds the prefix lanes of the lexical sort of hashed
string keys.  It is host code, not a device kernel: it compiles with
``g++`` at first use into ``cylon_tpu_torch/kernels/_build/`` (to a
temporary name, then ``os.replace``d into place, so a failed build never
leaves a partial library) and loads through ctypes, both through the
compile tier (exec/compiler.py), as the CUDA kernels do.

The values travel as Arrow's ``large_string`` layout — one ``uint8``
data buffer and ``n + 1`` int64 offsets — built here with numpy (UTF-8
encode, then a cumulative sum of the lengths); a null (``None``) is the
empty string, as in the reference.  Without a C++ toolchain every call
raises :class:`~cylon_tpu_torch.status.KernelError`: there is no other
hash, since any other would code strings differently from the
reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import threading

import numpy as np

from ..status import KernelError

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(_HERE, "strhash.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "kernels", "_build")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()


def _open(so: str) -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:
        raise KernelError(f"cannot load {so}: {e}") from e
    P, LL = ctypes.c_void_p, ctypes.c_int64
    lib.cylon_hash_strings.argtypes = [P, P, LL, P]
    lib.cylon_hash_strings.restype = None
    lib.cylon_prefix_lanes.argtypes = [P, P, LL, LL, P]
    lib.cylon_prefix_lanes.restype = None
    lib.cylon_max_adjacent_lcp.argtypes = [P, P, P, LL]
    lib.cylon_max_adjacent_lcp.restype = LL
    return lib


def _load() -> ctypes.CDLL:
    """The loaded library: the compile ledger's live handle, else built
    (through the compile tier, exec/compiler.build_all) if needed and
    loaded."""
    from ..exec import compiler
    with _lock:
        lib = compiler.live("strhash")
        if lib is not None:
            return lib
        cxx = shutil.which("g++")
        if cxx is None:
            raise KernelError("g++ not found: the string hash (native/"
                              "strhash.cpp) cannot be built")
        with open(_SOURCE, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode())
        sig = digest.hexdigest()[:16]
        so = os.path.join(compiler.build_dir(_BUILD_DIR),
                          f"libstrhash-{sig}.so")
        built = not compiler.usable(so)
        if built:
            tmp = f"{so}.{os.getpid()}.tmp"
            compiler.build_all([compiler.Job(
                "strhash", sig, [cxx, *_FLAGS, _SOURCE, "-o", tmp], tmp,
                so)])
        return compiler.admit("strhash", so, _open, built)


def utf8_buffers(values) -> tuple:
    """``(data uint8, offsets int64)`` of an object/str array in Arrow's
    ``large_string`` layout: value i is ``data[offsets[i]:offsets[i+1]]``,
    a null (``None``) the empty string."""
    enc = [b"" if v is None else v.encode("utf-8") for v in values]
    offsets = np.zeros(len(enc) + 1, np.int64)
    np.cumsum(np.fromiter(map(len, enc), np.int64, len(enc)),
              out=offsets[1:])
    data = np.frombuffer(b"".join(enc), np.uint8) if offsets[-1] \
        else np.zeros(1, np.uint8)
    return data, offsets


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def hash_strings(values) -> np.ndarray:
    """Stable 64-bit MurmurHash64A of each value's UTF-8 bytes (uint64),
    bit-equal to ``cylon_tpu.native.hash_strings`` with its native
    library."""
    lib = _load()
    data, offsets = utf8_buffers(values)
    n = len(offsets) - 1
    out = np.empty(n, np.uint64)
    lib.cylon_hash_strings(_ptr(data), _ptr(offsets), ctypes.c_int64(n),
                           _ptr(out))
    return out


def prefix_lanes(values, n_lanes: int, buffers=None) -> np.ndarray:
    """Big-endian u32 order lanes of each value's first ``4·n_lanes``
    UTF-8 bytes, zero-filled: ``(n, n_lanes)`` uint32 whose lane order is
    bytewise order.  ``buffers``: the values' :func:`utf8_buffers`, when
    the caller has them."""
    lib = _load()
    data, offsets = buffers if buffers is not None else utf8_buffers(values)
    n = len(offsets) - 1
    out = np.empty((n, int(n_lanes)), np.uint32)
    lib.cylon_prefix_lanes(_ptr(data), _ptr(offsets), ctypes.c_int64(n),
                           ctypes.c_int64(int(n_lanes)), _ptr(out))
    return out


def max_adjacent_lcp(values_in_order, buffers=None, order=None) -> int:
    """Longest common prefix in bytes over adjacent pairs of distinct
    values (callers pass sorted unique values, which makes it the largest
    over all distinct pairs).  ``order``: the values' positions in sorted
    order, when ``buffers`` hold them unsorted."""
    lib = _load()
    data, offsets = buffers if buffers is not None \
        else utf8_buffers(values_in_order)
    n = len(offsets) - 1
    order = np.arange(n, dtype=np.int64) if order is None \
        else np.ascontiguousarray(order, dtype=np.int64)
    if order.shape != (n,):
        raise ValueError(f"order holds {order.shape} positions for {n} "
                         "values")
    return int(lib.cylon_max_adjacent_lcp(_ptr(data), _ptr(offsets),
                                          _ptr(order), ctypes.c_int64(n)))


def utf8_lengths(values, buffers=None) -> np.ndarray:
    """Byte length of each value's UTF-8 encoding (int64)."""
    _, offsets = buffers if buffers is not None else utf8_buffers(values)
    return np.diff(offsets)
