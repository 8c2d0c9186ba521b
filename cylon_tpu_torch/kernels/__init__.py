"""Hand-written CUDA kernels for Hopper: build at first use, load with ctypes.

Each ``<name>.cu`` in this directory compiles with ``nvcc`` into a shared
library with a plain C interface, ``lib<name>-<digest>.so``, where the
digest covers the source and the flags: a changed source rebuilds, an
unchanged one loads the library already built.  The libraries live in
``_build/`` here, or in ``<dir>/kernels`` when the compile tier's
persistent layer is armed (``CYLON_TPU_TORCH_COMPILE_CACHE_DIR``).
Nothing here runs when the package is imported; :func:`build` starts one
``nvcc`` per source, all at once, and waits for them all.

Every build and load goes through the compile tier (exec/compiler.py):
its counters, its ledger of loaded libraries, and, armed, the sha256
manifest, the intent journal and quarantine, and the watchdog.  A build
or load failure raises :class:`~cylon_tpu_torch.status.KernelError`
(``CompileQuarantinedError`` or ``CompileTimeoutError`` under the
tier); there is no fallback.  :func:`load` gives each C entry its ctypes
signature (:data:`SIGNATURES`) when it loads the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import threading

from ..status import KernelError

KERNEL_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(KERNEL_DIR, "_build")
#: every kernel source of the package (``<name>.cu``)
SOURCES = ("windowed_gather", "splitter_probe")
#: sm_90a: Hopper with its architecture-specific features
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: name -> {C entry: argument types}; every entry returns a cudaError_t int
SIGNATURES = {
    "windowed_gather": {
        # lane pointers, M, L, idx, S, M128, W, out, ok, stream
        "cylon_windowed_take": [_P, _LL, _I, _P, _LL, _LL, _I, _P, _P, _P]},
    "splitter_probe": {
        # descriptor, K, cap, S, vec, image bytes, images, out, stream
        "cylon_count_ge_splitters": [_P, _I, _LL, _I, _I, _I, _I, _P, _P]},
}

_lock = threading.Lock()
#: name -> ptxas report (registers, spills) of the build in this process
build_logs: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise KernelError("nvcc not found: the CUDA kernels cannot be built")
    return path


def digest(name: str) -> str:
    """The source-and-flags digest of kernel ``name`` (the library's name
    suffix, and the compile tier's quarantine key)."""
    src = os.path.join(KERNEL_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        d = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return d.hexdigest()[:16]


def library_path(name: str) -> str:
    from ..exec import compiler
    return os.path.join(compiler.build_dir(BUILD_DIR),
                        f"lib{name}-{digest(name)}.so")


def build(names=SOURCES) -> dict:
    """Compile every named kernel that has no usable library yet, one
    ``nvcc`` per source, all at once (exec/compiler.build_all).  Returns
    {name: library path}."""
    from ..exec import compiler
    jobs = []
    for name in names:
        target = library_path(name)
        if compiler.usable(target):
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(KERNEL_DIR, f"{name}.cu")]
        jobs.append(compiler.Job(name, digest(name), cmd, tmp, target))
    try:
        compiler.build_all(jobs)
    finally:
        for j in jobs:
            if j.log is not None:
                build_logs[j.label] = j.log
    return {name: library_path(name) for name in names}


def _open(name: str, path: str) -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        raise KernelError(f"cannot load {path}: {e}") from e
    for entry, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (the compile ledger's live
    handle, else its library loaded, built first if needed), its C
    entries' signatures set."""
    from ..exec import compiler
    with _lock:
        lib = compiler.live(name)
        if lib is None:
            path = library_path(name)
            built = not compiler.usable(path)
            if built:
                build((name,))
            lib = compiler.admit(name, path, lambda p: _open(name, p),
                                 built)
        return lib
