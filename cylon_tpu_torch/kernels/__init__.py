"""Hand-written CUDA kernels for Hopper: build at first use, load with ctypes.

Each ``<name>.cu`` in this directory compiles with ``nvcc`` into a shared
library with a plain C interface, ``_build/lib<name>-<digest>.so``, where
the digest covers the source and the flags: a changed source rebuilds, an
unchanged one loads the library already built.  Nothing here runs when the
package is imported; :func:`build` starts one ``nvcc`` per source, all at
once, and waits for them all.

A build or load failure raises :class:`~cylon_tpu_torch.status.KernelError`;
there is no fallback.  :func:`load` gives each C entry its ctypes
signature (:data:`SIGNATURES`) once, when it loads the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
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
_libs: dict = {}
#: name -> ptxas report (registers, spills) of the build in this process
build_logs: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise KernelError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> str:
    src = os.path.join(KERNEL_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names=SOURCES) -> dict:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all running at once.  Returns {name: library path}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        target = library_path(name)
        if os.path.exists(target):
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(KERNEL_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
    if failed:
        raise KernelError("kernel build failed: " + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed, its C
    entries' signatures set."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build((name,))[name]
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise KernelError(f"cannot load {path}: {e}") from e
            for entry, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib
