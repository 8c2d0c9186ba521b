"""Windowed run-start gather — the fused groupby's one gather (counterpart of
``cylon_tpu/ops/pallas_gather.py``, TPU kernel K1).

``ops/groupby.grouped_reduce`` ends in ONE gather of a lane-major (L, M)
32-bit matrix at SORTED, dense run starts.  Each 256-row output tile then
reads from a bounded source window of W columns starting at the tile's
128-aligned head.  The contract, kept bit-for-bit from the TPU kernel:

* ``ws = min(floor(idx[tile head] / 128) * 128, M128 - W)`` with ``M128``
  the row count padded to 128 (padding columns read as 0);
* an output row whose index falls outside ``[ws, ws + W)`` comes out 0;
* ``ok`` is False when some tile's last index lies at or past
  ``ws + W``; the caller then discards the result and redispatches the
  plain gather (relational/fused.py).

On a CUDA tensor :func:`windowed_take_t` launches the hand-written kernel
``kernels/windowed_gather.cu``; on a CPU tensor it runs
:func:`windowed_take_plain`, the same contract in plain torch.  There is no
other fallback: a build or launch failure raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import config
from ..status import InvalidError, KernelError

#: output rows per tile (one CTA on the card)
TILE = 256
#: don't attempt the windowed path below this measured group density
MIN_DENSITY = 0.10
MIN_WINDOW, MAX_WINDOW = 1024, 4096

#: launch counts: ``launches`` counts kernel launches (never plain-version
#: calls); ``redispatches`` counts fused dispatches rerun because ``ok``
#: came back False.  Reset with :func:`reset_counts`.
COUNTS = {"launches": 0, "redispatches": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def pick_window(density_est: float) -> int:
    """Window size for a measured density: cover the average span
    TILE/density with ~1.8x margin, clamped to pow2 bounds."""
    want = int(TILE / max(density_est, 1e-6) * 1.8)
    return max(MIN_WINDOW, min(MAX_WINDOW, config.pow2ceil(want)))


def supported(n_rows: int, seg_cap: int, n_lanes: int, window: int) -> bool:
    """Static eligibility of the windowed path for a gather of ``seg_cap``
    sorted indices into an (n_lanes, n_rows) matrix."""
    return (seg_cap % TILE == 0 and seg_cap >= TILE
            and n_rows >= window and n_lanes >= 1)


def _window_starts(idx: torch.Tensor, m: int, window: int) -> torch.Tensor:
    m128 = -(-m // 128) * 128
    heads = idx[::TILE].to(torch.int64)
    return torch.clamp_max(torch.div(heads, 128, rounding_mode="floor") * 128,
                           m128 - window)


def windowed_take_plain(mat_t: torch.Tensor, idx: torch.Tensor,
                        window: int):
    """Plain-torch version of the kernel's contract: ``(out, ok)`` with out
    (L, S) int32 and ok a 0-dim bool tensor (module docstring)."""
    L, M = mat_t.shape
    i = idx.to(torch.int64)
    ws = _window_starts(i, M, window)
    rel = i - ws.repeat_interleave(TILE)
    take = (rel >= 0) & (rel < window) & (i >= 0) & (i < M)
    ok = torch.all(i[TILE - 1::TILE] - ws < window)
    src = torch.where(take, i, 0)
    out = torch.where(take, mat_t[:, src], torch.zeros((), dtype=mat_t.dtype,
                                                       device=mat_t.device))
    return out, ok


def _launch(mat_t: torch.Tensor, idx: torch.Tensor, window: int):
    if mat_t.dtype != torch.int32 or mat_t.dim() != 2 \
            or not mat_t.is_contiguous():
        raise InvalidError("mat_t must be a contiguous (L, M) int32 tensor")
    if idx.dim() != 1 or idx.device != mat_t.device:
        raise InvalidError("idx must be 1-D on mat_t's device")
    L, M = mat_t.shape
    S = idx.shape[0]
    if not supported(M, S, L, window):
        raise InvalidError(f"windowed gather unsupported for M={M} S={S} "
                           f"L={L} W={window}")
    idx = idx.to(torch.int32).contiguous()
    out = torch.empty((L, S), dtype=torch.int32, device=mat_t.device)
    ok = torch.ones(1, dtype=torch.int32, device=mat_t.device)
    from .. import kernels
    fn = kernels.load("windowed_gather").cylon_windowed_take
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(mat_t.device).cuda_stream
    m128 = -(-M // 128) * 128
    rc = fn(mat_t.data_ptr(), M, L, idx.data_ptr(), S, m128, window,
            out.data_ptr(), ok.data_ptr(), stream)
    if rc != 0:
        raise KernelError(f"windowed_gather launch failed: cudaError {rc}")
    COUNTS["launches"] += 1
    return out, ok[0] != 0


def windowed_take_t(mat_t: torch.Tensor, idx: torch.Tensor, window: int):
    """``mat_t[:, idx]`` under the window contract for SORTED ``idx`` into
    a lane-major (L, M) int32 ``mat_t``.  Returns ``(out, ok)``: out is
    (L, S) int32, ok a 0-dim bool tensor.  Caller ensures
    :func:`supported`.  A CUDA tensor launches the kernel; a CPU tensor
    takes :func:`windowed_take_plain`."""
    if mat_t.device.type == "cuda":
        return _launch(mat_t, idx, window)
    if mat_t.device.type == "cpu":
        return windowed_take_plain(mat_t, idx, window)
    raise InvalidError(f"no windowed gather for device {mat_t.device}")
