"""Windowed run-start gather — the fused groupby's one gather (counterpart of
``cylon_tpu/ops/pallas_gather.py``, TPU kernel K1).

``ops/groupby.grouped_reduce`` ends in ONE gather of L 32-bit lanes at
SORTED, dense run starts.  Each 256-row output tile then reads from a
bounded source window of W columns starting at the tile's 128-aligned
head.  The contract, kept bit-for-bit from the TPU kernel:

* ``ws = min(floor(idx[tile head] / 128) * 128, M128 - W)`` with ``M128``
  the row count padded to 128 (padding columns read as 0);
* an output row whose index falls outside ``[ws, ws + W)`` comes out 0;
* ``ok`` is False when some tile's last index lies at or past
  ``ws + W``; the caller then discards the result and redispatches the
  plain gather (relational/fused.py).

The lanes come as an ``(L, M)`` int32 matrix, as the TPU kernel takes
them, or as a sequence of L contiguous ``(M,)`` int32 tensors of one
length on one device: the kernel reads either through L lane pointers, so
its caller needs no stacked matrix.

On a CUDA tensor :func:`windowed_take_t` launches the hand-written kernel
``kernels/windowed_gather.cu``; on a CPU tensor it runs
:func:`windowed_take_plain`, the same contract in plain torch.  There is no
other fallback: a build or launch failure raises.
"""

from __future__ import annotations

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


def as_lanes(lanes) -> tuple:
    """The L lanes of an ``(L, M)`` int32 matrix (its rows, as views) or of
    a sequence of ``(M,)`` int32 tensors.  Raises :class:`InvalidError`
    unless every lane is a contiguous int32 tensor of one length on one
    device."""
    if isinstance(lanes, torch.Tensor):
        if lanes.dim() != 2 or lanes.dtype != torch.int32 \
                or not lanes.is_contiguous():
            raise InvalidError("a lane matrix must be a contiguous (L, M) "
                               "int32 tensor")
        lanes = lanes.unbind(0)
    lanes = tuple(lanes)
    if not lanes:
        raise InvalidError("the gather needs at least one lane")
    first = lanes[0]
    for lane in lanes:
        if not isinstance(lane, torch.Tensor) or lane.dim() != 1 \
                or lane.dtype != torch.int32 or not lane.is_contiguous():
            raise InvalidError("every lane must be a contiguous 1-D int32 "
                               "tensor")
        if lane.shape != first.shape or lane.device != first.device:
            raise InvalidError("lanes must have one length and one device")
    return lanes


def _window_starts(idx: torch.Tensor, m: int, window: int) -> torch.Tensor:
    m128 = -(-m // 128) * 128
    heads = idx[::TILE].to(torch.int64)
    return torch.clamp_max(torch.div(heads, 128, rounding_mode="floor") * 128,
                           m128 - window)


def windowed_take_plain(lanes, idx: torch.Tensor, window: int):
    """Plain-torch version of the kernel's contract: ``(out, ok)`` with out
    (L, S) int32 and ok a 0-dim bool tensor (module docstring).  ``lanes``
    is a matrix or a lane sequence, gathered lane by lane."""
    lanes = as_lanes(lanes)
    M = lanes[0].shape[0]
    i = idx.to(torch.int64)
    ws = _window_starts(i, M, window)
    rel = i - ws.repeat_interleave(TILE)
    take = (rel >= 0) & (rel < window) & (i >= 0) & (i < M)
    ok = torch.all(i[TILE - 1::TILE] - ws < window)
    src = torch.where(take, i, 0)
    zero = torch.zeros((), dtype=torch.int32, device=lanes[0].device)
    out = torch.stack([torch.where(take, lane[src], zero) for lane in lanes])
    return out, ok


def lane_pointers(lanes: tuple) -> list:
    """The kernel's lane descriptor: each lane's address."""
    return [lane.data_ptr() for lane in lanes]


def _launch(lanes: tuple, idx: torch.Tensor, window: int):
    """Launch the kernel on CUDA lanes (:func:`as_lanes`' tuple):
    ``(out, ok)`` as :func:`windowed_take_t`."""
    dev = lanes[0].device
    if idx.dim() != 1 or idx.device != dev:
        raise InvalidError("idx must be 1-D on the lanes' device")
    L, M, S = len(lanes), lanes[0].shape[0], idx.shape[0]
    if not supported(M, S, L, window):
        raise InvalidError(f"windowed gather unsupported for M={M} S={S} "
                           f"L={L} W={window}")
    idx = idx.to(torch.int32).contiguous()
    # a pinned, non-blocking upload: the lane pointers ride the stream
    desc = torch.tensor(lane_pointers(lanes), dtype=torch.int64) \
        .pin_memory().to(dev, non_blocking=True)
    out = torch.empty((L, S), dtype=torch.int32, device=dev)
    ok = torch.ones(1, dtype=torch.int32, device=dev)
    from .. import kernels
    fn = kernels.load("windowed_gather").cylon_windowed_take
    m128 = -(-M // 128) * 128
    rc = fn(desc.data_ptr(), M, L, idx.data_ptr(), S, m128, window,
            out.data_ptr(), ok.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise KernelError(f"windowed_gather launch failed: cudaError {rc}")
    COUNTS["launches"] += 1
    return out, ok[0] != 0


def windowed_take_t(lanes, idx: torch.Tensor, window: int):
    """``lane_l[idx]`` for every lane under the window contract, for SORTED
    ``idx`` into an ``(L, M)`` int32 matrix or a sequence of L ``(M,)``
    int32 lanes (module docstring).  Returns ``(out, ok)``: out is (L, S)
    int32, ok a 0-dim bool tensor.  Caller ensures :func:`supported`.  A
    CUDA tensor launches the kernel; a CPU tensor takes
    :func:`windowed_take_plain`."""
    lanes = as_lanes(lanes)
    dev = lanes[0].device
    if dev.type == "cuda":
        return _launch(lanes, idx, window)
    if dev.type == "cpu":
        return windowed_take_plain(lanes, idx, window)
    raise InvalidError(f"no windowed gather for device {dev}")
