"""Parity: the port's windowed gather (cylon_tpu_torch/ops/windowed_gather)
against the Pallas kernel K1 (cylon_tpu/ops/pallas_gather) run in
interpret mode on the CPU.  On a CPU tensor the port runs its plain
version, which must reproduce the kernel's whole contract bit for bit:
gathered values, the zeros of rows outside their tile's window, and the
``ok`` flag.  The CUDA kernel itself is held against the same plain
version on the card by chip_smoke.py.

The port takes its lanes as an (L, M) matrix, as the Pallas kernel does,
or as a sequence of L separate (M,) lanes: every bit-equal case runs in
both forms."""

import jax
import numpy as np
import pytest
import torch

from cylon_tpu.ops import pallas_gather as pg
from cylon_tpu_torch.ops import windowed_gather as wg


def _mk(n_rows, n_lanes, seg, pattern, rng):
    """Same inputs as tests/test_pallas_gather.py: a lane-major (L, M) u32
    matrix and ``seg`` sorted indices (dense, skewed, or all sentinel)."""
    mat = rng.integers(0, 1 << 32, (n_lanes, n_rows), dtype=np.uint32)
    if pattern == "dense":
        k = min(int(n_rows * 0.45), seg)
        real = np.sort(rng.choice(n_rows - 1, k, replace=False))
    elif pattern == "skewed":
        k = min(int(n_rows * 0.45), seg)
        real = np.sort(rng.choice(n_rows // 8, k - 1, replace=False))
        real = np.concatenate([real, [n_rows - 1]])
    else:  # tail sentinels only
        real = np.zeros(0, np.int64)
    idx = np.full(seg, n_rows - 1, np.int32)
    idx[:len(real)] = real
    return mat, idx


def _port_lanes(mat, form):
    """The port's input: the matrix itself, or its rows as separate
    allocations."""
    if form == "matrix":
        return torch.from_numpy(mat.view(np.int32))
    return [torch.from_numpy(row.view(np.int32).copy()) for row in mat]


def _both(mat, idx, window, form):
    out_r, ok_r = jax.jit(lambda m, i: pg.windowed_take_t(
        m, i, window=window, interpret=True))(mat, idx)
    out_p, ok_p = wg.windowed_take_t(_port_lanes(mat, form),
                                     torch.from_numpy(idx), window)
    return (np.asarray(out_r), bool(np.asarray(ok_r)),
            out_p.numpy().view(np.uint32), bool(ok_p))


FORMS = pytest.mark.parametrize("form", ["matrix", "lanes"])


@FORMS
@pytest.mark.parametrize("n_lanes", [1, 7, 8, 13])
def test_dense_bit_equal(rng, n_lanes, form):
    mat, idx = _mk(4096, n_lanes, 2048, "dense", rng)
    out_r, ok_r, out_p, ok_p = _both(mat, idx, 1024, form)
    assert ok_r and ok_p
    np.testing.assert_array_equal(out_p, out_r)
    np.testing.assert_array_equal(out_p, mat[:, idx])


@FORMS
def test_sentinel_tail_bit_equal(rng, form):
    mat, idx = _mk(4096, 5, 1024, "tail", rng)
    out_r, ok_r, out_p, ok_p = _both(mat, idx, 1024, form)
    assert ok_r and ok_p
    np.testing.assert_array_equal(out_p, out_r)


@FORMS
def test_skewed_spans_flagged_and_zeroed(rng, form):
    # overflowing rows come out 0 in both, and ok is False in both
    mat, idx = _mk(1 << 15, 6, 4096, "skewed", rng)
    out_r, ok_r, out_p, ok_p = _both(mat, idx, 1024, form)
    assert not ok_r and not ok_p
    np.testing.assert_array_equal(out_p, out_r)
    assert (out_p == 0).any()


@FORMS
def test_unaligned_rows_read_padding_as_zero(rng, form):
    # M % 128 != 0: the clamp uses the 128-padded row count, so tail tiles
    # read padding columns; both must produce the same zeros
    mat, idx = _mk(4000, 3, 1024, "dense", rng)
    idx[-256:] = 3999
    out_r, ok_r, out_p, ok_p = _both(mat, idx, 1024, form)
    assert ok_r == ok_p
    np.testing.assert_array_equal(out_p, out_r)


def test_supported_gate():
    for args in [(1 << 20, 1 << 20, 8, 1024), (512, 1 << 20, 8, 1024),
                 (1 << 20, 100, 8, 1024), (4096, 256, 1, 4096),
                 (4096, 128, 1, 1024)]:
        assert wg.supported(*args) == pg.supported(*args), args


@pytest.mark.parametrize("dens", [0.45, 0.25, 0.2, 0.1, 0.05, 1.0])
def test_pick_window(dens):
    assert wg.pick_window(dens) == pg.pick_window(dens)
    assert (wg.TILE, wg.MIN_DENSITY, wg.MIN_WINDOW, wg.MAX_WINDOW) == \
        (pg.TILE, pg.MIN_DENSITY, pg.MIN_WINDOW, pg.MAX_WINDOW)


def test_cpu_tensor_never_counts_a_launch(rng):
    mat, idx = _mk(4096, 2, 1024, "dense", rng)
    before = dict(wg.COUNTS)
    wg.windowed_take_t(torch.from_numpy(mat.view(np.int32)),
                       torch.from_numpy(idx), 1024)
    assert wg.COUNTS == before


def test_matrix_and_lanes_agree_with_plain(rng):
    mat, idx = _mk(4096, 7, 2048, "dense", rng)
    ti = torch.from_numpy(idx)
    out_m, ok_m = wg.windowed_take_t(_port_lanes(mat, "matrix"), ti, 1024)
    out_l, ok_l = wg.windowed_take_t(_port_lanes(mat, "lanes"), ti, 1024)
    out_p, ok_p = wg.windowed_take_plain(_port_lanes(mat, "lanes"), ti, 1024)
    assert bool(ok_m) and bool(ok_l) and bool(ok_p)
    assert torch.equal(out_m, out_l) and torch.equal(out_l, out_p)


def test_matrix_rows_are_lane_pointers():
    mat = torch.zeros((5, 1001), dtype=torch.int32)
    base = mat.data_ptr()
    assert wg.lane_pointers(wg.as_lanes(mat)) == \
        [base + 4 * 1001 * l for l in range(5)]


@pytest.mark.parametrize("bad", ["length", "dtype", "device",
                                 "non_contiguous", "empty", "matrix_3d"])
def test_wrapper_refuses_mismatched_lanes(bad):
    idx = torch.zeros(256, dtype=torch.int32)
    lane = torch.zeros(4096, dtype=torch.int32)
    lanes = {
        "length": [lane, torch.zeros(4095, dtype=torch.int32)],
        "dtype": [lane, torch.zeros(4096, dtype=torch.int64)],
        "device": [lane, torch.zeros(4096, dtype=torch.int32,
                                     device="meta")],
        "non_contiguous": [lane, torch.zeros(8192, dtype=torch.int32)[::2]],
        "empty": [],
        "matrix_3d": torch.zeros((2, 2, 4096), dtype=torch.int32),
    }[bad]
    before = dict(wg.COUNTS)
    with pytest.raises(wg.InvalidError):
        wg.windowed_take_t(lanes, idx, 1024)
    with pytest.raises(wg.InvalidError):
        wg.windowed_take_plain(lanes, idx, 1024)
    assert wg.COUNTS == before
