"""Parity: the port's windowed gather (cylon_tpu_torch/ops/windowed_gather)
against the Pallas kernel K1 (cylon_tpu/ops/pallas_gather) run in
interpret mode on the CPU.  On a CPU tensor the port runs its plain
version, which must reproduce the kernel's whole contract bit for bit:
gathered values, the zeros of rows outside their tile's window, and the
``ok`` flag.  The CUDA kernel itself is held against the same plain
version on the card by chip_smoke.py."""

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


def _both(mat, idx, window):
    out_r, ok_r = jax.jit(lambda m, i: pg.windowed_take_t(
        m, i, window=window, interpret=True))(mat, idx)
    out_p, ok_p = wg.windowed_take_t(
        torch.from_numpy(mat.view(np.int32)), torch.from_numpy(idx), window)
    return (np.asarray(out_r), bool(np.asarray(ok_r)),
            out_p.numpy().view(np.uint32), bool(ok_p))


@pytest.mark.parametrize("n_lanes", [1, 7, 8, 13])
def test_dense_bit_equal(rng, n_lanes):
    mat, idx = _mk(4096, n_lanes, 2048, "dense", rng)
    out_r, ok_r, out_p, ok_p = _both(mat, idx, 1024)
    assert ok_r and ok_p
    np.testing.assert_array_equal(out_p, out_r)
    np.testing.assert_array_equal(out_p, mat[:, idx])


def test_sentinel_tail_bit_equal(rng):
    mat, idx = _mk(4096, 5, 1024, "tail", rng)
    out_r, ok_r, out_p, ok_p = _both(mat, idx, 1024)
    assert ok_r and ok_p
    np.testing.assert_array_equal(out_p, out_r)


def test_skewed_spans_flagged_and_zeroed(rng):
    # overflowing rows come out 0 in both, and ok is False in both
    mat, idx = _mk(1 << 15, 6, 4096, "skewed", rng)
    out_r, ok_r, out_p, ok_p = _both(mat, idx, 1024)
    assert not ok_r and not ok_p
    np.testing.assert_array_equal(out_p, out_r)
    assert (out_p == 0).any()


def test_unaligned_rows_read_padding_as_zero(rng):
    # M % 128 != 0: the clamp uses the 128-padded row count, so tail tiles
    # read padding columns; both must produce the same zeros
    mat, idx = _mk(4000, 3, 1024, "dense", rng)
    idx[-256:] = 3999
    out_r, ok_r, out_p, ok_p = _both(mat, idx, 1024)
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
