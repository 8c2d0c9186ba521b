"""Parity: the port's join kernels (cylon_tpu_torch/ops/pack.py and
ops/join.py) against cylon_tpu's on the same numpy inputs.  Sort
operands, the sorted order, boundary flags, carried payloads, the carry
geometry and the expansion must be bit-equal (uint32 operands compare as
their values: the port holds them widened to int64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cylon_tpu import config as ref_config
from cylon_tpu.ops import join as rjoin
from cylon_tpu.ops import pack as rpack
from cylon_tpu_torch.ops import join as pjoin
from cylon_tpu_torch.ops import pack as ppack

PAD_L, PAD_R = 4, 5


def _case(rng, n_l, n_r, live_l, live_r, key_range, nullable=False,
          float_key=False):
    """Left/right key columns (int64, duplicates on both sides), optional
    validity, optional second float64 key, liveness masks."""
    def side(n, live):
        cols = [rng.integers(-key_range, key_range, n).astype(np.int64)]
        if float_key:
            f = rng.integers(0, 3, n).astype(np.float64)
            f[rng.random(n) < 0.1] = np.nan
            f[rng.random(n) < 0.1] = -0.0
            cols.append(f)
        valids = [(rng.random(n) > 0.2) if nullable else None]
        if float_key:
            valids.append(None)
        return cols, valids, np.arange(n) < live
    return side(n_l, live_l), side(n_r, live_r)


def _ops_np(ko):
    return [np.asarray(o).astype(np.float64 if k == "f" else np.int64)
            for o, k in zip(ko.ops, ko.kinds)]


def _keyops(lib, cols, valids, mask, pad, need_nf, narrow):
    if lib is rpack:
        conv = jnp.asarray
    else:
        conv = torch.from_numpy
    return lib.key_operands([conv(c) for c in cols],
                            [None if v is None else conv(v) for v in valids],
                            row_mask=None if mask is None else conv(mask),
                            pad_key=pad, need_null_flags=need_nf,
                            narrow32=narrow)


CASES = {
    # name: (n_l, n_r, live_l, live_r, key_range, nullable, float_key, narrow)
    "narrow_all_live": (300, 200, 300, 200, 40, False, False, (True,)),
    "wide_all_live": (300, 200, 300, 200, 40, False, False, (False,)),
    "padded_tail": (512, 256, 401, 177, 30, False, False, (True,)),
    "padded_tail_wide": (512, 256, 401, 177, 1 << 40, False, False,
                         (False,)),
    "nullable_key": (256, 256, 250, 200, 25, True, False, (False,)),
    "float_second_key": (256, 128, 256, 100, 10, False, True,
                         (True, False)),
}


def _build(rng, name, masked):
    n_l, n_r, live_l, live_r, kr, nullable, fk, narrow = CASES[name]
    (lc, lv, lm), (rc, rv, rm) = _case(rng, n_l, n_r, live_l, live_r, kr,
                                       nullable, fk)
    if not masked:
        lm = rm = None
    need_nf = tuple((a is not None) or (b is not None)
                    for a, b in zip(lv, rv))
    return (lc, lv, lm), (rc, rv, rm), need_nf, narrow


@pytest.mark.parametrize("name", sorted(CASES))
def test_key_operands_bit_equal(rng, name):
    (lc, lv, lm), _, need_nf, narrow = _build(rng, name, True)
    kr = _keyops(rpack, lc, lv, lm, PAD_L, need_nf, narrow)
    kp = _keyops(ppack, lc, lv, lm, PAD_L, need_nf, narrow)
    assert kr.kinds == kp.kinds
    for a, b in zip(_ops_np(kr), _ops_np(kp)):
        np.testing.assert_array_equal(a, b)


def test_sort_value_descending_and_float32(rng):
    x = rng.normal(size=300).astype(np.float32)
    x[::17] = np.nan
    x[::23] = -0.0
    i = rng.integers(-(1 << 62), 1 << 62, 300).astype(np.int64)
    for desc in (False, True):
        for arr in (x, i):
            r = rpack._sort_value(jnp.asarray(arr), desc)
            p = ppack._sort_value(torch.from_numpy(arr), desc)
            assert [k for _, k in r] == [k for _, k in p]
            for (a, _), (b, _) in zip(r, p):
                np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                              b.numpy().astype(np.int64))


def _state(lib, rng_case, payloads):
    (lc, lv, lm), (rc, rv, rm), need_nf, narrow = rng_case
    ko_l = _keyops(lib, lc, lv, lm, PAD_L, need_nf, narrow)
    ko_r = _keyops(lib, rc, rv, rm, PAD_R, need_nf, narrow)
    conv = jnp.asarray if lib is rpack else (
        lambda a: torch.from_numpy(a.view(np.int32)))
    mod = rjoin if lib is rpack else pjoin
    return mod.join_sort_state(ko_l, ko_r, tuple(conv(p) for p in payloads))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("masked", [True, False])
def test_join_sort_state_bit_equal(rng, name, masked):
    case = _build(rng, name, masked)
    n = len(case[0][0][0]) + len(case[1][0][0])
    payloads = [rng.integers(0, 1 << 32, n, dtype=np.uint32)
                for _ in range(3)]
    bnd_r, idx_r, pl_r = _state(rpack, case, payloads)
    bnd_p, idx_p, pl_p = _state(ppack, case, payloads)
    np.testing.assert_array_equal(_np(bnd_p), _np(bnd_r))
    np.testing.assert_array_equal(_np(idx_p), _np(idx_r))
    for a, b in zip(pl_r, pl_p):
        np.testing.assert_array_equal(_np(b).view(np.uint32), _np(a))


def _carries(rng, name, how):
    case = _build(rng, name, True)
    (lc, _, lm), (rc, _, rm), _, _ = case
    live = np.concatenate([lm, rm])
    n_l = len(lc[0])
    payloads = [rng.integers(0, 1 << 32, n_l + len(rc[0]), dtype=np.uint32)
                for _ in range(2)]
    bnd_r, idx_r, pl_r = _state(rpack, case, payloads)
    bnd_p, idx_p, pl_p = _state(ppack, case, payloads)
    tot_r, car_r = rjoin.join_carry(bnd_r, idx_r, jnp.asarray(live), n_l,
                                    how)
    tot_p, car_p = pjoin.join_carry(bnd_p, idx_p, torch.from_numpy(live),
                                    n_l, how)
    return n_l, (tot_r, car_r, pl_r), (tot_p, car_p, pl_p)


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
@pytest.mark.parametrize("name", ["padded_tail", "nullable_key",
                                  "float_second_key"])
def test_join_carry_bit_equal(rng, name, how):
    _n_l, (tot_r, car_r, _), (tot_p, car_p, _) = _carries(rng, name, how)
    assert int(tot_r) == int(tot_p)
    for f in car_r._fields:
        np.testing.assert_array_equal(_np(getattr(car_p, f)),
                                      _np(getattr(car_r, f)), err_msg=f)


@pytest.mark.parametrize("how,carry_emit,carry_match", [
    ("inner", False, False), ("inner", True, True), ("inner", True, False),
    ("left", False, True), ("right", False, False), ("outer", False, False)])
@pytest.mark.parametrize("name", ["padded_tail", "nullable_key"])
def test_join_take_bit_equal(rng, name, how, carry_emit, carry_match):
    n_l, (tot_r, car_r, pl_r), (tot_p, car_p, pl_p) = _carries(rng, name,
                                                               how)
    out_cap = ref_config.pow2ceil(int(tot_r))
    extra_r = pl_r[:1] if carry_emit else ()
    extra_p = pl_p[:1] if carry_emit else ()
    tk_r = rjoin.join_take(car_r, n_l, how, out_cap, extra=extra_r,
                           carry_emit=carry_emit, carry_match=carry_match)
    tk_p = pjoin.join_take(car_p, n_l, how, out_cap, extra=extra_p,
                           carry_emit=carry_emit, carry_match=carry_match)
    assert int(tk_r.total) == int(tk_p.total)
    for f in ("valid", "matched", "mpos", "l_take", "r_take"):
        a, b = getattr(tk_r, f), getattr(tk_p, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(_np(b), _np(a), err_msg=f)
    for a, b in zip(tk_r.extra, tk_p.extra):
        np.testing.assert_array_equal(_np(b).view(np.uint32), _np(a))
