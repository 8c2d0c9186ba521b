"""Parity: the port's groupby kernels (cylon_tpu_torch/ops/groupby.py)
against cylon_tpu's on the same numpy inputs.

``grouped_reduce`` runs in the reference at ``use_window=0`` (its CPU
route) and in the port at both ``use_window=0`` and ``use_window=1024``
(the windowed gather's plain version on the CPU).  Integer results and
sums of integer-valued float64 are exact, so they must be bit-equal.
Sums of other floats are prefix differences taken in another association
order, so they are held to ``atol = 64 * eps * sum(|v|)`` over the
group's values (eps of float64): the worst-case error of a prefix-sum
difference grows with the magnitudes summed before it, and 64 is a
margin over the few roundings each side takes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cylon_tpu.ops import groupby as rg
from cylon_tpu_torch.ops import groupby as pg

EPS = np.finfo(np.float64).eps


def _grouped(rng, n, n_live, mean_run, seg_cap, nullable_key=False):
    """Sorted grouped keys over ``n`` rows (live prefix ``n_live``), the
    run starts padded with ``n_live``, and per-row value columns."""
    runs = rng.geometric(1.0 / mean_run, n)
    key = np.repeat(np.arange(n, dtype=np.int64) * 3 - 500, runs)[:n]
    first = np.concatenate([[True], key[1:] != key[:-1]])
    first[n_live:] = False
    starts = np.full(seg_cap, n_live, np.int32)
    pos = np.nonzero(first)[0]
    assert len(pos) <= seg_cap
    starts[:len(pos)] = pos
    vals = {
        "i64": rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64),
        "i32": rng.integers(-1000, 1000, n).astype(np.int32),
        "f64int": rng.integers(-1000, 1000, n).astype(np.float64),
        "f64": rng.normal(size=n) * 1e3,
    }
    kval = (rng.random(n) > 0.1) if nullable_key else None
    return key, kval, starts, vals, len(pos)


def _run(lib, ops, vals, vmasks, starts, n_live, key, kval, seg_cap,
         key_narrow, use_window=0):
    if lib is rg:
        c = jnp.asarray
        return rg.grouped_reduce(
            ops, [c(v) for v in vals],
            [None if m is None else c(m) for m in vmasks], c(starts),
            jnp.int32(n_live), [c(key)], [None if kval is None else c(kval)],
            seg_cap, key_narrow=key_narrow)
    c = torch.from_numpy
    return pg.grouped_reduce(
        ops, [c(v) for v in vals],
        [None if m is None else c(m) for m in vmasks], c(starts), n_live,
        [c(key)], [None if kval is None else c(kval)], seg_cap,
        key_narrow=key_narrow, use_window=use_window)


def _check(name, a, b, vals_abs_prefix, exact):
    a, b = np.asarray(a), b.numpy()
    assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
    if exact:
        np.testing.assert_array_equal(b, a, err_msg=name)
    else:
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=64 * EPS * vals_abs_prefix,
                                   err_msg=name)


OPS = [("sum", "i64"), ("sum", "i32"), ("count", "f64"), ("mean", "i64"),
       ("var", "f64int"), ("std", "i32"), ("sumsq", "f64int"),
       ("sum", "f64"), ("mean", "f64"), ("var", "f64")]


@pytest.mark.parametrize("use_window", [0, 1024])
@pytest.mark.parametrize("n_live,nullable_key,key_narrow", [
    (4096, False, True), (3900, True, False)])
def test_grouped_reduce_matches_reference(rng, use_window, n_live,
                                          nullable_key, key_narrow):
    n, seg_cap = 4096, 2560
    key, kval, starts, vals, n_groups = _grouped(rng, n, n_live, 2.0,
                                                 seg_cap, nullable_key)
    ops = [op for op, _ in OPS]
    vlist = [vals[c] for _, c in OPS]
    vmasks = [(rng.random(n) > 0.15) if i % 2 else None
              for i in range(len(OPS))]
    ref = _run(rg, ops, vlist, vmasks, starts, n_live, key, kval, seg_cap,
               (key_narrow,))
    got = _run(pg, ops, vlist, vmasks, starts, n_live, key, kval, seg_cap,
               (key_narrow,), use_window)
    assert bool(got[3]), "window overflowed at this density"
    # keys (and their validity) ride the gather as passthrough lanes
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(ref[1][0]))
    if nullable_key:
        np.testing.assert_array_equal(got[2][0].numpy(),
                                      np.asarray(ref[2][0]))
    # the float tolerance's scale: total |v| (a bound on any group's
    # prefix magnitudes), per value column
    for i, (op, col) in enumerate(OPS):
        for name, a in ref[0][i].items():
            b = got[0][i][name]
            exact = col != "f64"
            scale = np.abs(vals[col]).sum() * (
                np.abs(vals[col]).max() if name == "sumsq" else 1.0)
            _check(f"{op}({col}).{name}", a[:n_groups], b[:n_groups],
                   scale, exact)


def test_window_overflow_flag(rng):
    # one giant group in every tile's reach: the port's windowed route
    # must flag it (the fused dispatch then reruns without the window)
    n, seg_cap = 8192, 512
    key = np.zeros(n, np.int64)
    key[:300] = np.arange(300)
    key[300:] = 300
    key[-200:] = 301 + np.arange(200)
    first = np.concatenate([[True], key[1:] != key[:-1]])
    starts = np.full(seg_cap, n, np.int32)
    pos = np.nonzero(first)[0]
    starts[:len(pos)] = pos
    got = pg.grouped_reduce(["sum"], [torch.from_numpy(key)], [None],
                            torch.from_numpy(starts), n,
                            [torch.from_numpy(key)], [None], seg_cap,
                            key_narrow=(True,), use_window=1024)
    assert not bool(got[3])


@pytest.mark.parametrize("op", ["sum", "count", "min", "max", "mean", "var",
                                "std", "sumsq"])
@pytest.mark.parametrize("dtype", ["int64", "float64"])
def test_combine_locally_and_finalize(rng, op, dtype):
    n, ns = 3000, 37
    gids = rng.integers(0, ns, n).astype(np.int32)
    vals = (rng.integers(-1000, 1000, n) if dtype == "int64"
            else rng.normal(size=n) * 100).astype(dtype)
    mask = rng.random(n) > 0.2
    ref = rg.combine_locally(op, jnp.asarray(vals), jnp.asarray(gids), ns,
                             jnp.asarray(mask))
    got = pg.combine_locally(op, torch.from_numpy(vals),
                             torch.from_numpy(gids), ns,
                             torch.from_numpy(mask))
    assert set(ref) == set(got)
    # integer inputs: exact; float sums reassociate (segment scatter order)
    scale = np.abs(vals).sum() * (np.abs(vals).max() if op in
                                  ("var", "std", "sumsq") else 1.0)
    for k in ref:
        exact = dtype == "int64" or k in ("count", "min", "max")
        _check(f"{op}.{k}", ref[k], got[k], scale, exact)
    if op in ("min", "max"):
        return
    # finalize over the SAME intermediates in both.  sum/count/mean are
    # elementwise IEEE ops with one rounding each: bit-equal.  var/std
    # compute sumsq/c - mean*mean, which XLA may contract into an FMA (one
    # rounding fewer), so they agree to a few ulps of the larger term:
    # atol = 8 * eps * sumsq/c on var (on std^2 for std)
    inter_np = {k: np.array(v) for k, v in ref.items()}
    for ddof in (0, 1):
        d_r, v_r = rg.finalize(op, {k: jnp.asarray(v)
                                    for k, v in inter_np.items()}, ddof)
        d_p, v_p = pg.finalize(op, {k: torch.from_numpy(v)
                                    for k, v in inter_np.items()}, ddof)
        d_r, d_p = np.asarray(d_r), d_p.numpy()
        if op in ("var", "std"):
            c = np.maximum(inter_np["count"], 1)
            term = np.abs(inter_np["sumsq"]) / c * (
                c / np.maximum(inter_np["count"] - ddof, 1))
            sq = (lambda x: x * x) if op == "std" else (lambda x: x)
            np.testing.assert_allclose(sq(d_p), sq(d_r), rtol=0,
                                       atol=8 * EPS * term.max())
        else:
            np.testing.assert_array_equal(d_p, d_r)
        assert (v_r is None) == (v_p is None)
        if v_r is not None:
            np.testing.assert_array_equal(v_p.numpy(), np.asarray(v_r))


@pytest.mark.parametrize("op,src", [
    ("sum", "int64"), ("count", "float32"), ("mean", "float32"),
    ("mean", "int32"), ("var", "float64"), ("max", "int16"),
    ("quantile", "float32")])
def test_np_result_dtype(op, src):
    assert pg.np_result_dtype(op, np.dtype(src)) == \
        rg.np_result_dtype(op, np.dtype(src))


def test_guard_saturation(monkeypatch):
    from cylon_tpu_torch.status import NumericOverflowError
    big = torch.tensor([1, (1 << 62) + 1], dtype=torch.int64)
    pg.guard_saturation("sum", big)            # unarmed: no check
    from cylon_tpu_torch import config as pconfig
    monkeypatch.setenv("CYLON_TPU_TORCH_AUDIT", "1")
    # the switch is read once and cached: a fresh cache reads it again
    monkeypatch.setattr(pconfig, "_AUDIT", [None])
    with pytest.raises(NumericOverflowError) as ei:
        pg.guard_saturation("sum", big, column="a_sum")
    assert ei.value.column == "a_sum"
    pg.guard_saturation("sum", big - 2)        # at the rail: fine
    pg.guard_saturation("mean", big)           # not an int accumulator op


@pytest.mark.parametrize("block", [4, 8, 1024])
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 8, 9, 17, 63, 64, 65, 1000,
                               4099])
def test_blocked_cumsum_matches_cumsum(rng, block, n):
    """The card's fixed-order float scan (``cumsum_f64``'s blocked
    helper), run on the CPU at small blocks so that the padding, the one-
    block floor and the recursion over block totals all occur: equal to
    ``torch.cumsum`` within rounding, and exact on integer-valued
    floats."""
    x = torch.from_numpy(rng.normal(size=n) * 1e3)
    got = pg._blocked_cumsum(x, block)
    want = torch.cumsum(x, 0)
    assert got.shape == want.shape and got.dtype == want.dtype
    tol = 64 * EPS * torch.cumsum(x.abs(), 0)
    assert bool(((got - want).abs() <= tol).all())
    xi = torch.from_numpy(rng.integers(-1000, 1000, n).astype(np.float64))
    assert torch.equal(pg._blocked_cumsum(xi, block), torch.cumsum(xi, 0))
    # on a CPU tensor the public entry keeps torch's sequential order
    assert torch.equal(pg.cumsum_f64(x), want)
    # a batch of rows (grouped_reduce's float prefixes): each row its own
    # scan, equal to that row scanned alone
    xs = torch.from_numpy(rng.normal(size=(3, n)) * 1e3)
    got = pg._blocked_cumsum(xs, block)
    assert got.shape == xs.shape
    for row, alone in zip(got, xs):
        assert torch.equal(row, pg._blocked_cumsum(alone, block))
    assert bool(((got - torch.cumsum(xs, -1)).abs()
                 <= 64 * EPS * torch.cumsum(xs.abs(), -1)).all())
