"""Parity of the order-preserving redistributions: cylon_tpu_torch's
``repartition``, ``repad_table``, ``slice_table``, ``head`` and ``tail``
against cylon_tpu's on the CPU at world sizes 1, 4 and 8 (the port on
``VirtualMeshConfig(W, device="cpu")``), 40 to 120 rows from a numpy
seed.

Every comparison is bit equality of the whole layout
(tests/test_torch_shuffle.assert_layout: ``valid_counts``, capacity,
each shard's rows in order and its padding, validity and bounds), and
the global row order is checked against the pandas frame.  The cases
mirror tests/test_repart.py: the even split after an uneven slice, a
specified split, slices at offsets that cross shard boundaries, head and
tail, and the refusals."""

import numpy as np
import pandas as pd
import pytest

import cylon_tpu as rct
from cylon_tpu.relational import repart as rrep
import cylon_tpu_torch as pct
from cylon_tpu_torch.ctx.context import VirtualMeshConfig
from test_torch_shuffle import assert_layout


@pytest.fixture(scope="module")
def envs(env1, env4, env8):
    return {1: env1, 4: env4, 8: env8}


def frame(n=120, seed=0):
    rng = np.random.default_rng(seed)
    v = pd.array(rng.integers(0, 1000, n), dtype="Int64")
    v[rng.random(n) < 0.1] = pd.NA
    return pd.DataFrame({"k": rng.integers(0, 20, n), "i": np.arange(n),
                         "v": v, "f": rng.random(n)})


def tables(df, envs, w):
    return (rct.Table.from_pandas(df, envs[w]),
            pct.Table.from_pandas(df, pct.CylonEnv(VirtualMeshConfig(w),
                                                   device="cpu")))


def rows(t):
    return t.to_pydict()["i"].tolist()


@pytest.mark.parametrize("w", [4, 8])
def test_repartition_even(envs, w):
    df = frame(100)
    rt, pt = tables(df, envs, w)
    # unbalance it with a slice, then rebalance
    rs, ps = rrep.slice_table(rt, 10, 77), pct.slice_table(pt, 10, 77)
    assert_layout(rs, ps)
    r, p = rrep.repartition(rs), pct.repartition(ps)
    assert_layout(r, p)
    base = 77 // w
    assert all(c in (base, base + 1) for c in p.valid_counts)
    assert rows(p) == list(range(10, 87))


def test_repartition_specified(envs):
    rt, pt = tables(frame(40), envs, 4)
    r, p = rrep.repartition(rt, (1, 2, 3, 34)), \
        pct.repartition(pt, (1, 2, 3, 34))
    assert_layout(r, p)
    assert p.valid_counts.tolist() == [1, 2, 3, 34]
    assert rows(p) == list(range(40))
    # the even split of an even table is the table itself
    assert pct.repartition(pt) is pt
    with pytest.raises(pct.InvalidError, match="rows_per_partition"):
        pct.repartition(pt, (1, 2, 3))
    with pytest.raises(pct.InvalidError, match="rows_per_partition"):
        pct.repartition(pt, (1, 2, 3, 4))


def test_repartition_world1(envs):
    rt, pt = tables(frame(40), envs, 1)
    assert pct.repartition(pt) is pt


@pytest.mark.parametrize("off,length", [(0, 10), (5, 50), (95, 25),
                                        (0, 120), (119, 1), (200, 5)])
def test_slice(envs, off, length):
    rt, pt = tables(frame(), envs, 8)
    p = pct.slice_table(pt, off, length)
    assert_layout(rrep.slice_table(rt, off, length), p)
    assert rows(p) == list(range(120))[off:off + length]


@pytest.mark.parametrize("w", [1, 8])
def test_head_tail(envs, w):
    rt, pt = tables(frame(), envs, w)
    for n in (7, 0, 500):
        assert_layout(rrep.head(rt, n), pct.head(pt, n))
        assert_layout(rrep.tail(rt, n), pct.tail(pt, n))
    assert rows(pct.head(pt, 7)) == list(range(7))
    assert rows(pct.tail(pt, 7)) == list(range(113, 120))


@pytest.mark.parametrize("new_cap", [32, 64, 40])
def test_repad(envs, new_cap):
    rt, pt = tables(frame(90), envs, 4)      # capacity 32, 23 rows a shard
    assert_layout(rrep.repad_table(rt, new_cap),
                  pct.repad_table(pt, new_cap))
    with pytest.raises(pct.InvalidError, match="exceed"):
        pct.repad_table(pt, 16)
