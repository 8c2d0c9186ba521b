"""Parity of the env's collective surface and ``Status``: cylon_tpu_torch's
``CylonEnv.{gather, bcast, allreduce, allgather, barrier, rank,
get_next_sequence, add_config, get_config, finalize}`` over
``parallel/collectives.py``, and ``status.Status``/``Code``, against
cylon_tpu's on the CPU (the reference on its ``env1``/W = 3/``env4``
mesh, the port on ``VirtualMeshConfig(W, device="cpu")``).  Mirrors
tests/test_collectives.py.

Held bit for bit: the gathered and broadcast tables' layouts (valid
counts, capacity, every shard's rows and padding, validity, bounds), the
allreduce results for sum, min and max with and without the valid
counts, and the typed errors for a bad root or op.
"""

import jax
import numpy as np
import pytest

import cylon_tpu as rct
from cylon_tpu import status as rstatus
from cylon_tpu.ctx.context import CPUMeshConfig
import cylon_tpu_torch as pct
from cylon_tpu_torch import status as pstatus
from cylon_tpu_torch.ctx.context import VirtualMeshConfig
from test_torch_shuffle import assert_layout

WORLDS = [1, 3, 4]


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """Release the reference's compiled XLA:CPU programs at module end."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def renvs(env1, env4):
    return {1: env1, 3: rct.CylonEnv(config=CPUMeshConfig(world_size=3)),
            4: env4}


def penv(w):
    return pct.CylonEnv(VirtualMeshConfig(w), device="cpu")


def _cols(n, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.random(n)
    return {"k": rng.integers(-50, 50, n).astype(np.int64),
            "v": np.where(rng.random(n) < 0.1, np.nan, v),
            "i": rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)}


def _both(renv, w, n, seed=0):
    cols = _cols(n, seed)
    return (rct.Table.from_pydict(cols, renv),
            pct.Table.from_pydict(cols, penv(w)))


@pytest.mark.parametrize("w", WORLDS)
def test_gather_matches_reference(renvs, w):
    """Every row onto the root in global order, the layout bit-equal to
    the reference's (a repartition onto the root); a root out of range
    raises ``InvalidError``."""
    rt, pt = _both(renvs[w], w, 37)
    for root in range(w):
        rg, pg = renvs[w].gather(rt, root), pt.env.gather(pt, root)
        assert_layout(rg, pg)
        assert int(pg.valid_counts[root]) == 37
    for bad in (-1, w):
        with pytest.raises(pstatus.InvalidError) as pe:
            pt.env.gather(pt, bad)
        with pytest.raises(rstatus.InvalidError) as re_:
            renvs[w].gather(rt, bad)
        assert str(pe.value) == str(re_.value)


@pytest.mark.parametrize("w", WORLDS)
def test_bcast_and_allgather_match_reference(renvs, w):
    """Bcast of a gathered table and of a plain one: every shard holds
    the root's rows, the layout bit-equal to the reference's; the
    all-gather alike; a world of 1 returns the table itself."""
    rt, pt = _both(renvs[w], w, 29, seed=1)
    for root in range(w):
        rg, pg = renvs[w].gather(rt, root), pt.env.gather(pt, root)
        assert_layout(renvs[w].bcast(rg, root), pt.env.bcast(pg, root))
        assert_layout(renvs[w].bcast(rt, root), pt.env.bcast(pt, root))
    assert_layout(renvs[w].allgather(rt), pt.env.allgather(pt))
    if w == 1:
        assert pt.env.bcast(pt, 0) is pt and pt.env.allgather(pt) is pt
    else:
        with pytest.raises(pstatus.InvalidError) as pe:
            pt.env.bcast(pt, w)
        with pytest.raises(rstatus.InvalidError) as re_:
            renvs[w].bcast(rt, w)
        assert str(pe.value) == str(re_.value)


@pytest.mark.parametrize("w", WORLDS)
def test_allreduce_matches_reference(renvs, w):
    """Sum, min and max across the shards of int64, int32 and float64
    columns, masked by the valid counts or not, bit-equal to the
    reference's host arrays (values and dtype); an unknown op raises
    ``InvalidError`` with the reference's text."""
    cols = {"k": np.arange(-20, 21, dtype=np.int64) * 3,
            "i": np.arange(41, dtype=np.int32) - 7,
            "v": np.linspace(-2.0, 2.0, 41)}
    rt = rct.Table.from_pydict(cols, renvs[w])
    pt = pct.Table.from_pydict(cols, penv(w))
    for name in cols:
        for op in ("sum", "min", "max"):
            for vc in (None, rt.valid_counts):
                r = renvs[w].allreduce(rt.column(name), op, vc)
                p = pt.env.allreduce(pt.column(name), op, vc)
                assert p.dtype == r.dtype, (name, op)
                np.testing.assert_array_equal(p, r, err_msg=f"{name} {op}")
        # a raw tensor takes the env's world from the env
        np.testing.assert_array_equal(
            pt.env.allreduce(pt.column(name).data, "max"),
            renvs[w].allreduce(rt.column(name).data, "max"))
    with pytest.raises(pstatus.InvalidError) as pe:
        pt.env.allreduce(pt.column("k"), "prod")
    with pytest.raises(rstatus.InvalidError) as re_:
        renvs[w].allreduce(rt.column("k"), "prod")
    assert str(pe.value) == str(re_.value)


def test_env_surface_matches_reference(env4):
    """``rank`` (0 under one controller), the monotone sequence, the
    config map, ``barrier`` and ``finalize``."""
    pe = penv(4)
    assert pe.rank == env4.rank == 0
    a, b = pe.get_next_sequence(), pe.get_next_sequence()
    assert b > a
    for env in (pe, env4):
        env.add_config("compression", "none")
        assert env.get_config("compression") == "none"
        assert env.get_config("missing", "dflt") == "dflt"
        assert env.barrier() is None
    pe.finalize()
    assert pe._finalized


def test_status_and_codes_match_reference():
    """Every ``Code`` of the reference, by name and value, and
    ``Status``'s value semantics and raise."""
    assert {c.name: int(c) for c in pstatus.Code} \
        == {c.name: int(c) for c in rstatus.Code}
    assert pct.Code is pstatus.Code and pct.Status is pstatus.Status
    for mod in (pstatus, rstatus):
        ok = mod.Status.OK()
        assert ok.is_ok() and ok.get_code() == mod.Code.OK
        assert ok.get_msg() == ""
        ok.raise_if_failed()
        bad = mod.Status(mod.Code.Invalid, "bad input")
        assert not bad.is_ok()
        assert int(bad.get_code()) == 4 and bad.get_msg() == "bad input"
        with pytest.raises(mod.CylonError) as e:
            bad.raise_if_failed()
        assert e.value.code == mod.Code.Invalid and str(e.value) == \
            "bad input"
        assert mod.Status(int(mod.Code.IOError)).get_code() \
            == mod.Code.IOError
