"""Parity of the exchange: cylon_tpu_torch's ``parallel/shuffle``
(``hash_targets``, ``count_targets``, ``exchange``) and
``relational/repart.shuffle_table`` against cylon_tpu's at world sizes 3,
4 and 8, the port on ``VirtualMeshConfig(W, device="cpu")``.

Every comparison is bit equality of the whole layout: the target array,
the (W, W) count matrix, and the shuffled table column by column and
shard by shard — ``valid_counts``, capacity, each shard's row order and
its zero padding.  Cases: uniform keys; one key for every row (the
reference runs its multi-round protocol there, the port one
permutation); empty shards; nullable keys with float64 payloads; world
size 1 (a no-op).  Inputs come from a numpy seed."""

import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu as rct
from cylon_tpu.ctx.context import CPUMeshConfig
from cylon_tpu.parallel import shuffle as rshuf
from cylon_tpu.relational.repart import shuffle_table as r_shuffle
import cylon_tpu_torch as pct
from cylon_tpu_torch.ctx.context import VirtualMeshConfig
from cylon_tpu_torch.parallel import shuffle as pshuf
from cylon_tpu_torch.relational.common import col_arrays
from cylon_tpu_torch.relational.repart import shuffle_table as p_shuffle


@pytest.fixture(scope="module")
def envs(env4, env8):
    return {3: rct.CylonEnv(config=CPUMeshConfig(world_size=3)),
            4: env4, 8: env8}


def _penv(w):
    return pct.CylonEnv(VirtualMeshConfig(w), device="cpu")


def assert_layout(ref, port):
    """Same columns, counts, capacity and every row of every shard,
    padding included."""
    assert port.column_names == ref.column_names
    np.testing.assert_array_equal(port.valid_counts, ref.valid_counts)
    assert port.capacity == ref.capacity
    for name in ref.column_names:
        rc, pc = ref.column(name), port.column(name)
        rd, pd_ = np.asarray(rc.data), pc.data.numpy()
        assert rd.dtype == pd_.dtype, name
        np.testing.assert_array_equal(pd_, rd, err_msg=name)
        assert (rc.validity is None) == (pc.validity is None), name
        if rc.validity is not None:
            np.testing.assert_array_equal(pc.validity.numpy(),
                                          np.asarray(rc.validity),
                                          err_msg=name)
        assert pc.bounds == rc.bounds, name


def _frame(case, seed=0):
    rng = np.random.default_rng(seed)
    n = 3000
    if case == "uniform":
        return pd.DataFrame({"k": rng.integers(0, 2000, n),
                             "v": rng.integers(-10**12, 10**12, n)})
    if case == "all_to_one":
        return pd.DataFrame({"k": np.full(n, 7, np.int64),
                             "v": np.arange(n, dtype=np.int64)})
    if case == "empty_shards":
        return pd.DataFrame({"k": np.array([3, 3], np.int64),
                             "v": np.array([1, 2], np.int64)})
    if case == "nullable_f64":
        k = pd.array(rng.integers(0, 500, n), dtype="Int64")
        k[rng.random(n) < 0.1] = pd.NA
        f = rng.normal(size=n)
        f[rng.random(n) < 0.05] = np.nan
        return pd.DataFrame({"k": k, "f": f,
                             "s": rng.integers(0, 9, n).astype(np.int32)})
    raise ValueError(case)


CASES = ("uniform", "all_to_one", "empty_shards", "nullable_f64")


@pytest.mark.parametrize("w", [3, 4, 8])
@pytest.mark.parametrize("case", CASES)
def test_targets_counts_and_shuffle(envs, w, case):
    df = _frame(case, seed=w)
    rt = rct.Table.from_pandas(df, envs[w])
    pt = pct.Table.from_pandas(df, _penv(w))
    assert_layout(rt, pt)          # ingest: the same contiguous split

    rcols = [rt.column("k")]
    r_tgt = rshuf.hash_targets(envs[w].mesh, [c.data for c in rcols],
                               [c.validity for c in rcols], rt.valid_counts)
    datas, valids = col_arrays([pt.column("k")])
    p_tgt = pshuf.hash_targets(pt.env, datas, valids, pt.valid_counts)
    np.testing.assert_array_equal(p_tgt.numpy(), np.asarray(r_tgt))
    r_counts = rshuf.count_targets(envs[w].mesh, r_tgt)
    p_counts = pshuf.count_targets(pt.env, p_tgt)
    assert p_counts.shape == (w, w)
    np.testing.assert_array_equal(p_counts, r_counts)

    rs, ps = r_shuffle(rt, ["k"]), p_shuffle(pt, ["k"])
    assert_layout(rs, ps)
    np.testing.assert_array_equal(ps.valid_counts, r_counts.sum(axis=0))


def test_world_one_is_a_no_op():
    pt = pct.Table.from_pandas(_frame("uniform"), pct.CylonEnv(device="cpu"))
    assert p_shuffle(pt, ["k"]) is pt


def test_two_keys_and_reference_state_at_shard_layout(envs):
    # a shuffled reference table is no contiguous split: carried across
    # with its capacity, every rank's rows land at its own shard
    rng = np.random.default_rng(5)
    df = pd.DataFrame({"k1": rng.integers(0, 40, 2000),
                       "k2": rng.integers(-3, 3, 2000).astype(np.int32),
                       "v": rng.normal(size=2000)})
    rt = rct.Table.from_pandas(df, envs[4])
    pt = pct.Table.from_pandas(df, _penv(4))
    rs, ps = r_shuffle(rt, ["k1", "k2"]), p_shuffle(pt, ["k1", "k2"])
    assert_layout(rs, ps)
    hc = rs.host_columns()
    state = {n: (hc[n][0], hc[n][1], rs.column(n).type.value,
                 rs.column(n).dictionary, rs.column(n).bounds)
             for n in rs.column_names}
    carried = pct.Table.from_reference_state(state, rs.valid_counts,
                                             _penv(4), capacity=rs.capacity)
    assert_layout(rs, carried)


def test_world_bounds():
    with pytest.raises(pct.InvalidError, match="world size"):
        pct.CylonEnv(VirtualMeshConfig(0), device="cpu")
    # the exchange sorts targets 0..W as uint8 keys: it serves at most
    # 255 ranks, one row each here, and refuses more before any work
    for w in (255, 256):
        env = pct.CylonEnv(VirtualMeshConfig(w), device="cpu")
        tgt = torch.arange(w, dtype=torch.int32).flip(0)
        counts = pshuf.count_targets(env, tgt)
        col = torch.arange(w, dtype=torch.int64)
        if w > pshuf.MAX_WORLD:
            with pytest.raises(pct.InvalidError, match="world size"):
                pshuf.exchange(env, tgt, counts, (col,))
            continue
        (out,), per_dest = pshuf.exchange(env, tgt, counts, (col,))
        np.testing.assert_array_equal(per_dest, np.ones(w))
        np.testing.assert_array_equal(out.numpy(), col.flip(0).numpy())
