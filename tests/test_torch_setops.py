"""Parity of the set operations: cylon_tpu_torch's ``set_operation``
(union, intersect, subtract), ``unique_table`` and ``equals`` against
cylon_tpu's on the CPU, at world sizes 1, 3, 4 and 8 (the port on
``VirtualMeshConfig(W, device="cpu")``), a few dozen to a few hundred
rows from a numpy seed.

The outputs only move values, so every comparison is bit equality of the
whole layout (tests/test_torch_shuffle.assert_layout): ``valid_counts``,
capacity, each shard's rows in order and its padding, validity, and
``grouped_by``; floats included.  ``equals`` returns the reference's
answer.  The cases mirror tests/test_setops.py: every op at env1, env4
and env8, string rows, keep first/last on a subset and on all columns,
mixed nullability, two nullable columns, NaN and -0.0 equality, the
unordered compare, and the repartition-to-match path of ``equals``."""

import numpy as np
import pandas as pd
import pytest

import cylon_tpu as rct
from cylon_tpu.ctx.context import CPUMeshConfig
from cylon_tpu.relational import equals as r_equals
from cylon_tpu.relational import repartition as r_repart
from cylon_tpu.relational import set_operation as r_setop
from cylon_tpu.relational import unique_table as r_unique
import cylon_tpu_torch as pct
from cylon_tpu_torch.ctx.context import VirtualMeshConfig
from test_torch_shuffle import assert_layout

OPS = ["union", "intersect", "subtract"]


@pytest.fixture(scope="module")
def envs(env1, env4, env8):
    return {1: env1, 3: rct.CylonEnv(config=CPUMeshConfig(world_size=3)),
            4: env4, 8: env8}


def penv(w):
    return pct.CylonEnv(VirtualMeshConfig(w), device="cpu")


def tables(dfs, envs, w):
    """Each pandas frame as a (reference, port) table pair at world w."""
    return [(rct.Table.from_pandas(d, envs[w]),
             pct.Table.from_pandas(d, penv(w))) for d in dfs]


def same(ref, port):
    assert_layout(ref, port)
    assert port.grouped_by == ref.grouped_by
    return port


def two(seed=42, na=60, nb=40, hi=25):
    rng = np.random.default_rng(seed)
    return (pd.DataFrame({"k": rng.integers(0, hi, na),
                          "g": rng.integers(0, 3, na)}),
            pd.DataFrame({"k": rng.integers(0, hi, nb),
                          "g": rng.integers(0, 3, nb)}))


@pytest.mark.parametrize("w", [1, 4, 8])
@pytest.mark.parametrize("op", OPS)
def test_set_ops(envs, w, op):
    (ra, pa), (rb, pb) = tables(two(), envs, w)
    out = same(r_setop(ra, rb, op), pct.set_operation(pa, pb, op))
    # distinct semantics: the output rows are a set
    rows = out.to_pydict()
    assert len(set(zip(rows["k"], rows["g"]))) == out.row_count


def test_set_ops_strings(envs):
    rng = np.random.default_rng(1)
    a = pd.DataFrame({"s": rng.choice(["a", "b", "c", "d"], 40)})
    b = pd.DataFrame({"s": rng.choice(["c", "d", "e"], 30)})
    (ra, pa), (rb, pb) = tables([a, b], envs, 8)
    for op in OPS:
        same(r_setop(ra, rb, op), pct.set_operation(pa, pb, op))


@pytest.mark.parametrize("w", [1, 8])
@pytest.mark.parametrize("keep", ["first", "last"])
def test_unique(envs, w, keep):
    rng = np.random.default_rng(2)
    df = pd.DataFrame({"k": rng.integers(0, 10, 80), "v": np.arange(80)})
    ((rt, pt),) = tables([df], envs, w)
    out = same(r_unique(rt, ["k"], keep), pct.unique_table(pt, ["k"], keep))
    exp = df.drop_duplicates(subset=["k"], keep=keep)
    assert sorted(out.to_pydict()["v"]) == sorted(exp["v"])


@pytest.mark.parametrize("w", [3, 8])
def test_unique_all_columns(envs, w):
    rng = np.random.default_rng(3)
    df = pd.DataFrame({"k": rng.integers(0, 5, 60),
                       "g": rng.integers(0, 2, 60)})
    ((rt, pt),) = tables([df], envs, w)
    same(r_unique(rt), pct.unique_table(pt))
    with pytest.raises(pct.InvalidError):
        pct.unique_table(pt, keep="middle")


@pytest.mark.parametrize("w", [1, 4, 8])
def test_equals(envs, w):
    rng = np.random.default_rng(4)
    df = pd.DataFrame({"k": rng.integers(0, 10, 50), "v": rng.random(50)})
    df3 = df.copy()
    df3.loc[17, "v"] = -1.0
    (r1, p1), (r2, p2), (r3, p3) = tables([df, df.copy(), df3], envs, w)
    assert pct.equals(p1, p2) is r_equals(r1, r2) is True
    assert pct.equals(p1, p3) is r_equals(r1, r3) is False
    # other names, other row counts
    assert pct.equals(p1, p1.rename({"v": "x"})) is False
    assert pct.equals(p1, pct.slice_table(p1, 0, 49)) is False


def test_equals_unordered(envs):
    rng = np.random.default_rng(5)
    df = pd.DataFrame({"k": rng.integers(0, 10, 50), "v": rng.random(50)})
    shuffled = df.sample(frac=1.0, random_state=1).reset_index(drop=True)
    (r1, p1), (r2, p2) = tables([df, shuffled], envs, 4)
    assert pct.equals(p1, p2, ordered=True) is r_equals(r1, r2) is False
    assert pct.equals(p1, p2, ordered=False) \
        is r_equals(r1, r2, ordered=False) is True


def test_equals_nan_and_signed_zero(envs):
    df = pd.DataFrame({"f": [1.0, np.nan, 3.0, np.nan, 0.0]})
    neg = pd.DataFrame({"f": [1.0, np.nan, 3.0, np.nan, -0.0]})
    (r1, p1), (r2, p2) = tables([df, neg], envs, 4)
    assert pct.equals(p1, p2) is r_equals(r1, r2) is True


def test_equals_repartition_to_match(envs):
    """Other row counts per shard and another capacity: ``b`` is
    repartitioned to ``a``'s counts and both repadded to one capacity."""
    rng = np.random.default_rng(6)
    df = pd.DataFrame({"k": rng.integers(0, 9, 70),
                       "v": rng.integers(0, 99, 70)})
    ((rt, pt),) = tables([df], envs, 4)
    rb, pb = r_repart(rt, (1, 2, 3, 64)), pct.repartition(pt, (1, 2, 3, 64))
    same(rb, pb)
    assert pb.capacity != pt.capacity
    assert pct.equals(pt, pb) is r_equals(rt, rb) is True
    changed = df.copy()
    changed.loc[69, "v"] = -5
    ((rc, pc),) = tables([changed], envs, 4)
    assert pct.equals(pc, pb) is r_equals(rc, rb) is False
    # a column without a common type with its partner: not equal
    s = pct.Table.from_pandas(df.assign(v=df["v"].astype(str)), penv(4))
    assert pct.equals(pt, s) is False


def test_setop_mixed_nullability(envs):
    """One side nullable, the other not: both get the null-flag operand."""
    a = pd.DataFrame({"x": [1.0, None, 3.0, 4.0]})
    b = pd.DataFrame({"x": [3.0, 4.0, 5.0]})
    (ra, pa), (rb, pb) = tables([a, b], envs, 4)
    got = same(r_setop(ra, rb, "intersect"),
               pct.set_operation(pa, pb, "intersect"))
    assert sorted(got.to_pydict()["x"].tolist()) == [3.0, 4.0]
    same(r_setop(ra, rb, "subtract"), pct.set_operation(pa, pb, "subtract"))
    same(r_setop(rb, ra, "union"), pct.set_operation(pb, pa, "union"))


@pytest.mark.parametrize("w", [3, 4])
@pytest.mark.parametrize("op", OPS)
def test_set_ops_two_nullable_columns(envs, w, op):
    """Two columns, nulls in both sides, an int32 and a float64 with NaN
    and -0.0: null equals null, NaN equals NaN, -0.0 equals 0.0."""
    rng = np.random.default_rng(7)

    def frame(n, lo):
        k = pd.array(rng.integers(lo, lo + 12, n), dtype="Int32")
        k[rng.random(n) < 0.15] = pd.NA
        f = rng.choice([0.5, 1.5, np.nan, 0.0, -0.0], n)
        return pd.DataFrame({"k": k, "f": f})

    (ra, pa), (rb, pb) = tables([frame(90, 0), frame(70, 6)], envs, w)
    same(r_setop(ra, rb, op), pct.set_operation(pa, pb, op))


def test_set_op_refusals(envs):
    (ra, pa), (rb, pb) = tables(two(), envs, 1)
    with pytest.raises(pct.InvalidError, match="unknown set op"):
        pct.set_operation(pa, pb, "xor")
    with pytest.raises(pct.InvalidError, match="schema mismatch"):
        pct.set_operation(pa, pb.rename({"g": "h"}), "union")


def test_new_paths_need_no_pandas():
    """Running this slice's paths — hashed-string ingest and its native
    hash, the hashed sort, the set ops, unique, equals, repartition,
    slices and the pipelined set op, on a CPU world — imports neither
    pandas nor pyarrow (the card machine has neither), nor jax."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "import numpy as np\n"
        "import cylon_tpu_torch as ct\n"
        "from cylon_tpu_torch import config\n"
        "config.STRING_HASH_MIN_ROWS, config.STRING_HASH_RATIO = 100, 0.2\n"
        "env = ct.CylonEnv(ct.VirtualMeshConfig(4), device='cpu')\n"
        "k = np.asarray([f'n{i % 900}' for i in range(2000)], dtype=object)\n"
        "a = ct.DataFrame({'k': k, 'v': np.arange(2000) % 7}, env=env)\n"
        "b = ct.DataFrame({'k': k[::3], 'v': np.arange(667) % 7}, env=env)\n"
        "assert type(a.table.column('k').dictionary).__name__ == "
        "'HashedStrings'\n"
        "u = a.union(b); a.intersect(b); a.subtract(b)\n"
        "a.drop_duplicates(['k']); a.sort_values('k')\n"
        "assert a.equals(a) and a.isin(u)\n"
        "a.repartition([0, 0, 0, 2000]).head(5); a.tail(5)\n"
        "ct.pipelined_set_op(a.table, b.table, 'subtract', n_chunks=3)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'cylon_tpu', 'pandas', 'pyarrow'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code, repo],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
