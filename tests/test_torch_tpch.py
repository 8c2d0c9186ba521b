"""Parity of the TPC-H suite: cylon_tpu_torch's ``tpch.py`` against
cylon_tpu's on the CPU; the port runs on ``VirtualMeshConfig(W,
device="cpu")``.  Both packages run at their defaults (the skew split
armed, the broadcast route at its default size).

* The generator: the port's ``generate_tables`` against the reference's
  ``generate_pandas`` at scale 0.01, seeds 0 and 3 — every table equal,
  layout included, to the port's own ingest of the reference's pandas
  frames, so every value, every string column's dictionary and codes and
  every bound equal what string ingest gives.
* The 21 queries at W = 1 and 4 against the reference's pandas oracles
  (``tpch.q*_pandas``), at the scales, seeds and tolerances of
  tests/test_tpch.py: integer results exact, float results to
  ``rtol = 1e-9``.
* Q3, Q5 and Q7 at W = 4 against the reference's own JAX queries on the
  same tables: the same rows, the same per-shard counts.
* ``import cylon_tpu_torch.tpch`` imports no pandas, and the generator
  and a query run with pandas and pyarrow unavailable."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest

import cylon_tpu as rct
from cylon_tpu import tpch as rtpch
import cylon_tpu_torch as pct
from cylon_tpu_torch import tpch as ptpch
from cylon_tpu_torch.ctx.context import VirtualMeshConfig
from test_torch_shuffle import assert_layout

#: query -> (scale, seed, kwargs) of tests/test_tpch.py
CASES = {
    "q1": (0.002, 3, {}), "q3": (0.002, 3, {}), "q4": (0.005, 7, {}),
    "q5": (0.002, 4, {}), "q6": (0.002, 4, {}), "q7": (0.004, 7, {}),
    "q8": (0.004, 8, {}), "q9": (0.002, 9, {}), "q10": (0.01, 8, {}),
    "q11": (0.004, 11, {}), "q12": (0.01, 9, {}), "q13": (0.004, 13, {}),
    "q14": (0.004, 14, {}), "q15": (0.01, 15, {}), "q16": (0.004, 16, {}),
    "q17": (0.02, 17, {}), "q18": (0.004, 18, {"quantity": 150}),
    "q19": (0.05, 19, {}), "q20": (0.01, 20, {}), "q21": (0.004, 16, {}),
    "q22": (0.004, 16, {}),
}
#: queries whose oracle compares exactly in tests/test_tpch.py
EXACT = {"q4", "q12", "q13", "q20"}

_PDFS = {}


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """Release the reference's compiled XLA:CPU programs when the module
    ends (tests/run_all.py: its compiler crashes more often in
    long-lived processes)."""
    yield
    jax.clear_caches()


def penv(w):
    return pct.CylonEnv(VirtualMeshConfig(w), device="cpu")


def pandas_tables(scale, seed):
    if (scale, seed) not in _PDFS:
        _PDFS[(scale, seed)] = rtpch.generate_pandas(scale=scale, seed=seed)
    return _PDFS[(scale, seed)]


@pytest.mark.parametrize("seed", [0, 3])
def test_generator_matches_reference(seed):
    pdfs = pandas_tables(0.01, seed)
    env = penv(4)
    dfs = ptpch.generate_tables(scale=0.01, env=env, seed=seed)
    assert list(dfs) == list(pdfs)
    for name, pdf in pdfs.items():
        got = dfs[name].table
        assert got.column_names == list(pdf.columns), name
        assert_layout(pct.DataFrame(pdf, env=env).table, got)


@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("qname", list(CASES))
def test_query_matches_oracle(w, qname):
    scale, seed, kw = CASES[qname]
    pdfs = pandas_tables(scale, seed)
    env = penv(w)
    dfs = ptpch.generate_tables(scale=scale, env=env, seed=seed)
    got = getattr(ptpch, qname)(dfs, env=env, **kw)
    exp = getattr(rtpch, f"{qname}_pandas")(pdfs, **kw)
    if isinstance(exp, float):
        assert isinstance(got, float)
        assert got == pytest.approx(exp, rel=1e-9)
        return
    got = got.to_pandas().reset_index(drop=True)
    assert len(got) == len(exp)
    if qname in EXACT:
        pd.testing.assert_frame_equal(got, exp[got.columns],
                                      check_dtype=False)
    else:
        pd.testing.assert_frame_equal(got, exp[got.columns],
                                      check_dtype=False, check_exact=False,
                                      rtol=1e-9)


@pytest.mark.parametrize("qname", ["q3", "q5", "q7"])
def test_query_matches_reference_jax(env4, qname):
    """The same tables through the reference's JAX query and the port's:
    equal rows and per-shard counts."""
    scale, seed, kw = CASES[qname]
    pdfs = pandas_tables(scale, seed)
    rdfs = {k: rct.DataFrame(v, env=env4) for k, v in pdfs.items()}
    ref = getattr(rtpch, qname)(rdfs, env=env4, **kw)
    env = penv(4)
    got = getattr(ptpch, qname)(
        ptpch.generate_tables(scale=scale, env=env, seed=seed), env=env,
        **kw)
    np.testing.assert_array_equal(got.table.valid_counts,
                                  ref._table.valid_counts)
    pd.testing.assert_frame_equal(got.to_pandas().reset_index(drop=True),
                                  ref.to_pandas().reset_index(drop=True),
                                  check_exact=False, rtol=1e-9)


def test_import_without_pandas():
    """The card machine has no pandas: importing the module must not pull
    it in, and the generator and a query run with it unavailable."""
    code = (
        "import sys\n"
        "import cylon_tpu_torch.tpch\n"
        "assert 'pandas' not in sys.modules and 'jax' not in sys.modules\n"
        "sys.modules['pandas'] = None\n"
        "sys.modules['pyarrow'] = None\n"
        "import cylon_tpu_torch as pct\n"
        "from cylon_tpu_torch import tpch\n"
        "env = pct.CylonEnv(device='cpu')\n"
        "d = tpch.generate_tables(0.001, env, 0)\n"
        "assert tpch.q6(d, env=env) > 0\n"
        "assert len(tpch.q3(d, env=env).to_pydict()['revenue']) == 10\n")
    root = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root, env=env)
    assert res.returncode == 0, res.stderr
