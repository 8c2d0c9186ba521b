"""Streams across processes: ``StreamTable``, ``IncrementalView`` and
``TumblingWindowJoin`` in gloo worlds of 2 processes × 2 ranks on the CPU,
held against one process and against the reference.

This file is both the pytest module and the per-process driver (the
protocol of tests/test_torch_multiprocess.py, whose helpers it uses):

    python tests/test_torch_multiprocess_stream.py <pid> <nproc> <addr> <V> <out.npz> <leg>

Ingest is SPMD: every process appends the same global batch and keeps
its own ranks' rows after the ``stream.recv`` shuffle.  Legs:

* ``stream``: ``N_BATCHES`` seeded batches into a view (sum, count, min,
  max, mean, var, std) and a window join (window 100, stride 60,
  lateness 30).  Each batch carries one row ahead in event time whose
  key lives on one process only, so the processes' local watermarks
  differ at every batch and the vote (``recovery.watermark_consensus``)
  min-agrees the windows to close.  Every read and every closed window
  is recorded.
* ``ckpt_first`` (armed): the view alone over the first ``CKPT_FIRST``
  batches; ``ckpt_resume`` (armed, ``CYLON_TPU_TORCH_RESUME=1``): the
  whole stream replayed, the committed batches fast-forwarded at the
  same layout.  The parent then resumes the same checkpoint in one
  process at ``VirtualMeshConfig(4)``, a new process layout: the
  committed prefix is adopted through the re-shard path.

Every read and window equals, row for row, the one-process W = 4 run's
and the reference's ``CPUMeshConfig(4)`` run's at the same batch.  The
payloads are integers, so every sum is exact and floats are held
bit-equal (var and std included).  At module level only torch, numpy
and the port are imported.
"""

import json
import os
import sys
import time

import numpy as np
import pytest

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
for _p in (_ROOT, _HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import cylon_tpu_torch as pct  # noqa: E402
import test_torch_multiprocess as mp  # noqa: E402

N_BATCHES = 6
CKPT_FIRST = 4
ROWS = 400
KEYS = 64
AGGS = [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max"),
        ("v", "mean"), ("v", "var"), ("v", "std")]
WINDOW, STRIDE, LATENESS = 100, 60, 30


def batches() -> list:
    """The stream: batch i's event times in ``[i·STRIDE, i·STRIDE +
    WINDOW)``, plus one row of key 0 at ``i·STRIDE + WINDOW + 5``: a lead
    only the process holding key 0 sees, short of the next window
    boundary, so its local watermark runs ahead of its peer's while both
    can close the same windows as one process can."""
    rng = np.random.default_rng(5)
    out = []
    for i in range(N_BATCHES):
        k = rng.integers(0, KEYS, ROWS).astype(np.int64)
        t = (i * STRIDE + rng.integers(0, WINDOW, ROWS)).astype(np.int64)
        k[0], t[0] = 0, i * STRIDE + WINDOW + 5
        out.append({"k": k, "t": t,
                    "v": rng.integers(-500, 500, ROWS).astype(np.float64)})
    return out


def dims(ct, env):
    return ct.Table.from_pydict(
        {"k": np.arange(KEYS, dtype=np.int64),
         "dim": np.arange(KEYS, dtype=np.int64) * 7}, env)


def stream_leg(ct, stream, env, out, n=N_BATCHES, windows=True):
    """``n`` batches into a stream table, a view and (``windows``) a
    window join: each read and each closed window's rows, and this
    process's local watermark at each step."""
    st = stream.StreamTable(env, key="k", name="mp")
    view = stream.IncrementalView(st, "k", AGGS, name="mpview")
    wj = stream.TumblingWindowJoin(
        env, key="k", time_col="t", window=WINDOW, build=dims(ct, env),
        build_on="k", lateness=LATENESS) if windows else None
    marks = []
    for i, b in enumerate(batches()[:n]):
        st.append(b)
        out[f"read{i}|rows"] = mp._rows(view.read())
        if wj is not None:
            wj.append(b)
            marks.append(wj.local_watermark())
            out[f"agreed{i}|n"] = np.asarray([wj.watermark()])
            for wid, tbl in wj.pop_closed():
                out[f"window{wid}|rows"] = mp._rows(tbl)
    if wj is not None:
        out["marks"] = np.asarray(marks, np.int64)
        if hasattr(wj, "release"):      # the port's stream end
            wj.release()
    out["ffwd"] = np.asarray([view.fast_forwarded])
    st.release()


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def _driver(argv) -> None:
    pid, nproc, addr, v, path = (int(argv[0]), int(argv[1]), argv[2],
                                 int(argv[3]), argv[4])
    leg = argv[5]
    from cylon_tpu_torch import stream
    from cylon_tpu_torch.exec import checkpoint
    from cylon_tpu_torch.parallel import transport
    env = pct.CylonEnv(pct.DistributedConfig(addr, pid, nproc,
                                             local_world=v, timeout_s=60),
                       device="cpu")
    ct = mp.port_api(env.world_size)
    out = {}
    t0 = time.perf_counter()
    if leg == "stream":
        stream_leg(ct, stream, env, out)
        marks = transport.allgather_array(out["marks"], "test.marks")
        out["marks_differ"] = np.asarray([bool((marks[0] != marks[1])
                                               .any())])
    else:
        stream_leg(ct, stream, env, out, windows=False,
                   n=CKPT_FIRST if leg == "ckpt_first" else N_BATCHES)
    out["s"] = np.asarray([time.perf_counter() - t0])
    mp._json(out, "stats", checkpoint.stats())
    np.savez(path, **out)
    env.finalize()


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------

_CACHE: dict = {}


def _launch(tmp, leg, **env):
    os.makedirs(tmp, exist_ok=True)
    return mp.start(tmp, 2, 2, legs=[leg], driver=os.path.abspath(__file__),
                    extra_env={"CYLON_TPU_TORCH_BROADCAST_JOIN_ROWS": "0",
                               **env})


def _one_process(**switches):
    """The stream in this process at ``VirtualMeshConfig(4)``."""
    from cylon_tpu_torch import stream
    from cylon_tpu_torch.exec import checkpoint
    env = pct.CylonEnv(pct.VirtualMeshConfig(4), device="cpu")
    prev = {k: os.environ.get(k) for k in switches}
    os.environ.update(switches)
    checkpoint.reset_stages()
    checkpoint.reset_stats()
    try:
        out = {}
        stream_leg(mp.port_api(4), stream, env, out,
                   windows=not switches)
        out["stats"] = checkpoint.stats()
        return out
    finally:
        for k, x in prev.items():
            if x is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = x


def _reference():
    import jax
    import cylon_tpu as rct
    import cylon_tpu.stream as rstream
    from cylon_tpu import config as rconfig
    from cylon_tpu.ctx.context import CPUMeshConfig
    prev = rconfig.BROADCAST_JOIN_ROWS
    rconfig.BROADCAST_JOIN_ROWS = 0
    try:
        out = {}
        stream_leg(mp.reference_api(), rstream, rct.CylonEnv(
            config=CPUMeshConfig(world_size=4)), out)
        return out
    finally:
        rconfig.BROADCAST_JOIN_ROWS = prev
        jax.clear_caches()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if "r" not in _CACHE:
        from cylon_tpu_torch import config as pconfig
        prev = pconfig.BROADCAST_JOIN_ROWS
        pconfig.BROADCAST_JOIN_ROWS = 0
        tmp = str(tmp_path_factory.mktemp("mpstream"))
        root = os.path.join(tmp, "ckpt")
        ck = {"CYLON_TPU_TORCH_CKPT_DIR": root}
        r = {}
        handles = {"stream": _launch(os.path.join(tmp, "a"), "stream"),
                   "ckpt_first": _launch(os.path.join(tmp, "b"),
                                         "ckpt_first", **ck)}
        try:
            r["virtual"] = _one_process()
            r["reference"] = _reference()
            for k in ("stream", "ckpt_first"):
                r[k] = mp.finish(handles.pop(k))
            handles["ckpt_resume"] = _launch(
                os.path.join(tmp, "c"), "ckpt_resume",
                CYLON_TPU_TORCH_RESUME="1", **ck)
            r["ckpt_resume"] = mp.finish(handles.pop("ckpt_resume"))
            # the 2 x 2 checkpoint resumed by one process: a new layout
            r["relayout"] = _one_process(CYLON_TPU_TORCH_CKPT_DIR=root,
                                         CYLON_TPU_TORCH_RESUME="1")
        finally:
            pconfig.BROADCAST_JOIN_ROWS = prev
            for h in handles.values():
                for p in h[0]:
                    p.kill()
        _CACHE["r"] = r
    return _CACHE["r"]


def _ok(run):
    codes, outs, res = run
    mp._assert_ok(codes, outs)
    for r in res:
        if isinstance(r["stats"], np.ndarray):
            r["stats"] = json.loads(bytes(r["stats"]))
    return res


def _compare(got: dict, want: dict, prefix: str) -> int:
    keys = sorted(k for k in want if k.startswith(prefix))
    for k in keys:
        assert k in got, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return len(keys)


def test_reads_equal_one_process_and_reference(runs):
    """Every read of the view, after every batch, on both processes."""
    assert _compare(runs["virtual"], runs["reference"], "read") \
        == N_BATCHES
    for r in _ok(runs["stream"]):
        assert _compare(r, runs["virtual"], "read") == N_BATCHES


def test_windows_equal_one_process_and_reference(runs):
    """The agreed close after every batch and every closed window's
    rows; the processes' local watermarks differed at some batch."""
    n = _compare(runs["virtual"], runs["reference"], "window")
    assert n >= 2
    _compare(runs["virtual"], runs["reference"], "agreed")
    res = _ok(runs["stream"])
    for r in res:
        assert _compare(r, runs["virtual"], "window") == n
        assert _compare(r, runs["virtual"], "agreed") == N_BATCHES
        assert bool(r["marks_differ"][0])
        assert not any(k.startswith("window") for k in r
                       if k not in runs["virtual"])


def test_view_checkpoint_resumes_across_layouts(runs):
    """The 2 × 2 view's checkpoint: each process commits its own blocks
    of each batch's partial; a 2 × 2 resume fast-forwards them, and one
    process at W = 4 adopts them through the re-shard path; every read
    equals the uninterrupted one-process run's."""
    for r in _ok(runs["ckpt_first"]):
        assert r["stats"]["checkpoint_events"] == CKPT_FIRST
        for i in range(CKPT_FIRST):
            np.testing.assert_array_equal(
                r[f"read{i}|rows"], runs["virtual"][f"read{i}|rows"])
    for r in _ok(runs["ckpt_resume"]):
        assert int(r["ffwd"][0]) == CKPT_FIRST
        assert r["stats"]["resume_world_mismatch"] == 0
        # the replayed batches are read before the restored partials
        # cover them only from the last fast-forwarded batch on
        for i in range(CKPT_FIRST - 1, N_BATCHES):
            np.testing.assert_array_equal(
                r[f"read{i}|rows"], runs["virtual"][f"read{i}|rows"])
    one = runs["relayout"]
    assert int(one["ffwd"][0]) == N_BATCHES
    assert one["stats"]["resume_world_mismatch"] == 1
    assert one["stats"]["resume_resharded_pieces"] == N_BATCHES
    np.testing.assert_array_equal(
        one[f"read{N_BATCHES - 1}|rows"],
        runs["virtual"][f"read{N_BATCHES - 1}|rows"])


def teardown_module():
    if "jax" in sys.modules:
        sys.modules["jax"].clear_caches()


if __name__ == "__main__":
    _driver(sys.argv[1:])
