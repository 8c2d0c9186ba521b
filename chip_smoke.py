"""Smoke run of cylon_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--rows N]

Builds the package's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, then drives the
BASELINE workload (bench.py's inner join of two int64 {k, payload} tables,
seed 42, keys uniform in [0, 0.9 n), then a groupby-sum on the join key)
through the package's public entry points — at 1M rows per side and at
``--rows`` per side (default 125M) — and checks every result against a
numpy oracle.  Prints one JSON line per phase, then the kernel summary
line, then the card's name and power limit as nvidia-smi reports them, and
last ``{"ok": true, "device": {...}}``.  Any failure raises: the script
exits nonzero without the last line.  It needs a CUDA device and fails
without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from cylon_tpu_torch.utils.host import sync_pull

#: published HBM3 bandwidth of one H100 SXM (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
K1_SOURCE = "cylon_tpu_torch/kernels/windowed_gather.cu"
K1_REPLACES = "cylon_tpu/ops/pallas_gather.py:161"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 10) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs (CUDA events), after
    one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_bytes(n_lanes: int, n_idx: int) -> int:
    """Bytes the gather must move: the indices read once, the gathered
    words read once, the output written once, the flag."""
    return 4 * n_idx + 2 * 4 * n_lanes * n_idx + 4


def k1_check(wg, label, mat_t, idx, window, expect_ok=None, timed=False):
    """Kernel vs plain version on the same card inputs: bit-equal output
    and flag.  Returns the phase record."""
    out_k, ok_k = wg.windowed_take_t(mat_t, idx, window)
    out_p, ok_p = wg.windowed_take_plain(mat_t, idx, window)
    torch.cuda.synchronize()
    if bool(ok_k) != bool(ok_p) or not torch.equal(out_k, out_p):
        raise AssertionError(f"K1 {label}: kernel and plain version differ")
    if expect_ok is not None and bool(ok_k) != expect_ok:
        raise AssertionError(f"K1 {label}: ok={bool(ok_k)}, want {expect_ok}")
    err = int((out_k.to(torch.int64) - out_p.to(torch.int64)).abs().max())
    L, M = mat_t.shape
    S = idx.shape[0]
    rec = {"phase": "k1", "case": label, "L": L, "M": M, "S": S,
           "window": window, "ok": bool(ok_k), "bit_equal": True,
           "max_abs_err": err}
    del out_k, out_p
    if timed:
        nbytes = k1_bytes(L, S)
        rec.update(
            ms=time_ms(lambda: wg.windowed_take_t(mat_t, idx, window)),
            plain_ms=time_ms(lambda: wg.windowed_take_plain(mat_t, idx,
                                                            window)),
            library_ms=time_ms(lambda: mat_t.index_select(1, idx)),
            bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes")
    return rec


def small_cases(rng, n_rows, n_lanes, seg, pattern, dev):
    """tests/test_pallas_gather.py's inputs, on the card."""
    mat = rng.integers(0, 1 << 32, (n_lanes, n_rows), dtype=np.uint32)
    if pattern == "dense":
        k = min(int(n_rows * 0.45), seg)
        real = np.sort(rng.choice(n_rows - 1, k, replace=False))
    elif pattern == "skewed":
        k = min(int(n_rows * 0.45), seg)
        real = np.sort(rng.choice(n_rows // 8, k - 1, replace=False))
        real = np.concatenate([real, [n_rows - 1]])
    else:
        real = np.zeros(0, np.int64)
    idx = np.full(seg, n_rows - 1, np.int32)
    idx[:len(real)] = real
    return (torch.from_numpy(mat.view(np.int32)).to(dev),
            torch.from_numpy(idx).to(dev))


def baseline_inputs(n: int, seed: int = 42, unique: float = 0.9):
    """bench.py's BASELINE tables (same generator, same draw order)."""
    rng = np.random.default_rng(seed)
    mv = max(int(n * unique), 1)
    lk = rng.integers(0, mv, n).astype(np.int64)
    a = rng.integers(0, mv, n).astype(np.int64)
    rk = rng.integers(0, mv, n).astype(np.int64)
    b = rng.integers(0, mv, n).astype(np.int64)
    return {"k": lk, "a": a}, {"k": rk, "b": b}, mv


def oracle(left, right, mv):
    """Per key: L, R, SA, SB by bincount; the join→groupby answer is
    keys where L>0 and R>0, sum_a = SA·R, sum_b = SB·L.  bincount weights
    are float64; every partial sum here stays below 2^53, so exact."""
    L = np.bincount(left["k"], minlength=mv)
    R = np.bincount(right["k"], minlength=mv)
    sa = np.bincount(left["k"], left["a"], minlength=mv)
    sb = np.bincount(right["k"], right["b"], minlength=mv)
    if max(sa.max() * R.max(), sb.max() * L.max()) >= 2.0 ** 53:
        raise AssertionError("oracle sums leave the exact float64 range")
    keep = (L > 0) & (R > 0)
    return {"k": np.nonzero(keep)[0],
            "a_sum": (sa.astype(np.int64) * R)[keep],
            "b_sum": (sb.astype(np.int64) * L)[keep],
            "rows": int((L * R).sum()), "L": L, "R": R,
            "sa": sa.astype(np.int64), "keep": keep}


def check_groupby(g, orc, label):
    out = g.to_pydict()
    for name in ("k", "a_sum", "b_sum"):
        if not np.array_equal(out[name], orc[name]):
            raise AssertionError(f"{label}: column {name} differs from the "
                                 "numpy oracle")
    if len(out["k"]) > 1 and not bool(np.all(np.diff(out["k"]) > 0)):
        raise AssertionError(f"{label}: keys not ascending")
    return len(out["k"])


def step(ct, lt, rt, times=None):
    """One BASELINE iteration through the public entry points."""
    t0 = time.perf_counter()
    j = ct.join_tables(lt, rt, "k", "k", how="inner")
    t1 = time.perf_counter()
    g = ct.groupby_aggregate(j, "k", [("a", "sum"), ("b", "sum")])
    sync_pull(g.column("k").data)
    t2 = time.perf_counter()
    if times is not None:
        times.append({"join_s": t1 - t0, "groupby_s": t2 - t1,
                      "total_s": t2 - t0})
    return g


def profile_step(ct, lt, rt, top: int = 12) -> dict:
    """One BASELINE iteration under torch.profiler: device time by kernel
    and by aten op, and the device's busy share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e, self_only):
        for name in (("self_device_time_total", "self_cuda_time_total")
                     if self_only else
                     ("device_time_total", "cuda_time_total")):
            v = getattr(e, name, None)
            if v is not None:
                return float(v)
        return 0.0

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(ct, lt, rt)
    wall_s = time.perf_counter() - t0
    evs = prof.key_averages()
    kern = [e for e in evs if str(getattr(e, "device_type", "")).endswith(
        "CUDA")]
    busy_us = sum(dev_us(e, True) for e in kern)
    ops = [e for e in evs if e.key.startswith("aten::")]
    return {
        "phase": "profile", "wall_s": wall_s, "device_busy_s": busy_us / 1e6,
        "device_idle_share_profiled": 1.0 - busy_us / 1e6 / wall_s,
        "kernels_ms": [[e.key[:80], dev_us(e, True) / 1e3, e.count]
                       for e in sorted(kern, key=lambda e: -dev_us(e, True))
                       [:top]],
        "aten_ops_ms": [[e.key, dev_us(e, False) / 1e3, e.count]
                        for e in sorted(ops, key=lambda e: -dev_us(e, False))
                        [:top]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=125_000_000,
                    help="rows per side of the full BASELINE run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this smoke run needs "
              "the card", file=sys.stderr)
        return 1
    import cylon_tpu_torch as ct
    from cylon_tpu_torch import kernels
    from cylon_tpu_torch.ops import windowed_gather as wg
    from torch.utils import cpp_extension

    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    emit({"phase": "card", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "ninja": cpp_extension.is_ninja_available()})

    # -- build every kernel from the checkout's sources --------------------
    t0 = time.perf_counter()
    libs = kernels.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(libs), "ptxas": kernels.build_logs})

    # -- K1 against its plain version on the card -------------------------
    rng = np.random.default_rng(42)
    for lanes in (1, 7, 8, 13):
        mat, idx = small_cases(rng, 4096, lanes, 2048, "dense", dev)
        emit(k1_check(wg, f"dense_L{lanes}", mat, idx, 1024, True))
    mat, idx = small_cases(rng, 4096, 5, 1024, "tail", dev)
    emit(k1_check(wg, "sentinel_tail", mat, idx, 1024, True))
    mat, idx = small_cases(rng, 1 << 15, 6, 4096, "skewed", dev)
    emit(k1_check(wg, "skewed", mat, idx, 1024, False))
    # BASELINE-shaped: L=7, M=2^28+1, S=2^26, ~0.2 density, sentinel tail
    gen = torch.Generator(device=dev).manual_seed(42)
    M, S = (1 << 28) + 1, 1 << 26
    mat = torch.randint(-(1 << 31), (1 << 31) - 1, (7, M), dtype=torch.int32,
                        device=dev, generator=gen)
    real = torch.nonzero(torch.rand(M - 1, device=dev, generator=gen) < 0.2)
    idx = torch.full((S,), M - 1, dtype=torch.int32, device=dev)
    k = min(real.shape[0], S)
    idx[:k] = real[:k, 0].to(torch.int32)
    del real
    emit(k1_check(wg, "baseline_shaped", mat, idx, wg.pick_window(0.2),
                  True, timed=True))
    del mat, idx
    torch.cuda.empty_cache()

    env = ct.CylonEnv()

    # -- small path: 1M rows per side --------------------------------------
    left, right, mv = baseline_inputs(1_000_000)
    orc = oracle(left, right, mv)
    lt, rt = ct.Table.from_pydict(left, env), ct.Table.from_pydict(right, env)
    n_groups = check_groupby(step(ct, lt, rt), orc, "small path")
    # read the deferred join instead of fusing it: Σ L·R rows, same sums
    j = ct.join_tables(lt, rt, "k", "k", how="inner")
    rows = j.to_pydict()
    if len(rows["k"]) != orc["rows"]:
        raise AssertionError("materialized join row count differs")
    sums = np.bincount(rows["k"], rows["a"], minlength=mv).astype(np.int64)
    if not np.array_equal(sums[orc["keep"]], (orc["sa"] * orc["R"])[orc["keep"]]):
        raise AssertionError("materialized join per-key sums differ")
    emit({"phase": "small_path", "rows_per_side": 1_000_000,
          "groups": n_groups, "join_rows": orc["rows"], "oracle": "equal"})
    del lt, rt, j, rows

    # -- full path: the main path, counted ---------------------------------
    n = args.rows
    t0 = time.perf_counter()
    left, right, mv = baseline_inputs(n)
    orc = oracle(left, right, mv)
    lt, rt = ct.Table.from_pydict(left, env), ct.Table.from_pydict(right, env)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    del left, right
    torch.cuda.reset_peak_memory_stats()
    wg.reset_counts()
    times = []
    g = step(ct, lt, rt, times)                 # warm-up (first sight)
    for _ in range(3):
        g = step(ct, lt, rt, times)
    counts = dict(wg.COUNTS)
    peak = torch.cuda.max_memory_allocated()
    n_groups = check_groupby(g, orc, "full path")
    if counts["launches"] < 1 or counts["redispatches"] != 0:
        raise AssertionError(f"windowed gather counts {counts}: expected "
                             "launches > 0 and no redispatch")
    best = min(t["total_s"] for t in times[1:])
    emit({"phase": "full_path", "rows_per_side": n, "groups": n_groups,
          "setup_s": setup_s, "iterations": times, "best_s": best,
          "rows_per_s": 2 * n / best, "peak_mem_bytes": peak,
          "oracle": "equal",
          "kernel_counts": {"windowed_gather": counts}})

    # a profiler failure is reported, not fatal: the phases above and the
    # kernel checks below decide the outcome
    try:
        prof = profile_step(ct, lt, rt)
        # the profiler slows the host many-fold: the idle share that
        # counts compares the device time with the unprofiled best
        prof["device_idle_share_of_best"] = 1.0 - prof["device_busy_s"] / best
        emit(prof)
    except Exception as e:  # noqa: BLE001 — report and carry on
        emit({"phase": "profile", "error": f"{type(e).__name__}: {e}"})

    # -- K1 at the main path's own inputs ----------------------------------
    captured = {}
    launch = wg.windowed_take_t

    def capture(mat_t, idx, window):
        captured.update(mat_t=mat_t, idx=idx, window=window)
        return launch(mat_t, idx, window)

    wg.windowed_take_t = capture
    try:
        del g
        check_groupby(step(ct, lt, rt), orc, "capture run")
    finally:
        wg.windowed_take_t = launch
    del lt, rt
    torch.cuda.empty_cache()
    rec = k1_check(wg, "main_path", captured["mat_t"], captured["idx"],
                   captured["window"], True, timed=True)
    emit(rec)
    emit({"kernels": [{
        "name": "windowed_gather", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": counts["launches"],
        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        "redispatches": counts["redispatches"]}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
