"""Compare one phase of chip_smoke.py between two checkouts on the card.

Each side runs the phase in a fresh process, in the order parent,
change, change, parent, so that a drift of the machine shows as a spread
within a side rather than as a difference between them:

    python3 chip_compare.py --parent DIR --phase tpch_path --tpch-scale 5

``DIR`` holds the parent checkout (``git archive <commit> | tar -x -C
DIR``, into a directory that .gitignore lists); the checkout this script
sits in is the change.  Each process builds the kernels from its own
checkout's sources, runs the phase once and prints one JSON line per
record: its side and order, and the record's times (``--profile`` adds
the profiled run of ``tpch_path`` or ``strings_path``, its device busy
time and top kernels).
With ``--serve-last`` the change's second process also runs
``serve_path`` and its preempt leg on ``tpch_path``'s tables after its
timings, and prints their records whole.  Needs the card; exits nonzero if any process fails.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

#: what a compact line keeps of a phase's record
KEYS = ("phase", "query", "case", "scale", "world", "best_s", "iterations",
        "rows_per_s", "lineitem_rows_per_s", "peak_mem_bytes",
        "failed_attempt_s", "recovery_s", "total_s", "kernel_counts",
        "phase_split_s", "cap_prediction", "profile")

#: the child: build, run one phase of the checkout's chip_smoke.py
CHILD = r"""
import json, sys, tempfile
sys.path.insert(0, ".")
import chip_smoke as cs
import cylon_tpu_torch as ct
from cylon_tpu_torch import kernels

spec = json.loads(sys.argv[1])
kernels.build()
phase = spec["phase"]
if phase == "tpch_path":
    kw = {"profile": spec["profile"]}
    if spec.get("serve_root"):
        kw["serve_root"] = spec["serve_root"]
    recs = cs.tpch_path(ct, spec["tpch_scale"], **kw)
elif phase == "broadcast_path":
    recs = [cs.broadcast_path(ct, cs.FACT_ROWS)]
elif phase == "strings_path":
    recs = [cs.strings_path(ct, cs.STRING_ROWS, profile=spec["profile"])]
elif phase == "dist_path":
    # the W = 4 monolithic join -> groupby on bench.py's tables (the
    # default --rows a side), a warm-up and best of 3, split armed and off
    import time
    import torch
    from cylon_tpu_torch import config as pconfig
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    left, right, _mv = cs.baseline_inputs(125_000_000)
    env = ct.CylonEnv(VirtualMeshConfig(4))
    lt = ct.Table.from_pydict(left, env)
    rt = ct.Table.from_pydict(right, env)
    del left, right
    recs = []
    for armed in (True, False):
        pconfig.SKEW_SPLIT = armed
        times = []
        for _ in range(4):
            g = cs.step(ct, lt, rt, times)
        del g
        torch.cuda.empty_cache()
        best = min(t["total_s"] for t in times[1:])
        recs.append({"phase": "dist_path", "query": "armed" if armed
                     else "unarmed", "world": 4, "best_s": best,
                     "iterations": [t["total_s"] for t in times]})
elif phase == "procs_gloo":
    # the W = 4 monolithic join -> groupby as 2 processes x 2 ranks over
    # gloo on bench.py's tables: this checkout's children, launched as
    # its procs_path launches them
    import os
    import shutil
    import time
    import numpy as np
    left, right, _mv = cs.baseline_inputs(125_000_000)
    data = tempfile.mkdtemp(prefix="compare_procs_", dir=".")
    try:
        for name, arr in (("lk", left["k"]), ("a", left["a"]),
                          ("rk", right["k"]), ("b", right["b"])):
            np.save(os.path.join(data, f"{name}.npy"), arr)
        del left, right
        res = cs._procs_collect(
            "procs_gloo", cs._procs_launch("procs_gloo", 2, 2, "gloo",
                                           os.path.abspath(data)),
            time.perf_counter() + cs.PROCS_TIMEOUT_S)
    finally:
        shutil.rmtree(data, ignore_errors=True)
    recs = [{"phase": "procs_gloo", "world": 4, "case": f"p{r['pid']}",
             "best_s": r["monolithic"]["best_s"],
             "iterations": [t["total_s"] for t in r["monolithic"][
                 "iterations"]],
             "rows_per_s": 2 * 125_000_000 / r["monolithic"]["best_s"]}
            for r in res]
elif phase == "left_join_path":
    # the W = 4 left join -> groupby through the DataFrame entry on
    # bench.py's tables, the default --rows a side
    left, right, mv = cs.baseline_inputs(125_000_000)
    recs = [cs.left_join_path(ct, left, right, mv)]
elif phase == "repart_path":
    # setops_path's input: the subtraction of bench.py's tables' keys at
    # W = 4, the default --rows a side
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    left, right, _mv = cs.baseline_inputs(125_000_000)
    env = ct.CylonEnv(VirtualMeshConfig(4))
    sub = ct.DataFrame(left, env=env)[["k"]].subtract(
        ct.DataFrame(right, env=env)[["k"]])
    del left, right
    recs = [cs.repart_path(ct, sub.table)]
else:
    recs = [cs.oom_path(ct, cs.OOM_ROWS)]
for rec in recs:
    out = rec if rec.get("phase") != phase \
        else {k: rec[k] for k in spec["keys"] if k in rec}
    print(json.dumps({"side": spec["side"], "order": spec["order"], **out},
                     default=str), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="directory of the parent checkout")
    ap.add_argument("--phase", required=True,
                    choices=("tpch_path", "broadcast_path", "strings_path",
                             "repart_path", "dist_path", "procs_gloo",
                             "left_join_path", "oom_path"))
    ap.add_argument("--tpch-scale", type=float, default=5.0)
    ap.add_argument("--serve-last", action="store_true",
                    help="the change's second run also runs serve_path")
    ap.add_argument("--profile", action="store_true",
                    help="tpch_path, strings_path: one profiled run per "
                    "query as well (its device busy time and top kernels)")
    args = ap.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    sides = {"parent": os.path.abspath(args.parent), "change": here}
    rc = 0
    with tempfile.TemporaryDirectory(dir=here) as root:
        for order, side in enumerate(("parent", "change", "change",
                                      "parent")):
            spec = {"side": side, "order": order, "phase": args.phase,
                    "tpch_scale": args.tpch_scale, "profile": args.profile,
                    "keys": KEYS,
                    "serve_root": os.path.join(root, "serve")
                    if args.serve_last and order == 2 else None}
            proc = subprocess.run(
                [sys.executable, "-c", CHILD, json.dumps(spec)],
                cwd=sides[side], timeout=1800)
            if proc.returncode:
                print(json.dumps({"side": side, "order": order,
                                  "rc": proc.returncode}), flush=True)
                rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
