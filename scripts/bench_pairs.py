#!/usr/bin/env python3
"""Parent against change on one card: ``bench_torch/run.py`` of two checkouts
in alternating pairs (parent, change, change, parent, ...), one process each.

    python3 scripts/bench_pairs.py --parent build/parent --pairs 10 --out build/pairs \\
        -- --cells sched365x20_dense_p64

``--parent`` is a second checkout (``git archive`` of the parent commit,
unpacked into a directory ``.gitignore`` lists); the change is the checkout
this script lies in.  The arguments after ``--`` go to both runners.  With
``--all-ops`` each traced round lists every device operation, not only the
ten with the most time (the runner's ``TOP_OPS``), and the report names the
scan kernels among them.  Each run's standard output and error go to
``--out``; standard output gets one line per run, then, per cell and metric,
both sides' values, medians and quartiles, the pairs the change won (by the
metric's direction in ``BENCHMARK.json``; ties count for neither) and the
ratio of the medians, and whether every repeat of every run made the same
iterations and reached the same best; last one JSON object with all of it.
Exit code 1 when a run failed."""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# Runs bench_torch/run.py of the checkout argv[1] in this process; argv[2] > 0 lists that many device ops.
BOOT = """import sys
root, top = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, root)
from bench_torch import run
if top:
    run.TOP_OPS = top
sys.exit(run.main(sys.argv[3:]))
"""
ALL_OPS = 1_000_000


def run_side(root: Path, all_ops: bool, run_args: list, out: Path, tag: str) -> dict:
    """One runner process from ``root``: its records by cell, exit code and wall."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", BOOT, str(root), str(ALL_OPS if all_ops else 0), *run_args],
                          cwd=root, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    (out / f"{tag}.out").write_text(proc.stdout)
    (out / f"{tag}.err").write_text(proc.stderr)
    records = {}
    for line in proc.stdout.splitlines():
        if line.startswith("{") and '"workload"' in line:
            rec = json.loads(line)
            records[rec["workload"]] = rec
    return {"rc": proc.returncode, "wall_s": wall, "records": records,
            "card": proc.stdout.splitlines()[0] if proc.stdout else None}


def cell_summary(rec: dict) -> dict:
    """What the report keeps of one cell's record."""
    trace = rec["breakdown"]
    ops = trace["top_device_ops"] if isinstance(trace["top_device_ops"], list) else []
    return {
        "correct": rec["correct"],
        "metrics": {m: v["value"] for m, v in rec["metrics"].items()},
        "iterations": [r["iterations"] for r in rec["repeats"]],
        "best": [r["best"] for r in rec["repeats"]],
        "busy_ms_per_iteration": trace["busy_ms_per_iteration"],
        "idle_share": trace["idle_share"],
        "top_device_ops": ops[:10],
        "scan_ops": [o for o in ops if "scan" in o["name"].lower()],
    }


def quartiles(values: list) -> list:
    return statistics.quantiles(values, n=4, method="inclusive") if len(values) > 1 else values * 3


def compare(runs: list, directions: dict) -> dict:
    """Per cell and metric: both sides' values in pair order, medians,
    quartiles, the change's wins and the ratio change / parent of the medians."""
    out = {}
    cells = sorted({c for r in runs for c in r["parent"]["cells"]})
    for cell in cells:
        for m in sorted({m for r in runs for m in r["parent"]["cells"].get(cell, {}).get("metrics", {})}):
            pv = [r["parent"]["cells"][cell]["metrics"][m] for r in runs]
            cv = [r["change"]["cells"][cell]["metrics"][m] for r in runs]
            if not all(isinstance(v, (int, float)) for v in pv + cv):
                continue
            sign = 1 if directions.get(m) == "higher" else -1
            wins = sum(sign * (c - p) > 0 for p, c in zip(pv, cv))
            pm, cm = statistics.median(pv), statistics.median(cv)
            out[f"{cell}.{m}"] = {"parent": pv, "change": cv, "parent_median": pm, "change_median": cm,
                                  "parent_quartiles": quartiles(pv), "change_quartiles": quartiles(cv),
                                  "change_wins": wins, "pairs": len(pv), "ratio": cm / pm if pm else None}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True, type=Path, help="the parent commit's checkout")
    parser.add_argument("--pairs", type=int, default=3)
    parser.add_argument("--out", required=True, type=Path, help="where each run's output goes")
    parser.add_argument("--all-ops", action="store_true", help="list every device op of each traced round")
    parser.add_argument("run_args", nargs=argparse.REMAINDER, help="-- then bench_torch/run.py's arguments")
    args = parser.parse_args(argv)
    run_args = args.run_args[1:] if args.run_args[:1] == ["--"] else args.run_args
    args.out.mkdir(parents=True, exist_ok=True)
    directions = {m: spec["direction"]
                  for m, spec in json.loads((ROOT / "BENCHMARK.json").read_text())["metrics"].items()}
    roots = {"parent": args.parent.resolve(), "change": ROOT}
    runs, failed = [], False
    for i in range(args.pairs):
        pair = {}
        for side in ("parent", "change") if i % 2 == 0 else ("change", "parent"):
            res = run_side(roots[side], args.all_ops, run_args, args.out, f"{i:02d}-{side}")
            failed |= res["rc"] != 0
            pair[side] = {"rc": res["rc"], "wall_s": res["wall_s"], "card": res["card"],
                          "cells": {c: cell_summary(r) for c, r in res["records"].items()}}
            print(json.dumps({"pair": i, "side": side, "rc": res["rc"], "wall_s": round(res["wall_s"], 1),
                              **{c: s["metrics"] for c, s in pair[side]["cells"].items()}}), flush=True)
        runs.append(pair)
    if failed:
        print(json.dumps({"ok": False, "rcs": [[r[s]["rc"] for s in ("parent", "change")] for r in runs]}))
        return 1
    table = compare(runs, directions)
    for cell in sorted(runs[0]["parent"]["cells"]):
        sides = [r[s]["cells"][cell] for r in runs for s in ("parent", "change")]
        same = all((c["iterations"], c["best"]) == (sides[0]["iterations"], sides[0]["best"]) for c in sides)
        table[f"{cell}.trajectory"] = {"same_in_every_run": same, "iterations": sides[0]["iterations"],
                                       "best": sides[0]["best"], "correct": all(c["correct"] for c in sides)}
        print(f"{cell}: every run correct {table[f'{cell}.trajectory']['correct']}; iterations and best "
              f"the same in every run of both sides {same}: {sides[0]['iterations']}, {sides[0]['best']}",
              flush=True)
    for key, row in table.items():
        if key.endswith(".trajectory"):
            continue
        pq, cq = (", ".join(f"{q:.6g}" for q in row[k]) for k in ("parent_quartiles", "change_quartiles"))
        print(f"{key}: parent median {row['parent_median']:.6g} (quartiles {pq}), change median "
              f"{row['change_median']:.6g} (quartiles {cq}), change wins {row['change_wins']}/"
              f"{row['pairs']}, ratio {row['ratio']:.4f}", flush=True)
    print(json.dumps({"ok": True, "compare": table, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
