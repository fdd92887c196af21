#!/usr/bin/env python3
"""How the QAP cell's correctness check reads faults planted in the descent's
in-place move: ``bench_torch/run.py``'s ``qap4096_inc_p4`` run once per plant,
with its warm-up and one checked repeat, and the check's verdict, failures and
cost gaps printed.

    python3 scripts/qap_plant.py                      # on the card, n = 4096
    python3 scripts/qap_plant.py --device cpu --n 256

Each plant is written into ``Problem.in_place``:

- ``none``: no fault (the control);
- ``move_g_drift`` / ``move_h_drift``: entry (0, 1) of G or H one more in
  every lane the in-place move writes, after each move (the descent's own
  state; the rebuild of its best from the permutation stays exact);
- ``rebuild_g_drift`` / ``rebuild_h_drift``: the same entry one more in every
  lane of the state rebuilt from the descent's best permutation (the state the
  solver carries out of the descent);
- ``state_unchanged``: the move writes nothing (its score is carried).

One JSON line per plant, then one JSON object with all of them.  The exit code
is 0 whether a plant is caught or not: the output is the reading; it is 1 only
when the control fails its check."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from bench_torch import run as bench  # noqa: E402

CELL = "qap4096_inc_p4"
PLANTS = ("none", "move_g_drift", "move_h_drift", "rebuild_g_drift", "rebuild_h_drift", "state_unchanged")


def planted(make, plant: str):
    """``make_qap_problem`` whose ``in_place`` carries ``plant``."""

    def call(spec, **kw):
        prob = make(spec, **kw)
        ip = prob.in_place
        if plant == "none":
            return prob
        if plant == "state_unchanged":
            return prob._replace(in_place=ip._replace(move=lambda st, moves, idx, mask: None))
        where, leaf = plant.split("_")[:2]
        if where == "rebuild":

            def rebuild(p):
                st = ip.rebuild(p)
                getattr(st, leaf)[:, 0, 1] += 1.0
                return st

            return prob._replace(in_place=ip._replace(rebuild=rebuild))

        def move(st, moves, idx, mask):  # no host read: the move may be captured in a CUDA graph
            ip.move(st, moves, idx, mask)
            getattr(st, leaf)[:, 0, 1] += mask.to(st.g.dtype)

        return prob._replace(in_place=ip._replace(move=move))

    return call


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--n", type=int, default=None, help="facilities (default: the cell's)")
    parser.add_argument("--plants", nargs="+", default=list(PLANTS), choices=PLANTS)
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("scripts/qap_plant.py: no CUDA device (--device cpu runs on the host)", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    spec = json.loads(bench.BENCHMARK.read_text())
    record = bench.describe_device(device)
    real, out = bench.make_qap_problem, []
    for plant in args.plants:
        cell = bench.load_cells(spec, [CELL])[CELL]
        if args.n is not None:
            cell["config"]["n"] = args.n
        cell["traffic"]["repeats"] = 1
        bench.make_qap_problem = planted(real, plant)
        try:
            _, rec = bench.time_cell(cell, device, spec["seed"], record)
        finally:
            bench.make_qap_problem = real
        (rep,) = rec["repeats"]
        line = {"plant": plant, "n": cell["config"]["n"], "correct": rec["correct"],
                "failures": rec["failures"], "cost_gap": rep["cost_gap"], "iterations": rep["iterations"],
                "best": rep["best"]}
        print(json.dumps(line), flush=True)
        out.append(line)
    print(json.dumps({"device": record, "plants": out}), flush=True)
    return 0 if all(r["correct"] for r in out if r["plant"] == "none") else 1


if __name__ == "__main__":
    sys.exit(main())
