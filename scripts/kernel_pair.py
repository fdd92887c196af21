#!/usr/bin/env python3
"""K4 (the masked N-Queens move), K5 (the roster's dense neighborhood), K6 (the
N-Queens column sample) or K7 (the fingerprints of N-Queens candidates) of two
checkouts on one card and on the same inputs, in alternating runs (parent,
change, change, parent, ...), one process each.

    python3 scripts/kernel_pair.py --kernel k5 --parent build/parent --pairs 2 --out build/kernel_pair

``--parent`` is a second checkout (``git archive`` of the parent commit,
unpacked into a directory ``.gitignore`` lists); the change is the checkout
this script lies in.  Both sides take their inputs from this checkout's
``chip_smoke.py`` and call the kernel through its wrapper, whose signature
both versions share:

- ``k4``: the all-on moves with no best board of phase 2f (``k4_cases``) at
  (256, 50, 1000) and (16, 64, 16384), each applied over state copies that do
  not fit the L2 (``k4_rotation``), through ``nqueens_move(state, moves, idx,
  mask)``; device-only us per launch (``device_ms``: its events in a
  ``torch.profiler`` trace).
- ``k5``: phase 2g's two timed cases (``k5_cases``: the roster's (64, 365, 20,
  256, 4) and 730 x 40 at P = 128), through ``sched_dense``; device-only us
  per call (``k5_device_ms``: every K5 kernel's events in a trace, summed)
  and each kernel's part, and the launches a call.
- ``k6``: phase 2h's timed K6 cases (``k6_cases``: random and near-solved
  boards at (256, 1000, 50) and (16, 16384, 64)), through ``nqueens_sample``
  where the checkout has it, else through the chain its N-Queens
  neighborhood runs (the stable sort and the gathers, as
  ``nqueens_sample_ref`` has them); ``k7``: phase 2h's timed K7 cases (a
  pick at both cells' shapes, the exact filter's [256, 50000]), through
  ``nqueens_move_fp``, else the decode and ``fp_update``.  For each: the
  device work of one call (its kernels and their device us in a
  ``torch.profiler`` trace, ``eager_chain_kernels``) and us per call by
  CUDA events over ``TIMED_LAUNCHES`` calls.

Each run also gives the wrapper's host us per call (``host_us``, the less of
two runs).  Standard output gets the card, one line per run and shape, then
one JSON object with all of it.  Exit code 1 when a run failed."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# Loads the chip_smoke.py at argv[2] with the checkout argv[1] first on the path.
PRELUDE = """import importlib.util, json, sys
root, smoke = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("chip_smoke", smoke)
c = sys.modules["chip_smoke"] = importlib.util.module_from_spec(spec)
spec.loader.exec_module(c)
import torch
"""

# Times each kernel of the checkout on the smoke's inputs; prints one JSON line.
BOOT = {
    "k4": PRELUDE + """from constraint_solver_tpu_torch.ops import nqueens_move as nm
from constraint_solver_tpu_torch.utils.tree import tree_map

def kernel(state, moves, idx, mask, best=None, save=None):
    nm.nqueens_move(state, moves, idx, mask)

out = {"package": nm.__file__}
labels = [f"all on {shape}" for shape in c.K4_SHAPES]
for case in c.k4_cases(torch.device("cuda", 0)):
    if case.label not in labels:
        continue
    copies, call = c.k4_rotation(case.state, case.moves, case.idx, case.mask)
    cycle = 2 * len(copies)
    c.time_ms(call, (kernel,), cycle)  # warm-up (and the build)
    dev, how = c.device_ms(call, (kernel,), cycle, c.K4_EVENT)
    args = (tree_map(torch.clone, case.state), case.moves, case.idx, case.mask)
    host = min(c.host_us(nm.nqueens_move, args, c.TIMED_LAUNCHES) for _ in range(2))
    out[case.label] = {"device_us": dev * 1e3, "how": how, "host_us": host, "state_copies": len(copies)}
print(json.dumps(out))
""",
    "k5": PRELUDE + """from constraint_solver_tpu_torch.ops import sched_dense as sd

out = {"package": sd.__file__}
for case in c.k5_cases(torch.device("cuda", 0)):
    if not case.timed:
        continue
    c.time_ms(sd.sched_dense, case.args, 2)  # warm-up (and the build)
    before = sd.sched_dense.launches
    sd.sched_dense(*case.args)
    launches = sd.sched_dense.launches - before
    dev, split, how = c.k5_device_ms(sd.sched_dense, case.args, c.K5_CALLS)
    host = min(c.host_us(sd.sched_dense, case.args, c.K5_CALLS) for _ in range(2))
    out[case.label] = {"device_us": dev * 1e3, "split_us": {k: v * 1e3 for k, v in split.items()}, "how": how,
                       "host_us": host, "launches_a_call": launches}
print(json.dumps(out))
""",
    "k6": PRELUDE + """try:
    from constraint_solver_tpu_torch.ops import nqueens_sample as ns
    fn, what = ns.nqueens_sample, "K6"
except ImportError:  # a checkout from before K6: the neighborhood's chain
    def fn(cs, table, gumbel, num_cols, n_conflicted, rows, rc, dc, ac, a):
        n = cs.shape[1]
        logits = torch.where(cs > 0, table[cs.long()], -torch.inf)
        c = torch.sort(logits + gumbel, dim=-1, descending=True, stable=True).indices[:, :a]
        col_valid = torch.arange(a, device=cs.device) < torch.minimum(num_cols, n_conflicted)[:, None]
        r = rows.gather(1, c)
        removed = (rc.gather(1, r) - 1) + (dc.gather(1, r - c + (n - 1)) - 1) + (ac.gather(1, r + c) - 1)
        return c, c.to(torch.int32), r.to(torch.int32), removed, col_valid, col_valid.sum(dim=-1) * n
    what = "eager chain"

out = {"package": c.__file__, "what": what}
for case in c.k6_cases(torch.device("cuda", 0)):
    if not case.timed:
        continue
    c.time_ms(fn, case.args, 3)  # warm-up (and the build)
    work = c.eager_chain_kernels(fn, case.args)
    us = [c.time_ms(fn, case.args, c.TIMED_LAUNCHES) * 1e3 for _ in range(2)]
    out[case.label] = {"what": what, "device_us": work["device_ms"] * 1e3, "kernels": work.get("kernels", 0),
                       "copies": work.get("copies", 0), "us": sum(us) / 2}
print(json.dumps(out))
""",
    "k7": PRELUDE + """from constraint_solver_tpu_torch.ops import fingerprint as fpk

fn, what = getattr(fpk, "nqueens_move_fp", None), "K7"
if fn is None:  # a checkout from before K7: its model's move_fp, the decode then fp_update
    import functools

    from constraint_solver_tpu_torch.models.nqueens import NQMoves, NQState, make_nqueens_problem

    problem = functools.lru_cache(make_nqueens_problem)

    def fn(cur_fp, cols, rows, idx):
        n = rows.shape[1]
        return problem(n).move_fp(NQState(rows, None, None, None, None), cur_fp, NQMoves(cols, n), idx)
    what = "decode and K2a"
out = {"package": fpk.__file__, "what": what}
for case in c.k7_cases(torch.device("cuda", 0)):
    if not case.timed:
        continue
    c.time_ms(fn, case.args, 3)  # warm-up (and the build)
    work = c.eager_chain_kernels(fn, case.args)
    us = [c.time_ms(fn, case.args, c.TIMED_LAUNCHES) * 1e3 for _ in range(2)]
    out[case.label] = {"what": what, "device_us": work["device_ms"] * 1e3, "kernels": work.get("kernels", 0),
                       "copies": work.get("copies", 0), "us": sum(us) / 2}
print(json.dumps(out))
""",
}


def run_side(kernel: str, root: Path, out: Path, tag: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", BOOT[kernel], str(root), str(ROOT / "chip_smoke.py")],
                          cwd=root, capture_output=True, text=True)
    (out / f"{tag}.out").write_text(proc.stdout)
    (out / f"{tag}.err").write_text(proc.stderr)
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    return {"rc": proc.returncode, "result": result}


def describe(kernel: str, r: dict) -> str:
    if kernel in ("k6", "k7"):
        return (f"{r['what']}: {r['kernels']} kernels and {r['copies']} copies a call, device {r['device_us']:.3f} us, "
                f"{r['us']:.3f} us a call by CUDA events")
    if kernel == "k4":
        return (f"device-only {r['device_us']:.3f} us ({r['how']}), host {r['host_us']:.1f} us, "
                f"{r['state_copies']} state copies")
    split = ", ".join(f"{k} {v:.3f}" for k, v in r["split_us"].items())
    return (f"device-only {r['device_us']:.3f} us ({r['how']}: {split}), {r['launches_a_call']:g} launches a call, "
            f"host {r['host_us']:.1f} us")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kernel", choices=sorted(BOOT), required=True)
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "kernel_pair")
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    sides = {"parent": args.parent.resolve(), "change": ROOT}
    runs, ok = [], True
    for i in range(args.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for side in order:
            run = run_side(args.kernel, sides[side], args.out, f"{args.kernel}-{i}-{side}")
            runs.append({"pair": i, "side": side, **run})
            if run["result"] is None:
                ok = False
                print(f"pair {i} {side}: rc {run['rc']}, see {args.out}/{args.kernel}-{i}-{side}.err", flush=True)
                continue
            for label, r in run["result"].items():
                if label not in ("package", "what"):
                    print(f"pair {i} {side:6} {label:44} {describe(args.kernel, r)}", flush=True)
    print(json.dumps({"card": card, "kernel": args.kernel, "runs": runs}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
