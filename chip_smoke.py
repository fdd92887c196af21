#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``constraint_solver_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits nonzero:

1. builds the CUDA kernel from ``constraint_solver_tpu_torch/csrc`` and prints the
   card's name and power limit (``nvidia-smi``); without a CUDA device it stops
   before printing any result;
2. holds the kernel against its plain PyTorch version on the card at the shapes
   the solver gives it, bit for bit, and times both at the main shape with CUDA
   events;
3. runs a few rounds of nqueens-64 with 8 lanes on the card and on the CPU from
   the same host-side draws, in both tabu modes: the states must be equal;
4. drives the main path, ``PopulationSolver(make_nqueens_problem(1000), ...,
   population=256, exchange_every=2, device="cuda").run(chunk=2)``, until the
   best board has zero conflicts (cancelled at ``WALL_CAP_S``), then checks the
   board with an independent numpy count, every lane's carried counters against
   a rebuild from its board, the carried fingerprints against a full
   recomputation, and that the kernel was launched in the run.

The line before the last is a JSON object with each kernel's measurements; the
last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import threading
import time

import numpy as np

MAIN_N, MAIN_P, MAIN_A = 1000, 256, 50
WALL_CAP_S = 300.0
CHECK_SHAPES = ((MAIN_P, MAIN_A, MAIN_N), (4, 3, 8), (8, 5, 1003), (2, 3, 14000))
TIMED_LAUNCHES = 50


def log(msg: str) -> None:
    print(msg, flush=True)


def main_config():
    """The main path's solver configuration (the JAX package's bench.py headline)."""
    from constraint_solver_tpu_torch.core.ils import SolverConfig

    return SolverConfig(
        seed="bench",
        local_search_max_iterations=250,
        all_solutions_capacity=256,
        best_solutions_capacity=8,
        iterated_local_search_max_iterations=10_000,
        max_allow_no_improvement_for=5,
    )


def kernel_inputs(rng, p, a, n, device):
    """Counters of random boards, A distinct sampled columns per lane, their
    rows, removed terms and current totals: the kernel's arguments."""
    import torch

    from constraint_solver_tpu_torch.models.nqueens import build_state, total_conflicts

    st = build_state(torch.as_tensor(rng.integers(0, n, size=(p, n)), device=device))
    c = torch.as_tensor(np.argsort(rng.random((p, n)), axis=1)[:, :a], device=device)
    r = st.rows.gather(1, c)
    removed = (st.rc.gather(1, r) - 1) + (st.dc.gather(1, r - c + n - 1) - 1) + (st.ac.gather(1, r + c) - 1)
    cur = total_conflicts(st.rows).to(torch.float32)
    return (st.rc, st.dc, st.ac, c.to(torch.int32), r.to(torch.int32), removed.contiguous(), cur)


def time_ms(fn, args, launches: int) -> float:
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn(*args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / launches


def phase_kernel(device) -> dict:
    """Kernel vs plain version at every shape; times at the main shape."""
    import torch

    from constraint_solver_tpu_torch.ops import nqueens_kernel as nk

    rng = np.random.default_rng(0)
    max_err = 0.0
    for p, a, n in CHECK_SHAPES:
        args = kernel_inputs(rng, p, a, n, device)
        got = nk.nqueens_neighborhood_scores(*args)
        torch.cuda.synchronize()
        want = nk.nqueens_neighborhood_scores_ref(*args)
        for name, w, g in zip(("scores", "row_min", "row_arg"), want, got):
            if w.shape != g.shape or w.dtype != g.dtype or not torch.equal(w, g):
                raise AssertionError(f"kernel != plain version for {name} at (P, A, n) = {(p, a, n)}")
        err = float((got[0] - want[0]).abs().max())
        max_err = max(max_err, err)
        log(f"phase 2: kernel == plain version bit for bit at (P, A, n) = {(p, a, n)}")

    args = kernel_inputs(rng, MAIN_P, MAIN_A, MAIN_N, device)
    for fn in (nk.nqueens_neighborhood_scores, nk.nqueens_neighborhood_scores_ref):
        time_ms(fn, args, 5)  # warm-up
    # In turns (plain, kernel, kernel, plain), so drift hits both alike.
    plain = [time_ms(nk.nqueens_neighborhood_scores_ref, args, TIMED_LAUNCHES)]
    kern = [time_ms(nk.nqueens_neighborhood_scores, args, TIMED_LAUNCHES) for _ in range(2)]
    plain.append(time_ms(nk.nqueens_neighborhood_scores_ref, args, TIMED_LAUNCHES))
    ms, plain_ms = sum(kern) / 2, sum(plain) / 2
    log(
        f"phase 2: at (P, A, n) = {(MAIN_P, MAIN_A, MAIN_N)}: kernel {kern} ms, plain {plain} ms "
        f"(mean of {TIMED_LAUNCHES} launches each, CUDA events)"
    )
    return {
        "name": "nqueens_neighborhood_scores",
        "route": "cuda",
        "source": "constraint_solver_tpu_torch/csrc/nqueens_scores.cu",
        "replaces": "constraint_solver_tpu/ops/nqueens_pallas.py:121",
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }


def run_rounds(device, exact, chunks=3):
    """nqueens-64, 8 lanes, from draws made on the host; returns the state in
    the reference layout and the per-round traces."""
    from constraint_solver_tpu_torch.core.ils import SolverConfig
    from constraint_solver_tpu_torch.models.nqueens import make_nqueens_problem
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver
    from constraint_solver_tpu_torch.utils.convert import to_reference
    from constraint_solver_tpu_torch.utils.draws import TorchDraws

    config = SolverConfig(
        seed="smoke-64", local_search_max_iterations=40, best_solutions_capacity=4,
        all_solutions_capacity=64, restart_every=4, tabu_exact_filter=exact,
    )
    solver = PopulationSolver(
        make_nqueens_problem(64), config, population=8, exchange_every=2, device=device,
        draws=TorchDraws(config.seed, 8, device, draw_device="cpu"),
    )
    traces = [solver.execute_chunk_traced(2) for _ in range(chunks)]
    return to_reference(solver.state), np.concatenate(traces), solver.stats()


def assert_tree_equal(a, b, path="state"):
    if hasattr(a, "_fields"):
        for f in a._fields:
            assert_tree_equal(getattr(a, f), getattr(b, f), f"{path}.{f}")
    elif a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b):
        raise AssertionError(f"card and CPU runs differ at {path}")


def phase_cross_device(device) -> None:
    for exact in (None, False):
        on_card, trace_card, stats = run_rounds(device, exact)
        on_cpu, trace_cpu, _ = run_rounds("cpu", exact)
        assert_tree_equal(on_card, on_cpu)
        if not np.array_equal(trace_card, trace_cpu):
            raise AssertionError("card and CPU traces differ")
        mode = "exact filter" if exact is None else "pick-then-check"
        log(
            f"phase 3: nqueens-64 P=8 ({mode}): card == CPU after {stats['rounds']} rounds, "
            f"{stats['ls_iterations']} descent iterations, best hard {trace_card[-1, 1]}"
        )


def numpy_counts(rows: np.ndarray):
    """Line counters of boards rows[..., n] by numpy bincount, independent of the port."""
    n = rows.shape[-1]
    flat = rows.reshape(-1, n).astype(np.int64)
    cols = np.arange(n)

    def count(idx, size):
        return np.stack([np.bincount(i, minlength=size) for i in idx]).astype(np.float32)

    rc, dc, ac = count(flat, n), count(flat - cols + n - 1, 2 * n - 1), count(flat + cols, 2 * n - 1)
    lanes = np.arange(flat.shape[0])[:, None]
    cs = (rc[lanes, flat] - 1) + (dc[lanes, flat - cols + n - 1] - 1) + (ac[lanes, flat + cols] - 1)
    return rc, dc, ac, cs


def attacking_pairs(rows: np.ndarray) -> int:
    rc, dc, ac, _ = numpy_counts(rows[None])
    return int(sum((c * (c - 1) / 2).sum() for c in (rc, dc, ac)))


def phase_main(device, n=MAIN_N, population=MAIN_P, wall_cap=WALL_CAP_S) -> dict:
    import torch

    from constraint_solver_tpu_torch.models.nqueens import make_nqueens_problem
    from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
    from constraint_solver_tpu_torch.ops.fingerprint import fingerprint_i32
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver

    problem = make_nqueens_problem(n)
    config = main_config()

    def solver():
        return PopulationSolver(problem, config, population=population, exchange_every=2, device=device)

    t0 = time.time()
    solver().run(max_rounds=2, chunk=2)  # warm-up: first-call costs stay out of the timing
    log(f"phase 4: warm-up (2 rounds) {time.time() - t0:.3f} s")

    nk.nqueens_neighborhood_scores.launches = 0
    s = solver()
    timer = threading.Timer(wall_cap, s.cancel)
    timer.start()
    try:
        t0 = time.time()
        s.run(chunk=2)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        ttz = time.time() - t0
    finally:
        timer.cancel()
        timer.join()
    launches = nk.nqueens_neighborhood_scores.launches
    stats = s.stats()
    (hard, soft), best = s.get_best_solution()
    if hard != 0:
        raise AssertionError(f"not solved within {wall_cap} s: best ({hard}, {soft}) after {stats}")
    if attacking_pairs(best.rows) != 0 or sorted(best.rows.tolist()) != list(range(n)):
        raise AssertionError("the best board has attacking queens by an independent count")

    cur = s.state.current_state
    for name, want in zip(("rc", "dc", "ac", "cs"), numpy_counts(cur.rows.cpu().numpy())):
        if not np.array_equal(getattr(cur, name).cpu().numpy(), want):
            raise AssertionError(f"carried {name} differs from a rebuild from the boards")
    if not torch.equal(s.state.current_fp, fingerprint_i32(cur.rows)):
        raise AssertionError("carried fingerprints differ from a full recomputation")
    elite = s.state.elite
    if not torch.equal(elite.fps[elite.valid], fingerprint_i32(elite.states.rows)[elite.valid]):
        raise AssertionError("archived fingerprints differ from a full recomputation")
    if torch.device(device).type == "cuda" and launches == 0:
        raise AssertionError("the main path never launched the kernel")
    log(
        f"phase 4: nqueens-{n} P={population} solved: time to zero {ttz:.3f} s, "
        f"{stats['rounds']} rounds, {stats['ls_iterations']} descent iterations, "
        f"moves/s {stats.get('moves_per_sec')}, kernel launches {launches}"
    )
    return {"ttz_s": ttz, "launches": launches, **stats}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; the port's kernels run only on the card")
    from constraint_solver_tpu_torch.ops import nqueens_kernel as nk

    device = torch.device("cuda", 0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.time()
    report = nk.build_library(force=True)
    log(f"phase 1: built {nk._LIB_PATH.name} in {time.time() - t0:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"  nvcc: {line.strip()}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"phase 1: card {card}")

    kernel = phase_kernel(device)
    phase_cross_device(device)
    main_run = phase_main(device)
    kernel["launches"] = main_run["launches"]

    log(json.dumps({"main_path": main_run, "card": card}))
    log(card)
    log(json.dumps({"kernels": [kernel]}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
