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
   recomputation, and that the kernel was launched in the run;
5. parallel min-conflicts, the kernel's second caller: ``pmc_solve(1000,
   max_steps=5000)`` on the card over the full [n, n] block after one warm-up
   solve (zero conflicts by an independent count, the carried score equal to
   it, kernel launches > 0), then nqueens-64 with 4 lanes on the card and on
   the CPU from host-side draws: the states must be equal;
6. scheduling, the reference CLI instance (31 days x 7 employees from
   2022-05-09, 8 lanes, 4 rounds) with the random proposer, the dense proposer
   and the dense proposer with noisy selection, on the card and on the CPU from
   host-side draws: every state leaf must be equal;
7. scheduling at the JAX bench's size (365 days x 20 employees from
   2024-01-01, 10 holidays each): (a) the dense throughput arm, 64 lanes, 40
   rounds after a 4-round warm-up, which must reach hard 0; (b) the random
   window quality arm (``presets.scheduling_quality``, 128 lanes, culling a
   quarter) for ``QUALITY_WALL_S``.  For both, the recorded best must equal a
   rescore by the date-based scorer below (independent of the port), and every
   lane's carried score and fingerprint a full recomputation.

Each path's kernel launches are counted from 0 just before it runs.  The line
before the last is a JSON object with each kernel's measurements; the last line
is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import datetime
import json
import subprocess
import threading
import time
from collections import Counter

import numpy as np

MAIN_N, MAIN_P, MAIN_A = 1000, 256, 50
PMC_N = 1000
WALL_CAP_S = 300.0
QUALITY_WALL_S = 10.0
CHECK_SHAPES = (
    (MAIN_P, MAIN_A, MAIN_N), (1, PMC_N, PMC_N), (4, 64, 64), (4, 3, 8), (8, 5, 1003), (2, 3, 14000)
)
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

    def timed(shape):
        args = kernel_inputs(rng, *shape, device)
        for fn in (nk.nqueens_neighborhood_scores, nk.nqueens_neighborhood_scores_ref):
            time_ms(fn, args, 5)  # warm-up
        # In turns (plain, kernel, kernel, plain), so drift hits both alike.
        plain = [time_ms(nk.nqueens_neighborhood_scores_ref, args, TIMED_LAUNCHES)]
        kern = [time_ms(nk.nqueens_neighborhood_scores, args, TIMED_LAUNCHES) for _ in range(2)]
        plain.append(time_ms(nk.nqueens_neighborhood_scores_ref, args, TIMED_LAUNCHES))
        log(
            f"phase 2: at (P, A, n) = {shape}: kernel {kern} ms, plain {plain} ms "
            f"(mean of {TIMED_LAUNCHES} launches each, CUDA events)"
        )
        return sum(kern) / 2, sum(plain) / 2

    ms, plain_ms = timed((MAIN_P, MAIN_A, MAIN_N))
    pmc_ms, pmc_plain_ms = timed((1, PMC_N, PMC_N))
    return {
        "name": "nqueens_neighborhood_scores",
        "route": "cuda",
        "source": "constraint_solver_tpu_torch/csrc/nqueens_scores.cu",
        "replaces": "constraint_solver_tpu/ops/nqueens_pallas.py:121",
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "pmc_ms": pmc_ms,
        "pmc_plain_ms": pmc_plain_ms,
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
        sync(device)
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


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_pmc(device, n=PMC_N, max_steps=5000, check_n=64) -> dict:
    """PMC nqueens-n through the kernel, then a card == CPU check at ``check_n``."""
    import torch

    from constraint_solver_tpu_torch.models.nqueens_parallel import pmc_solve
    from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
    from constraint_solver_tpu_torch.utils.convert import to_reference
    from constraint_solver_tpu_torch.utils.draws import TorchDraws

    t0 = time.time()
    pmc_solve(n, TorchDraws("pmc-warm-up", 1, device), max_steps=max_steps)
    sync(device)
    log(f"phase 5: warm-up solve {time.time() - t0:.3f} s")

    nk.nqueens_neighborhood_scores.launches = 0
    t0 = time.time()
    out = pmc_solve(n, TorchDraws("pmc", 1, device), max_steps=max_steps)
    sync(device)
    ttz = time.time() - t0
    launches = nk.nqueens_neighborhood_scores.launches
    rows = out.state.rows[0].cpu().numpy()
    score, steps = float(out.score[0]), int(out.steps[0])
    recount = 2 * attacking_pairs(rows)  # the carried score counts each pair twice
    if score != 0 or recount != 0:
        raise AssertionError(f"PMC nqueens-{n} not solved in {steps} steps: carried {score}, recount {recount}")
    if torch.device(device).type == "cuda" and launches == 0:
        raise AssertionError("PMC never launched the kernel")
    moves = steps * n * n
    log(
        f"phase 5: PMC nqueens-{n} solved: time to zero {ttz:.3f} s, {steps} steps, "
        f"moves/s {moves / ttz:.4g}, kernel launches {launches}"
    )

    def lanes(dev):
        return to_reference(pmc_solve(check_n, TorchDraws("pmc-64", 4, dev, draw_device="cpu"), max_steps=2000))

    assert_tree_equal(lanes(device), lanes("cpu"))
    log(f"phase 5: PMC nqueens-{check_n} P=4: card == CPU")
    return {"ttz_s": ttz, "steps": steps, "moves_per_sec": moves / ttz, "launches": launches}


def oracle_schedule_score(start_date, assign, holidays_by_emp):
    """(hard, soft) of a schedule from its dates, written independently of the
    port: loops over days, windows and Counters."""
    days = [start_date + datetime.timedelta(days=i) for i in range(len(assign))]
    weekend = [d.weekday() >= 5 for d in days]
    hard = soft = 0
    for emp, hols in holidays_by_emp.items():
        for hol in hols:
            idx = (hol - start_date).days
            if 0 <= idx < len(assign) and assign[idx] == emp:
                hard += 1
    hard += sum(assign[i] == assign[i + 1] for i in range(len(assign) - 1))
    for i in range(len(assign) - 8):
        if weekend[i] and weekend[i + 1]:
            hard += sum(assign[a] == assign[b] for a in (i, i + 1) for b in (i + 7, i + 8))
    for i in range(len(assign) - 13):
        hard += sum(c > 3 for c in Counter(assign[i : i + 14]).values())
    for i in range(len(assign) - 6):
        soft += sum(c > 2 for c in Counter(assign[i : i + 7]).values())
    per_weekday = {}
    for d, emp in zip(days, assign):
        if d.weekday() < 5:
            per_weekday.setdefault(d.weekday(), Counter())[emp] += 1
    soft += sum(min(c.values()) for c in per_weekday.values() if len(c) > 1)
    emp_days = {}
    for d, emp in zip(days, assign):
        emp_days.setdefault(emp, []).append(d)
    if len(emp_days) >= 2:
        totals = [len(v) for v in emp_days.values()]
        wkends = [sum(d.weekday() >= 5 for d in v) for v in emp_days.values()]
        soft += (max(totals) - min(totals)) + (max(wkends) - min(wkends))
    return float(hard), float(soft)


SCHED_MODES = (("random", {}), ("dense", {}), ("dense", {"select_topk": 64, "select_temp": 0.5}))


def run_schedule(device, proposer, extra, rounds=4, population=8):
    """The reference CLI instance from host-side draws; the state in the
    reference layout, the per-round traces and the stats."""
    from constraint_solver_tpu_torch.core.ils import SolverConfig
    from constraint_solver_tpu_torch.models.scheduling import ScheduleSpec, make_scheduling_problem
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver
    from constraint_solver_tpu_torch.utils.convert import to_reference
    from constraint_solver_tpu_torch.utils.draws import TorchDraws

    d0 = datetime.date(2022, 5, 9)
    spec = ScheduleSpec.from_dates(d0, d0 + datetime.timedelta(days=30), 7)
    config = SolverConfig(
        seed="smoke-sched", local_search_max_iterations=60, best_solutions_capacity=8,
        all_solutions_capacity=128, all_solution_iteration_expiry=1000,
        max_allow_no_improvement_for=20, restart_every=3, **extra,
    )
    solver = PopulationSolver(
        make_scheduling_problem(spec, proposer=proposer), config, population=population,
        exchange_every=2, cull_frac=0.25, device=device,
        draws=TorchDraws(config.seed, population, device, draw_device="cpu"),
    )
    traces = [solver.execute_chunk_traced(2) for _ in range(rounds // 2)]
    return to_reference(solver.state), np.concatenate(traces), solver.stats()


def phase_schedule_cross_device(device) -> None:
    for proposer, extra in SCHED_MODES:
        on_card, trace_card, stats = run_schedule(device, proposer, extra)
        on_cpu, trace_cpu, _ = run_schedule("cpu", proposer, extra)
        assert_tree_equal(on_card, on_cpu)
        if not np.array_equal(trace_card, trace_cpu):
            raise AssertionError("card and CPU scheduling traces differ")
        log(
            f"phase 6: scheduling-31d-7e P=8 {proposer} {extra or ''}: card == CPU after "
            f"{stats['rounds']} rounds, {stats['ls_iterations']} descent iterations, "
            f"best {tuple(float(x) for x in trace_card[-1, 1:])}"
        )


def bench_schedule(days=365, emps=20):
    """The JAX bench's instance: employee e's 10 holidays on days (17e + 11k) mod D."""
    from constraint_solver_tpu_torch.models.scheduling import ScheduleSpec

    d0 = datetime.date(2024, 1, 1)
    hols = {e: [d0 + datetime.timedelta(days=(17 * e + 11 * k) % days) for k in range(10)] for e in range(emps)}
    return ScheduleSpec.from_dates(d0, d0 + datetime.timedelta(days=days - 1), emps, hols), d0, hols


def check_schedule(solver, problem, d0, hols, label) -> tuple:
    """The recorded best against the date-based scorer; every lane's carried
    score and fingerprint, and the archive's fingerprints, against a full
    recomputation.  Returns the best (hard, soft)."""
    import torch

    from constraint_solver_tpu_torch.ops.fingerprint import fingerprint_i32

    (hard, soft), best = solver.get_best_solution()
    want = oracle_schedule_score(d0, best.tolist(), hols)
    if (hard, soft) != want:
        raise AssertionError(f"{label}: recorded best {(hard, soft)} != independent rescore {want}")
    st = solver.state
    if not torch.equal(st.current_score, problem.score(st.current_state)):
        raise AssertionError(f"{label}: carried scores differ from a full rescore")
    if not torch.equal(st.current_fp, fingerprint_i32(st.current_state)):
        raise AssertionError(f"{label}: carried fingerprints differ from a full recomputation")
    elite = st.elite
    if not torch.equal(elite.fps[elite.valid], fingerprint_i32(elite.states)[elite.valid]):
        raise AssertionError(f"{label}: archived fingerprints differ from a full recomputation")
    return hard, soft


def phase_schedule_bench(device, population=64, q_population=128, rounds=40, quality_wall=QUALITY_WALL_S,
                         days=365, emps=20) -> dict:
    from constraint_solver_tpu_torch.core.ils import SolverConfig
    from constraint_solver_tpu_torch.models.scheduling import make_scheduling_problem
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver
    from constraint_solver_tpu_torch.utils import presets

    spec, d0, hols = bench_schedule(days, emps)
    out = {}

    # (a) Throughput arm: the dense block with 256 random swaps.
    dense = make_scheduling_problem(spec, proposer="dense", n_rand_swaps=256)
    config = SolverConfig(
        seed="bench", local_search_max_iterations=50, best_solutions_capacity=16,
        all_solutions_capacity=64, all_solution_iteration_expiry=1_000,
        iterated_local_search_max_iterations=10_000, max_allow_no_improvement_for=20,
    )

    def dense_solver():
        return PopulationSolver(dense, config, population=population, exchange_every=4, device=device)

    t0 = time.time()
    dense_solver().run(max_rounds=4, chunk=4)
    sync(device)
    log(f"phase 7a: warm-up (4 rounds) {time.time() - t0:.3f} s")
    s = dense_solver()
    t0 = time.time()
    s.run(max_rounds=rounds, chunk=4)
    sync(device)
    wall = time.time() - t0
    stats = s.stats()
    hard, soft = check_schedule(s, dense, d0, hols, "phase 7a")
    if hard != 0:
        raise AssertionError(f"phase 7a: dense arm ended at ({hard}, {soft}) after {stats['rounds']} rounds")
    log(
        f"phase 7a: scheduling-{days}d-{emps}e dense P={population}: best ({hard}, {soft}) in {wall:.3f} s, "
        f"{stats['rounds']} rounds, {stats['ls_iterations']} descent iterations, "
        f"moves/s {stats['moves_evaluated'] / wall:.4g}"
    )
    out["dense"] = {"best": [hard, soft], "wall_s": wall, **stats, "moves_per_sec": stats["moves_evaluated"] / wall}

    # (b) Quality arm: the random window with culling, for a fixed wall budget.
    window = make_scheduling_problem(spec, proposer="random", window_size=100)

    def quality_solver(seed):
        return PopulationSolver(
            window, presets.scheduling_quality(seed), population=q_population, exchange_every=2,
            cull_frac=0.25, device=device,
        )

    t0 = time.time()
    quality_solver("warm-up").execute_chunk_traced(2)
    sync(device)
    log(f"phase 7b: warm-up (2 rounds) {time.time() - t0:.3f} s")
    q = quality_solver("bench0")
    timer = threading.Timer(quality_wall, q.cancel)
    timer.start()
    try:
        t0 = time.time()
        q.run(chunk=2)
        sync(device)
        wall = time.time() - t0
    finally:
        timer.cancel()
        timer.join()
    stats = q.stats()
    hard, soft = check_schedule(q, window, d0, hols, "phase 7b")
    log(
        f"phase 7b: scheduling-{days}d-{emps}e random W=100 P={q_population}: best ({hard}, {soft}) "
        f"at {wall:.3f} s, {stats['rounds']} rounds, {stats['ls_iterations']} descent iterations, "
        f"moves/s {stats['moves_evaluated'] / wall:.4g}"
    )
    out["quality"] = {"best": [hard, soft], "wall_s": wall, **stats, "moves_per_sec": stats["moves_evaluated"] / wall}
    return out


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
    pmc_run = phase_pmc(device)
    phase_schedule_cross_device(device)
    sched = phase_schedule_bench(device)
    kernel["launches"] = main_run["launches"] + pmc_run["launches"]
    kernel["launches_by_path"] = {"nqueens_population": main_run["launches"], "pmc": pmc_run["launches"]}

    log(json.dumps({"main_path": main_run, "pmc": pmc_run, "scheduling": sched, "card": card}))
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
