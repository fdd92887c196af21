#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``constraint_solver_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py                # every phase
    python3 chip_smoke.py --kernel-only  # phases 1 and 2, no result line

Phases, each printing its own lines; any failure raises and exits nonzero:

1. builds the CUDA kernel from ``constraint_solver_tpu_torch/csrc`` and prints the
   card's name and power limit (``nvidia-smi``); without a CUDA device it stops
   before printing any result;
2. holds the kernel against its plain PyTorch version on the card, bit for bit,
   at the shapes the solvers give it (phase 13's sharded (128, 25, 1000) and
   (64, 50, 1000) included) and at n on both sides of the staging threshold;
   then, at the population shape (256, 50, 1000), PMC's (1, 1000, 1000) and
   the two sharded shapes, it measures the kernel's device-only ms per launch (its events in a
   ``torch.profiler`` trace), the wrapper's host us per call (``perf_counter``
   with no sync), both over 50 calls with CUDA events, the plain version
   likewise, and the DRAM bound (bytes over 3.35 TB/s) with the share reached;
   and the device-only time of variants of the kernel's launch plan, each held
   against the plain version;
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
   lane's carried score and fingerprint a full recomputation;
8. QAP (``bench/qap_scale.py``'s configuration): (a) qap-64 with 8 lanes in the
   dense, compact and incremental modes, card == CPU from host-side draws;
   (b) qap-256, 64 lanes, dense and compact, 2 warm-up and 6 timed rounds, and
   the compact winner equal to the dense one on every lane; (c) qap-1024
   compact, 16 lanes; (d) qap-4096 incremental, 4 lanes, with the perturbation
   (which rebuilds H) timed apart and the carried G and H exact.  For (b)-(d)
   the recorded best must be a permutation whose carried cost is within 1e-3
   of an int64 host cost; one more round of each runs under ``torch.profiler``;
9. Ackley d=10, 64 lanes, the JAX CLI's configuration, until |f| <= 1e-2 or
   ``ACKLEY_WALL_S``: the recorded best equal to the float64 function of its
   point within 2e-5;
10. diagram layout, 64 boxes, 96 connectors, a 32x32 grid, 64 lanes, 6 rounds:
    the recorded best equal to the host oracle; 8 boxes on 8x8 with 4 lanes
    card == CPU;
11. (a) the phased solver on phase 7's instance, dense until round 8, then the
    random window until round 16: each program runs exactly in its rounds and
    the best equals the date-based rescore; (b) checkpoints on the card:
    2 rounds, save, load into a fresh solver, 2 rounds == 4 rounds straight,
    for qap-1024 compact and for the nqueens main path;
12. the user surface on the card: the five CLIs run in this process with
    ``--device cuda``, each printed result checked apart (the nqueens board at
    n = 1000, P = 256 and PMC's board by the numpy attacking-pair count, the
    31 d x 7 e schedule at P = 64 by the date-based scorer, qap-4096's
    permutation by an int64 cost, the 64-box diagram's SVG with every
    connector routed, Ackley d = 10's value finite); the HTTP service on a
    thread, where an nqueens-1000 client and the web page's scheduling
    request step their solvers at the same time (checked likewise), then a
    64-box diagram and its SVG; one main-path round under
    ``utils/profiling.trace``, whose Chrome trace must hold the kernel's
    events; and ``roofline()`` of the main path's solver, of a main-path
    solver after one round and of qap-4096 incremental with 4 lanes: every
    share at most 1.05, the state unchanged, the kernel's counted bytes
    ``kernel_bytes`` times its launches;
13. multi-device solving (``parallel/``): four ranks, spawned processes on the
    one card with the gloo backend, every mesh over all four, each sub-phase
    timed on every rank with its kernel launches (per shape), collectives and
    descent iterations: (a) ``ShardedPopulationSolver`` over 2 x 2 (pop, nbr),
    nqueens-1000 at P = 256 with ``nbr_keep=64`` (the kernel at (128, 25,
    1000) on every rank), until zero conflicts (cancelled at ``WALL_CAP_S``):
    the board by the numpy count, every lane's counters and fingerprints
    rebuilt, and for a few descent iterations every gathered candidate against
    a full rescore of its move; (b) ``PopulationSolver(mesh=)`` over pop 4, 4
    rounds from host-side draws: every lane equal to the one-device run (the
    kernel at (64, 50, 1000)); (c) ``SeqShardedSolver`` over 2 x 2 (pop, seq)
    on phase 7's instance, P = 64, the window of 100, 8 rounds: the state equal
    to the one-device random proposer's, the best equal to the date-based
    rescore; then the sharded scorer over 4 ranks on 730 days x 40 employees
    equal to the one-device scorer; (d) qap-1024 with ``nbr_axis``, P = 16, 4
    rounds: the best a permutation whose carried cost is the int64 cost within
    1e-3; (e) (a)'s configuration: 2 rounds, save (rank 0 writes), load into
    fresh solvers, 2 more == 4 straight, and the file loaded by the one-device
    solver gives the same best; (f) ``roofline()`` of (a)'s solved solver:
    counted on every rank, the kernel's bytes ``kernel_bytes`` times the
    launches summed over ranks, every share at most 1.05.  It prints the
    backend, each rank's device and which collectives gloo takes on CUDA
    tensors.

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
ACKLEY_WALL_S = 60.0
# The main and PMC shapes, small and odd ones, and n at the staging threshold
# (11,617: the tables fill 227 KB of shared memory) and above it.
# The shapes of phase 13's sharded paths: a rank of the 2 x 2 (pop, nbr) mesh
# scores (P/2, A/2, n), a rank of the pop-4 mesh (P/4, A, n).
SHARD_SHAPES = ((MAIN_P // 2, MAIN_A // 2, MAIN_N), (MAIN_P // 4, MAIN_A, MAIN_N))
CHECK_SHAPES = (
    (MAIN_P, MAIN_A, MAIN_N), (1, PMC_N, PMC_N), *SHARD_SHAPES, (4, 64, 64), (4, 3, 8), (8, 5, 1003),
    (16, 50, 1001), (2, 3, 11617), (2, 3, 11620), (2, 3, 14000),
)
TIMED_LAUNCHES = 50
KERNEL_EVENT = "nqueens_scores"  # in the CUDA kernel's name in a profiler trace
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet


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


def device_ms(fn, args, launches: int) -> tuple[float, str]:
    """The kernel's device-only ms per launch: its own events in a
    ``torch.profiler`` trace of ``launches`` calls or, where the trace holds
    none, the replay of a CUDA graph of the calls timed with CUDA events.
    Returns (ms, the source of the number)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn(*args)
        torch.cuda.synchronize()
    us = [
        e.time_range.elapsed_us() for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and KERNEL_EVENT in e.name
    ]
    if len(us) == launches:
        return sum(us) / 1e3 / launches, "profiler"
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn(*args)
    graph.replay()  # warm-up
    return time_ms(graph.replay, (), 1) / launches, "CUDA graph replay"


def host_us(fn, args, launches: int) -> float:
    """The wrapper's host µs per call: ``perf_counter`` over ``launches``
    calls with no synchronise in between, so it measures the enqueue."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(launches):
        fn(*args)
    us = (time.perf_counter() - t0) / launches * 1e6
    torch.cuda.synchronize()
    return us


def kernel_bytes(p: int, a: int, n: int) -> int:
    """Bytes the function must move: rc, dc, ac, c, r, removed and cur read
    once, scores, row_min and row_arg written once, 4 bytes each."""
    return 4 * (p * n + 2 * p * (2 * n - 1) + 3 * p * a + p + p * a * n + 2 * p * a)


def kernel_bound_ms(p: int, a: int, n: int) -> float:
    """The least time on the card: the bytes over the HBM rate.  The ~10
    float32 operations per score (P·A·n·10 over 67 TFLOP/s) take a tenth of
    that, so bytes bound it."""
    return kernel_bytes(p, a, n) / HBM_BYTES_PER_S * 1e3


def probe_kernel_bytes(p=MAIN_P, a=MAIN_A, n=MAIN_N) -> dict:
    """Bytes each TPU probe kernel of ``bench/kernel_iso.py`` must move at its
    default shape (P lanes, A columns, n rows padded to a multiple of 128),
    each input read once and each output written once: the scores [A, n_pad]
    in float32, the rc, dc and ac tables (float32 or int16; the packed probe
    holds dc and ac in one int32 table), c, r and removed, cur, and the row
    min and argmin where the probe writes them.  Those probes stay with the
    benchmark folder; this gives their bounds."""
    n_pad = -(-n // 128) * 128
    scores, scalars, row_min = 4 * a * n_pad, 4 * (3 * a + 1), 8 * a
    f32_tables, i16_tables = 4 * (n_pad + 4 * n_pad), 2 * (n_pad + 4 * n_pad)
    per_lane = {
        "_kern_packed": scores + 4 * n_pad + 4 * 2 * n_pad + scalars + row_min,
        "_kern_base": scores + f32_tables + scalars,
        "_kern_noroll": scores + f32_tables + scalars,
        "_kern_i16": scores + i16_tables + scalars,
        "_kern_i16min": scores + i16_tables + scalars + row_min,
    }
    return {name: p * b for name, b in per_lane.items()}


def probe_plans(rng, device, shape) -> dict:
    """Device-only ms per launch of the kernel under its launch plan and under
    variants of it at one shape, each held against the plain version bit for
    bit: the measurements behind the plan's choices."""
    import torch

    from constraint_solver_tpu_torch.ops import nqueens_kernel as nk

    p, a, n = shape
    args = kernel_inputs(rng, p, a, n, device)
    want = nk.nqueens_neighborhood_scores_ref(*args)
    plan = nk._launch_plan(p, a, n)
    variants = {"plan": plan, "4-byte stores": plan._replace(vector=False),
                "tables from global memory": plan._replace(staged=False, smem_bytes=0)}
    for g in (8, 4, 2):
        if g != plan.cols_per_block:
            variants[f"{g} columns per block"] = plan._replace(cols_per_block=g, grid=(-(-a // g), p))
    out = {}
    for name, variant in variants.items():
        got = tuple(torch.empty_like(w) for w in want)

        def call(variant=variant, got=got):
            nk._launch((*args, *got), p, a, n, variant)

        call()
        torch.cuda.synchronize()
        if not all(torch.equal(w, g) for w, g in zip(want, got)):
            raise AssertionError(f"kernel != plain version under {variant} at (P, A, n) = {shape}")
        out[name], _ = device_ms(call, (), TIMED_LAUNCHES)
        log(f"phase 2 probe: at (P, A, n) = {shape}, {name} {tuple(variant)}: device-only {out[name]:.6f} ms")
    return out


def phase_kernel(device) -> dict:
    """Kernel vs plain version at every shape; times, bound and share, and
    the launch-plan variants, at the population and PMC shapes."""
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
        kern_fn, plain_fn = nk.nqueens_neighborhood_scores, nk.nqueens_neighborhood_scores_ref
        for fn in (kern_fn, plain_fn):
            time_ms(fn, args, 5)  # warm-up
        # In turns (plain, kernel, kernel, plain), so drift hits both alike.
        plain = [time_ms(plain_fn, args, TIMED_LAUNCHES)]
        kern = [time_ms(kern_fn, args, TIMED_LAUNCHES) for _ in range(2)]
        plain.append(time_ms(plain_fn, args, TIMED_LAUNCHES))
        dev, how = device_ms(kern_fn, args, TIMED_LAUNCHES)
        host = [host_us(kern_fn, args, TIMED_LAUNCHES) for _ in range(2)]
        bound = kernel_bound_ms(*shape)
        out = {
            "ms": sum(kern) / 2, "plain_ms": sum(plain) / 2, "device_ms": dev, "host_us": min(host),
            "bound_ms": bound, "bound_share": bound / dev,
        }
        log(
            f"phase 2: at (P, A, n) = {shape}: kernel {kern} ms, plain {plain} ms (mean of {TIMED_LAUNCHES} "
            f"calls each, CUDA events); device-only {dev:.6f} ms per launch ({how}); wrapper host {host} us "
            f"per call (perf_counter, no sync); bound {bound:.6f} ms ({kernel_bytes(*shape)} bytes at "
            f"{HBM_BYTES_PER_S / 1e12} TB/s), share {out['bound_share']:.3f}"
        )
        return out

    main = timed((MAIN_P, MAIN_A, MAIN_N))
    pmc = timed((1, PMC_N, PMC_N))
    sharded = {}
    for shape in SHARD_SHAPES:
        sharded["x".join(map(str, shape))] = {**timed(shape), "launch_plan": list(nk._launch_plan(*shape))}
        log(f"phase 2: launch plan at (P, A, n) = {shape}: {nk._launch_plan(*shape)}")
    main["plan_probe_ms"] = probe_plans(rng, device, (MAIN_P, MAIN_A, MAIN_N))
    pmc["plan_probe_ms"] = probe_plans(rng, device, (1, PMC_N, PMC_N))
    return {
        "name": "nqueens_neighborhood_scores",
        "route": "cuda",
        "source": "constraint_solver_tpu_torch/csrc/nqueens_scores.cu",
        "replaces": "constraint_solver_tpu/ops/nqueens_pallas.py:122",
        "max_abs_err": max_err,
        **main,
        "bound_by": "bytes",
        "library_ms": None,
        **{f"pmc_{k}": v for k, v in pmc.items()},
        "sharded_shapes": sharded,
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


def phase_main(device, n=MAIN_N, population=MAIN_P, wall_cap=WALL_CAP_S):
    """Returns the measurements and the solved solver."""
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
    return {"ttz_s": ttz, "launches": launches, **stats}, s


def sync(device) -> None:
    import torch

    if is_cuda(device):
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


class Counters:
    """Lockstep descent iterations (calls of a problem's ``neighborhood``) and
    the time spent in its ``perturb``, counted by ``instrument``."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = 0
        self.perturb_spans = []  # (start, end) CUDA events on the card
        self.perturb_host_s = 0.0  # on the CPU, where every op is synchronous

    def perturb_s(self) -> float:
        """The summed perturbation time; read it after a sync."""
        return self.perturb_host_s + sum(a.elapsed_time(b) for a, b in self.perturb_spans) / 1e3


def instrument(problem, device, time_perturb=False):
    """The same problem with its neighborhood calls counted and, optionally,
    its perturbation timed: on the card between two CUDA events on the stream,
    so the host never waits and the timed run has no extra sync."""
    counters = Counters()
    neighborhood, perturb = problem.neighborhood, problem.perturb

    def counted(*args):
        counters.calls += 1
        return neighborhood(*args)

    def timed(*args):
        if not is_cuda(device):
            t0 = time.perf_counter()
            out = perturb(*args)
            counters.perturb_host_s += time.perf_counter() - t0
            return out
        import torch

        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = perturb(*args)
        end.record()
        counters.perturb_spans.append((start, end))
        return out

    return problem._replace(neighborhood=counted, perturb=timed if time_perturb else perturb), counters


def profile_round(solver, counters) -> dict:
    """One round under ``torch.profiler``: device kernels, their summed busy
    time, memory copies and host reads (``aten::_local_scalar_dense``), per
    lockstep descent iteration, and the profiled idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    counters.calls = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.execute_round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = copies = reads = 0
    busy_us = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name.startswith(("Memcpy", "Memset")):
                copies += 1
            else:
                kernels += 1
            busy_us += e.time_range.elapsed_us()
        elif e.name == "aten::_local_scalar_dense":
            reads += 1
    it = max(counters.calls, 1)
    out = {
        "iterations": counters.calls,
        "wall_s": wall,
        "kernels": kernels,
        "copies": copies,
        "host_reads": reads,
        "kernels_per_iteration": kernels / it,
        "host_reads_per_iteration": reads / it,
        "busy_ms_per_iteration": busy_us / 1e3 / it if kernels else None,
        "idle_share": 1.0 - busy_us / 1e6 / wall if kernels else None,
    }
    if not kernels:
        log("  profile: the trace holds no device events; device busy and idle not measured")
    return out


QAP_MODES = {"dense": {}, "compact": {"compact": True}, "incremental": {"incremental": True}}


def qap_config(seed="bench", capacity=8):
    """The JAX package's ``bench/qap_scale.py`` configuration."""
    from constraint_solver_tpu_torch.core.ils import SolverConfig

    return SolverConfig(
        seed=seed, local_search_max_iterations=50, best_solutions_capacity=capacity, all_solutions_capacity=128,
        all_solution_iteration_expiry=1_000, iterated_local_search_max_iterations=100_000,
        max_allow_no_improvement_for=5,
    )


def qap_host_cost(flow, dist, p) -> int:
    """sum_ij F[i, j] D[p[i], p[j]] in int64 on the host."""
    return int((flow.astype(np.int64) * dist.astype(np.int64)[np.ix_(p, p)]).sum())


def run_qap(device, mode, n=64, population=8, rounds=4):
    """qap-n from host-side draws; the state in the reference layout, the
    per-round traces and the stats."""
    from constraint_solver_tpu_torch.models.qap import QAPSpec, make_qap_problem
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver
    from constraint_solver_tpu_torch.utils.convert import to_reference
    from constraint_solver_tpu_torch.utils.draws import TorchDraws

    config = qap_config("smoke-qap")
    solver = PopulationSolver(
        make_qap_problem(QAPSpec.random(n, seed=0), **QAP_MODES[mode]), config, population=population,
        device=device, draws=TorchDraws(config.seed, population, device, draw_device="cpu"),
    )
    traces = [solver.execute_chunk_traced(2) for _ in range(rounds // 2)]
    return to_reference(solver.state), np.concatenate(traces), solver.stats()


def qap_arm(device, n, population, mode, warm, rounds, label, capacity=8):
    """``warm`` warm-up rounds on one solver, then ``rounds`` timed rounds
    (chunk 2) on a fresh one, the int64 cost check and one profiled round.
    Returns the measurements and the timed solver."""
    from constraint_solver_tpu_torch.models.qap import QAPSpec, make_qap_problem
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver

    spec = QAPSpec.random(n, seed=0)
    problem, counters = instrument(
        make_qap_problem(spec, **QAP_MODES[mode]), device, time_perturb=mode == "incremental"
    )
    config = qap_config(capacity=capacity)
    t0 = time.time()
    PopulationSolver(problem, config, population=population, device=device).run(max_rounds=warm, chunk=2)
    sync(device)
    log(f"phase 8{label}: qap-{n} {mode} P={population} warm-up ({warm} rounds) {time.time() - t0:.3f} s")
    s = PopulationSolver(problem, config, population=population, device=device)
    counters.reset()
    t0 = time.time()
    s.run(max_rounds=rounds, chunk=2)
    sync(device)
    wall = time.time() - t0
    stats = s.stats()
    calls, perturb_s = counters.calls, counters.perturb_s()
    (cost, _), best = s.get_best_solution()
    perm = best.p if mode == "incremental" else best
    if sorted(perm.tolist()) != list(range(n)):
        raise AssertionError(f"phase 8{label}: the recorded best is not a permutation")
    flow, dist = spec.arrays()
    exact = qap_host_cost(flow, dist, perm)
    if abs(exact - cost) > 1e-3 * max(1.0, abs(exact)):
        raise AssertionError(f"phase 8{label}: carried cost {cost} != int64 host cost {exact}")
    out = {
        "n": n, "population": population, "mode": mode, "rounds": stats["rounds"], "wall_s": wall,
        "wall_per_round_s": wall / rounds, "best_carried": cost, "best_int64": exact,
        "lockstep_iterations": calls, "ms_per_iteration": 1e3 * wall / max(calls, 1),
        "ls_iterations": stats["ls_iterations"], "moves_per_sec": stats["moves_evaluated"] / wall,
    }
    if mode == "incremental":
        out["perturb_s"] = perturb_s
        out["rebuild_share"] = perturb_s / wall
    if is_cuda(device):
        out["profile"] = profile_round(s, counters)
    log(
        f"phase 8{label}: qap-{n} {mode} P={population}: {rounds} rounds in {wall:.3f} s, "
        f"{calls} lockstep iterations ({out['ms_per_iteration']:.3f} ms each), best {cost:.0f} "
        f"(int64 host cost {exact}), moves/s {out['moves_per_sec']:.4g}"
        + (f", perturbation with H rebuild {perturb_s:.3f} s ({out['rebuild_share']:.3f} of the wall)"
           if mode == "incremental" else "")
        + (f", profiled round: {out['profile']}" if "profile" in out else "")
    )
    return out, s


def is_cuda(device) -> bool:
    import torch

    return torch.device(device).type == "cuda"


def qap_winners(dense, compact, state, draws):
    """Each lane's lexicographic winner (a, b, score) under both proposers."""
    import torch

    from constraint_solver_tpu_torch.ops.lex import lex_argmin

    p, score = state.current_state, state.current_score
    on = torch.ones(p.shape[0], dtype=torch.bool, device=p.device)
    nb_d, nb_c = dense.neighborhood(p, score, draws, on), compact.neighborhood(p, score, draws, on)
    wd, wc = lex_argmin(nb_d.scores, nb_d.valid), lex_argmin(nb_c.scores, nb_c.valid)
    lane = torch.arange(p.shape[0], device=p.device)
    n = p.shape[1]
    return (
        (wd // n, wd % n, nb_d.scores[lane, wd]),
        (wc, nb_c.moves.partner[lane, wc], nb_c.scores[lane, wc]),
    )


def phase_qap(device, check_n=64, sizes=((256, 64, 2, 6), (1024, 16, 2, 6), (4096, 4, 1, 2))) -> dict:
    """(a) card == CPU at check_n in three modes; (b) qap-256 dense and compact;
    (c) qap-1024 compact; (d) qap-4096 incremental with exact G and H."""
    import torch

    from constraint_solver_tpu_torch.models.qap import QAPSpec, make_qap_problem
    from constraint_solver_tpu_torch.utils.draws import TorchDraws

    for mode in QAP_MODES:
        on_card, trace_card, stats = run_qap(device, mode, n=check_n)
        on_cpu, trace_cpu, _ = run_qap("cpu", mode, n=check_n)
        assert_tree_equal(on_card, on_cpu)
        if not np.array_equal(trace_card, trace_cpu):
            raise AssertionError(f"card and CPU QAP traces differ ({mode})")
        log(
            f"phase 8a: qap-{check_n} P=8 {mode}: card == CPU after {stats['rounds']} rounds, "
            f"{stats['ls_iterations']} descent iterations, best {trace_card[-1, 1]}"
        )

    out = {}
    (n_b, p_b, w_b, r_b), (n_c, p_c, w_c, r_c), (n_d, p_d, w_d, r_d) = sizes
    out["dense"], s_dense = qap_arm(device, n_b, p_b, "dense", w_b, r_b, "b")
    out["compact"], s_comp = qap_arm(device, n_b, p_b, "compact", w_b, r_b, "b")
    spec = QAPSpec.random(n_b, seed=0)
    dense, compact = make_qap_problem(spec), make_qap_problem(spec, compact=True)
    draws = TorchDraws("winners", p_b, device)
    for s in (s_dense, s_comp):
        (ad, bd, sd), (ac, bc, sc) = qap_winners(dense, compact, s.state, draws)
        if not (torch.equal(ad, ac) and torch.equal(bd, bc) and torch.equal(sd, sc)):
            raise AssertionError("phase 8b: the compact winner differs from the dense winner")
    same = out["dense"]["best_carried"] == out["compact"]["best_carried"]
    out["dense_best_equals_compact_best"] = same
    log(f"phase 8b: compact winner == dense winner on every lane; 6-round bests equal: {same}")
    out["compact_1024"], _ = qap_arm(device, n_c, p_c, "compact", w_c, r_c, "c")
    out["incremental_4096"], s_inc = qap_arm(device, n_d, p_d, "incremental", w_d, r_d, "d")

    # (d) G == D[p][:, p] (a numpy gather on the host) and H == F G (a float64
    # product on the card, exact: every partial sum is an integer far below
    # 2^53) on every lane.
    flow_np, dist_np = QAPSpec.random(n_d, seed=0).arrays()
    st = s_inc.state.current_state
    for k, pk in enumerate(st.p.cpu().numpy()):
        if not np.array_equal(st.g[k].cpu().numpy(), dist_np[np.ix_(pk, pk)]):
            raise AssertionError(f"phase 8d: carried G of lane {k} differs from D[p][:, p]")
    flow = torch.from_numpy(flow_np).to(device)
    if not torch.equal(st.h.double(), torch.matmul(flow.double(), st.g.double())):
        raise AssertionError("phase 8d: carried H differs from the exact F G")
    log(f"phase 8d: carried G and H exact on all {p_d} lanes")
    if is_cuda(device):
        ms = time_ms(torch.matmul, (flow, st.g), 5)
        tflops = 2 * p_d * n_d**3 / ms / 1e9
        out["incremental_4096"].update(rebuild_matmul_ms=ms, rebuild_matmul_tflops=tflops)
        log(f"phase 8d: F @ G for {p_d} lanes at n={n_d}: {ms:.3f} ms ({tflops:.1f} TFLOP/s FP32, CUDA events)")
    return out


def phase_ackley(device, d=10, population=64, wall_cap=ACKLEY_WALL_S) -> dict:
    """Ackley d=10 with the JAX CLI's configuration until |f| <= 1e-2 or the
    wall cap; the recorded best against the float64 host function.  The cap is
    read between rounds, and one round (a 10,000-iteration descent) takes tens
    of seconds on the card, so the phase may run up to a round past it."""
    from constraint_solver_tpu_torch.core.ils import SolverConfig
    from constraint_solver_tpu_torch.models.ackley import ackley_np, make_ackley_problem
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver

    problem, counters = instrument(make_ackley_problem(d), device)
    kw = dict(
        seed="42", local_search_max_iterations=10_000, best_solutions_capacity=32, all_solutions_capacity=512,
        all_solution_iteration_expiry=10_000, iterated_local_search_max_iterations=1000,
        max_allow_no_improvement_for=10,
    )
    s = PopulationSolver(problem, SolverConfig(**kw), population=population, device=device)
    timer = threading.Timer(wall_cap, s.cancel)
    timer.start()
    try:
        t0 = time.time()
        s.run(chunk=1)
        sync(device)
        wall = time.time() - t0
    finally:
        timer.cancel()
        timer.join()
    stats = s.stats()
    (value, _), x = s.get_best_solution()
    host = float(ackley_np(x))
    if not np.isclose(value, host, rtol=2e-5, atol=2e-5):
        raise AssertionError(f"phase 9: recorded best {value} != float64 Ackley {host} of its point")
    out = {
        "d": d, "population": population, "best": value, "best_float64": host, "reached": abs(value) <= 1e-2,
        "wall_s": wall, "rounds": stats["rounds"], "lockstep_iterations": counters.calls,
        "ms_per_iteration": 1e3 * wall / max(counters.calls, 1), "wall_per_round_s": wall / max(stats["rounds"], 1),
        "ls_iterations": stats["ls_iterations"], "moves_per_sec": stats["moves_evaluated"] / wall,
    }
    if is_cuda(device):
        # A short-descent solver for the profile: a 10,000-iteration round is
        # too long a trace.
        short, c_short = instrument(make_ackley_problem(d), device)
        ps = PopulationSolver(
            short, SolverConfig(**{**kw, "local_search_max_iterations": 40}), population=population, device=device
        )
        ps.execute_round()
        out["profile_ls40"] = profile_round(ps, c_short)
    log(
        f"phase 9: ackley-{d}d P={population}: best {value:.6g} (float64 {host:.6g}), reached 1e-2: "
        f"{out['reached']}, {stats['rounds']} rounds in {wall:.3f} s, {counters.calls} lockstep iterations "
        f"({out['ms_per_iteration']:.3f} ms each), moves/s {out['moves_per_sec']:.4g}"
        + (f", profiled round (LS max 40): {out['profile_ls40']}" if "profile_ls40" in out else "")
    )
    return out


def diagram_config(seed="bench"):
    """The JAX package's ``bench/domains_tpu.py`` diagram configuration."""
    from constraint_solver_tpu_torch.core.ils import SolverConfig

    return SolverConfig(
        seed=seed, local_search_max_iterations=50, best_solutions_capacity=8, all_solutions_capacity=128,
        all_solution_iteration_expiry=1_000, iterated_local_search_max_iterations=100_000,
        max_allow_no_improvement_for=5,
    )


def run_diagram(device, boxes=8, edges=10, grid=8, population=4, rounds=4):
    from constraint_solver_tpu_torch.models.diagram_layout import DiagramLayoutSpec, make_diagram_layout_problem
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver
    from constraint_solver_tpu_torch.utils.convert import to_reference
    from constraint_solver_tpu_torch.utils.draws import TorchDraws

    config = diagram_config("smoke-diagram")
    solver = PopulationSolver(
        make_diagram_layout_problem(DiagramLayoutSpec.random(boxes, edges, grid, seed=3)), config,
        population=population, exchange_every=2, device=device,
        draws=TorchDraws(config.seed, population, device, draw_device="cpu"),
    )
    traces = [solver.execute_chunk_traced(2) for _ in range(rounds // 2)]
    return to_reference(solver.state), np.concatenate(traces), solver.stats()


def phase_diagram(device, boxes=64, edges=96, grid=32, max_size=4, population=64, rounds=6) -> dict:
    from constraint_solver_tpu_torch.models.diagram_layout import (
        DiagramLayoutSpec,
        layout_score_naive,
        make_diagram_layout_problem,
    )
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver

    on_card, trace_card, stats = run_diagram(device)
    on_cpu, trace_cpu, _ = run_diagram("cpu")
    assert_tree_equal(on_card, on_cpu)
    if not np.array_equal(trace_card, trace_cpu):
        raise AssertionError("card and CPU diagram traces differ")
    log(f"phase 10: diagram-8b-8g P=4: card == CPU after {stats['rounds']} rounds, best {tuple(trace_card[-1, 1:])}")

    spec = DiagramLayoutSpec.random(boxes, edges, grid, seed=0, max_size=max_size)
    problem, counters = instrument(make_diagram_layout_problem(spec), device)
    t0 = time.time()
    PopulationSolver(problem, diagram_config(), population=population, device=device).run(max_rounds=2, chunk=2)
    sync(device)
    log(f"phase 10: warm-up (2 rounds) {time.time() - t0:.3f} s")
    s = PopulationSolver(problem, diagram_config(), population=population, device=device)
    counters.calls = 0
    t0 = time.time()
    s.run(max_rounds=rounds, chunk=2)
    sync(device)
    wall = time.time() - t0
    stats = s.stats()
    (hard, soft), pos = s.get_best_solution()
    want = layout_score_naive(spec, pos)
    if (hard, soft) != want:
        raise AssertionError(f"phase 10: recorded best {(hard, soft)} != host oracle {want}")
    out = {
        "boxes": boxes, "edges": edges, "grid": grid, "population": population, "best": [hard, soft],
        "rounds": stats["rounds"], "wall_s": wall, "wall_per_round_s": wall / rounds,
        "lockstep_iterations": counters.calls, "ms_per_iteration": 1e3 * wall / max(counters.calls, 1),
        "ls_iterations": stats["ls_iterations"], "moves_per_sec": stats["moves_evaluated"] / wall,
    }
    if is_cuda(device):
        out["profile"] = profile_round(s, counters)
    log(
        f"phase 10: diagram-{boxes}b-{grid}g P={population}: best ({hard}, {soft}) == host oracle, "
        f"{rounds} rounds in {wall:.3f} s, {out['lockstep_iterations']} lockstep iterations ({out['ms_per_iteration']:.3f} ms "
        f"each), moves/s {out['moves_per_sec']:.4g}" + (f", profiled round: {out['profile']}" if "profile" in out else "")
    )
    return out


def phase_phased(device, population=64, switch=8, total=16, chunk=3, days=365, emps=20) -> dict:
    """(a) the 365d x 20e instance, dense until round ``switch`` then the random
    window until ``total``, in chunks of ``chunk`` rounds: each program must run
    in exactly the chunks of its phase, the chunk before the switch clipped to
    end at it."""
    from constraint_solver_tpu_torch.core.ils import SolverConfig
    from constraint_solver_tpu_torch.models.scheduling import make_scheduling_problem
    from constraint_solver_tpu_torch.parallel.phased import Phase, PhasedPopulationSolver

    spec, d0, hols = bench_schedule(days, emps)
    solver = {}

    def tracked(problem, starts):
        """The problem, recording the round each of its chunks starts from."""
        inner = problem.neighborhood

        def neighborhood(*args):
            starts.add(solver["s"].get_iteration_info()["current"])
            return inner(*args)

        return problem._replace(neighborhood=neighborhood)

    dense_starts, window_starts = set(), set()
    dense = tracked(make_scheduling_problem(spec, proposer="dense", n_rand_swaps=256), dense_starts)
    window = tracked(make_scheduling_problem(spec, proposer="random", window_size=100), window_starts)
    kw = dict(
        seed="phased", local_search_max_iterations=50, best_solutions_capacity=16, all_solutions_capacity=64,
        all_solution_iteration_expiry=1_000, max_allow_no_improvement_for=20,
    )
    s = solver["s"] = PhasedPopulationSolver(
        [Phase(dense, SolverConfig(**kw), until_round=switch),
         Phase(window, SolverConfig(**kw, iterated_local_search_max_iterations=total))],
        population=population, exchange_every=4, device=device,
    )
    t0 = time.time()
    s.run(chunk=chunk)
    sync(device)
    wall = time.time() - t0
    starts, r = [], 0
    while r < total:
        starts.append(r)
        r = min(r + chunk, switch if r < switch else total)
    want = ({x for x in starts if x < switch}, {x for x in starts if x >= switch})
    if (dense_starts, window_starts) != want or s.stats()["phase"] != 1:
        raise AssertionError(f"phase 11a: chunks from rounds {sorted(dense_starts)} (dense), "
                             f"{sorted(window_starts)} (window); expected {[sorted(w) for w in want]}")
    hard, soft = check_schedule(s, window, d0, hols, "phase 11a")
    stats = s.stats()
    log(
        f"phase 11a: phased scheduling-{days}d-{emps}e P={population}: chunks of {chunk} from rounds "
        f"{sorted(dense_starts)} ran the dense program, from {sorted(window_starts)} the window; switch at round "
        f"{switch} exactly; best ({hard}, {soft}) == date-based rescore, {stats['rounds']} rounds in {wall:.3f} s, "
        f"{stats['ls_iterations']} descent iterations, moves {stats['moves_evaluated']}"
    )
    return {"best": [hard, soft], "wall_s": wall, "dense_chunk_starts": sorted(dense_starts),
            "window_chunk_starts": sorted(window_starts), **stats}


def phase_checkpoint(device, qap_n=1024, qap_p=16, nq_n=MAIN_N, nq_p=MAIN_P) -> dict:
    """(b) save after 2 rounds, load into a fresh solver, 2 more rounds: equal
    to 4 rounds run straight, leaf for leaf, for qap-1024 compact and for the
    nqueens main path (which launches the kernel)."""
    import os

    from constraint_solver_tpu_torch.models.nqueens import make_nqueens_problem
    from constraint_solver_tpu_torch.models.qap import QAPSpec, make_qap_problem
    from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver
    from constraint_solver_tpu_torch.utils.convert import to_reference

    os.makedirs("build/checkpoints", exist_ok=True)
    out = {}
    cases = (
        ("qap", make_qap_problem(QAPSpec.random(qap_n, seed=0), compact=True), qap_config(), qap_p, {}),
        ("nqueens", make_nqueens_problem(nq_n), main_config(), nq_p, {"exchange_every": 2}),
    )
    for name, problem, config, population, kw in cases:
        def solver():
            return PopulationSolver(problem, config, population=population, device=device, **kw)

        nk.nqueens_neighborhood_scores.launches = 0
        t0 = time.time()
        straight = solver()
        for _ in range(4):
            straight.execute_round()
        part = solver()
        for _ in range(2):
            part.execute_round()
        path = f"build/checkpoints/{name}.npz"
        part.save(path)
        resumed = solver()
        resumed.load(path)
        for _ in range(2):
            resumed.execute_round()
        sync(device)
        launches = nk.nqueens_neighborhood_scores.launches
        assert_tree_equal(to_reference(straight.state), to_reference(resumed.state))
        size = os.path.getsize(path)
        os.remove(path)
        out[name] = {"launches": launches, "file_bytes": size, "wall_s": time.time() - t0}
        log(
            f"phase 11b: {problem.name} P={population}: 2 rounds, save ({size} bytes), load, 2 rounds == 4 rounds "
            f"straight, leaf for leaf; kernel launches {launches}"
        )
    if is_cuda(device) and out["nqueens"]["launches"] == 0:
        raise AssertionError("phase 11b: the nqueens checkpoint run never launched the kernel")
    return out


SURFACE_DIR = "build/surface"  # the diagram CLI's SVG and the profiler's trace
WEB_PAGE_PAYLOAD = {  # the index page's default request: 7 employees over 31 days
    "startDate": "2022-05-09", "endDate": "2022-06-08",
    "employees": [{"id": i} for i in range(7)], "employeeHolidays": [[] for _ in range(7)],
}


def run_cli(module, argv, device) -> tuple:
    """``module.main(argv + ["--device", device])`` in this process with its
    standard output captured; returns (return value, output, wall s, kernel
    launches)."""
    import contextlib
    import io

    import torch

    from constraint_solver_tpu_torch.ops import nqueens_kernel as nk

    buf = io.StringIO()
    nk.nqueens_neighborhood_scores.launches = 0
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = module.main([*argv, "--device", str(torch.device(device).type)])
    sync(device)
    return rc, buf.getvalue(), time.time() - t0, nk.nqueens_neighborhood_scores.launches


def printed(text: str, prefix: str) -> str:
    """The rest of the output line that starts with ``prefix``."""
    for line in text.splitlines():
        if line.startswith(prefix):
            return line[len(prefix):].strip()
    raise AssertionError(f"no line starting {prefix!r} in the output")


def parse_board(text: str, n: int) -> np.ndarray:
    """The board the CLI printed (``format_board``): rows[c] = r for the Q in
    column c of row r."""
    lines = text.splitlines()
    top = lines.index("-" * (4 * n + 1))
    grid = np.array([list(lines[top + 1 + 2 * r]) for r in range(n)])  # [n, 4n + 1]
    queens = grid[:, 2::4] == "Q"  # [row, column]
    if not (queens.sum(axis=0) == 1).all():
        raise AssertionError("the printed board does not hold one queen per column")
    return queens.argmax(axis=0)


def cli_nqueens(device, argv, n, label) -> dict:
    from constraint_solver_tpu_torch.cli import nqueens

    rc, text, wall, launches = run_cli(nqueens, argv, device)
    rows = parse_board(text, n)
    score = int(printed(text, "result.score:"))
    pairs = attacking_pairs(rows)
    if score != 2 * pairs or rc != score:
        raise AssertionError(f"phase 12 {label}: printed score {score} (rc {rc}) != 2 x {pairs} attacking pairs")
    if is_cuda(device) and launches == 0:
        raise AssertionError(f"phase 12 {label}: the CLI never launched the kernel")
    log(f"phase 12 {label}: {' '.join(argv)}: score {score} == 2 x numpy attacking pairs; wall {wall:.3f} s; "
        f"kernel launches {launches}; {printed(text, 'stats:')}")
    return {"score": score, "wall_s": wall, "launches": launches, "stats": printed(text, "stats:")}


def cli_scheduling(device, days=31, emps=7, population=64, rounds=5) -> dict:
    from constraint_solver_tpu_torch.cli import scheduling

    argv = ["--days", str(days), "--employees", str(emps), "--population", str(population), "--rounds", str(rounds)]
    _, text, wall, _ = run_cli(scheduling, argv, device)
    start = datetime.date(2022, 5, 9)
    lines = text.split("result.solution:\n", 1)[1].split("\n---\n", 1)[0].splitlines()
    assign = [int(line.rsplit("employee ", 1)[1]) for line in lines]
    hard, soft = (float(x) for x in printed(text, "result.score: hard").split(" soft "))
    want = oracle_schedule_score(start, assign, {})
    if len(assign) != days or (hard, soft) != want:
        raise AssertionError(f"phase 12 scheduling CLI: printed ({hard}, {soft}) != date-based rescore {want}")
    log(f"phase 12 scheduling CLI: {' '.join(argv)}: best ({hard}, {soft}) == date-based rescore; wall {wall:.3f} s; "
        f"{printed(text, 'stats:')}")
    return {"best": [hard, soft], "wall_s": wall, "stats": printed(text, "stats:")}


def cli_qap(device, n=4096, rounds=6) -> dict:
    from constraint_solver_tpu_torch.cli import qap
    from constraint_solver_tpu_torch.models.qap import QAPSpec

    argv = ["--size", str(n), "--rounds", str(rounds)]
    rc, text, wall, _ = run_cli(qap, argv, device)  # the CLI asserts its best against its host oracle
    perm = np.array(json.loads(printed(text, "result.permutation:")))
    cost = float(printed(text, "result.cost:"))
    flow, dist = QAPSpec.random(n, seed=0).arrays()
    exact = qap_host_cost(flow, dist, perm)
    if rc != 0 or sorted(perm.tolist()) != list(range(n)) or abs(exact - cost) > 1e-3 * max(1.0, exact):
        raise AssertionError(f"phase 12 qap CLI: printed cost {cost} != int64 host cost {exact} (rc {rc})")
    log(f"phase 12 qap CLI: {' '.join(argv)}: cost {cost:.0f}, int64 host cost {exact}; wall {wall:.3f} s; "
        f"{printed(text, 'stats:')}")
    return {"cost": cost, "cost_int64": exact, "wall_s": wall, "stats": printed(text, "stats:")}


def cli_diagram(device, boxes=64, edges=96, grid=32, max_size=4, population=64, rounds=6) -> dict:
    import os

    from constraint_solver_tpu_torch.cli import diagram
    from constraint_solver_tpu_torch.diagram import route

    svg_path = os.path.join(SURFACE_DIR, "layout.svg")
    argv = ["--boxes", str(boxes), "--edges", str(edges), "--grid", str(grid), "--max-size", str(max_size),
            "--population", str(population), "--rounds", str(rounds), "--svg", svg_path]
    routed = []
    inner = route.route_connectors

    def recorded(boxes_, edges_, *args):
        routes = inner(boxes_, edges_, *args)
        routed.append((boxes_, routes))
        return routes

    route.route_connectors = recorded
    try:
        _, text, wall, _ = run_cli(diagram, argv, device)
    finally:
        route.route_connectors = inner
    with open(svg_path) as f:
        svg = f.read()
    (geom, routes), = routed
    if len(routes) != edges or any(r is None for r in routes) or svg.count("<polyline") != edges:
        raise AssertionError(f"phase 12 diagram CLI: {sum(r is None for r in routes)} connectors not routed")
    crossings = route.route_crossings(routes, geom)  # reported: the router does not promise 0
    log(f"phase 12 diagram CLI: {' '.join(argv)}: {printed(text, 'result.score:')}; all {edges} connectors routed, "
        f"{crossings} box crossings, SVG {len(svg)} bytes; wall {wall:.3f} s; {printed(text, 'stats:')}")
    return {"score": printed(text, "result.score:"), "svg_bytes": len(svg), "wall_s": wall,
            "stats": printed(text, "stats:")}


def cli_ackley(device, d=10, population=64, rounds=1) -> dict:
    from constraint_solver_tpu_torch.cli import ackley

    argv = ["--dims", str(d), "--population", str(population), "--rounds", str(rounds)]
    rc, text, wall, _ = run_cli(ackley, argv, device)
    value = float(printed(text, "result.value:"))
    x = json.loads(printed(text, "result.x:"))
    if not np.isfinite(value) or len(x) != d or rc != (0 if abs(value) <= 1e-2 else 1):
        raise AssertionError(f"phase 12 ackley CLI: value {value}, rc {rc}, point {x}")
    log(f"phase 12 ackley CLI: {' '.join(argv)}: value {value} (finite, rc {rc}); wall {wall:.3f} s; "
        f"{printed(text, 'stats:')}")
    return {"value": value, "wall_s": wall, "stats": printed(text, "stats:")}


def http(url, method="GET", body=None):
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        raw = resp.read()
        return json.loads(raw) if resp.headers["Content-Type"] == "application/json" else raw.decode()


def phase_serve(device, nq_n=MAIN_N, rounds=3, boxes=64, edges=96, grid=32, max_size=4) -> dict:
    """The service on the card, in this process on a thread, driven over
    HTTP: an N-Queens client and a scheduling client (the web page's request)
    step their solvers at the same time; then a 64-box diagram and its SVG."""
    from constraint_solver_tpu_torch.models.diagram_layout import DiagramLayoutSpec, layout_score_naive
    from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
    from constraint_solver_tpu_torch.serve.server import SolverService, run_server

    server = run_server("127.0.0.1", 0, SolverService(device))
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/api/solvers"
    out = {}
    try:
        clients = {
            "nqueens": {"problem": "nqueens", "boardSize": nq_n, "seed": "serve"},
            "scheduling": WEB_PAGE_PAYLOAD,
        }
        results, errors, times = {}, [], {}

        def client(name, payload):
            try:
                sid = http(url, "POST", payload)["solverId"]
                spans = []
                for _ in range(rounds):
                    t0 = time.time()
                    results[name] = http(f"{url}/{sid}/round", "POST")
                    spans.append(time.time() - t0)
                times[name] = spans
                http(f"{url}/{sid}", "DELETE")
            except Exception as e:  # noqa: BLE001 — re-raised on the main thread below
                errors.append((name, e))

        nk.nqueens_neighborhood_scores.launches = 0
        threads = [threading.Thread(target=client, args=item) for item in clients.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        sync(device)
        launches = nk.nqueens_neighborhood_scores.launches
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"phase 12 serve: client failed: {errors}")
        nq = results["nqueens"]["result"]
        rows = np.array(nq["rows"])
        if nq["score"]["hard_score"] != 2 * attacking_pairs(rows) or rows.shape != (nq_n,):
            raise AssertionError(f"phase 12 serve: nqueens best {nq['score']} != 2 x numpy attacking pairs")
        sched = results["scheduling"]["result"]
        assign = [e["id"] for _, e in sched["days_to_employees"]]
        want = oracle_schedule_score(datetime.date(2022, 5, 9), assign, {})
        if (sched["score"]["hard_score"], sched["score"]["soft_score"]) != want:
            raise AssertionError(f"phase 12 serve: scheduling best {sched['score']} != date-based rescore {want}")
        if is_cuda(device) and launches == 0:
            raise AssertionError("phase 12 serve: the nqueens solver never launched the kernel")
        out.update(launches=launches, round_s=times, nqueens_best=nq["score"], scheduling_best=list(want))
        log(f"phase 12 serve: nqueens-{nq_n} and the web page's scheduling request, {rounds} rounds each from two "
            f"clients at once: nqueens {nq['score']} == 2 x numpy attacking pairs, scheduling {want} == date-based "
            f"rescore; round seconds {times}; kernel launches {launches}")

        sid = http(url, "POST", {"problem": "diagram", "boxes": boxes, "edges": edges, "grid": grid,
                                 "maxSize": max_size, "iterated_local_search_max_iterations": 2})["solverId"]
        t0 = time.time()
        r = http(f"{url}/{sid}/round", "POST")["result"]
        round_s = time.time() - t0
        t0 = time.time()
        svg = http(f"{url}/{sid}/svg")
        svg_s = time.time() - t0
        spec = DiagramLayoutSpec.random(boxes, edges, grid, seed=0, max_size=max_size)
        want = layout_score_naive(spec, np.array(r["positions"]))
        if (r["score"]["hard_score"], r["score"]["soft_score"]) != want or svg.count("<polyline") != edges:
            raise AssertionError(f"phase 12 serve: diagram best {r['score']} vs host oracle {want}")
        out["diagram"] = {"best": list(want), "round_s": round_s, "svg_s": svg_s, "svg_bytes": len(svg)}
        log(f"phase 12 serve: diagram-{boxes}b-{grid}g: one round {round_s:.3f} s, best {want} == host oracle; "
            f"/svg {len(svg)} bytes with {edges} connectors in {svg_s:.3f} s")
    finally:
        server.shutdown()
        server.server_close()
        serving.join(timeout=60)
    return out


def phase_trace(device, n=MAIN_N, population=MAIN_P) -> dict:
    """One nqueens-n round under ``utils/profiling.trace``: the Chrome trace
    holds the kernel's events and the ``annotate`` span."""
    import glob
    import os

    from constraint_solver_tpu_torch.models.nqueens import make_nqueens_problem
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver
    from constraint_solver_tpu_torch.utils.profiling import annotate, trace

    logdir = os.path.join(SURFACE_DIR, "trace")
    s = PopulationSolver(make_nqueens_problem(n), main_config(), population=population, exchange_every=2,
                         device=device)
    before = set(glob.glob(os.path.join(logdir, "*.json")))
    t0 = time.time()
    with trace(logdir):
        with annotate("smoke-round"):
            s.execute_round()
    wall = time.time() - t0
    (path,) = set(glob.glob(os.path.join(logdir, "*.json"))) - before
    with open(path) as f:
        names = Counter(e.get("name", "") for e in json.load(f)["traceEvents"])
    size = os.path.getsize(path)
    os.remove(path)  # some 200 MB for a main-path round
    kernel_events = sum(c for name, c in names.items() if KERNEL_EVENT in name)
    if (is_cuda(device) and kernel_events == 0) or names["smoke-round"] == 0:
        raise AssertionError(f"phase 12 trace: {kernel_events} kernel events, {names['smoke-round']} spans in {path}")
    log(f"phase 12 trace: one nqueens-{n} P={population} round traced in {wall:.3f} s: {kernel_events} "
        f"{KERNEL_EVENT} events, {sum(names.values())} events in all, {size} bytes")
    return {"kernel_events": kernel_events, "events": sum(names.values()), "wall_s": wall}


def checked_roofline(solver, label, kernel_shape=None) -> dict:
    """``solver.roofline()`` with every share at most 1.05, the solver's state
    unchanged, and the kernel's counted calls equal to its launches in the
    chunk and its counted bytes to ``kernel_bytes(*kernel_shape)`` times them."""
    from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
    from constraint_solver_tpu_torch.utils.convert import to_reference
    from constraint_solver_tpu_torch.utils.roofline import format_roofline

    before = to_reference(solver.state)
    nk.nqueens_neighborhood_scores.launches = 0
    r = solver.roofline()
    launches = nk.nqueens_neighborhood_scores.launches
    assert_tree_equal(before, to_reference(solver.state))
    shares = {k: r[k] for k in ("mfu_bf16", "mfu_f32", "hbm_frac")}
    if not all(0.0 <= v <= 1.05 for v in shares.values()):
        raise AssertionError(f"phase 12 roofline {label}: a share above 1.05: {shares}")
    kern = r["kernels"].get(nk.KERNEL_NAME, {"calls": 0, "bytes": 0})
    if is_cuda(solver.device) and kern["calls"] != launches:
        raise AssertionError(f"phase 12 roofline {label}: {kern['calls']} kernel calls counted, {launches} launched")
    if kern["calls"]:
        want = kernel_bytes(*kernel_shape) * kern["calls"]
        if kern["bytes"] != want:
            raise AssertionError(f"phase 12 roofline {label}: kernel bytes {kern['bytes']} != {want}")
    log(f"phase 12 roofline {label}: {format_roofline(r)}; per round {r['flops_per_round']:.4g} operations, "
        f"{r['hbm_bytes_per_round']:.4g} bytes; kernel {kern}; state unchanged")
    return r


def phase_roofline(device, main_solver, n=MAIN_N, population=MAIN_P, qap_n=4096) -> dict:
    """``roofline()`` of the main path's solved solver, of a main-path solver
    after one round (its chunk descends, so the kernel runs), and of qap-4096
    incremental with 4 lanes after 2 rounds."""
    from constraint_solver_tpu_torch.models.nqueens import make_nqueens_problem
    from constraint_solver_tpu_torch.models.qap import QAPSpec, make_qap_problem
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver

    shape = (population, main_solver.program.problem.width // n, n)
    out = {"main_path_solved": checked_roofline(main_solver, "main path (solved)", shape)}
    fresh = PopulationSolver(make_nqueens_problem(n), main_config(), population=population, exchange_every=2,
                             device=device)
    fresh.run(max_rounds=1, chunk=1)
    out["main_path_round_1"] = checked_roofline(fresh, "main path after round 1", shape)
    if out["main_path_round_1"]["kernels"].get("nqueens_neighborhood_scores", {}).get("calls", 0) == 0:
        raise AssertionError("phase 12 roofline: the main path's chunk after round 1 never ran the kernel")
    qap = PopulationSolver(make_qap_problem(QAPSpec.random(qap_n, seed=0), incremental=True), qap_config(),
                           population=4, device=device)
    qap.run(max_rounds=2, chunk=2)
    out[f"qap_{qap_n}_incremental"] = checked_roofline(qap, f"qap-{qap_n} incremental P=4")
    return out


def phase_surface(device, main_solver, n=MAIN_N, population=MAIN_P, pmc_n=PMC_N, qap_n=4096, sizes=None) -> dict:
    """12. The user surface on the card: the five CLIs in this process, the
    HTTP service, a profiler trace and the roofline.  ``sizes`` overrides the
    keyword arguments of each part (``cli_scheduling``, ``cli_diagram``,
    ``cli_ackley``, ``serve``), for a rehearsal on the CPU."""
    import os

    sizes = sizes or {}
    os.makedirs(SURFACE_DIR, exist_ok=True)
    t0 = time.time()
    out = {
        "cli_nqueens": cli_nqueens(device, ["--board-size", str(n), "--population", str(population)], n,
                                   "nqueens CLI"),
        "cli_pmc": cli_nqueens(device, ["--algo", "pmc", "--board-size", str(pmc_n)], pmc_n, "PMC CLI"),
        "cli_scheduling": cli_scheduling(device, **sizes.get("cli_scheduling", {})),
        "cli_qap": cli_qap(device, qap_n),
        "cli_diagram": cli_diagram(device, **sizes.get("cli_diagram", {})),
        "cli_ackley": cli_ackley(device, **sizes.get("cli_ackley", {})),
        "serve": phase_serve(device, **sizes.get("serve", {"nq_n": n})),
        "trace": phase_trace(device, n, population),
        "roofline": phase_roofline(device, main_solver, n, population, qap_n),
    }
    out["wall_s"] = time.time() - t0
    log(f"phase 12: the user surface in {out['wall_s']:.1f} s")
    return out


MULTI_WORLD = 4
# Phase 13's sizes: the main path's width on a 2 x 2 mesh, and the other
# sub-phases' instances (a CPU rehearsal passes smaller ones).
MULTI_SIZES = {
    "n": MAIN_N, "population": MAIN_P, "nbr_keep": 64, "wall_cap": WALL_CAP_S, "check_iterations": 3,
    "pop4_rounds": 4, "seq_days": 365, "seq_emps": 20, "seq_population": 64, "seq_window": 100, "seq_rounds": 8,
    "score_days": 730, "score_emps": 40, "score_assignments": 8, "qap_n": 1024, "qap_population": 16,
    "qap_rounds": 4, "ckpt_rounds": 2,
}
MULTI_TRANSPORT = ("all_gather and ppermute travel as all_reduce SUM of zero-filled buffers "
                   "(constraint_solver_tpu_torch/parallel/mesh.py): PyTorch lists gloo's CUDA collectives as "
                   "broadcast and all_reduce")


def _gloo_cuda_probe(device) -> dict:
    """Which collectives gloo takes on this rank's device: each is tried once on
    a small tensor (every rank the same, so a refusal is everyone's)."""
    import torch
    import torch.distributed as dist

    world = dist.get_world_size()
    out = {}
    x = torch.full((4,), float(dist.get_rank()), device=device)
    for name, call in (
        ("broadcast", lambda: dist.broadcast(x.clone(), src=0)),
        ("all_reduce", lambda: dist.all_reduce(x.clone())),
        ("all_gather", lambda: dist.all_gather([torch.empty_like(x) for _ in range(world)], x)),
    ):
        try:
            call()
            torch.cuda.synchronize(device)
            out[name] = "ok"
        except (RuntimeError, ValueError) as e:
            out[name] = f"refused: {str(e).splitlines()[0][:160]}"
    return out


def multi_rank(rank: int, world: int, sizes: dict, device: str, ckpt_path: str) -> dict:
    """One rank of phase 13: sub-phases (a)-(f) on the meshes over all four
    ranks; returns each sub-phase's wall, kernel launches (per shape),
    collectives and descent iterations, and what the parent checks."""
    import torch

    from constraint_solver_tpu_torch.models.nqueens import build_state, make_nqueens_problem, total_conflicts
    from constraint_solver_tpu_torch.models.qap import QAPSpec, make_qap_problem
    from constraint_solver_tpu_torch.models.scheduling import make_scheduling_problem
    from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
    from constraint_solver_tpu_torch.ops.fingerprint import fingerprint_i32
    from constraint_solver_tpu_torch.ops.lex import lex_argmin
    from constraint_solver_tpu_torch.parallel.mesh import all_reduce, collective_calls, make_mesh, use_mesh
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver
    from constraint_solver_tpu_torch.parallel.seq_shard import make_sharded_schedule_score
    from constraint_solver_tpu_torch.parallel.seq_solver import SeqShardedSolver
    from constraint_solver_tpu_torch.parallel.sharded import ShardedPopulationSolver
    from constraint_solver_tpu_torch.utils import presets
    from constraint_solver_tpu_torch.utils.convert import to_reference
    from constraint_solver_tpu_torch.utils.draws import TorchDraws
    from constraint_solver_tpu_torch.utils.tree import tree_leaves

    import dataclasses

    z = sizes
    n, pop_size = z["n"], z["population"]
    grid = make_mesh(2, 2)                      # (pop, nbr)
    pop4 = make_mesh(4, 1)                      # (pop)
    popseq = make_mesh(2, 2, ("pop", "seq"))
    seq4 = make_mesh(1, 4, ("pop", "seq"))
    out = {"rank": rank, "device": str(torch.device(device)), "card": torch.cuda.get_device_name(device)
           if is_cuda(device) else "cpu", "sub": {}}

    def sub(name, counters, fn):
        nk.nqueens_neighborhood_scores.launches = 0
        nk.nqueens_neighborhood_scores.shapes.clear()
        if counters is not None:
            counters.reset()
        calls0 = collective_calls()
        t0 = time.time()
        result = fn()
        sync(device)
        rec = {
            "wall_s": time.time() - t0,
            "launches": nk.nqueens_neighborhood_scores.launches,
            "launch_shapes": {str(k): v for k, v in nk.nqueens_neighborhood_scores.shapes.items()},
            "collectives": collective_calls() - calls0,
        }
        if counters is not None:
            rec["iterations"] = counters.calls
            rec["collectives_per_iteration"] = rec["collectives"] / max(counters.calls, 1)
        out["sub"][name] = rec
        return result

    def sharded_nqueens():
        return instrument(make_nqueens_problem(n, nbr_axis="nbr", nbr_shards=2, nbr_keep=z["nbr_keep"]), device)

    # (a) pop 2 x nbr 2 at the main path's width, until zero conflicts.
    problem_a, counters_a = sharded_nqueens()
    s = ShardedPopulationSolver(problem_a, main_config(), population=pop_size, mesh=grid, exchange_every=2,
                                device=device)

    def solve():
        timer = threading.Timer(z["wall_cap"], s.cancel)
        timer.start()
        try:
            s.run(chunk=2)
        finally:
            timer.cancel()
            timer.join()

    sub("a", counters_a, solve)
    (hard, soft), best = s.get_best_solution()
    if hard != 0:
        raise AssertionError(f"phase 13a: not solved within {z['wall_cap']} s: best ({hard}, {soft})")
    if rank == 0 and (attacking_pairs(best.rows) != 0 or sorted(best.rows.tolist()) != list(range(n))):
        raise AssertionError("phase 13a: the best board has attacking queens by an independent count")
    cur = s.state.current_state
    for name, want in zip(("rc", "dc", "ac", "cs"), numpy_counts(cur.rows.cpu().numpy())):
        if not np.array_equal(getattr(cur, name).cpu().numpy(), want):
            raise AssertionError(f"phase 13a: rank {rank}: carried {name} differs from a rebuild from the boards")
    if not torch.equal(s.state.current_fp, fingerprint_i32(cur.rows)):
        raise AssertionError(f"phase 13a: rank {rank}: carried fingerprints differ from a full recomputation")
    out["a"] = {"best": [hard, soft], "stats": s.stats(), "rounds": s.get_iteration_info()["current"]}

    # Every gathered candidate against a full rescore of its move, along a
    # few greedy descent iterations from random boards.
    problem = make_nqueens_problem(n, nbr_axis="nbr", nbr_shards=2, nbr_keep=z["nbr_keep"])
    local = s.local_population
    draws = TorchDraws("phase13-candidates", local, device)
    state = build_state(draws.permutation(n))
    score = problem.score(state)
    lane = torch.arange(local, device=state.rows.device)
    checked = 0
    with use_mesh(grid):
        for _ in range(z["check_iterations"]):
            nb = problem.neighborhood(state, score, draws, torch.ones(local, dtype=torch.bool, device=device))
            boards = state.rows[:, None, :].repeat(1, nb.valid.shape[1], 1)
            boards.scatter_(2, nb.moves.cols[..., None], nb.moves.rows[..., None])
            rescored = total_conflicts(boards).to(torch.float32)
            if not torch.equal(torch.where(nb.valid, nb.scores[..., 0], 0.0), torch.where(nb.valid, rescored, 0.0)):
                raise AssertionError(f"phase 13a: rank {rank}: a gathered candidate's score differs from its rescore")
            checked += int(nb.valid.sum())
            win = lex_argmin(nb.scores, nb.valid)
            state, score = problem.apply_move(state, nb.moves, win), nb.scores[lane, win]
    out["a"]["candidates_checked"] = checked

    # (f) roofline of (a)'s solved solver: the chunk counted on every rank.
    before = to_reference(s.state)
    nk.nqueens_neighborhood_scores.launches = 0
    r = s.roofline()
    launched = int(all_reduce(torch.tensor([nk.nqueens_neighborhood_scores.launches], device=grid.device),
                              grid.world).item())
    assert_tree_equal(before, to_reference(s.state))
    kern = r["kernels"].get(nk.KERNEL_NAME, {"calls": 0, "bytes": 0})
    shares = {k: r[k] for k in ("mfu_bf16", "mfu_f32", "hbm_frac")}
    if not all(0.0 <= v <= 1.05 for v in shares.values()):
        raise AssertionError(f"phase 13f: a share above 1.05: {shares}")
    if is_cuda(device) and kern["calls"] != launched:
        raise AssertionError(f"phase 13f: {kern['calls']} kernel calls counted, {launched} launched on the ranks")
    shape_a = (local, problem.width // n // 2, n)
    if kern["calls"] == 0 or kern["bytes"] != kernel_bytes(*shape_a) * kern["calls"]:
        raise AssertionError(f"phase 13f: kernel {kern} != {kernel_bytes(*shape_a)} bytes x calls")
    out["f"] = {k: r[k] for k in ("chip", "flops_per_sec", "hbm_bytes_per_sec", "mfu_bf16", "mfu_f32", "hbm_frac",
                                  "flops_per_round", "hbm_bytes_per_round", "counted_from", "ranks", "cards")}
    out["f"]["kernel"] = kern
    out["f"]["launched"] = launched

    # (b) pop 4: the one-device problem, lanes over four ranks, host draws.
    problem_b, counters_b = instrument(make_nqueens_problem(n), device)
    b = PopulationSolver(problem_b, main_config(), population=pop_size, exchange_every=2, mesh=pop4, device=device,
                         draws=TorchDraws(main_config().seed, pop_size, device, draw_device="cpu"))
    sub("b", counters_b, lambda: b.run(max_rounds=z["pop4_rounds"], chunk=2))
    out["b"] = {"state": to_reference(b.state), "rounds": b.get_iteration_info()["current"]}

    # (c) pop 2 x seq 2: the random-window scheduling solver over dated days.
    spec, d0, hols = bench_schedule(z["seq_days"], z["seq_emps"])
    c = SeqShardedSolver(spec, presets.scheduling_quality("phase13"), popseq, window_size=z["seq_window"],
                         population=z["seq_population"], exchange_every=4, device=device,
                         draws=TorchDraws("phase13", z["seq_population"], device, draw_device="cpu"))
    problem_c, counters_c = instrument(c.problem, device)
    c.program = dataclasses.replace(c.program, problem=problem_c)
    sub("c", counters_c, lambda: c.run(max_rounds=z["seq_rounds"], chunk=4))
    (hard, soft), assign = c.get_best_solution()
    want = oracle_schedule_score(d0, assign.tolist(), hols)
    if (hard, soft) != want:
        raise AssertionError(f"phase 13c: best ({hard}, {soft}) != date-based rescore {want}")
    whole = to_reference(c._dense_state(c.state))  # a collective: every rank gathers, rank 0 returns it
    out["c"] = {"best": [hard, soft], "state": whole if rank == 0 else None}
    spec2, _, _ = bench_schedule(z["score_days"], z["score_emps"])
    score_fn = make_sharded_schedule_score(spec2, seq4)
    assigns = torch.as_tensor(np.random.default_rng(13).integers(
        0, z["score_emps"], (z["score_assignments"], z["score_days"])), device=device)
    got = sub("c_scorer", None, lambda: score_fn(assigns))
    if not torch.equal(got, make_scheduling_problem(spec2).score(assigns)):
        raise AssertionError("phase 13c: the 4-rank sharded scorer differs from the one-device scorer")
    out["c"]["scorer_scores"] = got.cpu().numpy()

    # (d) QAP with its neighborhood over nbr.
    qspec = QAPSpec.random(z["qap_n"], seed=0)
    problem_d, counters_d = instrument(make_qap_problem(qspec, nbr_axis="nbr", nbr_shards=2), device)
    d = ShardedPopulationSolver(problem_d, qap_config(), population=z["qap_population"], mesh=grid, device=device)
    sub("d", counters_d, lambda: d.run(max_rounds=z["qap_rounds"], chunk=2))
    (cost, _), perm = d.get_best_solution()
    if sorted(perm.tolist()) != list(range(z["qap_n"])):
        raise AssertionError("phase 13d: the recorded best is not a permutation")
    exact = qap_host_cost(*qspec.arrays(), perm)
    if abs(exact - cost) > 1e-3 * max(1.0, abs(exact)):
        raise AssertionError(f"phase 13d: carried cost {cost} != int64 host cost {exact}")
    out["d"] = {"best_carried": cost, "best_int64": exact}

    # (e) (a)'s configuration: 2 rounds, save (rank 0 writes), load into a
    # fresh solver, 2 more == 4 rounds straight.
    problem_e, counters_e = sharded_nqueens()

    def sharded():
        return ShardedPopulationSolver(problem_e, main_config(), population=pop_size, mesh=grid, exchange_every=2,
                                       device=device)

    def resume():
        k = z["ckpt_rounds"]
        straight = sharded()
        for _ in range(2 * k):
            straight.execute_round()
        part = sharded()
        for _ in range(k):
            part.execute_round()
        part.save(ckpt_path)
        saved_best = part.get_best_solution()
        resumed = sharded()
        resumed.load(ckpt_path)
        for _ in range(k):
            resumed.execute_round()
        return straight, resumed, saved_best

    straight, resumed, saved_best = sub("e", counters_e, resume)
    for x, y in zip(tree_leaves(straight.state), tree_leaves(resumed.state)):
        if not torch.equal(x, y):
            raise AssertionError(f"phase 13e: rank {rank}: the resumed run differs from the straight run")
    out["e"] = {"saved_best": saved_best[0], "saved_rows": saved_best[1].rows}
    if is_cuda(device):
        out["gloo_cuda_ops"] = _gloo_cuda_probe(device)
    return out


def phase_multi(device, sizes=None) -> dict:
    """13. Four ranks (spawned processes, gloo, every one on ``device``) run
    ``multi_rank``; this process holds (b) and (c) against the one-device
    solver from the same host-side draws and (e)'s file against a one-device
    load."""
    import os

    import torch

    from constraint_solver_tpu_torch.models.nqueens import make_nqueens_problem
    from constraint_solver_tpu_torch.models.scheduling import make_scheduling_problem
    from constraint_solver_tpu_torch.parallel import distributed
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver
    from constraint_solver_tpu_torch.utils import presets
    from constraint_solver_tpu_torch.utils.convert import to_reference
    from constraint_solver_tpu_torch.utils.draws import TorchDraws
    from constraint_solver_tpu_torch.utils.tree import tree_map

    z = {**MULTI_SIZES, **(sizes or {})}
    os.makedirs("build/checkpoints", exist_ok=True)
    ckpt = os.path.abspath("build/checkpoints/sharded_nqueens.npz")
    dev = str(torch.device(device))
    log(f"phase 13: {MULTI_WORLD} ranks, backend gloo, every rank on {dev}; {MULTI_TRANSPORT}")
    t0 = time.time()
    # The host's cores shared out, so the ranks' host-side draws do not oversubscribe them.
    ranks = distributed.run_ranks(multi_rank, MULTI_WORLD, (z, dev, ckpt), backend="gloo", device=dev,
                                  timeout_s=900, threads=max(1, os.cpu_count() // MULTI_WORLD))
    wall = time.time() - t0
    n, p = z["n"], z["population"]

    # (b): every rank's lanes == the one-device run's.
    dense = PopulationSolver(make_nqueens_problem(n), main_config(), population=p, exchange_every=2, device=device,
                             draws=TorchDraws(main_config().seed, p, device, draw_device="cpu"))
    dense.run(max_rounds=z["pop4_rounds"], chunk=2)
    want = to_reference(dense.state)
    for r in ranks:
        lanes = slice(r["rank"] * p // MULTI_WORLD, (r["rank"] + 1) * p // MULTI_WORLD)
        assert_tree_equal(tree_map(lambda x: x[lanes], want), r["b"]["state"])
    # (c): the whole (gathered) state == the one-device random-window run's.
    spec, _, _ = bench_schedule(z["seq_days"], z["seq_emps"])
    dense_c = PopulationSolver(make_scheduling_problem(spec, window_size=z["seq_window"], proposer="random"),
                               presets.scheduling_quality("phase13"), population=z["seq_population"],
                               exchange_every=4, device=device,
                               draws=TorchDraws("phase13", z["seq_population"], device, draw_device="cpu"))
    dense_c.run(max_rounds=z["seq_rounds"], chunk=4)
    assert_tree_equal(to_reference(dense_c.state), ranks[0]["c"]["state"])
    # (e): the sharded file in a one-device load gives the same global best.
    loaded = PopulationSolver(make_nqueens_problem(n), main_config(), population=p, exchange_every=2, device=device)
    loaded.load(ckpt)
    (score, best) = loaded.get_best_solution()
    if score != ranks[0]["e"]["saved_best"] or not np.array_equal(best.rows, ranks[0]["e"]["saved_rows"]):
        raise AssertionError("phase 13e: a one-device load of the sharded file gives another best")

    shapes = {"a": (p // 2, -(-(n // 20) // 2), n), "b": (p // 4, n // 20, n), "e": (p // 2, -(-(n // 20) // 2), n)}
    for r in ranks:
        for name, shape in shapes.items():
            rec = r["sub"][name]
            if is_cuda(device) and rec["launch_shapes"].get(str(shape), 0) == 0:
                raise AssertionError(f"phase 13{name}: rank {r['rank']} never launched the kernel at {shape}: "
                                     f"{rec['launch_shapes']}")
    out = {"backend": "gloo", "world": MULTI_WORLD, "devices": [r["device"] for r in ranks], "wall_s": wall,
           "transport": MULTI_TRANSPORT, "gloo_cuda_ops": ranks[0].get("gloo_cuda_ops"),
           "sub": {name: {"wall_s": [r["sub"][name]["wall_s"] for r in ranks],
                          "launches": [r["sub"][name]["launches"] for r in ranks],
                          "launch_shapes": ranks[0]["sub"][name]["launch_shapes"],
                          "collectives": [r["sub"][name]["collectives"] for r in ranks],
                          "iterations": ranks[0]["sub"][name].get("iterations"),
                          "collectives_per_iteration": ranks[0]["sub"][name].get("collectives_per_iteration")}
                   for name in ranks[0]["sub"]},
           "a": ranks[0]["a"], "c_best": ranks[0]["c"]["best"], "d": ranks[0]["d"], "f": ranks[0]["f"]}
    for name, rec in out["sub"].items():
        log(f"phase 13{name}: wall per rank {[round(w, 3) for w in rec['wall_s']]} s; kernel launches per rank "
            f"{rec['launches']} at {rec['launch_shapes']}; collectives per rank {rec['collectives']}"
            + (f"; {rec['iterations']} descent iterations, {rec['collectives_per_iteration']:.3f} collectives each"
               if rec["iterations"] else ""))
    log(f"phase 13a: nqueens-{n} P={p} on 2 x 2 (pop, nbr) solved {out['a']['best']} in {out['a']['rounds']} rounds; "
        f"{out['a']['candidates_checked']} gathered candidates == full rescores; counters and fingerprints rebuilt")
    log(f"phase 13b: pop 4 lanes == one-device run after {z['pop4_rounds']} rounds, every leaf")
    log(f"phase 13c: pop 2 x seq 2 state == one-device random window; best {out['c_best']} == date-based rescore; "
        f"4-rank scorer == one-device scorer on {z['score_assignments']} schedules of {z['score_days']} days")
    log(f"phase 13d: qap-{z['qap_n']} over nbr: best {out['d']['best_carried']} (int64 {out['d']['best_int64']})")
    log(f"phase 13e: 2 + save + load + 2 rounds == 4 straight on every rank; one-device load best {score}")
    log(f"phase 13f: roofline of (a)'s solver over {out['f']['ranks']} ranks on {out['f']['cards']} card(s), counted "
        f"from the {out['f']['counted_from']} state: kernel {out['f']['kernel']} (launched {out['f']['launched']}); "
        f"mfu_f32 {out['f']['mfu_f32']:.4g}, hbm_frac {out['f']['hbm_frac']:.4g}")
    if out["gloo_cuda_ops"]:
        log(f"phase 13: gloo on CUDA tensors: {out['gloo_cuda_ops']}")
    log(f"phase 13: {MULTI_WORLD} ranks (gloo, {', '.join(out['devices'])}) in {wall:.1f} s")
    return out


def main() -> None:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--kernel-only", action="store_true",
        help="run phases 1 and 2 only, print the kernel's measurements and stop (no result line)",
    )
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; the port's kernels run only on the card")
    from constraint_solver_tpu_torch.ops import nqueens_kernel as nk

    device = torch.device("cuda", 0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.time()
    report = nk.build_library(force=True)
    log(f"phase 1: built {nk._LIB_PATH.name} in {time.time() - t0:.1f} s")
    for line in report.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill")) or "error" in line.lower():
            log(f"  nvcc: {line.strip()}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"phase 1: card {card}")
    for name, nbytes in probe_kernel_bytes().items():
        log(f"phase 1: TPU probe {name} (bench/kernel_iso.py, not ported) at (P, A, n) = {(MAIN_P, MAIN_A, MAIN_N)}: "
            f"{nbytes} bytes, bound {nbytes / HBM_BYTES_PER_S * 1e3:.6f} ms")

    kernel = phase_kernel(device)
    if args.kernel_only:
        log(json.dumps({"kernels": [kernel]}))
        return
    phase_cross_device(device)
    main_run, main_solver = phase_main(device)
    pmc_run = phase_pmc(device)
    phase_schedule_cross_device(device)
    sched = phase_schedule_bench(device)
    qap = phase_qap(device)
    ackley = phase_ackley(device)
    diagram = phase_diagram(device)
    phased = phase_phased(device)
    ckpt = phase_checkpoint(device)
    surface = phase_surface(device, main_solver)
    multi = phase_multi(device)
    paths = {
        "nqueens_population": main_run["launches"],
        "pmc": pmc_run["launches"],
        "checkpoint_resume": ckpt["nqueens"]["launches"],
        "cli_nqueens": surface["cli_nqueens"]["launches"],
        "cli_pmc": surface["cli_pmc"]["launches"],
        "serve_nqueens": surface["serve"]["launches"],
        "sharded_nbr": sum(multi["sub"]["a"]["launches"]),
        "pop_sharded": sum(multi["sub"]["b"]["launches"]),
        "sharded_checkpoint": sum(multi["sub"]["e"]["launches"]),
    }
    kernel["launches"] = sum(paths.values())
    kernel["launches_by_path"] = paths

    log(json.dumps({
        "main_path": main_run, "pmc": pmc_run, "scheduling": sched, "qap": qap, "ackley": ackley,
        "diagram": diagram, "phased": phased, "checkpoint": ckpt, "surface": surface, "multi_device": multi,
        "card": card,
    }, default=str))
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
