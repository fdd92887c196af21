#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``constraint_solver_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py                # every phase
    python3 chip_smoke.py --kernel-only  # phases 1 and 2 to 2h, no result line
    python3 chip_smoke.py --k3-solves    # phase 1, then K3's launches over a solve of each N-Queens cell

Phases, each printing its own lines; any failure raises and exits nonzero:

1. builds the eight CUDA libraries from ``constraint_solver_tpu_torch/csrc``
   (``nqueens_scores.cu``, ``nqueens_probes.cu``, ``qap_row_min.cu``,
   ``fingerprint.cu``, ``block_pick.cu``, ``nqueens_move.cu``,
   ``sched_dense.cu`` and ``nqueens_sample.cu``, one ``nvcc`` each, started together) and prints the card's name and power limit (``nvidia-smi``);
   without a CUDA device it stops before printing any result;
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
2b. the five probe kernels of ``bench/kernel_iso.py`` (``ops/nqueens_probes.py``)
   at the harness's (256, 50, 1000) and at (16, 819, 16384): each equal to its
   plain version bit for bit on the whole padded block, min and argmin; its
   device-only ms, wrapper ms and host us, the plain version's ms, the bound and
   the share; at n = 16384 the staged int16 and packed probes also with their
   tables read from global memory and with 16 and 32 columns per block, and B1
   timed and held equal to the min probes; then the ported harness's
   ``main(["--packed", "--i16", "--mxu"])`` with the probes' launch counts from
   0: each arm's ms/iter, and every probe arm's sums equal to the plain slice
   block's;
2c. K1, QAP's swap row minimum (``ops/qap_row_min.py``, ``csrc/qap_row_min.cu``),
   at qap4096_inc_p4's (4, 4096), at (16, 1024) and (64, 256) and at the ragged
   (5, 1003), each with the path its launch plan takes (the ring of stages, or
   the strip loop where n % 4 != 0): equal to its
   plain version bit for bit on the solver's data and on non-integer floats;
   on the solver's data its device-only ms per launch (its events in a
   ``torch.profiler`` trace), the wrapper's host us, its time and the plain
   version's (the eager chain it replaces) by CUDA events in turns, and the
   DRAM bound with the share reached; at (4, 4096) also the rate of a plain
   ``torch.sum`` over H beside K1's, a yardstick of what the card streams;
2d. K2, the fingerprint hash (``ops/fingerprint.py``, ``csrc/fingerprint.cu``):
   K2a (``hash_xor``) at the solvers' shapes, ``fp_update`` at [256] and [16],
   QAP's swap at [4], the roster's random swaps [64, 256], swap diagonals [64,
   4, 365] (expanded views) and dense block [64, 365, 20], and K2b
   (``fingerprint_i32``) on rows of (256, 1000), (16, 16384), (4, 4096) and
   (64, 365), each equal to its plain version bit for bit; then on adversarial
   values (negative int32, -0.0, NaN payloads, values at and past 2^32 - 1,
   strided rows); at the solvers' shapes each kernel's device-only time (its
   events in a profiler trace), the wrapper's host us, the wrapper and the
   plain chain by CUDA events, and the bound (bytes over 3.35 TB/s or integer
   operations over 67 T/s, the larger) with the share, beside the card's name
   and power limit.  Then K2a's ring form (``hash_probe``, the descent's tabu
   push and check in one launch) against its plain version (``TabuRing.push``
   and ``is_tabu``), every output bit for bit: the picks at [256] against a
   ring of 256, [16] against 256 and [4] against 128, a retry's check with no
   push, the roster's exact filter [64, 9016] against 64, then adversarial
   rings (a fingerprint in several slots, a full ring wrapping its head,
   expired and never-written slots against a candidate (0, 0), a push already
   present, an expiry near 2^31 - 1 whose sum wraps, a count that wraps, heads
   outside the ring, rings of more than one shared-memory tile, strided and
   expanded operands), timed likewise; K2b's split plan is the one its rows of
   (16, 16384) and (4, 4096) take;
2e. K3, the block pick (``ops/block_pick.py``, ``csrc/block_pick.cu``): on B1's
   blocks at the N-Queens cells' (256, 50, 1000) and (16, 64, 16384), the
   first pick (no exclusion), a retry with 8 excluded row minima a lane,
   exclusions mixed with -1 slots and invalid rows, lanes with no valid row,
   at n = 16384 a block off 16 bytes, and the ragged (5, 7, 1003): each pick
   equal to its plain version (``lex_argmin`` over the stacked block) bit for
   bit; at the two shapes' first pick and retry its device-only time (its
   events in a profiler trace), the wrapper's host us, the wrapper, the plain
   chain and ``torch.argmin`` over the block (the nearest single PyTorch call)
   by CUDA events, and the bound of this call's rows with the share;
2f. K4, the masked N-Queens move (``ops/nqueens_move.py``,
   ``csrc/nqueens_move.cu``), at the N-Queens cells' (256, 50, 1000) and (16,
   64, 16384) and the ragged (5, 7, 1003), with masks all on, all off and
   mixed, same-row moves and the columns 0 and n - 1 among the moves: every
   leaf of the state equal to its plain version's bit for bit; the mixed case
   at (16, 64, 16384) replayed once in a CUDA graph; at the two shapes' all-on
   move and the headline's mixed one its device-only time (its events in a
   profiler trace), the wrapper's host us, the wrapper, the plain version and
   the select form's chain (``apply_move`` then the select) by CUDA events,
   and the bound of this call's masked lanes with the share;
2g. K5, the roster's dense neighborhood (``ops/sched_dense.py``,
   ``csrc/sched_dense.cu``), at the roster cell's (64, 365, 20, 256, 4), 730
   x 40 at P = 128, 31 d x 7 e with holidays at P = 8, an instance from a
   Friday, D < 15 (no diagonals), no random swaps, and lanes on two
   employees: every output (scores, validity, fingerprint deltas, the four
   move tensors, padding slots included) equal to its plain version's, the
   eager chain the dense proposer ran before it, each case's plan logged
   (cluster size, blocks, dynamic shared memory a block, the plane's place,
   registers, blocks an SM and clusters the card holds at once); the roster
   case replayed once in a CUDA graph; at the roster's and 730 x 40's shapes
   its device-only time (its events in a profiler trace), the wrapper's host
   us, the wrapper and the plain version by CUDA events, the plain version's
   kernels a call, and the bound (bytes over 3.35 TB/s) with the share;
2h. K6, the N-Queens column sample and the block's inputs
   (``ops/nqueens_sample.py``, ``csrc/nqueens_sample.cu``), at both N-Queens
   cells' (P, n, A) on random and near-solved boards, keys that tie
   everywhere, no conflicted column, A = n, a ragged n and each branch of
   its plan (survivors placed by rank or by the bitonic sort, the keys and
   the survivors in global memory): every output equal to its plain
   version's (the stable sort and the gathers); K7, the fingerprints of
   N-Queens candidates (``nqueens_move_fp`` in ``ops/fingerprint.py``), at a
   pick of both cells, the exact filter's [256, 50000] and [8, 192], int32
   candidates through a stride and the last candidate: equal to its plain
   version and to the chain it replaced (the decode, then K2a); both
   replayed once in a CUDA graph; at the cells' shapes each one's
   device-only time (its events in a profiler trace), the wrapper's host
   us, the wrapper, the plain version and (K6) ``torch.topk`` or (K7) the
   replaced chain by CUDA events, and the bound with the share;
3. runs a few rounds of nqueens-64 with 8 lanes on the card and on the CPU from
   the same host-side draws, in both tabu modes: the states must be equal;
4. drives the main path, ``PopulationSolver(make_nqueens_problem(1000), ...,
   population=256, exchange_every=2, device="cuda").run(chunk=2)``, until the
   best board has zero conflicts (cancelled at ``WALL_CAP_S``), then checks the
   board with an independent numpy count, every lane's carried counters against
   a rebuild from its board, the carried fingerprints against a full
   recomputation by K2b and by the plain version, and that the kernel, K2a's
   ring form, K2b, K3, K4, K6 and K7 were launched in the run;
4b. the descent replayed as CUDA graphs (``core/graphed.py``, the solvers'
   default on the card) against the eager loop (the solvers' private
   ``_graphed=False``), from one seed, drawing on the card: nqueens-64 with 8
   lanes in both tabu modes, 3 chunks of 2 rounds, and the main path's
   ``run(chunk=2)`` to zero after a warm-up of each: the final state trees,
   the traces, ``stats()``, the generator's state and the launches of the
   kernel, of K2a, its ring form and K2b, of K3, K4, K6 and K7 must be
   equal, and each but K2a must have launched; nqueens-512 P=8 with its retries in clusters;
   then nqueens-512 P=8 with its move written in place (K4) against the same
   problem with ``in_place`` stripped, both graphed: state bits, traces and
   ``stats()`` equal; it prints both walls, the capture time and both peak
   memories, each with the card's name and power limit, then the benchmark's
   traced round on the second round of a fresh solver on each path;
4c. the same comparison for the other domains that replay their descents as
   graphs, each from one seed, drawing on the card: scheduling 31 d x 7 e with
   8 lanes (random, dense, noisy dense and systematic proposers, 4 rounds),
   the roster cell's configuration (365 d x 20 e, dense, 64 lanes, 8 rounds
   after a 4-round warm-up), qap-64 with 8 lanes (dense, compact,
   incremental), qap-256 with 64 (dense, compact) and qap-4096 incremental
   with 4 (2 rounds; G and H are 268 MB each; every compact and incremental
   case must launch K1, as often graphed as eager; every case K2, as often
   graphed as eager: K2a's ring form and K2b, and K2a but for the systematic
   proposer, whose moves are whole states, and the dense one, whose
   fingerprint deltas K5 hashes; every dense scheduling case K5, as often
   graphed as eager), Ackley d = 10 with 64 lanes
   (6 rounds of descents of at most 40 iterations) and the diagram layout (8
   boxes with 4 lanes, 64 boxes with 64, 3 rounds): state trees, traces,
   ``stats()`` and the generator's state equal; both walls and ms per
   iteration, the capture time and both peak memories, with the card's name
   and power limit; then the benchmark's traced round on the second round of
   a fresh roster solver, eager and graphed.  Every later phase whose draws
   are made on the card runs its descents as graphs (the solvers' default);
4d. the JAX package's matrix forms of the N-Queens block (``block_impl=
   "mxu_conv"`` and ``"mxu_toeplitz"``, plain torch ops that run instead of
   the kernel): at (8, 50, 1000) and (4, 64, 64) each block equal to the
   kernel's on the same inputs and each neighborhood to the kernel's from the
   same draws, bit for bit, with both times per call; then nqueens-64 with 8
   lanes on ``mxu_conv``, graphed == eager as in 4b;
5. parallel min-conflicts, the kernel's second caller: ``pmc_solve(1000,
   max_steps=5000)`` on the card over the full [n, n] block after one warm-up
   solve, its steps replayed as CUDA graphs (the default; zero conflicts by an
   independent count, the carried score equal to it, kernel launches > 0),
   then nqueens-64 with 4 lanes on the card and on the CPU from host-side
   draws (the eager loop): the states must be equal; then graphed against
   eager (``_graphed=False``), from one seed, drawing on the card:
   nqueens-64 with 4 lanes, the nqueens-1000 solve after a warm-up and
   nqueens-1000 with ``sample_cols=64`` for 200 steps: the final
   ``PMCState``, the steps, the generator's state and the kernel's launches
   must be equal; it prints both walls, ms per step, launches per step, the
   capture time and both peak memories, and, at n = 1000, a profiled stretch
   of 64 steps of each side (idle share, device kernels and host reads per
   step), each with the card's name and power limit;
6. scheduling, the reference CLI instance (31 days x 7 employees from
   2022-05-09, 8 lanes, 4 rounds) with the random proposer, the dense proposer
   and the dense proposer with noisy selection, on the card and on the CPU from
   host-side draws: every state leaf must be equal;
7. scheduling at the JAX bench's size (365 days x 20 employees from
   2024-01-01, 10 holidays each): (a) the dense throughput arm, 64 lanes, 40
   rounds after a 4-round warm-up, which must reach hard 0, with its ms per
   lockstep iteration; (b) the random
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
   of an int64 host cost, and the timed run's peak and reserved memory are
   printed; one more round of each runs under ``torch.profiler`` (K1's events
   timed apart); every compact and incremental run on the card must launch K1,
   and every run K2a and K2b;
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
    for qap-1024 compact (K1, K2a and K2b launched) and for the nqueens main
    path (K2b and K2's ring form launched, K6 and K7 counted on the path);
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
    and K6's, K7's, K2b's and K2a's ring form's events; and ``roofline()`` of the
    main path's solver, of a main-path solver after one round and of qap-4096
    incremental with 4 lanes: every share at most 1.05, the state unchanged,
    each kernel's counted bytes its bytes per call times its launches (B1
    ``kernel_bytes``, K1 ``kernel_work``, K6 ``kernel_work``, K2 and K7 each
    launch plan's ``work``); the nqueens CLI must launch K7, K2's ring form
    and K2b, the qap CLI K2a, its ring form and K2b;
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
14. the benchmark's headline cell (``bench_torch/run.py``, ``BENCHMARK.json``'s
    ``nqueens1000_p256``) in this process with one repeat: its record must say
    ``correct``, the device must be the card, and every metric the benchmark
    names for the cell must hold a number, the kernel's from its own events.

Each path's kernel launches are counted from 0 just before it runs: B1's on the
N-Queens paths, K1's on phases 4c, 8, 11b and the QAP CLI, K2a's, its ring
form's and K2b's on phases 4, 4b, 4c, 8, 11b and the nqueens and QAP CLIs
(K2a's not on the N-Queens paths, whose moves K7 fingerprints), K3's, K4's,
K6's and K7's on phases 4, 4b, 4d, 11b, 12 and 14, K5's on phases 4c, 6, 7,
11a and 12 (the scheduling CLI and the service), each of which must launch it.  The line before the
last is a JSON object with each kernel's measurements; the last line
is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import json
import re
import subprocess
import threading
import time
from collections import Counter
from typing import Any, NamedTuple

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
FP32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
# Phase 2b: the probe harness's default shape (n = 1000 padded to 1024), and
# n = 16384 at 16 lanes with the harness's A = n // 20, where the float32 tables
# no longer fit a block's shared memory and the int16 and packed ones do; timed
# launches of the wrapper and of the plain version (several GB a call there).
PROBE_SHAPES = ((MAIN_P, MAIN_A, MAIN_N), (16, 819, 16384))
PROBE_LAUNCHES = {PROBE_SHAPES[0]: (TIMED_LAUNCHES, 20), PROBE_SHAPES[1]: (20, 3)}
HARNESS_ARGV = ["--packed", "--i16", "--mxu"]  # the ported harness at its default n, P and K
BENCH_CELL = "nqueens1000_p256"  # phase 14: the benchmark's headline cell
# Phase 2c: K1 (QAP's swap row minimum) at qap4096_inc_p4's shape and at phase
# 8's compact qap-1024 and qap-256 lanes (the ring path), and at a ragged n (the
# strip loop); its events in a profiler trace.
K1_SHAPES = ((4, 4096), (16, 1024), (64, 256), (5, 1003))
K1_EVENT = "qap_row_min"
K1_REPLACES = "constraint_solver_tpu/models/qap.py:202-224, :325-341 (XLA fusion, no Pallas call)"
# Phase 2d: K2 (the fingerprint hash), K2a's and K2b's events in a profiler trace.
K2A_EVENT, K2B_EVENT = "fp_hash_xor", "fingerprint_rows"
K2A_REPLACES = ("constraint_solver_tpu/ops/fingerprint.py:30-59, :89-95 (_mix32, position_hash_planes, "
                "position_hash, fp_update; XLA fusion, no Pallas call)")
K2B_REPLACES = ("constraint_solver_tpu/ops/fingerprint.py:30-86 (_mix32, position_hash, _xor_reduce, "
                "fingerprint_i32, fingerprint_f32; XLA fusion, no Pallas call)")
K2P_EVENT = "fp_hash_probe"  # K2a's ring form
K2P_REPLACES = ("constraint_solver_tpu/core/history.py:55-90 (TabuRing.push, TabuRing.is_tabu; used at "
                "core/local_search.py:130, :146, :210, :245; XLA fusion, no Pallas call)")
# Phase 2e: K3 (the block pick) at the N-Queens cells' shapes and a ragged one; its events in a profiler trace.
K3_SHAPES = ((MAIN_P, MAIN_A, MAIN_N), (16, 64, 16384))
K3_RAGGED = (5, 7, 1003)
K3_EVENT = "block_pick"
K3_REPLACES = ("constraint_solver_tpu/ops/lex.py:30-34 (make_score) via models/nqueens.py:327-329, :353, read at "
               "core/local_search.py:126, :144, :263 (lex_argmin, the pick's score; XLA fusion, no Pallas call)")
# Phase 2f: K4 (the masked N-Queens move) at the N-Queens cells' (P, A, n) and a ragged one (n % 8 = 7, its
# plan's S = 8), each at its plan and at S = 1 and 8; its events in a trace.
K4_SHAPES = ((MAIN_P, MAIN_A, MAIN_N), (16, 64, 16384))
K4_RAGGED = (5, 7, 16383)
K4_SLICES = (1, 8)
K4_EVENT = "nqueens_move"
L2_BYTES = 50 * 2**20  # H100 SXM's L2
K4_L2_SPAN = 4  # phase 2f times K4 over state copies whose rows, cs and best hold this many times the L2
K4_REPLACES = ("constraint_solver_tpu/models/nqueens.py:375-406 (apply_move) with core/local_search.py:107-108 "
               "(_select) at :281-283, :290 and :305-316 (XLA fusion, no Pallas call)")
# Phase 2g: K5 (the roster's dense neighborhood), its kernel's events in a trace.
K5_EVENT = "sched_d"  # the start of every K5 kernel's name (sched_dense_kernel)
K5_CALLS = 20  # timed calls of the wrapper (and of the plain version, a tenth as many)
K5_REPLACES = ("constraint_solver_tpu/models/scheduling.py:594-884 (neighborhood_dense) with :454-555 "
               "(exact_move_deltas; XLA fusion, no Pallas call)")
# Phase 2h: K6 (the N-Queens column sample and the block's inputs) and K7 (the
# fingerprints of N-Queens candidates), their events in a profiler trace.
K6_EVENT, K7_EVENT = "nqueens_sample", "fp_nq_move"
K6_SHAPES = ((MAIN_P, MAIN_N, MAIN_A), (16, 16384, 64))  # (P, n, A) of the two N-Queens cells
K6_REPLACES = ("constraint_solver_tpu/models/nqueens.py:196-238 (the Gumbel top-k sample around lax.top_k, "
               "col_valid, r and removed) with :106-110 (_take_1d; XLA fusion, no Pallas call)")
K7_REPLACES = ("constraint_solver_tpu/models/nqueens.py:365-373 (move_fp: the pick's decode and fp_update; "
               "XLA fusion, no Pallas call)")


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


def device_ms(fn, args, launches: int, event: str = KERNEL_EVENT) -> tuple[float, str]:
    """The kernel's device-only ms per launch: its own events (``event`` in
    their name) in a ``torch.profiler`` trace of ``launches`` calls or, where
    the trace holds none, the replay of a CUDA graph of the calls timed with
    CUDA events.  Returns (ms, the source of the number)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn(*args)
        torch.cuda.synchronize()
    us = [
        e.time_range.elapsed_us() for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and event in e.name
    ]
    if len(us) == launches:
        return sum(us) / 1e3 / launches, "profiler"
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn(*args)
    graph.replay()  # warm-up
    return time_ms(graph.replay, (), 1) / launches, f"CUDA graph replay; {len(us)} of its events in the trace"


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


def bound_of(ops: int, nbytes: int) -> tuple[float, str]:
    """The least ms on the card: bytes over 3.35 TB/s or operations over 67 T/s, the larger."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def probe_bound(name: str, shape) -> tuple[float, str]:
    """A probe's least time on the card, ms: the larger of its bytes over the
    HBM rate and its operations over the float32 rate (``probe_work``), and
    which of the two it is."""
    from constraint_solver_tpu_torch.ops import nqueens_probes as npr

    return bound_of(*npr.probe_work(name, *shape))


def assert_outputs_equal(want, got, what: str) -> None:
    import torch

    for i, (w, g) in enumerate(zip(want, got, strict=True)):
        if w.shape != g.shape or w.dtype != g.dtype or not torch.equal(w, g):
            raise AssertionError(
                f"{what}: output {i} differs ({tuple(w.shape)} {w.dtype} vs {tuple(g.shape)} {g.dtype})"
            )


def time_probe(name: str, args, shape, launches: int, plain_launches: int) -> dict:
    """One probe at one shape: CUDA-event ms of its wrapper and of its plain
    version in turns (plain, kernel, kernel, plain), device-only ms from its
    profiler events, the wrapper's host us, the bound and the share."""
    from constraint_solver_tpu_torch.ops import nqueens_probes as npr

    kern, plain = npr.WRAPPERS[name], npr.REFS[name]
    time_ms(kern, args, 3)  # warm-up
    plain_ms = [time_ms(plain, args, plain_launches)]
    kern_ms = [time_ms(kern, args, launches) for _ in range(2)]
    plain_ms.append(time_ms(plain, args, plain_launches))
    dev, how = device_ms(kern, args, launches, npr.PROBES[name].event)
    host = min(host_us(kern, args, launches) for _ in range(2))
    bound, by = probe_bound(name, shape)
    plan = npr.launch_plan(name, *shape)
    log(
        f"phase 2b: {name} at (P, A, n) = {shape}: device-only {dev:.6f} ms per launch ({how}); wrapper "
        f"{kern_ms} ms, plain {plain_ms} ms (CUDA events, {launches} / {plain_launches} calls); host "
        f"{host:.1f} us per call; bound {bound:.6f} ms by {by} ({npr.probe_work(name, *shape)[1]} bytes), "
        f"share {bound / dev:.3f}; plan {tuple(plan)}"
    )
    return {
        "ms": sum(kern_ms) / 2, "plain_ms": sum(plain_ms) / 2, "device_ms": dev, "host_us": host,
        "bound_ms": bound, "bound_by": by, "bound_share": bound / dev, "launch_plan": list(plan),
    }


def probe_plan_variants(name: str, args, shape, want) -> dict:
    """Device-only ms of a staged probe under variants of its plan, each held
    against the plain version: its tables read from global memory, and 16 or
    32 columns per block (one block per SM holds more warps)."""
    import torch

    from constraint_solver_tpu_torch.ops import nqueens_probes as npr

    p, a, n = shape
    rc, dc, ac, c, r, removed, cur = args
    plan = npr.launch_plan(name, *shape)
    variants = {"tables from global memory": plan._replace(staged=False, smem_bytes=0)}
    for g in (16, 32):
        variants[f"{g} columns per block"] = plan._replace(cols_per_block=g, grid=(-(-a // g), p))
    tables = npr.prepare_tables(npr.PROBES[name].table, rc, dc, ac)
    out = {}
    for label, variant in variants.items():
        outs = tuple(torch.empty_like(w) for w in want)

        def call(variant=variant, outs=outs):
            npr._launch(name, tables, c, r, removed, cur, outs, p, a, n, variant)

        call()
        torch.cuda.synchronize()
        assert_outputs_equal(want, outs, f"{name} under {variant} at {shape}")
        out[label], _ = device_ms(call, (), PROBE_LAUNCHES[shape][0], npr.PROBES[name].event)
        log(f"phase 2b: {name} at (P, A, n) = {shape}, {label} {tuple(variant)}: device-only {out[label]:.6f} ms")
    return out


def phase_probes(device) -> tuple[list, dict]:
    """Phase 2b: the five probe kernels of ``bench/kernel_iso.py``.  Returns
    their entries of the kernels line and B1's numbers at the large shape."""
    import torch

    from constraint_solver_tpu_torch.bench import kernel_iso
    from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
    from constraint_solver_tpu_torch.ops import nqueens_probes as npr

    t0 = time.time()
    rng = np.random.default_rng(2)
    per = {name: {"max_abs_err": 0.0} for name in npr.PROBES}
    b1 = {}
    for shape in PROBE_SHAPES:
        args = kernel_inputs(rng, *shape, device)
        outs = {}
        for name in npr.PROBES:
            got = npr.WRAPPERS[name](*args)
            torch.cuda.synchronize()
            want = npr.REFS[name](*args)
            assert_outputs_equal(want, got, f"{name} != its plain version at {shape}")
            per[name]["max_abs_err"] = max(per[name]["max_abs_err"], float((got[0] - want[0]).abs().max()))
            log(f"phase 2b: {name} == plain version bit for bit at (P, A, n) = {shape}, n_pad {npr.padded(shape[2])}")
            outs[name] = got
            per[name][shape] = time_probe(name, args, shape, *PROBE_LAUNCHES[shape])
            if npr.launch_plan(name, *shape).staged and shape != PROBE_SHAPES[0]:
                per[name][shape]["plan_probe_ms"] = probe_plan_variants(name, args, shape, want)
            del want
        if shape == PROBE_SHAPES[0]:
            # rc of 4s, dc and ac of 2s: every valid column's three terms sum to at
            # least 5, a padding column's (rc 0 there) to at most 4, so only the
            # kernels' masks keep the padding out of the min.
            twos = tuple(torch.full_like(t, v) for t, v in zip(args[:3], (4.0, 2.0, 2.0)))
            for name in ("kern_i16min", "kern_packed"):
                got = npr.WRAPPERS[name](*twos, *args[3:])
                assert_outputs_equal(npr.REFS[name](*twos, *args[3:]), got, f"{name} on constant tables at {shape}")
                if not bool((got[0].amin(dim=-1) < got[1]).all()):
                    raise AssertionError(f"{name}: the padding columns do not test the row-min mask")
            log(f"phase 2b: kern_i16min and kern_packed skip the padding columns in the row min at {shape}")
        if shape[2] == npr.padded(shape[2]):
            # B1 computes B2d's and B2e's function where n = n_pad: the like-for-like yardstick.
            got = nk.nqueens_neighborhood_scores(*args)
            for name in ("kern_i16min", "kern_packed"):
                assert_outputs_equal(got, outs[name], f"B1 != {name} at {shape}")
            dev, how = device_ms(nk.nqueens_neighborhood_scores, args, PROBE_LAUNCHES[shape][0])
            host = min(host_us(nk.nqueens_neighborhood_scores, args, PROBE_LAUNCHES[shape][0]) for _ in range(2))
            bound = kernel_bound_ms(*shape)
            b1[shape] = {"device_ms": dev, "host_us": host, "bound_ms": bound, "bound_share": bound / dev,
                         "launch_plan": list(nk._launch_plan(*shape))}
            log(f"phase 2b: B1 (nqueens_neighborhood_scores) == kern_i16min == kern_packed at (P, A, n) = {shape}; "
                f"device-only {dev:.6f} ms ({how}), host {host:.1f} us, bound {bound:.6f} ms "
                f"({kernel_bytes(*shape)} bytes), share {bound / dev:.3f}, plan {nk._launch_plan(*shape)}")
        del args, outs
        torch.cuda.empty_cache()

    # The harness's path: every probe's count from 0 just before it, read just after.
    for fn in npr.WRAPPERS.values():
        fn.launches = 0
    t1 = time.time()
    iso = kernel_iso.main(HARNESS_ARGV)
    launches = {name: fn.launches for name, fn in npr.WRAPPERS.items()}
    want = iso["arms"]["torch slice block"]["acc"]
    for arm, res in iso["arms"].items():
        same = bool(torch.equal(res["acc"], want))
        if arm.startswith(("base", "packed", "i16")) and not same:
            raise AssertionError(f"harness arm {arm!r}: its sums differ from the plain slice block's")
        if not arm.startswith("noroll"):
            log(f"phase 2b: harness arm {arm!r}: sums {'equal' if same else 'differ from'} the plain slice "
                f"block's (max |delta| {float((res['acc'] - want).abs().max())})")
    log(f"phase 2b: harness {HARNESS_ARGV} in {time.time() - t1:.1f} s; launches {launches}")
    arm_of = {"kern_base": "base f32", "kern_noroll": "noroll (timing only)", "kern_i16": "i16 tables",
              "kern_i16min": "i16 + row min/argmin", "kern_packed": "packed 1-roll + min"}
    entries = []
    main_shape, large = PROBE_SHAPES
    for name, probe in npr.PROBES.items():
        main = per[name][main_shape]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "constraint_solver_tpu_torch/csrc/nqueens_probes.cu",
            "replaces": f"bench/kernel_iso.py:{probe.body_line}",
            "launches": launches[name],
            "launches_by_path": {"kernel_iso": launches[name]},
            "max_abs_err": per[name]["max_abs_err"],
            **{k: main[k] for k in ("ms", "plain_ms", "device_ms", "host_us", "bound_ms", "bound_by",
                                    "bound_share", "launch_plan")},
            "library_ms": None,
            "x".join(map(str, large)): per[name][large],
            "harness_ms_per_iter": iso["arms"][arm_of[name]]["ms_per_iter"],
        })
    log(f"phase 2b: {time.time() - t0:.1f} s; harness ms/iter "
        f"{ {arm: round(res['ms_per_iter'], 6) for arm, res in iso['arms'].items()} }")
    return entries, {"x".join(map(str, s)): v for s, v in b1.items()}


def k1_inputs(kind: str, p: int, n: int, device) -> tuple:
    """K1's arguments (h, g, flow, cur) at (P, n): "qap" is the solver's own
    data, G = D[p][:, p] and H = F G of random permutations of
    ``QAPSpec.random(n, seed=0)`` with each lane's cost, cur a strided view of
    the score as the neighborhoods pass it; "float" holds non-integer floats,
    whose operations round."""
    import torch

    from constraint_solver_tpu_torch.models.qap import QAPSpec

    gen = torch.Generator(device=device).manual_seed(p * 100_003 + n)
    if kind == "qap":
        flow_np, dist_np = QAPSpec.random(n, seed=0).arrays()
        flow, dist = torch.from_numpy(flow_np).to(device), torch.from_numpy(dist_np).to(device)
        perm = torch.argsort(torch.rand((p, n), generator=gen, device=device), dim=1)
        rows = dist[perm]
        g = rows.gather(2, perm[:, None, :].expand(rows.shape)).contiguous()
        h = torch.matmul(flow, g)
        score = torch.stack([(flow * g).sum(dim=(1, 2)), torch.zeros(p, device=device)], dim=1)
        return h, g, flow, score[:, 0]
    h = torch.randn((p, n, n), generator=gen, device=device) * 1e3
    g = torch.randn((p, n, n), generator=gen, device=device)
    flow = torch.randn((n, n), generator=gen, device=device) * 10.0
    return h, g, flow, torch.randn((p,), generator=gen, device=device) * 1e3 + 1e5


def k1_bound(p: int, n: int) -> tuple[float, str]:
    """K1's least time on the card, ms (``kernel_work``'s bytes over the HBM
    rate or its operations over the float32 rate, the larger), and which."""
    from constraint_solver_tpu_torch.ops import qap_row_min as qrm

    return bound_of(*qrm.kernel_work(p, n))


def assert_k1_equal(got, want, what: str) -> float:
    """rmin's bits and rarg equal (NaNs compared as NaN); returns the largest
    |rmin - plain| over the finite entries."""
    import torch

    (rmin, rarg), (wmin, warg) = got, want
    nan = rmin.isnan()
    if not (rarg.dtype == warg.dtype == torch.int64 and torch.equal(rarg, warg) and torch.equal(nan, wmin.isnan())
            and torch.equal(rmin[~nan].view(torch.int32), wmin[~nan].view(torch.int32))):
        raise AssertionError(f"phase 2c: K1 != its plain version ({what})")
    finite = rmin.isfinite() & wmin.isfinite()
    return float((rmin[finite] - wmin[finite]).abs().max()) if bool(finite.any()) else 0.0


def phase_k1(device, shapes=K1_SHAPES) -> dict:
    """2c. K1 against its plain version bit for bit at each shape, on the
    solver's data and on non-integer floats; then, on the solver's data, its
    device-only ms per launch, the wrapper's host us, its time and the plain
    version's (the eager chain it replaces) by CUDA events in turns, the bound
    and the share.  Returns K1's entry of the kernels line (its launches are
    filled in by the paths)."""
    import torch

    from constraint_solver_tpu_torch.ops import qap_row_min as qrm

    t0 = time.time()
    per, max_err = {}, 0.0
    kern_fn, plain_fn = qrm.qap_swap_row_min, qrm.qap_swap_row_min_ref
    for p, n in shapes:
        plan = qrm._launch_plan(p, n)
        for kind in ("float", "qap"):
            args = k1_inputs(kind, p, n, device)
            got = kern_fn(*args)
            torch.cuda.synchronize()
            max_err = max(max_err, assert_k1_equal(got, plain_fn(*args), f"{kind} at (P, n) = {(p, n)}"))
            log(f"phase 2c: K1 == plain version bit for bit at (P, n) = {(p, n)}, {kind} inputs, {plan.path} path")
        calls, plain_calls = (20, 10) if n >= 4096 else (TIMED_LAUNCHES, TIMED_LAUNCHES)
        for fn in (kern_fn, plain_fn):
            time_ms(fn, args, 3)  # warm-up
        plain = [time_ms(plain_fn, args, plain_calls)]
        kern = [time_ms(kern_fn, args, calls) for _ in range(2)]
        plain.append(time_ms(plain_fn, args, plain_calls))
        dev, how = device_ms(kern_fn, args, calls, K1_EVENT)
        host = min(host_us(kern_fn, args, calls) for _ in range(2))
        bound, by = k1_bound(p, n)
        per[(p, n)] = {"ms": sum(kern) / 2, "plain_ms": sum(plain) / 2, "device_ms": dev, "host_us": host,
                       "bound_ms": bound, "bound_by": by, "bound_share": bound / dev, "launch_plan": list(plan),
                       "k1_tb_per_s": qrm.kernel_work(p, n)[1] / dev / 1e9}
        if (p, n) == shapes[0]:
            # What this card streams on a plain read: torch.sum over H (not K1's function; a yardstick of the rate).
            sum_ms = time_ms(lambda t: t.sum(), args[:1], calls)
            per[(p, n)]["sum_h_tb_per_s"] = args[0].numel() * 4 / sum_ms / 1e9
            log(f"phase 2c: read yardstick at (P, n) = {(p, n)}: torch.sum over H ({args[0].numel() * 4} bytes) "
                f"{sum_ms:.6f} ms, {per[(p, n)]['sum_h_tb_per_s']:.3f} TB/s; K1 {per[(p, n)]['k1_tb_per_s']:.3f} TB/s")
        log(f"phase 2c: K1 at (P, n) = {(p, n)}, plan {plan}: {kern} ms, eager chain (the plain version) {plain} ms (CUDA "
            f"events, {calls} / {plain_calls} calls); device-only {dev:.6f} ms per launch ({how}); host {host:.1f} "
            f"us per call; bound {bound:.6f} ms ({qrm.kernel_work(p, n)[1]} bytes at {HBM_BYTES_PER_S / 1e12} "
            f"TB/s), share {bound / dev:.3f}; eager chain / K1 {per[(p, n)]['plain_ms'] / per[(p, n)]['ms']:.2f}x")
        del args, got
        torch.cuda.empty_cache()
    main = per[shapes[0]]
    log(f"phase 2c: {time.time() - t0:.1f} s")
    return {
        "name": qrm.KERNEL_NAME,
        "route": "cuda",
        "source": "constraint_solver_tpu_torch/csrc/qap_row_min.cu",
        "replaces": K1_REPLACES,
        "max_abs_err": max_err,
        **main,
        "library_ms": None,
        "shapes": {"x".join(map(str, s)): v for s, v in per.items()},
    }


def k2_wrappers() -> dict:
    """K2's three counted wrappers: K2a ``hash_xor``, K2b ``fingerprint_i32``
    and K2a's ring form ``hash_probe``."""
    from constraint_solver_tpu_torch.ops import fingerprint as fpk

    return {"K2a": fpk.hash_xor, "K2b": fpk.fingerprint_i32, "K2a-ring": fpk.hash_probe}


def k2_reset() -> None:
    """K2's launch counters (and their plans) to 0."""
    for wrapper in k2_wrappers().values():
        wrapper.launches = 0
        wrapper.shapes = Counter()


def k2_launches() -> dict:
    return {name: wrapper.launches for name, wrapper in k2_wrappers().items()}


def require_k2(launches: dict, what: str, kernels=None) -> None:
    """On the card, each of ``kernels`` (by default K2a, K2b and K2a's ring form) must have launched."""
    kernels = kernels or ("K2a", "K2b", "K2a-ring")
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{what}: K2 ({', '.join(missing)}) never launched: {launches}")


NQ_K2 = ("K2b", "K2a-ring")  # K2's kernels on the N-Queens paths, whose moves' fingerprints K7 writes


def k67_wrappers() -> dict:
    """K6's and K7's counted wrappers."""
    from constraint_solver_tpu_torch.ops import fingerprint as fpk
    from constraint_solver_tpu_torch.ops import nqueens_sample as ns

    return {"K6": ns.nqueens_sample, "K7": fpk.nqueens_move_fp}


def k67_reset() -> None:
    for wrapper in k67_wrappers().values():
        wrapper.launches = 0


def k67_launches() -> dict:
    return {name: wrapper.launches for name, wrapper in k67_wrappers().items()}


def require_k67(launches: dict, what: str) -> None:
    """On the card, K6 and K7 must have launched."""
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"{what}: {', '.join(missing)} never launched: {launches}")


def require_k3(pair: dict, what: str) -> None:
    """On the card, K3 must have launched on both sides of a graphed-against-eager pair."""
    launches = (pair["eager"]["k3_launches"], pair["graphed"]["k3_launches"])
    if 0 in launches:
        raise AssertionError(f"{what}: K3 (block_pick) never launched (eager, graphed): {launches}")


def require_k4(pair: dict, what: str) -> None:
    """On the card, K4 must have launched on both sides of a graphed-against-eager pair."""
    launches = (pair["eager"]["k4_launches"], pair["graphed"]["k4_launches"])
    if 0 in launches:
        raise AssertionError(f"{what}: K4 (nqueens_move) never launched (eager, graphed): {launches}")


def k2_cases(device) -> list:
    """(label, kernel, wrapper call, plain call, arguments, timed) at the shapes
    the solvers give K2, then on adversarial values."""
    import torch

    from constraint_solver_tpu_torch.ops import fingerprint as fpk

    gen = torch.Generator(device=device).manual_seed(17)

    def ints(shape, high, dtype=torch.int64):
        return torch.randint(0, high, shape, generator=gen, device=device, dtype=dtype)

    def planes(base, terms):
        return fpk.hash_xor(base, terms, planes=True)

    def planes_ref(base, terms):
        return fpk.hash_xor_ref(base, terms, planes=True)

    cases = []
    for p, n in ((MAIN_P, MAIN_N), (16, 16384)):  # the N-Queens move: fp_update at [P]
        args = (ints((p, 2), 2**32), ints((p,), n), ints((p,), n), ints((p,), n))
        cases.append((f"fp_update [{p}]", "K2a", fpk.fp_update, fpk.fp_update_ref, args, True))
    a, b, pa, pb = (ints((4,), 4096) for _ in range(4))  # QAP's swap: base and four terms at [4]
    cases.append(("qap swap [4]", "K2a", fpk.hash_xor, fpk.hash_xor_ref,
                  (ints((4, 2), 2**32), ((a, pa), (a, pb), (b, pb), (b, pa))), True))
    p, d, e, off, rand = 64, 365, 20, 4, 256  # the roster cell's neighborhood
    asg = ints((p, d), e)
    d1, d2 = ints((p, rand), d), ints((p, rand), d)
    e1, e2 = asg.gather(1, d1), asg.gather(1, d2)
    cases.append(("roster swaps [64, 256]", "K2a", planes, planes_ref,
                  (None, ((d1, e1), (d1, e2), (d2, e2), (d2, e1))), True))
    iota = torch.arange(d, device=device)
    d1_b, a_b = iota.expand(p, off, d), asg[:, None, :].expand(p, off, d)  # expanded views, as the proposer passes them
    a2, d2_sw = ints((p, off, d), e), ints((p, off, d), d)
    cases.append(("roster diagonals [64, 4, 365]", "K2a", planes, planes_ref,
                  (None, ((d1_b, a_b), (d1_b, a2), (d2_sw, a2), (d2_sw, a_b))), True))
    cases.append(("roster dense block [64, 365, 20]", "K2a", planes, planes_ref,
                  (None, ((iota[:, None], asg[..., None]), (iota[:, None], torch.arange(e, device=device)))), True))
    # Adversarial: Ackley's move on float bits (-0.0, NaN payloads, infinities, negative int32 views) at
    # [64, 20], positions and values at and past 2^32 - 1 in int64.
    bits = torch.randn((64, 20), generator=gen, device=device) * 1e3
    bits[0, :6] = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"), -1.0], device=device)
    bits = bits.view(torch.int32)
    bits[1, :3] = torch.tensor([0x7FC00123, -0x00400001, -2**31], dtype=torch.int32, device=device)  # NaN payloads
    big = torch.tensor([2**32 - 1, 2**32, 2**33 + 5, -1, -2**40, 2**31], device=device)
    pos = ints((64, 20), 2**62)
    pos[0, :6] = big
    cases.append(("adversarial [64, 20]", "K2a", fpk.hash_xor, fpk.hash_xor_ref,
                  (ints((64, 1, 2), 2**32), ((pos, bits), (pos, bits.flip(1)), (big[:1], -pos))), False))
    for shape in ((MAIN_P, MAIN_N), (16, 16384), (4, 4096), (64, 365)):  # each descent's start, the archive
        cases.append((f"rows {shape}", "K2b", fpk.fingerprint_i32, fpk.fingerprint_i32_ref, (ints(shape, shape[1]),),
                      True))
    cases.append(("rows adversarial float bits [64, 20]", "K2b", fpk.fingerprint_i32, fpk.fingerprint_i32_ref,
                  (bits,), False))
    cases.append(("rows adversarial int64 [8, 1000]", "K2b", fpk.fingerprint_i32, fpk.fingerprint_i32_ref,
                  (torch.cat([big.expand(8, 6), ints((8, 994), 2**62) - 2**61], dim=1),), False))
    cases.append(("rows adversarial strided int32 [8, 777]", "K2b", fpk.fingerprint_i32, fpk.fingerprint_i32_ref,
                  (ints((8, 1554), 2**31, torch.int32).sub(2**30)[:, ::2],), False))
    return cases


def probe_ring(rng, device, p, t, fill, count=None, expiry=1000, head=None):
    """A ``TabuRing`` of P lanes and T slots as a descent leaves it: the first
    ``fill`` slots written (fingerprints in [0, 2^32), stamps up to two expiries
    before the count), the others never written ((0, 0), stamp -(2^31 - 1));
    ``count``, ``expiry`` and ``head`` as given, else drawn."""
    import torch

    from constraint_solver_tpu_torch.core.history import TabuRing

    fps = rng.integers(0, 2**32, size=(p, t, 2))
    fps[:, fill:] = 0
    cnt = rng.integers(fill, fill + 50, size=p) if count is None else np.full(p, count)
    iters = np.full((p, t), -(2**31 - 1), dtype=np.int64)
    iters[:, :fill] = cnt[:, None] - rng.integers(0, 2 * expiry + 1, size=(p, min(fill, t)))
    hd = rng.integers(0, t, size=p) if head is None else np.full(p, head)
    i32 = lambda x: torch.from_numpy(np.asarray(x, dtype=np.int64).astype(np.int32)).to(device)  # noqa: E731
    return TabuRing(torch.from_numpy(fps).to(device), i32(iters), i32(hd), i32(cnt), i32(np.full(p, expiry)))


def probe_candidates(rng, ring, w, share):
    """[P, W, 2] fingerprints, ``share`` of them copied from the ring's slots."""
    import torch

    p, t = ring.fps.shape[:2]
    fresh = torch.from_numpy(rng.integers(0, 2**32, size=(p, w, 2))).to(ring.fps.device)
    src = torch.from_numpy(rng.integers(0, t, size=(p, w))).to(ring.fps.device)
    take = torch.from_numpy(rng.random((p, w)) < share).to(ring.fps.device)
    lane = torch.arange(p, device=ring.fps.device)[:, None]
    return torch.where(take[..., None], ring.fps[lane, src], fresh)


def probe_cases(device) -> list:
    """(label, "K2a-ring", ``hash_probe``, ``hash_probe_ref``, arguments (ring,
    push_fp, fps, base, deltas, valid), timed) at the shapes the descents give
    K2a's ring form, then on adversarial rings."""
    import torch

    from constraint_solver_tpu_torch.ops import fingerprint as fpk

    rng = np.random.default_rng(18)
    cases = []

    def case(label, ring, push=None, fps=None, base=None, deltas=None, valid=None, timed=False):
        cases.append((label, "K2a-ring", fpk.hash_probe, fpk.hash_probe_ref, (ring, push, fps, base, deltas, valid),
                      timed))

    def fresh(p):
        return torch.from_numpy(rng.integers(0, 2**32, size=(p, 2))).to(device)

    def mask(shape, share):
        return torch.from_numpy(rng.random(shape) < share).to(device)

    # The picks of pick-then-check: the headline [256] and nqueens-16384 [16] against rings of 256, qap-4096 [4]
    # against 128; the push (present in half the lanes) and the check in one launch, then a retry's check alone.
    for p, t in ((MAIN_P, 256), (16, 256), (4, 128)):
        ring = probe_ring(rng, device, p, t, fill=t // 2 + 40)
        push = torch.where(mask((p, 1), 0.5), ring.fps[:, 3], fresh(p))
        fp0 = probe_candidates(rng, ring, 1, 0.5)
        case(f"pick [{p}] ring {t}", ring, push, fp0, valid=mask((p, 1), 0.9), timed=True)
        case(f"retry [{p}] ring {t}", ring, fps=fp0, valid=mask((p,), 0.5)[:, None], timed=p == MAIN_P)
    # The roster's exact filter: base ^ deltas of its 365 x 20 + 256 + 4 x 365 candidates against a ring of 64,
    # the deltas a [P, W, 2] view of two planes as the dense proposer stacks them.
    p, t, w = 64, 64, 365 * 20 + 256 + 4 * 365
    ring = probe_ring(rng, device, p, t, fill=t)
    cur = fresh(p)
    deltas = probe_candidates(rng, ring, w, 0.02) ^ cur[:, None, :]
    case(f"roster exact filter [{p}, {w}] ring {t}", ring, cur, base=cur, deltas=deltas, valid=mask((p, w), 0.95),
         timed=True)
    # Adversarial rings.
    p, t = 8, 16
    ring = probe_ring(rng, device, p, t, fill=t, count=100)
    dup = ring.fps[:, 5].clone()
    ring.fps[:, 9], ring.fps[:, 12] = dup, dup  # one fingerprint in three slots: the first wins
    case("a fingerprint in three slots, pushed", ring, dup, dup[:, None, :].expand(p, 3, 2))
    ring = probe_ring(rng, device, p, t, fill=t, count=100, head=t - 1)
    case("a full ring wrapping its head", ring, fresh(p), probe_candidates(rng, ring, 40, 0.5))
    ring = probe_ring(rng, device, p, t, fill=5, count=3000, expiry=10)  # stamps 3000-20..3000: some expired
    zero = torch.zeros((p, 4, 2), dtype=torch.int64, device=device)
    zero[:, 1], zero[:, 2] = ring.fps[:, 0], ring.fps[:, 1]
    case("expired and never-written slots against (0, 0)", ring, fps=zero)
    case("expired and never-written slots, (0, 0) pushed", ring, torch.zeros((p, 2), dtype=torch.int64, device=device),
         zero)
    ring = probe_ring(rng, device, p, t, fill=t, count=50, expiry=2**31 - 1)
    ring.iters[:, :8] = torch.tensor([5, -5, 2**31 - 1, -2**31, 0, 100, 49, 51], dtype=torch.int32, device=device)
    case("expiry 2^31 - 1: stamp + expiry wraps", ring, ring.fps[:, 2].clone(), ring.fps.clone())
    ring = probe_ring(rng, device, p, t, fill=t, count=2**31 - 1, expiry=3)
    ring.iters[:, :4] = torch.tensor([2**31 - 1, 2**31 - 2, -2**31, 2**31 - 4], dtype=torch.int32, device=device)
    case("count 2^31 - 1: the push wraps it", ring, fresh(p), ring.fps.clone())
    for head in (2**31 - 1, t + 3, -1):
        ring = probe_ring(rng, device, p, t, fill=t, head=head)
        case(f"head {head}", ring, fresh(p), probe_candidates(rng, ring, 7, 0.5))
    for t in (1025, 2500):  # more slots than one shared-memory tile
        ring = probe_ring(rng, device, 3, t, fill=t - t // 4, expiry=200)
        cur = fresh(3)
        cands = probe_candidates(rng, ring, 700, 0.4)
        case(f"ring {t} (tiles of {fpk.PROBE_TILE}), pushed", ring, ring.fps[:, t // 2].clone(), base=cur,
             deltas=cands ^ cur[:, None, :], valid=mask((3, 700), 0.9))
        case(f"ring {t} (tiles of {fpk.PROBE_TILE})", ring, fps=cands)
    ring = probe_ring(rng, device, 4, 32, fill=32)
    case("no candidate, pushed", ring, ring.fps[:, 0].clone(), torch.zeros((4, 0, 2), dtype=torch.int64, device=device))
    case("plane-strided candidates, expanded valid", ring, ring.fps[:, 7].clone(),
         torch.stack([ring.fps[..., 0], ring.fps[..., 1]]).permute(1, 2, 0),
         valid=torch.ones((1, 1), dtype=torch.bool, device=device).expand(4, 32))
    return cases


def outputs_equal(got, want) -> bool:
    """K2's outputs bit for bit: a tensor, or the ring form's (ring, tabu or ok),
    every field of the ring."""
    import torch

    if isinstance(got, torch.Tensor):
        return got.dtype == want.dtype and torch.equal(got, want)
    (g_ring, g_out), (w_ring, w_out) = got, want
    return all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip((*g_ring, g_out), (*w_ring, w_out)))


def phase_k2(device, cases=None) -> list:
    """2d. K2a and K2b against their plain versions bit for bit at the solvers'
    shapes and on adversarial values; then, at the solvers' shapes, each
    kernel's device-only ms per launch (its events in a ``torch.profiler``
    trace), the wrapper's host us, its time and the plain chain's by CUDA events
    in turns, and the bound with the share reached; then K2a's ring form
    likewise (``probe_cases``).  Returns K2a's, K2b's and the ring form's
    entries of the kernels line (main shapes: the headline's ``fp_update`` at
    [256], its (256, 1000) rows and its pick against a ring of 256; launches
    filled in by the paths)."""
    import torch

    from constraint_solver_tpu_torch.ops import fingerprint as fpk
    from constraint_solver_tpu_torch.utils import roofline

    t0 = time.time()
    names = {"K2a": fpk.HASH_KERNEL, "K2b": fpk.ROWS_KERNEL, "K2a-ring": fpk.PROBE_KERNEL}
    events = {"K2a": K2A_EVENT, "K2b": K2B_EVENT, "K2a-ring": K2P_EVENT}
    per = {"K2a": {}, "K2b": {}, "K2a-ring": {}}
    max_err = {"K2a": 0.0, "K2b": 0.0, "K2a-ring": 0.0}
    card = card_line() if is_cuda(device) else "cpu"
    for label, kernel, fn, plain, args, timed in cases or (k2_cases(device) + probe_cases(device)):
        got, want = fn(*args), plain(*args)
        sync(device)
        if (kernel != "K2a-ring" and got.dtype != torch.int64) or not outputs_equal(got, want):
            raise AssertionError(f"phase 2d: {kernel} != its plain version ({label})")
        if kernel != "K2a-ring":
            max_err[kernel] = max(max_err[kernel], float((got - want).abs().max()))
        shape = tuple(got[1].shape) if kernel == "K2a-ring" else tuple(got.shape)
        plan = ""
        if kernel == "K2b":
            rp = fpk._rows_plan(args[0].shape, args[0].stride(), args[0].dtype)
            plan = f" ({rp.warps_per_row} warps a row, {rp.splits} blocks a row, grid {rp.grid})"
        elif kernel == "K2a-ring":
            pp = fpk.probe_plan(*args)[0]
            plan = f" ({pp.per_thread} candidates a thread, {pp.chunks} blocks a lane, {pp.tiles} ring tiles)"
        log(f"phase 2d: {kernel} == plain version bit for bit at {label}, output {shape}{plan}")
        if not timed:
            continue
        with roofline.counting() as count:
            fn(*args)
        work = count.kernels[names[kernel]]
        bound, by = bound_of(work["flops"], work["bytes"])
        if not is_cuda(device):
            per[kernel][label] = {"bound_ms": bound, "bound_by": by, "bytes": work["bytes"], "operations": work["flops"]}
            continue
        for f in (fn, plain):
            time_ms(f, args, 3)  # warm-up
        plain_ms = [time_ms(plain, args, TIMED_LAUNCHES)]
        kern = [time_ms(fn, args, TIMED_LAUNCHES) for _ in range(2)]
        plain_ms.append(time_ms(plain, args, TIMED_LAUNCHES))
        dev, how = device_ms(fn, args, TIMED_LAUNCHES, events[kernel])
        host = min(host_us(fn, args, TIMED_LAUNCHES) for _ in range(2))
        per[kernel][label] = {"ms": sum(kern) / 2, "plain_ms": sum(plain_ms) / 2, "device_ms": dev, "host_us": host,
                              "bound_ms": bound, "bound_by": by, "bound_share": bound / dev, "bytes": work["bytes"],
                              "operations": work["flops"]}
        log(f"phase 2d: {kernel} at {label}: {kern} ms by CUDA events over {TIMED_LAUNCHES} calls (host-bound: "
            f"the wrapper's enqueue), plain chain {plain_ms} ms; device-only {dev * 1e3:.3f} us per launch ({how}); "
            f"host {host:.1f} us per call; bound {bound * 1e3:.4f} us ({work['bytes']} bytes at "
            f"{HBM_BYTES_PER_S / 1e12} TB/s, {work['flops']} operations at {FP32_OPS_PER_S / 1e12} T/s: {by}), share "
            f"{bound / dev:.3f}; plain chain / wrapper {per[kernel][label]['plain_ms'] / per[kernel][label]['ms']:.2f}x; "
            f"{card}")
    log(f"phase 2d: {time.time() - t0:.1f} s")
    entries = []
    for kernel, main, replaces in (("K2a", f"fp_update [{MAIN_P}]", K2A_REPLACES),
                                   ("K2b", f"rows {(MAIN_P, MAIN_N)}", K2B_REPLACES),
                                   ("K2a-ring", f"pick [{MAIN_P}] ring 256", K2P_REPLACES)):
        entries.append({
            "name": names[kernel],
            "route": "cuda",
            "source": "constraint_solver_tpu_torch/csrc/fingerprint.cu",
            "replaces": replaces,
            "max_abs_err": max_err[kernel],
            **per[kernel][main],
            "library_ms": None,
            "shapes": per[kernel],
        })
    return entries


def k3_row_minima(rng, row_arg, c: int, k: int):
    """[P, k] int64: the flat indices of the first minima of k distinct rows a
    lane, in rows of C = ``c`` candidates."""
    import torch

    p, r = row_arg.shape
    rows = torch.from_numpy(np.argsort(rng.random((p, r)), axis=1)[:, :k]).to(row_arg.device)
    return (rows * c + row_arg.gather(1, rows).long()).contiguous()


def k3_retry(rng, row_arg, c: int, k: int, e: int = 8):
    """[P, e] int64: a retry's exclusion list with the first minima of k rows
    a lane, the other slots -1 (the descent's lists are ``tabu_retries`` = 8
    slots, filled one a retry)."""
    import torch

    excl = k3_row_minima(rng, row_arg, c, k)
    pad = torch.full((row_arg.shape[0], e - k), -1, dtype=torch.int64, device=row_arg.device)
    return torch.cat([excl, pad], dim=1).contiguous()


def k3_traps(rng, device, p=16, a=64, n=16384):
    """A row block at (p, a, n) of integers 2-5 whose lanes hold, in turn,
    traps for a cluster's merge in 3 queued rows of 8 (the rows q = 1, 4, 7 of
    the queue, in the blocks 1, 4 and 7 of 8): ties at 1.0 whose lowest index
    is in a later block than a tie that block 0 holds (an unqueued row's first
    minimum); a NaN only in the last queued row, after an excluded one; -0.0
    in an earlier block and 0.0 in a later one; the same the other way round.
    Each planted row holds its value twice, the first (its row_arg) excluded."""
    import torch

    hard = torch.from_numpy(rng.integers(2, 6, size=(p, a, n)).astype(np.float32)).to(device)
    rows = torch.from_numpy(np.sort(np.argsort(rng.random((p, a)), axis=1)[:, :9], axis=1)).to(device)
    queued, free = rows[:, :8], rows[:, 8]
    for lane in range(p):
        trap = lane % 4
        q1, q4, q7 = (int(queued[lane, q]) for q in (1, 4, 7))
        cols = [int(x) for x in rng.choice(n, size=2, replace=False)]
        first, second = min(cols), max(cols)
        if trap == 0:
            hard[lane, q4, first] = hard[lane, q4, second] = 1.0
            hard[lane, q7, first] = hard[lane, q7, second] = 1.0
            hard[lane, int(free[lane]), 0] = 1.0
        elif trap == 1:
            hard[lane, int(queued[lane, 7]), first] = hard[lane, int(queued[lane, 7]), n - 1] = float("nan")
        else:
            early, late = (-0.0, 0.0) if trap == 2 else (0.0, -0.0)
            hard[lane, q1, first] = hard[lane, q1, second] = early
            hard[lane, q7, first] = hard[lane, q7, second] = late
    row_min, row_arg = hard.amin(-1), hard.argmin(-1).to(torch.int32)
    excl = (queued * n + row_arg.gather(1, queued).long()).contiguous()
    ones = torch.ones((p, a), dtype=torch.bool, device=device)
    return hard, ones, row_min, row_arg, excl


def k3_cases(device) -> list:
    """(label, arguments (hard, row_valid, row_min, row_arg, excl), timed,
    slices) at the N-Queens cells' shapes (256, 50, 1000) and (16, 64,
    16384): the first pick (no exclusion), a retry with 8 excluded row minima
    a lane, exclusions mixed with -1 slots and invalid rows, lanes with no
    valid row, a retry of 1 row a lane (as the cells' solves retry); at (16,
    64, 16384) also a retry with nothing to rescan, one of 3 rows a lane, the
    retries of 0, 1 and 8 rows forced to each cluster size the plan can take
    (``slices``; None is the plan's), the merge's traps (``k3_traps``) and a
    block off 16 bytes; then one lane and 300 lanes, and the ragged (5, 7,
    1003).  ``timed``: True for the full timing, "device" for the
    device-only time alone."""
    import torch

    from constraint_solver_tpu_torch.ops import block_pick as bp
    from constraint_solver_tpu_torch.ops import nqueens_kernel as nk

    rng = np.random.default_rng(19)
    cases = []

    def mixed(p, r, c, row_arg, e=8):
        """-1 slots, row minima (of valid and invalid rows) and other flat indices."""
        excl = k3_row_minima(rng, row_arg, c, min(e, r))
        if excl.shape[1] < e:
            excl = torch.cat([excl, excl[:, :1].expand(p, e - excl.shape[1])], dim=1)
        other = torch.from_numpy(rng.integers(0, r * c, size=(p, e))).to(device)
        u = torch.from_numpy(rng.random((p, e))).to(device)
        return torch.where(u < 0.25, -1, torch.where(u < 0.75, excl, other)).contiguous()

    for p, a, n in K3_SHAPES + (K3_RAGGED,):
        # B1's block of random boards: the row block the N-Queens neighborhood hands K3.
        hard, row_min, row_arg = nk.nqueens_neighborhood_scores(*kernel_inputs(rng, p, a, n, device))
        ones = torch.ones((p, a), dtype=torch.bool, device=device)
        timed = (p, a, n) != K3_RAGGED
        cases.append((f"first pick {(p, a, n)}", (hard, ones, row_min, row_arg, None), timed, None))
        retry8 = (hard, ones, row_min, row_arg, k3_row_minima(rng, row_arg, n, min(8, a)))
        cases.append((f"8 excluded row minima {(p, a, n)}", retry8, timed, None))
        row_valid = torch.from_numpy(rng.random((p, a)) < 0.8).to(device)
        cases.append((f"mixed exclusions, invalid rows {(p, a, n)}",
                      (hard, row_valid, row_min, row_arg, mixed(p, a, n, row_arg)), False, None))
        dead = row_valid.clone()
        dead[::2] = False  # every other lane has no valid row
        cases.append((f"lanes with no valid row {(p, a, n)}", (hard, dead, row_min, row_arg, mixed(p, a, n, row_arg)),
                      False, None))
        retry1 = (hard, ones, row_min, row_arg, k3_retry(rng, row_arg, n, 1))
        if timed:  # the retries of the cells' solves rescan one row a lane
            cases.append((f"1 excluded row minima {(p, a, n)}", retry1, True, None))
        if n == 16384:
            empty = (hard, ones, row_min, row_arg, torch.full((p, 8), -1, dtype=torch.int64, device=device))
            cases.append((f"8 empty exclusion slots {(p, a, n)}", empty, "device", None))
            cases.append((f"3 excluded row minima {(p, a, n)}",
                          (hard, ones, row_min, row_arg, k3_retry(rng, row_arg, n, 3)), "device", None))
            # Nothing to rescan, the solves' one row a lane, and 8 rows, at every cluster size.
            for label, retry in (("8 empty exclusion slots", empty), ("1 excluded row minima", retry1),
                                 ("8 excluded row minima", retry8)):
                for s in (1, 2, 4, bp.MAX_SLICES):
                    cases.append((f"{label} {(p, a, n)}, {s} blocks a lane", retry, "device", s))
            traps = k3_traps(rng, device, p, a, n)
            for s in (None, 2, 4):
                cases.append((f"cluster merge traps {(p, a, n)}" + (f", {s} blocks a lane" if s else ""), traps,
                              False, s))
            # the block one float past 16 bytes: the rescans read it 4 bytes at a time
            buf = torch.empty(hard.numel() + 1, dtype=hard.dtype, device=device)
            off = buf[1:].view(hard.shape)
            off.copy_(hard)
            cases.append((f"block off 16 bytes, 8 excluded row minima {(p, a, n)}",
                          (off, ones, row_min, row_arg, k3_row_minima(rng, row_arg, n, 8)), False, None))
    for p, a, n in ((1, 64, 16384), (300, MAIN_A, MAIN_N)):
        hard, row_min, row_arg = nk.nqueens_neighborhood_scores(*kernel_inputs(rng, p, a, n, device))
        ones = torch.ones((p, a), dtype=torch.bool, device=device)
        cases.append((f"8 excluded row minima {(p, a, n)}",
                      (hard, ones, row_min, row_arg, k3_row_minima(rng, row_arg, n, 8)), False, None))
    return cases


def k3_rescanned(hard, row_valid, row_min, row_arg, excl) -> int:
    """The rows K3 scans again on these inputs: valid rows whose first minimum is excluded."""
    import torch

    if excl is None:
        return 0
    c = hard.shape[2]
    flat = torch.arange(row_arg.shape[1], device=row_arg.device) * c + row_arg.long()
    return int(((flat[:, :, None] == excl[:, None, :]).any(dim=-1) & row_valid).sum())


def k3_plan(args, slices=None) -> str:
    """The launch K3 takes for its arguments (hard, row_valid, row_min,
    row_arg, excl): blocks a lane and threads (``slices`` forced)."""
    from constraint_solver_tpu_torch.ops import block_pick as bp
    from constraint_solver_tpu_torch.ops import nqueens_kernel as nk

    hard, excl = args[0], args[4]
    sms = bp._sms(hard.device.index) if is_cuda(hard.device) else nk._SMS
    plan = bp._launch_plan(*hard.shape, 0 if excl is None else excl.shape[1], sms)
    if slices is not None:
        plan = plan._replace(slices=slices, grid=hard.shape[0] * slices)
    return f"{plan.slices} blocks a lane of {plan.threads} threads, grid {plan.grid}"


def k3_graph_replay(device, args) -> str:
    """K3 captured in a CUDA graph (with the plan's cluster when S > 1) and
    replayed: each replay counts one launch and rewrites the pick bit for bit."""
    import torch

    from constraint_solver_tpu_torch.core import graphed
    from constraint_solver_tpu_torch.ops import block_pick as bp

    want = bp.block_pick_ref(*args)
    before = bp.block_pick.launches
    seg = graphed.capture(lambda: bp.block_pick(*args), torch.cuda.CUDAGraph(), torch.cuda.Stream(device))
    for _ in range(3):
        seg.out.fill_(-1)
        seg.replay()
    sync(device)
    if bp.block_pick.launches != before + 3 or not torch.equal(seg.out, want):
        raise AssertionError(f"phase 2e: K3 replayed in a CUDA graph: {bp.block_pick.launches - before} launches "
                             f"counted for 3 replays, equal {torch.equal(seg.out, want)}")
    return k3_plan(args)


def phase_k3(device, cases=None) -> dict:
    """2e. K3, the block pick, against its plain version bit for bit at
    ``k3_cases`` (each with its launch plan; forced cluster sizes through the
    wrapper's ``_slices``), and the 8-row retry at (16, 64, 16384) replayed in
    a CUDA graph; then, at the timed cases, its device-only ms per launch (its
    events in a ``torch.profiler`` trace), the wrapper's host us, its time, the
    plain chain's and that of ``torch.argmin(hard.view(P, -1), dim=1)`` (the
    nearest single PyTorch call: the first pick when every row is valid) by
    CUDA events, and the bound (this call's bytes over 3.35 TB/s or its
    operations over 67 T/s, the larger) with the share; at the cases timed
    "device", the device-only ms, bound and share alone.  Returns K3's entry
    of the kernels line (main case: the headline's first pick; launches filled
    in by the paths)."""
    import torch

    from constraint_solver_tpu_torch.ops import block_pick as bp

    t0 = time.time()
    per, max_err = {}, 0.0
    card = card_line() if is_cuda(device) else "cpu"
    cases = cases or k3_cases(device)
    for label, args, timed, slices in cases:
        pick = bp.block_pick if slices is None else functools.partial(bp.block_pick, _slices=slices)
        plan = k3_plan(args, slices)
        got, want = pick(*args), bp.block_pick_ref(*args)
        sync(device)
        if got.dtype != torch.int64 or not torch.equal(got, want):
            raise AssertionError(f"phase 2e: K3 != its plain version ({label}, {plan})")
        max_err = max(max_err, float((got - want).abs().max()))
        rescanned = k3_rescanned(*args)
        log(f"phase 2e: K3 == plain version bit for bit at {label} ({plan}): {rescanned} rows rescanned, "
            f"{int((got == 0).sum())} lanes pick 0")
        if not timed:
            continue
        p, r, c = args[0].shape
        e = 0 if args[4] is None else args[4].shape[1]
        ops, nbytes = bp.kernel_work(p, r, c, e, rescanned)
        bound, by = bound_of(ops, nbytes)
        entry = {"bound_ms": bound, "bound_by": by, "bytes": nbytes, "operations": ops, "rescanned": rescanned,
                 "plan": plan}
        per[label] = entry
        if not is_cuda(device):
            continue
        pick(*args)  # warm-up
        dev, how = device_ms(pick, args, TIMED_LAUNCHES, K3_EVENT)
        entry.update(device_ms=dev, bound_share=bound / dev)
        if timed == "device":
            log(f"phase 2e: K3 at {label} ({plan}): device-only {dev * 1e3:.3f} us per launch ({how}); bound "
                f"{bound * 1e3:.4f} us ({by}), share {bound / dev:.3f}; {card}")
            continue
        flat = args[0].view(p, -1)
        argmin = (lambda t: torch.argmin(t, dim=1), (flat,))
        for f, a in ((bp.block_pick_ref, args), argmin):
            time_ms(f, a, 3)  # warm-up
        plain_ms = [time_ms(bp.block_pick_ref, args, 10)]
        kern = [time_ms(pick, args, TIMED_LAUNCHES) for _ in range(2)]
        plain_ms.append(time_ms(bp.block_pick_ref, args, 10))
        library_ms = time_ms(*argmin, TIMED_LAUNCHES)
        library_dev, _ = device_ms(*argmin, TIMED_LAUNCHES, "")
        host = min(host_us(pick, args, TIMED_LAUNCHES) for _ in range(2))
        entry.update(ms=sum(kern) / 2, plain_ms=sum(plain_ms) / 2, library_ms=library_ms,
                     library_device_ms=library_dev, host_us=host)
        log(f"phase 2e: K3 at {label} ({plan}): {kern} ms by CUDA events over {TIMED_LAUNCHES} calls (host-bound: "
            f"the wrapper's enqueue), plain chain {plain_ms} ms (10 calls), torch.argmin over the block "
            f"{library_ms:.6f} ms ({library_dev * 1e3:.3f} us device-only); device-only {dev * 1e3:.3f} us per "
            f"launch ({how}); host {host:.1f} us per call; bound {bound * 1e3:.4f} us ({nbytes} bytes at "
            f"{HBM_BYTES_PER_S / 1e12} TB/s, {ops} operations at {FP32_OPS_PER_S / 1e12} T/s: {by}), share "
            f"{bound / dev:.3f}; {card}")
    if is_cuda(device):
        label, args = next((label, args) for label, args, _, slices in cases
                           if label == f"8 excluded row minima {K3_SHAPES[1]}" and slices is None)
        log(f"phase 2e: K3 at {label} replayed 3 times in a CUDA graph ({k3_graph_replay(device, args)}): "
            f"3 launches counted, the pick bit for bit")
    log(f"phase 2e: {time.time() - t0:.1f} s")
    main = dict(per[f"first pick {K3_SHAPES[0]}"])
    return {
        "name": bp.KERNEL_NAME,
        "route": "cuda",
        "source": "constraint_solver_tpu_torch/csrc/block_pick.cu",
        "replaces": K3_REPLACES,
        "max_abs_err": max_err,
        **main,
        "library_ms": main.get("library_ms"),
        "shapes": per,
    }


class K4Case(NamedTuple):
    label: str
    state: Any
    moves: Any
    idx: Any
    mask: Any
    best: Any  # int64[P, n] or None: the call carries no best board
    save: Any
    timed: bool


def k4_edges(n: int, slices: int) -> list:
    """The first and last column of each block's chunk of a lane at S =
    ``slices`` (``csrc/nqueens_move.cu``: pairs of columns when n is even)."""
    width = 2 if n % 2 == 0 else 1
    items = n // width
    return sorted({items * b // slices * width for b in range(slices)}
                  | {items * (b + 1) // slices * width - 1 for b in range(slices)})


def k4_cases(device) -> list:
    """``K4Case``s at the N-Queens cells' (256, 50, 1000) and (16, 64, 16384)
    and the ragged (5, 7, 16383): counters of random boards, A distinct
    columns a lane as a row-strided view (the neighborhood's sample is one),
    random moves with every fourth lane a same-row move (r_old == r_new),
    lane 0's column 0 to row n - 1, lane 1's column n - 1 to row 0, and every
    other even lane moving the first or last column of a block's chunk at S =
    8; masks all on, all off and mixed (random, about half), each without a
    best board and with one saving a random half of the lanes (with the masks
    all off and mixed, lanes that save their board as it is).  ``timed``: at
    the two cells' shapes the all-on move with and without a best board, and
    the headline's mixed and all-off ones (the latter the launch and the
    masks' load alone)."""
    import torch

    from constraint_solver_tpu_torch.models.nqueens import NQMoves, build_state

    rng = np.random.default_rng(21)
    cases = []
    for p, a, n in K4_SHAPES + (K4_RAGGED,):
        st = build_state(torch.as_tensor(rng.integers(0, n, size=(p, n)), device=device))
        perm = np.argsort(rng.random((p, n)), axis=1)
        edges = k4_edges(n, 8)
        for lane in range(p):  # lane 0 samples column 0 first, lane 1 column n - 1, the others a chunk's edge
            edge = 0 if lane == 0 else n - 1 if lane == 1 else edges[lane % len(edges)]
            perm[lane] = np.r_[edge, perm[lane][perm[lane] != edge]]
        moves = NQMoves(torch.as_tensor(perm, device=device)[:, :a], n)
        lane = torch.arange(p, device=device)
        k = torch.as_tensor(rng.integers(0, a, size=p), device=device)
        k = torch.where((lane < 2) | (lane % 2 == 0), 0, k)
        r_new = torch.as_tensor(rng.integers(0, n, size=p), device=device)
        r_new[:2] = torch.tensor([n - 1, 0])  # column 0 to row n - 1, column n - 1 to row 0
        r_new = torch.where(lane % 4 == 3, st.rows[lane, moves.cols[lane, k]], r_new)  # same-row moves
        idx = k * n + r_new
        save = torch.as_tensor(rng.random(p) < 0.5, device=device)
        best = torch.as_tensor(rng.integers(0, n, size=(p, n)), device=device)
        masks = {"all on": torch.ones(p, dtype=torch.bool, device=device),
                 "all off": torch.zeros(p, dtype=torch.bool, device=device),
                 "mixed": torch.as_tensor(rng.random(p) < 0.5, device=device)}
        for name, mask in masks.items():
            for with_best in (False, True):
                timed = (p, a, n) != K4_RAGGED and (name == "all on" or (n == MAIN_N and not with_best))
                label = f"{name}{', best' if with_best else ''} {(p, a, n)}"
                cases.append(K4Case(label, st, moves, idx.contiguous(), mask, best if with_best else None,
                                    save if with_best else None, timed))
    return cases


def k4_equal(got, want) -> bool:
    """Every leaf of two N-Queens states (or boards) equal, floats by their bits."""
    import torch

    bits = (lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t)
    return all(torch.equal(bits(x), bits(y)) for x, y in zip(got, want, strict=True))


def k4_run(case, slices=None, ref=False):
    """A copy of the case's state and best board after K4 at S = ``slices``
    (None: the plan's), or after the plain version with ``ref``."""
    import torch

    from constraint_solver_tpu_torch.ops import nqueens_move as nm
    from constraint_solver_tpu_torch.utils.tree import tree_map

    st = tree_map(torch.clone, case.state)
    best = None if case.best is None else case.best.clone()
    if ref:
        nm.nqueens_move_ref(st, case.moves, case.idx, case.mask, best, case.save)
    else:
        nm.nqueens_move(st, case.moves, case.idx, case.mask, best, case.save, _slices=slices)
    return (*st, best) if best is not None else tuple(st)


def k4_graph_replay(device, case) -> None:
    """K4 at its plan captured in a CUDA graph and replayed once: one launch
    counted, the state and best board written bit for bit as the plain
    version writes them."""
    import torch

    from constraint_solver_tpu_torch.core import graphed
    from constraint_solver_tpu_torch.ops import nqueens_move as nm
    from constraint_solver_tpu_torch.utils.tree import tree_map

    want = k4_run(case, ref=True)
    got = tree_map(torch.clone, case.state)
    best = None if case.best is None else case.best.clone()
    before = nm.nqueens_move.launches
    seg = graphed.capture(lambda: nm.nqueens_move(got, case.moves, case.idx, case.mask, best, case.save),
                          torch.cuda.CUDAGraph(), torch.cuda.Stream(device))
    untouched = (*case.state, case.best) if best is not None else tuple(case.state)
    if not k4_equal((*got, best) if best is not None else tuple(got), untouched):
        raise AssertionError("phase 2f: capturing K4 wrote the state")
    seg.replay()
    sync(device)
    equal = k4_equal((*got, best) if best is not None else tuple(got), want)
    if nm.nqueens_move.launches != before + 1 or not equal:
        raise AssertionError(f"phase 2f: K4 replayed in a CUDA graph: {nm.nqueens_move.launches - before} launches "
                             f"counted for 1 replay, equal {equal}")


def k4_rotation(st, moves, idx, mask, best=None, save=None):
    """Copies of ``st`` (and of ``best``) whose rows, cs and best boards (what
    K4 streams) hold ``K4_L2_SPAN`` times the L2, and ``call(fn)``, which
    applies ``fn`` (K4 or a plain form, with K4's signature) to the next copy:
    each copy's move ``idx`` on the first pass over them, the move back to the
    old row on the second, and so on.  Every call does the same work from
    HBM; a run of ``2 * copies`` calls leaves every copy's state as it was
    (and its best board, where it saves, the board).  Returns (copies, call),
    a copy a pair (state, best or None)."""
    import torch

    from constraint_solver_tpu_torch.utils.tree import tree_map

    p, n = st.rows.shape
    nbytes = st.rows.nbytes + st.cs.nbytes + (0 if best is None else best.nbytes)
    count = max(2, -(-K4_L2_SPAN * L2_BYTES // nbytes))
    copies = [(tree_map(torch.clone, st), None if best is None else best.clone()) for _ in range(count)]
    lane, k = torch.arange(p, device=idx.device), idx // n
    back = (k * n + st.rows[lane, moves.cols[lane, k]]).contiguous()
    step = [0]

    def call(fn):
        i = step[0]
        step[0] = i + 1
        state, b = copies[i % count]
        fn(state, moves, back if i // count % 2 else idx, mask, b, save)

    return copies, call


def phase_k4(device, cases=None) -> dict:
    """2f. K4, the masked N-Queens move, against its plain version bit for bit
    at ``k4_cases`` (every leaf of the state and the best board, floats by
    their bits), each at its launch plan and at S = 1 and 8 blocks a lane,
    and the mixed case with a best board at (16, 64, 16384) (its plan: S = 8,
    a thread-block cluster) replayed once in a CUDA graph; then, at the timed
    cases, its device-only ms per launch (its events in a ``torch.profiler``
    trace), the wrapper's host us, its time, the plain version's and the
    select form's chain (``apply_move`` then the select by the mask, and the
    best's select by ``save``: what the descent ran before K4) by CUDA
    events, each over state copies that do not fit the L2 (``k4_rotation``),
    and the bound (``move_work``: this call's bytes, from the lanes it masks
    and saves and the scores its moves change, over 3.35 TB/s, or its
    operations over 67 T/s, the larger) with the share; the all-on move at
    (16, 64, 16384) with no best board also at S = 1, one block a lane.  No
    single PyTorch call computes the move
    (no library time).  Returns K4's entry of the kernels line (main case:
    the headline's all-on move with no best board; launches filled in by the
    paths)."""
    import torch

    from constraint_solver_tpu_torch.models.nqueens import make_nqueens_problem
    from constraint_solver_tpu_torch.ops import nqueens_move as nm
    from constraint_solver_tpu_torch.ops.block_pick import _sms
    from constraint_solver_tpu_torch.utils.tree import tree_map, tree_where

    t0 = time.time()
    per, max_err = {}, 0.0
    card = card_line() if is_cuda(device) else "cpu"
    sms = _sms(torch.device(device).index or 0) if is_cuda(device) else 132
    cases = cases or k4_cases(device)
    for case in cases:
        p, a = case.moves.cols.shape
        n = case.moves.n
        want = k4_run(case, ref=True)
        plan = nm._launch_plan(p, n, sms)
        for slices in dict.fromkeys((None, *K4_SLICES)):
            got = k4_run(case, slices)
            sync(device)
            s = slices or plan.slices
            if not k4_equal(got, want):
                raise AssertionError(f"phase 2f: K4 != its plain version ({case.label}, S = {s})")
            max_err = max(max_err, *(float((x.double() - y.double()).abs().max()) for x, y in zip(got, want)))
        masked = int(case.mask.sum())
        saved = -1 if case.save is None else int(case.save.sum())
        changed = int((want[0] != case.state.rows).any(dim=1).sum())
        log(f"phase 2f: K4 == plain version bit for bit at {case.label} at its plan (S = {plan.slices}, "
            f"{plan.threads} threads a block) and S = {', '.join(map(str, K4_SLICES))}: {masked} lanes masked, "
            f"{changed} boards changed, " + ("no best board" if saved < 0 else f"{saved} boards saved"))
        if not case.timed:
            continue
        variants = [None]
        if case.label.startswith("all on (") and plan.slices > 1:  # the cluster against one block a lane
            variants.append(1)
        for slices in variants:
            label = case.label + (f" S={slices}" if slices else "")
            st, moves, idx, mask, best, save = case.state, case.moves, case.idx, case.mask, case.best, case.save
            ops, nbytes = nm.move_work(st, moves, idx, mask, best, save)
            bound, by = bound_of(ops, nbytes)
            use = nm._launch_plan(p, n, sms, slices)
            entry = per[label] = {"bound_ms": bound, "bound_by": by, "bytes": nbytes, "operations": ops,
                                  "masked": masked, "saved": max(saved, 0), "slices": use.slices,
                                  "threads": use.threads}
            if not is_cuda(device):
                continue
            copies, call = k4_rotation(st, moves, idx, mask, best, save)
            cycle = 2 * len(copies)  # calls that leave every copy as it was
            problem = make_nqueens_problem(n, sample_cols=a)
            kernel = functools.partial(nm.nqueens_move, _slices=slices)

            def select_chain(state, moves, idx, mask, best, save):
                moved = tree_where(mask, problem.apply_move(state, moves, idx), state)
                return moved if best is None else (moved, torch.where(save[:, None], moved.rows, best))

            for f in (kernel, nm.nqueens_move_ref, select_chain):
                time_ms(call, (f,), cycle)  # warm-up
            dev, how = device_ms(call, (kernel,), cycle, K4_EVENT)
            plain_ms = [time_ms(call, (nm.nqueens_move_ref,), cycle)]
            chain_ms = [time_ms(call, (select_chain,), cycle)]
            kern = [time_ms(call, (kernel,), cycle) for _ in range(2)]
            plain_ms.append(time_ms(call, (nm.nqueens_move_ref,), cycle))
            chain_ms.append(time_ms(call, (select_chain,), cycle))
            args = (tree_map(torch.clone, st), moves, idx, mask, None if best is None else best.clone(), save)
            host = min(host_us(kernel, args, TIMED_LAUNCHES) for _ in range(2))
            restored = k4_run(case._replace(mask=torch.zeros_like(mask)), ref=True)  # the state, the board saved
            if not all(k4_equal((*c, b) if b is not None else tuple(c), restored) for c, b in copies):
                raise AssertionError(f"phase 2f: K4's timed moves there and back did not restore the state ({label})")
            del copies
            entry.update(ms=sum(kern) / 2, device_ms=dev, bound_share=bound / dev, plain_ms=sum(plain_ms) / 2,
                         select_chain_ms=sum(chain_ms) / 2, library_ms=None, host_us=host, state_copies=cycle // 2)
            log(f"phase 2f: K4 at {label} (S = {use.slices}, {use.threads} threads a block): {kern} ms by CUDA "
                f"events over {cycle} calls on {cycle // 2} state copies (host-bound: the wrapper's enqueue), plain "
                f"version {plain_ms} ms, the select form's chain {chain_ms} ms; device-only {dev * 1e3:.3f} us per "
                f"launch ({how}, the copies {K4_L2_SPAN}x the L2 in rows, cs and best); host {host:.1f} us per "
                f"call; bound {bound * 1e3:.4f} us ({nbytes} bytes at {HBM_BYTES_PER_S / 1e12} TB/s, {ops} "
                f"operations at {FP32_OPS_PER_S / 1e12} T/s: {by}), share {bound / dev:.3f}; {card}")
    if is_cuda(device):
        case = next(c for c in cases if c.label == f"mixed, best {K4_SHAPES[1]}")
        k4_graph_replay(device, case)
        log(f"phase 2f: K4 at {case.label} (S = {nm._launch_plan(*K4_SHAPES[1][::2], sms).slices}) replayed once "
            f"in a CUDA graph: 1 launch counted, the state and best board bit for bit")
    log(f"phase 2f: {time.time() - t0:.1f} s")
    main = dict(per[f"all on {K4_SHAPES[0]}"])
    return {
        "name": nm.KERNEL_NAME,
        "route": "cuda",
        "source": "constraint_solver_tpu_torch/csrc/nqueens_move.cu",
        "replaces": K4_REPLACES,
        "max_abs_err": max_err,
        **main,
        "library_ms": None,
        "plan": {label: {"slices": e["slices"], "threads": e["threads"]} for label, e in per.items()},
        "shapes": per,
    }


class K5Case(NamedTuple):
    label: str
    args: tuple  # sched_dense's: (assign, cur_score, tables, start_weekday, rs_d1, rs_off, delta)
    timed: bool


def k5_cases(device) -> list:
    """``K5Case``s: the roster cell's (64, 365, 20, 256, 4) and 730 x 40 at P =
    128 (the JAX bench's largest quality instance; both with the bench's
    holidays), the reference CLI instance 31 d x 7 e with holidays at P = 8,
    30 d x 4 e from a Friday, 14 d x 2 e (D < 15: no diagonals), 42 d x 5 e
    with no random swaps, and 60 d x 5 e whose lanes use two employees (lane 0
    one: S2-S4 with fewer than two present).  Assignments from a seeded numpy
    generator, the draws from ``TorchDraws`` on the device, the diagonals
    (n_off = 4 where D >= 15) and random swaps as the problem draws them."""
    import torch

    from constraint_solver_tpu_torch.models.scheduling import ScheduleSpec, make_scheduling_problem, make_tables
    from constraint_solver_tpu_torch.utils.draws import TorchDraws

    d0, fri = datetime.date(2022, 5, 9), datetime.date(2022, 5, 13)
    day = datetime.timedelta

    def spec(start, days, emps, hols=None):
        return ScheduleSpec.from_dates(start, start + day(days=days - 1), emps, hols)

    hol31 = {0: [d0 + day(days=3)], 2: [d0 + day(days=k) for k in (5, 6, 20)]}
    rng = np.random.default_rng(23)
    cases = []
    for label, sp, p, n_rand, timed, used in (
        ("roster (64, 365, 20, 256, 4)", bench_schedule(365, 20)[0], 64, 256, True, None),
        ("730 x 40 P=128", bench_schedule(730, 40)[0], 128, 256, True, None),
        ("31 d x 7 e with holidays P=8", spec(d0, 31, 7, hol31), 8, 64, False, None),
        ("30 d x 4 e from a Friday P=8", spec(fri, 30, 4), 8, 64, False, None),
        ("14 d x 2 e (D < 15) P=8", spec(d0, 14, 2), 8, 64, False, None),
        ("42 d x 5 e, no random swaps P=8", spec(d0, 42, 5), 8, 0, False, None),
        ("60 d x 5 e on two employees P=8", spec(fri, 60, 5), 8, 64, False, 2),
    ):
        d, e = sp.num_days, sp.num_employees
        n_off = 4 if d >= 15 else 0
        a = torch.as_tensor(rng.integers(0, used or e, size=(p, d)), device=device)
        if used:
            a[0] = 0
        cur = make_scheduling_problem(sp).score(a)
        dr = TorchDraws(label, p, device).dense_swaps(n_rand, n_off, d, torch.ones(p, dtype=torch.bool, device=device))
        cases.append(K5Case(f"{label}, n_rand={n_rand}, n_off={n_off}",
                            (a, cur, make_tables(sp, device), sp.start_weekday, dr.rs_d1, dr.rs_off, dr.delta), timed))
    return cases


def k5_equal(got, want) -> bool:
    """Every output of two ``DenseOut``s equal (``torch.equal``: -0.0 is 0.0) with its dtype."""
    import torch

    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(got, want, strict=True))


def k5_graph_replay(device, case) -> None:
    """K5 captured in a CUDA graph and replayed once: its launches counted
    once each at the replay, none at the capture, and every output written
    as the plain version writes it."""
    import torch

    from constraint_solver_tpu_torch.core import graphed
    from constraint_solver_tpu_torch.ops import sched_dense as sd

    want = sd.sched_dense_ref(*case.args)
    before = sd.sched_dense.launches
    seg = graphed.capture(lambda: sd.sched_dense(*case.args), torch.cuda.CUDAGraph(), torch.cuda.Stream(device))
    captured = sum(seg.launches.values())
    for t in seg.out:
        t.zero_()
    seg.replay()
    sync(device)
    if captured != 1 or sd.sched_dense.launches != before + 1 or not k5_equal(seg.out, want):
        raise AssertionError(f"phase 2g: K5 in a CUDA graph: {captured} launches captured, "
                             f"{sd.sched_dense.launches - before} counted for 1 replay of 1 launch, "
                             f"equal {k5_equal(seg.out, want)}")


def k5_device_ms(fn, args, calls: int) -> tuple[float, dict, str]:
    """K5's device-only ms per call, its kernels' events (``K5_EVENT``) in a
    ``torch.profiler`` trace of ``calls`` calls summed, and each kernel's
    share; where the trace holds fewer events than the wrapper's launches,
    the replay of a CUDA graph of the calls timed with CUDA events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from constraint_solver_tpu_torch.ops import sched_dense as sd

    before = sd.sched_dense.launches
    fn(*args)
    torch.cuda.synchronize()
    per_call = sd.sched_dense.launches - before
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    split = Counter()
    events = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and K5_EVENT in e.name:
            split[re.search(r"sched_\w+_kernel", e.name).group(0)] += e.time_range.elapsed_us() / 1e3 / calls
            events += 1
    if events == per_call * calls:
        return sum(split.values()), dict(split), "profiler"
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn(*args)
    graph.replay()  # warm-up
    return time_ms(graph.replay, (), 1) / calls, {}, f"CUDA graph replay; {events} of its events in the trace"


def eager_chain_kernels(fn, args) -> dict:
    """The device work of one call of ``fn``: its kernels, copies and sets in
    a ``torch.profiler`` trace, and the sum of their device ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    out = Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out["copies" if e.name.startswith(("Memcpy", "Memset")) else "kernels"] += 1
            out["device_ms"] += e.time_range.elapsed_us() / 1e3
    return dict(out)


def phase_k5(device, cases=None) -> dict:
    """2g. K5, the roster's dense neighborhood, against its plain version
    (the eager chain the dense proposer ran before it) bit for bit at
    ``k5_cases``: scores, validity, fingerprint deltas and the four move
    tensors, padding slots included, as ``torch.equal`` reads them; the
    roster case replayed once in a CUDA graph; then at the timed cases its
    device-only ms per call (its events in a ``torch.profiler``
    trace; the inputs, 0.5 MB at the roster's shape, warm in L2, the 29 MB of
    outputs written), the wrapper's host us, the wrapper and the plain version
    by CUDA events, the plain version's kernels and copies in a trace of one
    call (and their device ms), the device-only time of the same call without
    its random swaps, and the bound (``kernel_work``: bytes over 3.35 TB/s or operations
    over 67 T/s, the larger) with the share.  No single PyTorch call computes
    the neighborhood (no library time).  Returns K5's entry of the kernels
    line (main case: the roster's; launches filled in by the paths)."""
    import torch

    from constraint_solver_tpu_torch.ops import sched_dense as sd
    from constraint_solver_tpu_torch.ops.block_pick import _sms

    t0 = time.time()
    per, plans, max_err = {}, {}, 0.0
    card = card_line() if is_cuda(device) else "cpu"
    sms = _sms(torch.device(device).index or 0) if is_cuda(device) else 132
    cases = cases or k5_cases(device)
    for case in cases:
        a, _, tables, _, rs_d1, _, delta = case.args
        p, d = a.shape
        e, n_rand, n_off = tables.holiday_de.shape[1], rs_d1.shape[1], delta.shape[1]
        want = sd.sched_dense_ref(*case.args)
        got = sd.sched_dense(*case.args)
        sync(device)
        if not k5_equal(got, want):
            bad = [f for f, x, y in zip(sd.DenseOut._fields, got, want) if not torch.equal(x, y)]
            raise AssertionError(f"phase 2g: K5 != its plain version ({case.label}): {bad}")
        max_err = max(max_err, *(float((x.double() - y.double()).abs().max()) for x, y in zip(got, want)))
        plan = (sd.occupancy(p, d, e, n_rand, n_off, device) if is_cuda(device)
                else sd._launch_plan(p, d, e, n_rand, n_off, sms)._asdict())
        plans[case.label] = plan
        padding = int((~want.valid).sum())
        where = ", ".join(f"{name} in {'shared' if plan[f'{k}_shared'] else 'global'} memory" for k, name in
                          (("flags", "window flags"), ("plane", "plane"), ("hol", "holiday rows")))
        log(f"phase 2g: K5 == plain version bit for bit at {case.label} (W = {want.valid.shape[1]}, {padding} "
            f"padding slots); plan: clusters of {plan['slices']} blocks, {plan['grid']} blocks of {sd.THREADS} "
            f"threads, {plan['smem']} B of dynamic shared memory a block, spans of {plan['span']} days in chunks "
            f"of {plan['chunk']}, swaps in batches of {plan['swap_batch']}, {where}"
            + (f"; {plan['registers']} registers, {plan['local_bytes']} B local a thread, {plan['blocks_per_sm']} "
               f"blocks an SM, {plan['clusters_at_once']} clusters at once" if 'registers' in plan else ""))
        if not case.timed:
            continue
        ops, nbytes = sd.kernel_work(p, d, e, n_rand, n_off)
        bound, by = bound_of(ops, nbytes)
        entry = per[case.label] = {"bound_ms": bound, "bound_by": by, "bytes": nbytes, "operations": ops,
                                   "plan": plan}
        if not is_cuda(device):
            continue
        for f in (sd.sched_dense, sd.sched_dense_ref):
            time_ms(f, case.args, 2)  # warm-up
        dev, split, how = k5_device_ms(sd.sched_dense, case.args, K5_CALLS)
        plain_calls = max(2, K5_CALLS // 10)
        plain_ms = [time_ms(sd.sched_dense_ref, case.args, plain_calls)]
        kern = [time_ms(sd.sched_dense, case.args, K5_CALLS) for _ in range(2)]
        plain_ms.append(time_ms(sd.sched_dense_ref, case.args, plain_calls))
        host = min(host_us(sd.sched_dense, case.args, K5_CALLS) for _ in range(2))
        chain = eager_chain_kernels(sd.sched_dense_ref, case.args)
        entry.update(ms=sum(kern) / 2, device_ms=dev, device_split_ms=split, bound_share=bound / dev,
                     plain_ms=sum(plain_ms) / 2, library_ms=None, host_us=host, plain_device_work=chain)
        if n_rand:  # the same call without its random swaps: what the tile blocks alone take
            bare = (*case.args[:4], rs_d1[:, :0], case.args[5][:, :0], delta)
            if not k5_equal(sd.sched_dense(*bare), sd.sched_dense_ref(*bare)):
                raise AssertionError(f"phase 2g: K5 != its plain version ({case.label} without random swaps)")
            entry["device_ms_without_random_swaps"] = k5_device_ms(sd.sched_dense, bare, K5_CALLS)[:2]
        log(f"phase 2g: K5 at {case.label}: {kern} ms by CUDA events over {K5_CALLS} calls, plain version "
            f"{plain_ms} ms ({chain} a call); device-only {dev * 1e3:.3f} us per call ({how}; "
            f"{ {k: round(v * 1e3, 3) for k, v in split.items()} } us); host {host:.1f} us per call; bound "
            f"{bound * 1e3:.4f} us ({nbytes} bytes at {HBM_BYTES_PER_S / 1e12} TB/s, {ops} operations at "
            f"{FP32_OPS_PER_S / 1e12} T/s: {by}), share {bound / dev:.3f}; without its random swaps "
            f"{entry.get('device_ms_without_random_swaps')} ms; {card}")
    if is_cuda(device):
        case = cases[0]
        k5_graph_replay(device, case)
        log(f"phase 2g: K5 at {case.label} replayed once in a CUDA graph: its launches counted at the replay, "
            f"every output bit for bit")
    log(f"phase 2g: {time.time() - t0:.1f} s")
    main = dict(per[cases[0].label])
    return {
        "name": sd.KERNEL_NAME,
        "route": "cuda",
        "source": "constraint_solver_tpu_torch/csrc/sched_dense.cu",
        "replaces": K5_REPLACES,
        "max_abs_err": max_err,
        **main,
        "library_ms": None,
        "plan": plans,
        "shapes": per,
    }


class K6Case(NamedTuple):
    label: str
    args: tuple  # nqueens_sample's: (cs, table, gumbel, num_cols, n_conflicted, rows, rc, dc, ac, a)
    timed: bool


def near_solved(rng, p: int, n: int, moved: int):
    """Solved boards (the even-n construction, valid for n % 6 in {0, 4}) with
    ``moved`` queens a lane put on random rows: a few conflicted columns, as
    late in a solve."""
    sol = np.array([2 * i + 1 for i in range(n // 2)] + [2 * i for i in range(n // 2)])
    boards = np.tile(sol, (p, 1))
    for b in boards:
        b[rng.choice(n, moved, replace=False)] = rng.integers(0, n, moved)
    return boards


def k6_args(rng, boards, a: int, device, kind: str = "gumbel") -> tuple:
    """K6's arguments for the boards [P, n]: their counters, the default log
    table, Gumbel draws (or, with ``kind="ties"``, small integers as draws and
    column scores in {0, 1, 2}: keys tie everywhere, at the threshold too) and
    num_cols uniform in [1, clamp(n_conflicted, 1, A)], as the draws make them."""
    import torch

    from constraint_solver_tpu_torch.models.nqueens import build_state, default_log_weights

    p, n = boards.shape
    st = build_state(torch.as_tensor(boards, device=device))
    cs = st.cs
    if kind == "ties":
        gumbel = torch.as_tensor(rng.integers(-2, 3, size=(p, n)), dtype=torch.float32, device=device)
        cs = torch.as_tensor(rng.integers(0, 3, size=(p, n)), dtype=torch.float32, device=device)
    else:
        gumbel = torch.as_tensor(-np.log(-np.log(rng.random((p, n)).clip(1e-38))), dtype=torch.float32,
                                 device=device)
    n_conflicted = (cs > 0).sum(dim=-1)
    hi = n_conflicted.clamp(1, a).cpu().numpy()
    num_cols = torch.as_tensor(rng.integers(1, hi + 1), device=device)
    return (cs, default_log_weights(n).to(device), gumbel, num_cols, n_conflicted, st.rows, st.rc, st.dc, st.ac, a)


def k6_cases(device) -> list:
    """``K6Case``s: both N-Queens cells' (P, n, A) on random boards (nearly
    every column conflicted) and on near-solved ones (fewer conflicted columns
    than A: the -inf tail ties at the threshold), keys that tie everywhere,
    boards with no conflicted column, A = n, n not a multiple of 32, and each
    branch of the plan at shapes where the plan takes it: the survivors
    placed by rank (A up to 256) or by the bitonic sort (above), the keys in
    global memory (n = 60,000), the survivors too (A = 20,000)."""
    rng = np.random.default_rng(26)
    cases = []
    for p, n, a in K6_SHAPES:
        cases.append(K6Case(f"random {(p, n, a)}", k6_args(rng, rng.integers(0, n, (p, n)), a, device), True))
        cases.append(K6Case(f"near solved {(p, n, a)}", k6_args(rng, near_solved(rng, p, n, 8), a, device), True))
    for label, (p, n, a), kind in (
        ("ties", (64, 1000, 50), "ties"),
        ("ties", (4, 16384, 64), "ties"),
        ("no conflicted column", (8, 1000, 50), "solved"),
        ("A = n", (4, 64, 64), "gumbel"),
        ("ragged", (5, 1003, 50), "gumbel"),
        ("bitonic sort", (64, 1000, 300), "gumbel"),
        ("bitonic sort, ties", (4, 16384, 300), "ties"),
        ("keys in global memory", (2, 60000, 50), "gumbel"),
        ("keys in global memory, bitonic sort", (2, 60000, 3000), "gumbel"),
        ("survivors in global memory", (1, 40000, 20000), "gumbel"),
        ("keys and survivors in global memory, ties", (1, 60000, 20000), "ties"),
    ):
        boards = near_solved(rng, p, n, 0) if kind == "solved" else rng.integers(0, n, (p, n))
        cases.append(K6Case(f"{label} {(p, n, a)}", k6_args(rng, boards, a, device, kind), False))
    return cases


def k6_equal(got, want) -> bool:
    """Every output of two ``Sample``s equal with its dtype."""
    import torch

    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(got, want, strict=True))


class K7Case(NamedTuple):
    label: str
    args: tuple  # nqueens_move_fp's: (cur_fp, cols, rows, idx)
    timed: bool


def k7_cases(device) -> list:
    """``K7Case``s: a pick [P] at both N-Queens cells' (P, A, n), the exact
    filter's [P, A·n] (an expanded iota) at the headline's and at nqueens-64's
    (8, 3, 64), int32 candidates read through a stride, and picks of the last
    candidate of every lane."""
    import torch

    rng = np.random.default_rng(27)
    cases = []

    def lane_args(p, a, n):
        cur = torch.as_tensor(rng.integers(0, 2**32, (p, 2)), device=device)
        cols = torch.as_tensor(np.argsort(rng.random((p, n)), axis=1)[:, :a], device=device).contiguous()
        rows = torch.as_tensor(rng.integers(0, n, (p, n)), device=device)
        return cur, cols, rows

    for p, n, a in K6_SHAPES:
        cur, cols, rows = lane_args(p, a, n)
        idx = torch.as_tensor(rng.integers(0, a * n, p), device=device)
        cases.append(K7Case(f"pick [{p}] at {(p, a, n)}", (cur, cols, rows, idx), True))
    for p, a, n, timed in ((MAIN_P, MAIN_A, MAIN_N, True), (8, 3, 64, False)):
        cur, cols, rows = lane_args(p, a, n)
        idx = torch.arange(a * n, device=device).expand(p, a * n)
        cases.append(K7Case(f"exact filter [{p}, {a * n}] at {(p, a, n)}", (cur, cols, rows, idx), timed))
    cur, cols, rows = lane_args(6, 5, 37)
    idx = torch.as_tensor(rng.integers(0, 5 * 37, (6, 22)), dtype=torch.int32, device=device)[:, ::2]
    cases.append(K7Case("int32 candidates through a stride [6, 11] at (6, 5, 37)", (cur, cols, rows, idx), False))
    cur, cols, rows = lane_args(3, 4, 9)
    cases.append(K7Case("the last candidate [3] at (3, 4, 9)",
                        (cur, cols, rows, torch.full((3,), 4 * 9 - 1, device=device)), False))
    return cases


def k7_chain(cur_fp, cols, rows, idx):
    """What the N-Queens model ran for a pick's fingerprint before K7: the
    decode (two divisions, two gathers) and ``fp_update`` (K2a on the card)."""
    from constraint_solver_tpu_torch.ops import fingerprint as fpk

    return fpk.nqueens_move_fp_ref(cur_fp, cols, rows, idx, update=fpk.fp_update)


def k67_graph_replay(device, k6: K6Case, k7: K7Case) -> None:
    """K6 and K7 captured in one CUDA graph and replayed once: one launch of
    each counted at the replay, none at the capture, and both outputs written
    as the plain versions write them."""
    import torch

    from constraint_solver_tpu_torch.core import graphed
    from constraint_solver_tpu_torch.ops import fingerprint as fpk
    from constraint_solver_tpu_torch.ops import nqueens_sample as ns

    want6, want7 = ns.nqueens_sample_ref(*k6.args), fpk.nqueens_move_fp_ref(*k7.args)
    before = (ns.nqueens_sample.launches, fpk.nqueens_move_fp.launches)
    seg = graphed.capture(lambda: (ns.nqueens_sample(*k6.args), fpk.nqueens_move_fp(*k7.args)),
                          torch.cuda.CUDAGraph(), torch.cuda.Stream(device))
    captured = sum(seg.launches.values())
    got6, got7 = seg.out
    for t in (*got6, got7):
        t.zero_()
    seg.replay()
    sync(device)
    after = (ns.nqueens_sample.launches - before[0], fpk.nqueens_move_fp.launches - before[1])
    if captured != 2 or after != (1, 1) or not k6_equal(got6, want6) or not torch.equal(got7, want7):
        raise AssertionError(f"phase 2h: K6 and K7 in a CUDA graph: {captured} launches captured, {after} counted "
                             f"for 1 replay, equal {k6_equal(got6, want6)} and {torch.equal(got7, want7)}")


def time_pair(kernel, plain, args, event: str, calls: int = TIMED_LAUNCHES, yardsticks=None) -> dict:
    """The wrapper ``kernel`` against ``plain`` on ``args``: the kernel's
    device-only ms per launch (its events in a profiler trace), the wrapper's
    host us, the wrapper and the plain version by CUDA events in turns (plain,
    kernel, kernel, plain), the plain version's device work in a trace of one
    call, and each of ``yardsticks`` (name -> (fn, args)) by CUDA events."""
    for f in (kernel, plain):
        time_ms(f, args, 2)  # warm-up
    dev, how = device_ms(kernel, args, calls, event)
    plain_ms = [time_ms(plain, args, calls)]
    kern = [time_ms(kernel, args, calls) for _ in range(2)]
    plain_ms.append(time_ms(plain, args, calls))
    out = {"ms": sum(kern) / 2, "ms_runs": kern, "device_ms": dev, "device_ms_from": how,
           "host_us": min(host_us(kernel, args, calls) for _ in range(2)), "plain_ms": sum(plain_ms) / 2,
           "plain_ms_runs": plain_ms, "plain_device_work": eager_chain_kernels(plain, args)}
    for name, (fn, fn_args) in (yardsticks or {}).items():
        time_ms(fn, fn_args, 2)
        out[f"{name}_ms"] = sum(time_ms(fn, fn_args, calls) for _ in range(2)) / 2
        out[f"{name}_device_work"] = eager_chain_kernels(fn, fn_args)
    return out


def phase_k67(device) -> tuple[dict, dict]:
    """2h. K6, the N-Queens column sample and the block's inputs, against its
    plain version (the eager chain with its stable sort) bit for bit at
    ``k6_cases``, which take every branch of its plan; K7, the fingerprints of
    N-Queens candidates, against its plain version (the decode, then
    ``fp_update``) bit for bit at ``k7_cases``; both captured in one CUDA
    graph and replayed once.  Then at the timed cases each one's device-only
    ms per launch (its events in a ``torch.profiler`` trace), the wrapper's
    host us, the wrapper and the plain version by CUDA events, the plain
    version's device work a call, and the bound (``kernel_work`` / the plan's
    ``work``: bytes over 3.35 TB/s or operations over 67 T/s, the larger) with
    the share; for K6 also ``torch.topk(keys, A, sorted=True)`` on the keys
    (the library call that computes the same top A, though it promises no
    order among ties), and for K7 the chain the model ran before it (the
    decode, then K2a).  Returns K6's and K7's entries of the kernels line
    (main cases: random boards at the headline, and the headline's pick;
    launches filled in by the paths)."""
    import torch

    from constraint_solver_tpu_torch.ops import fingerprint as fpk
    from constraint_solver_tpu_torch.ops import nqueens_sample as ns

    t0 = time.time()
    card = card_line() if is_cuda(device) else "cpu"
    k6, k7 = k6_cases(device), k7_cases(device)
    per6, per7, plans, err6 = {}, {}, {}, 0.0
    for case in k6:
        cs, *_, a = case.args
        p, n = cs.shape
        want = ns.nqueens_sample_ref(*case.args)
        got = ns.nqueens_sample(*case.args)
        sync(device)
        if not k6_equal(got, want):
            bad = [f for f, x, y in zip(ns.Sample._fields, got, want) if not torch.equal(x, y)]
            raise AssertionError(f"phase 2h: K6 != its plain version ({case.label}): {bad}")
        err6 = max(err6, *(float((x.double() - y.double()).abs().max()) for x, y in zip(got, want)))
        plan = plans[case.label] = ns._launch_plan(p, n, a)._asdict()
        conflicted = int(case.args[4].min()), int(case.args[4].max())
        log(f"phase 2h: K6 == plain version bit for bit at {case.label} (conflicted columns a lane "
            f"{conflicted[0]}-{conflicted[1]}); plan {plan}")
        if not case.timed:
            continue
        bound, by = bound_of(*ns.kernel_work(p, n, a))
        entry = per6[case.label] = {"bound_ms": bound, "bound_by": by, "plan": plan}
        if not is_cuda(device):
            continue
        table, gumbel = case.args[1], case.args[2]
        keys = torch.where(cs > 0, table[cs.long()], -torch.inf) + gumbel
        entry.update(time_pair(ns.nqueens_sample, ns.nqueens_sample_ref, case.args, K6_EVENT,
                               yardsticks={"library": (lambda k: torch.topk(k, a, dim=-1, sorted=True), (keys,))}))
        entry["bound_share"] = bound / entry["device_ms"]
        log(f"phase 2h: K6 at {case.label}: {entry['ms_runs']} ms by CUDA events, plain version "
            f"{entry['plain_ms_runs']} ms ({entry['plain_device_work']} a call), torch.topk {entry['library_ms']} ms; "
            f"device-only {entry['device_ms'] * 1e3:.3f} us ({entry['device_ms_from']}); host "
            f"{entry['host_us']:.1f} us; bound {bound * 1e3:.4f} us ({by}), share {entry['bound_share']:.3f}; {card}")
    branches = {(plan["keys_shared"], plan["cands_shared"], plan["rank_sort"]) for plan in plans.values()}
    if len(branches) != 6:
        raise AssertionError(f"phase 2h: K6's cases take {len(branches)} of its plan's six branches: {branches}")
    err7 = 0.0
    for case in k7:
        want = fpk.nqueens_move_fp_ref(*case.args)
        got = fpk.nqueens_move_fp(*case.args)
        sync(device)
        if got.dtype != torch.int64 or not torch.equal(got, want):
            raise AssertionError(f"phase 2h: K7 != its plain version ({case.label})")
        if not torch.equal(k7_chain(*case.args), want):
            raise AssertionError(f"phase 2h: K7's plain version != the chain it replaces ({case.label})")
        err7 = max(err7, float((got - want).abs().max()))
        log(f"phase 2h: K7 == plain version == the decode and K2a bit for bit at {case.label}")
        if not case.timed:
            continue
        cur, cols, rows, idx = case.args
        flat = idx[:, None] if idx.dim() == 1 else idx
        work = fpk._nq_move_plan(*((t.shape, t.stride(), t.dtype) for t in (cur, cols, rows, flat))).work
        bound, by = bound_of(*work)
        entry = per7[case.label] = {"bound_ms": bound, "bound_by": by}
        if not is_cuda(device):
            continue
        entry.update(time_pair(fpk.nqueens_move_fp, fpk.nqueens_move_fp_ref, case.args, K7_EVENT,
                               yardsticks={"chain": (k7_chain, case.args)}))
        entry["bound_share"] = bound / entry["device_ms"]
        log(f"phase 2h: K7 at {case.label}: {entry['ms_runs']} ms by CUDA events, plain version "
            f"{entry['plain_ms_runs']} ms, the decode and K2a {entry['chain_ms']} ms ({entry['chain_device_work']} "
            f"a call); device-only {entry['device_ms'] * 1e3:.3f} us ({entry['device_ms_from']}); host "
            f"{entry['host_us']:.1f} us; bound {bound * 1e3:.4f} us ({by}), share {entry['bound_share']:.3f}; {card}")
    if is_cuda(device):
        k67_graph_replay(device, k6[0], k7[0])
        log(f"phase 2h: K6 at {k6[0].label} and K7 at {k7[0].label} replayed once in a CUDA graph: one launch "
            f"of each counted at the replay, both outputs bit for bit")
    log(f"phase 2h: {time.time() - t0:.1f} s")
    six = {"name": ns.KERNEL_NAME, "route": "cuda", "source": "constraint_solver_tpu_torch/csrc/nqueens_sample.cu",
           "replaces": K6_REPLACES, "max_abs_err": err6, **per6[k6[0].label], "plan": plans, "shapes": per6}
    seven = {"name": fpk.NQ_MOVE_KERNEL, "route": "cuda", "source": "constraint_solver_tpu_torch/csrc/fingerprint.cu",
             "replaces": K7_REPLACES, "max_abs_err": err7, **per7[k7[0].label], "library_ms": None, "shapes": per7}
    return six, seven


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
    from constraint_solver_tpu_torch.ops import block_pick as bp
    from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
    from constraint_solver_tpu_torch.ops import nqueens_move as nm
    from constraint_solver_tpu_torch.ops.fingerprint import fingerprint_i32, fingerprint_i32_ref
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver

    problem = make_nqueens_problem(n)
    config = main_config()

    def solver():
        return PopulationSolver(problem, config, population=population, exchange_every=2, device=device)

    t0 = time.time()
    solver().run(max_rounds=2, chunk=2)  # warm-up: first-call costs stay out of the timing
    log(f"phase 4: warm-up (2 rounds) {time.time() - t0:.3f} s")

    nk.nqueens_neighborhood_scores.launches = bp.block_pick.launches = nm.nqueens_move.launches = 0
    k2_reset()
    k67_reset()
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
    launches, k3, k4 = nk.nqueens_neighborhood_scores.launches, bp.block_pick.launches, nm.nqueens_move.launches
    k2, k67 = k2_launches(), k67_launches()
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
    # Carried fingerprints (K7's updates) against a full recomputation by K2b and by the plain version.
    for full in (fingerprint_i32, fingerprint_i32_ref):
        if not torch.equal(s.state.current_fp, full(cur.rows)):
            raise AssertionError(f"carried fingerprints differ from a full recomputation ({full.__name__})")
        elite = s.state.elite
        if not torch.equal(elite.fps[elite.valid], full(elite.states.rows)[elite.valid]):
            raise AssertionError(f"archived fingerprints differ from a full recomputation ({full.__name__})")
    if torch.device(device).type == "cuda":
        if launches == 0:
            raise AssertionError("the main path never launched the kernel")
        require_k2(k2, "phase 4: the main path", NQ_K2)
        require_k67(k67, "phase 4: the main path")
        if k3 == 0:
            raise AssertionError("the main path never launched K3 (block_pick)")
        if k4 == 0:
            raise AssertionError("the main path never launched K4 (nqueens_move)")
    log(
        f"phase 4: nqueens-{n} P={population} solved: time to zero {ttz:.3f} s, "
        f"{stats['rounds']} rounds, {stats['ls_iterations']} descent iterations, "
        f"moves/s {stats.get('moves_per_sec')}, kernel launches {launches}, K2 launches {k2}, K3 launches {k3}, "
        f"K4 launches {k4}, K6 and K7 launches {k67}"
    )
    return {"ttz_s": ttz, "launches": launches, "k2_launches": k2, "k3_launches": k3, "k4_launches": k4,
            "k67_launches": k67, **stats}, s


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def graphs_pair(device, make, drive, label="4b") -> dict:
    """4b's and 4c's comparison: ``drive`` on an eager solver (``_graphed=False``)
    and on a graphed one, each from ``make(graphed)``; the final state trees,
    what ``drive`` returns (the traces), ``stats()``, the generator's state and
    the launches of B1, of K1, of K2a and K2b, of K3, of K4, of K5, of K6 and of K7 must be equal.  Each side's wall, its peak
    memory, and the graphed side's capture time."""
    import torch

    from constraint_solver_tpu_torch.ops import block_pick as bp
    from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
    from constraint_solver_tpu_torch.ops import nqueens_move as nm
    from constraint_solver_tpu_torch.ops import qap_row_min as qrm
    from constraint_solver_tpu_torch.ops import sched_dense as sd
    from constraint_solver_tpu_torch.utils.convert import to_reference

    out = {}
    cuda = is_cuda(device)
    if cuda:
        torch.zeros(1, device=device)  # the allocator's peak counters exist once it has allocated
    for graphed in (False, True):
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        launches0, k1_launches0 = nk.nqueens_neighborhood_scores.launches, qrm.qap_swap_row_min.launches
        k2_0, k3_0, k3_shapes0 = k2_launches(), bp.block_pick.launches, Counter(bp.block_pick.shapes)
        k4_0, k5_0, k67_0 = nm.nqueens_move.launches, sd.sched_dense.launches, k67_launches()
        s = make(graphed)
        sync(device)
        t0 = time.time()
        result = drive(s)
        sync(device)
        wall = time.time() - t0
        graphs = s.program.graphs
        out[graphed] = {
            "wall_s": wall, "state": to_reference(s.state), "result": result,
            "stats": {k: v for k, v in s.stats().items() if k != "moves_per_sec"},  # that one is the wall's
            "generator": s.draws.state_dict()["generator"],
            "launches": nk.nqueens_neighborhood_scores.launches - launches0,
            "k1_launches": qrm.qap_swap_row_min.launches - k1_launches0,
            "k2_launches": {k: v - k2_0[k] for k, v in k2_launches().items()},
            "k3_launches": bp.block_pick.launches - k3_0,
            "k3_shapes": {str(k): v - k3_shapes0[k] for k, v in bp.block_pick.shapes.items()
                          if v != k3_shapes0[k]},
            "k4_launches": nm.nqueens_move.launches - k4_0,
            "k5_launches": sd.sched_dense.launches - k5_0,
            "k67_launches": {k: v - k67_0[k] for k, v in k67_launches().items()},
            "peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
            "reserved_bytes": torch.cuda.memory_reserved(device) if cuda else None,
            "capture_s": graphs.capture_s if graphs is not None else None,
            "units": len(graphs._units) if graphs is not None else None,
        }
    eager, graph = out[False], out[True]
    assert_tree_equal(graph["state"], eager["state"])
    if not np.array_equal(np.asarray(graph["result"]), np.asarray(eager["result"])):
        raise AssertionError(f"phase {label}: graphed and eager traces differ")
    for key in ("stats", "launches", "k1_launches", "k2_launches", "k3_launches", "k3_shapes", "k4_launches",
                "k5_launches", "k67_launches"):
        if graph[key] != eager[key]:
            raise AssertionError(f"phase {label}: graphed and eager {key} differ: {graph[key]} != {eager[key]}")
    if not torch.equal(graph["generator"], eager["generator"]):
        raise AssertionError(f"phase {label}: the generator's state differs after the graphed run")
    if is_cuda(device) and graph["units"] != 1:
        raise AssertionError(f"phase {label}: the graphed solver made {graph['units']} graphed descents, not 1")
    return {side: {k: v[k] for k in ("wall_s", "peak_bytes", "reserved_bytes", "capture_s", "launches", "k1_launches",
                                     "k2_launches", "k3_launches", "k3_shapes", "k4_launches", "k5_launches",
                                     "k67_launches",
                                     "stats")}
            for side, v in (("eager", eager), ("graphed", graph))}


def phase_graphs(device, n=MAIN_N, population=MAIN_P, small_n=64, small_p=8, clustered=(512, 64, 8, 4, 4),
                 card=None) -> dict:
    """4b. The descent replayed as CUDA graphs against the eager loop, from one
    seed, drawing on the device: nqueens-``small_n`` P=``small_p`` in both tabu
    modes (phase 3's configuration, 3 chunks of 2 rounds with their traces),
    then nqueens-``n`` P=``population`` ``run(chunk=2)`` to zero, after a
    2-round warm-up of each path; then a few lanes whose K3 retries launch as
    thread-block clusters (``clustered``: n, sample_cols, P, rounds, S; the
    main path's configuration, seed "smoke-clusters"; the retries forced to S
    blocks a lane through the wrapper's ``_slices``, since the plan takes a
    cluster only for rows of 2048 candidates and more, whose solves retry late;
    nqueens-512 P=8 retries some 26 times in its first round): K3's launches
    by shape equal on both sides, retries among them; then that configuration
    with its move written in place (K4) against ``_replace(in_place=None)``,
    both graphed (``select_form_pair``): state bits, traces and stats equal,
    K4 launched."""
    from constraint_solver_tpu_torch.core import problem as core_problem
    from constraint_solver_tpu_torch.core.ils import SolverConfig
    from constraint_solver_tpu_torch.models.nqueens import make_nqueens_problem
    from constraint_solver_tpu_torch.ops import block_pick as bp
    from constraint_solver_tpu_torch.ops import nqueens_move as nm
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver

    card = card or (card_line() if is_cuda(device) else "cpu")
    out = {}
    for exact in (None, False):
        config = SolverConfig(
            seed="smoke-64", local_search_max_iterations=40, best_solutions_capacity=4,
            all_solutions_capacity=64, restart_every=4, tabu_exact_filter=exact,
        )
        mode = "exact filter" if exact is None else "pick-then-check"
        out[mode] = graphs_pair(
            device,
            lambda graphed: PopulationSolver(make_nqueens_problem(small_n), config, population=small_p,
                                             exchange_every=2, device=device, _graphed=graphed),
            lambda s: np.concatenate([s.execute_chunk_traced(2) for _ in range(3)]),
        )
        if is_cuda(device):
            require_k2(out[mode]["graphed"]["k2_launches"], f"phase 4b: nqueens-{small_n} ({mode})", NQ_K2)
            require_k67(out[mode]["graphed"]["k67_launches"], f"phase 4b: nqueens-{small_n} ({mode})")
            require_k3(out[mode], f"phase 4b: nqueens-{small_n} ({mode})")
            require_k4(out[mode], f"phase 4b: nqueens-{small_n} ({mode})")
        log(f"phase 4b: nqueens-{small_n} P={small_p} ({mode}): graphed == eager (state, traces, stats, "
            f"generator, {out[mode]['graphed']['launches']} kernel launches, K2 "
            f"{out[mode]['graphed']['k2_launches']}, K3 {out[mode]['graphed']['k3_launches']}, K4 "
            f"{out[mode]['graphed']['k4_launches']}); walls eager "
            f"{out[mode]['eager']['wall_s']:.3f} s, graphed {out[mode]['graphed']['wall_s']:.3f} s")

    problem, config = make_nqueens_problem(n), main_config()

    def make(graphed):
        return PopulationSolver(problem, config, population=population, exchange_every=2, device=device,
                                _graphed=graphed)

    for graphed in (False, True):
        make(graphed).run(max_rounds=2, chunk=2)  # warm-up: first-call costs stay out of the walls

    def solve(s):
        timer = threading.Timer(WALL_CAP_S, s.cancel)
        timer.start()
        try:
            s.run(chunk=2)
        finally:
            timer.cancel()
            timer.join()
        if s.cancelled or s.get_best_score()[0] != 0:
            raise AssertionError(f"phase 4b: nqueens-{n} not solved: {s.get_best_score()} after {s.stats()}")
        return np.zeros(0)

    main = out["main"] = graphs_pair(device, make, solve)
    eager, graph = main["eager"], main["graphed"]
    if is_cuda(device):
        require_k2(graph["k2_launches"], f"phase 4b: nqueens-{n}", NQ_K2)
        require_k67(graph["k67_launches"], f"phase 4b: nqueens-{n}")
        require_k3(main, f"phase 4b: nqueens-{n}")
        require_k4(main, f"phase 4b: nqueens-{n}")
    log(f"phase 4b: nqueens-{n} P={population} run(chunk=2) to zero: graphed == eager (state, stats, generator, "
        f"{graph['launches']} kernel launches, K2 {graph['k2_launches']}, K3 {graph['k3_launches']}, "
        f"K4 {graph['k4_launches']}, "
        f"{graph['stats']['rounds']} rounds, "
        f"{graph['stats']['ls_iterations']} descent iterations)")
    log(f"phase 4b: wall eager {eager['wall_s']:.4f} s, graphed {graph['wall_s']:.4f} s; {card}")
    log(f"phase 4b: capture {graph['capture_s']:.4f} s (host, inside the graphed wall); {card}")
    log(f"phase 4b: peak memory eager {eager['peak_bytes']} B, graphed {graph['peak_bytes']} B; reserved after "
        f"each {eager['reserved_bytes']} B, {graph['reserved_bytes']} B; {card}")
    cl_n, cl_a, cl_p, cl_rounds, cl_s = clustered
    cl_problem = make_nqueens_problem(cl_n, sample_cols=cl_a)
    cl_config = dataclasses.replace(config, seed="smoke-clusters")

    def clustered_pick(hard, row_valid, row_min, row_arg, excl=None):
        return bp.block_pick(hard, row_valid, row_min, row_arg, excl, _slices=None if excl is None else cl_s)

    core_problem.block_pick = clustered_pick  # ``Neighborhood.pick``: every retry
    try:
        clusters = out["clusters"] = graphs_pair(
            device,
            lambda graphed: PopulationSolver(cl_problem, cl_config, population=cl_p, exchange_every=2,
                                             device=device, _graphed=graphed),
            lambda s: s.run(max_rounds=cl_rounds, chunk=2) or np.asarray(s.get_best_score()),
        )
    finally:
        core_problem.block_pick = bp.block_pick
    retries = {k: v for k, v in clusters["graphed"]["k3_shapes"].items() if not k.endswith(", 0)")}
    if is_cuda(device) and not retries:
        raise AssertionError(f"phase 4b: nqueens-{cl_n} P={cl_p} made no K3 retry: "
                             f"{clusters['graphed']['k3_shapes']}")
    log(f"phase 4b: nqueens-{cl_n} P={cl_p} {cl_rounds} rounds, retries in clusters of {cl_s}: graphed == eager "
        f"(state, stats, generator, K3 launches by (P, R, C, E) {clusters['graphed']['k3_shapes']}); walls eager "
        f"{clusters['eager']['wall_s']:.3f} s, graphed {clusters['graphed']['wall_s']:.3f} s; {card}")
    # The masked move (K4) and the best carried as the board, against the select form, both graphed.
    k4_0 = nm.nqueens_move.launches
    sel = out["in_place"] = select_form_pair(device, cl_problem, cl_config, dict(population=cl_p, exchange_every=2),
                                             2, (2,) * (cl_rounds // 2), label="4b")
    sel["k4_launches"] = nm.nqueens_move.launches - k4_0  # the in-place side's and its warm-up's
    if is_cuda(device) and sel["k4_launches"] == 0:
        raise AssertionError(f"phase 4b: nqueens-{cl_n} P={cl_p} in place never launched K4 (nqueens_move)")
    log(f"phase 4b: nqueens-{cl_n} P={cl_p} {cl_rounds} rounds: in place == select form (state bits, traces, "
        f"stats), both {'graphed' if is_cuda(device) else 'eager'}, K4 launches {sel['k4_launches']}; walls "
        f"select {sel['select']['wall_s']:.4f} s, in place {sel['in_place']['wall_s']:.4f} s; peak memory above "
        f"the start select {sel['select']['peak_bytes']} B, in place {sel['in_place']['peak_bytes']} B; {card}")
    if is_cuda(device):
        out["second_round"] = {}
        for graphed in (False, True):
            trace = second_round_trace(device, problem, config, population, graphed)
            out["second_round"]["graphed" if graphed else "eager"] = trace
            log(f"phase 4b: traced second round, {'graphed' if graphed else 'eager'}: {trace['iterations']} "
                f"iterations in {trace['wall_s']:.4f} s, idle {trace['idle_share']:.4f}, busy "
                f"{trace['busy_ms_per_iteration']:.4f} ms, {trace['device_kernels'] / trace['iterations']:.3f} "
                f"kernels and {trace['host_reads'] / trace['iterations']:.3f} host reads per iteration, "
                f"B1 {trace['kernel']['ms_per_launch']:.6f} ms in {trace['kernel']['events']} events; "
                f"top {[(o['name'][:40], round(o['ms'], 3), o['calls']) for o in trace['top_device_ops'][:5]]}; "
                f"gaps {trace['idle_gaps']}; {card}")
    return out


def graphs_domain_cases(sched_p=8, roster=(365, 20, 64, 8), qap_small=(64, 8), qap_big=(256, 64), qap_inc=(4096, 4),
                        ackley=(10, 64, 6), diagrams=((8, 10, 8, 3, 4, 3), (64, 96, 32, 4, 64, 3))) -> list:
    """4c's configurations: (label, problem, config, solver keywords, warm-up
    rounds, chunks of rounds), each drawing on the solver's device."""
    from constraint_solver_tpu_torch.core.ils import SolverConfig
    from constraint_solver_tpu_torch.models.ackley import make_ackley_problem
    from constraint_solver_tpu_torch.models.diagram_layout import DiagramLayoutSpec, make_diagram_layout_problem
    from constraint_solver_tpu_torch.models.qap import QAPSpec, make_qap_problem
    from constraint_solver_tpu_torch.models.scheduling import ScheduleSpec, make_scheduling_problem

    cases = []
    # Phase 6's scheduling instance and configuration.
    d0 = datetime.date(2022, 5, 9)
    spec = ScheduleSpec.from_dates(d0, d0 + datetime.timedelta(days=30), 7)
    sched_kw = dict(
        seed="smoke-sched", local_search_max_iterations=60, best_solutions_capacity=8, all_solutions_capacity=128,
        all_solution_iteration_expiry=1000, max_allow_no_improvement_for=20, restart_every=3,
    )
    for proposer, extra in (*SCHED_MODES, ("systematic", {})):
        noisy = " noisy" if extra else ""
        cases.append((f"scheduling-31d-7e {proposer}{noisy} P={sched_p}", make_scheduling_problem(spec, proposer=proposer),
                      SolverConfig(**sched_kw, **extra), dict(population=sched_p, exchange_every=2, cull_frac=0.25),
                      0, (2, 2)))
    # The roster cell's configuration (phase 7a's).
    days, emps, population, rounds = roster
    roster_spec, _, _ = bench_schedule(days, emps)
    cases.append((
        f"scheduling-{days}d-{emps}e dense P={population} (the roster cell)",
        make_scheduling_problem(roster_spec, proposer="dense", n_rand_swaps=256),
        SolverConfig(seed="bench", local_search_max_iterations=50, best_solutions_capacity=16,
                     all_solutions_capacity=64, all_solution_iteration_expiry=1_000,
                     iterated_local_search_max_iterations=10_000, max_allow_no_improvement_for=20),
        dict(population=population, exchange_every=4), 4, (4,) * (rounds // 4),
    ))
    # Phase 8's QAP configurations.
    for (n, population), modes, warm, chunks in ((qap_small, QAP_MODES, 0, (2, 2)),
                                                 (qap_big, ("dense", "compact"), 2, (2, 2)),
                                                 (qap_inc, ("incremental",), 1, (2,))):
        for mode in modes:
            cases.append((f"qap-{n} {mode} P={population}", make_qap_problem(QAPSpec.random(n, seed=0), **QAP_MODES[mode]),
                          qap_config("smoke-qap"), dict(population=population), warm, chunks))
    # Phase 9's Ackley configuration with its profiled round's descents of at
    # most 40 iterations (the JAX CLI's 10,000 run every round to the limit).
    d, population, rounds = ackley
    cases.append((
        f"ackley-{d}d P={population} (LS max 40)", make_ackley_problem(d),
        SolverConfig(seed="42", local_search_max_iterations=40, best_solutions_capacity=32,
                     all_solutions_capacity=512, all_solution_iteration_expiry=10_000,
                     iterated_local_search_max_iterations=1000, max_allow_no_improvement_for=10),
        dict(population=population), 1, (2,) * (rounds // 2),
    ))
    # Phase 10's diagram instances.
    for boxes, edges, grid, max_size, population, rounds in diagrams:
        spec_d = DiagramLayoutSpec.random(boxes, edges, grid, seed=0, max_size=max_size)
        cases.append((f"diagram-{boxes}b-{grid}g P={population}", make_diagram_layout_problem(spec_d),
                      diagram_config("smoke-diagram"), dict(population=population, exchange_every=2),
                      1 if boxes > 8 else 0, (rounds,)))
    return cases


def phase_graphs_domains(device, card=None, **sizes) -> dict:
    """4c. The descents of scheduling (every proposer), QAP (every mode),
    Ackley and the diagram layout replayed as CUDA graphs against the eager
    loop, from one seed each, drawing on the device: for each configuration of
    ``graphs_domain_cases``, after its warm-up rounds on a throwaway solver of
    each side, its chunks with their traces; state trees, traces, ``stats()``
    and the generator's state must be equal."""
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver

    card = card or (card_line() if is_cuda(device) else "cpu")
    out = {}
    for label, problem, config, kw, warm, chunks in graphs_domain_cases(**sizes):
        counted, counters = instrument(problem, device)

        def make(graphed):
            counters.calls = 0
            return PopulationSolver(counted, config, device=device, _graphed=graphed, **kw)

        t0 = time.time()
        for graphed in (False, True):
            if warm:
                make(graphed).run(max_rounds=warm, chunk=warm)  # first-call costs stay out of the walls
        sync(device)
        warm_s = time.time() - t0
        pair = graphs_pair(device, make, lambda s: np.concatenate([s.execute_chunk_traced(c) for c in chunks]),
                           label="4c")
        eager, graph = pair["eager"], pair["graphed"]
        if is_cuda(device) and label.startswith("qap") and ("compact" in label or "incremental" in label) \
                and graph["k1_launches"] == 0:
            raise AssertionError(f"phase 4c: {label}: K1 (qap_swap_row_min) never launched")
        dense = label.startswith("scheduling") and " dense" in label
        if is_cuda(device):
            # K5 hashes the dense proposer's fingerprint deltas itself; the systematic one's moves are states.
            require_k2(graph["k2_launches"], f"phase 4c: {label}",
                       ("K2b", "K2a-ring") if "systematic" in label or dense else ("K2a", "K2b", "K2a-ring"))
            if dense and graph["k5_launches"] == 0:
                raise AssertionError(f"phase 4c: {label}: K5 (sched_dense) never launched")
        iterations = counters.calls  # the graphed side's, which equal the eager side's (stats)
        out[label] = {**pair, "iterations": iterations, "warm_up_s": warm_s,
                      "ms_per_iteration": {k: 1e3 * v["wall_s"] / max(iterations, 1) for k, v in pair.items()}}
        log(f"phase 4c: {label}: graphed == eager (state, traces, stats, generator) after {graph['stats']['rounds']} "
            f"rounds, {iterations} lockstep iterations, {graph['stats']['ls_iterations']} descent iterations, "
            f"K1 launches {graph['k1_launches']}, K2 {graph['k2_launches']}, K5 {graph['k5_launches']}; walls eager "
            f"{eager['wall_s']:.4f} s, graphed {graph['wall_s']:.4f} s "
            f"({out[label]['ms_per_iteration']['eager']:.4f} / {out[label]['ms_per_iteration']['graphed']:.4f} "
            f"ms per iteration); capture {graph['capture_s']:.4f} s (host, inside the graphed wall); peak memory "
            f"eager {eager['peak_bytes']} B, graphed {graph['peak_bytes']} B, reserved after each "
            f"{eager['reserved_bytes']} B, {graph['reserved_bytes']} B; {card}")
        if problem.in_place is not None:
            sel = out[label]["select_form"] = select_form_pair(device, problem, config, kw, warm, chunks)
            log(f"phase 4c: {label}: in place == select form (state bits, traces, stats), both "
                f"{'graphed' if is_cuda(device) else 'eager'}; walls "
                f"select {sel['select']['wall_s']:.4f} s, in place {sel['in_place']['wall_s']:.4f} s; peak memory "
                f"above the start select {sel['select']['peak_bytes']} B, in place {sel['in_place']['peak_bytes']} B; "
                f"{card}")
        if is_cuda(device) and "roster" in label:
            out[label]["second_round"] = {}
            for graphed in (False, True):
                trace = second_round_trace(device, problem, config, kw["population"], graphed, kw["exchange_every"])
                out[label]["second_round"]["graphed" if graphed else "eager"] = trace
                log(f"phase 4c: roster traced second round, {'graphed' if graphed else 'eager'}: "
                    f"{trace['iterations']} iterations in {trace['wall_s']:.4f} s, idle {trace['idle_share']:.4f}, "
                    f"busy {trace['busy_ms_per_iteration']:.4f} ms, "
                    f"{trace['device_kernels'] / trace['iterations']:.3f} kernels and "
                    f"{trace['host_reads'] / trace['iterations']:.3f} host reads per iteration; top "
                    f"{[(o['name'][:40], round(o['ms'], 3), o['calls']) for o in trace['top_device_ops'][:5]]}; "
                    f"gaps {trace['idle_gaps']}; {card}")
    return out


def select_form_pair(device, problem, config, kw, warm, chunks, label="4c") -> dict:
    """4c's second comparison for a problem with a masked move and a keyed best
    (QAP incremental; N-Queens in 4b): solves with ``in_place`` and with it stripped (the
    select form, the JAX package's), each after its own warm-up, from one
    seed; the state trees bit for bit, the traces and ``stats()`` must be
    equal.  Each side's wall, and its peak memory above what the card held as
    it started (the first side's state stays held for the comparison)."""
    import torch

    from constraint_solver_tpu_torch.parallel.population import PopulationSolver
    from constraint_solver_tpu_torch.utils.tree import tree_leaves

    cuda = is_cuda(device)
    stripped = problem._replace(in_place=None)
    out, states = {}, {}
    for side, prob in (("select", stripped), ("in_place", problem)):
        if warm:
            PopulationSolver(prob, config, device=device, **kw).run(max_rounds=warm, chunk=warm)
        base = 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
        s = PopulationSolver(prob, config, device=device, **kw)
        sync(device)
        t0 = time.time()
        trace = np.concatenate([s.execute_chunk_traced(c) for c in chunks])
        sync(device)
        out[side] = {"wall_s": time.time() - t0, "trace": trace,
                     "stats": {k: v for k, v in s.stats().items() if k != "moves_per_sec"},
                     "peak_bytes": torch.cuda.max_memory_allocated(device) - base if cuda else None}
        states[side] = s.state
    sel, inp = out["select"], out["in_place"]
    for i, (x, y) in enumerate(zip(tree_leaves(states["select"]), tree_leaves(states["in_place"]), strict=True)):
        bits = (lambda t: t.view(torch.int32)) if x.dtype == torch.float32 else (lambda t: t)
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(bits(x), bits(y)):
            raise AssertionError(f"phase {label}: {problem.name}: in place and select form differ at state leaf {i}")
    if not np.array_equal(sel.pop("trace"), inp.pop("trace")) or sel["stats"] != inp["stats"]:
        raise AssertionError(f"phase {label}: {problem.name}: in place and select form differ in traces or stats")
    return out


MATRIX_FORMS = ("mxu_conv", "mxu_toeplitz")


def phase_matrix_forms(device, shapes=((8, 50, 1000), (4, 64, 64)), small_n=64, small_p=8, card=None) -> dict:
    """4d. The JAX package's matrix forms of the N-Queens block
    (``block_impl="mxu_conv"``, ``"mxu_toeplitz"``), which run instead of the
    kernel: at each shape their block equal to the kernel's on the same inputs,
    and their whole neighborhood to the kernel's (``"slice"``) from the same
    draws, bit for bit; then nqueens-``small_n`` P=``small_p`` with
    ``mxu_conv``, graphed against eager (4b's comparison)."""
    import torch

    from constraint_solver_tpu_torch.core.ils import SolverConfig
    from constraint_solver_tpu_torch.models.nqueens import build_state, make_nqueens_problem, matrix_block
    from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver
    from constraint_solver_tpu_torch.utils.draws import TorchDraws

    card = card or (card_line() if is_cuda(device) else "cpu")
    rng = np.random.default_rng(4)
    out = {}
    for p, a, n in shapes:
        args = kernel_inputs(rng, p, a, n, device)
        want = nk.nqueens_neighborhood_scores(*args)
        boards = torch.as_tensor(rng.integers(0, n, size=(p, n)), device=device)
        on = torch.ones(p, dtype=torch.bool, device=device)

        def neighborhood(impl):
            problem = make_nqueens_problem(n, sample_cols=a, block_impl=impl)
            st = build_state(boards)
            nb = problem.neighborhood(st, problem.score(st), TorchDraws(f"4d-{n}", p, device), on)
            return nb.all_scores(), nb.all_valid(), nb.hint_idx, nb.n_valid

        want_nb = neighborhood("slice")
        for impl in MATRIX_FORMS:
            assert_outputs_equal(want, matrix_block(impl, *args), f"phase 4d: {impl} block at {(p, a, n)}")
            assert_outputs_equal(want_nb, neighborhood(impl), f"phase 4d: {impl} neighborhood at {(p, a, n)}")
            ms = {"kernel": None, impl: None}
            if is_cuda(device):
                ms = {"kernel": time_ms(nk.nqueens_neighborhood_scores, args, 20),
                      impl: time_ms(lambda *x: matrix_block(impl, *x), args, 5)}
            out[f"{impl} {(p, a, n)}"] = ms
            log(f"phase 4d: {impl} at (P, A, n) = {(p, a, n)}: block and neighborhood == the kernel's; ms per call "
                f"{ms[impl]}, the kernel's {ms['kernel']}; {card}")
    config = SolverConfig(seed="smoke-64", local_search_max_iterations=40, best_solutions_capacity=4,
                          all_solutions_capacity=64, restart_every=4, tabu_exact_filter=False)
    pair = out["graphs mxu_conv"] = graphs_pair(
        device,
        lambda graphed: PopulationSolver(make_nqueens_problem(small_n, block_impl="mxu_conv"), config,
                                         population=small_p, exchange_every=2, device=device, _graphed=graphed),
        lambda s: np.concatenate([s.execute_chunk_traced(2) for _ in range(3)]),
        label="4d",
    )
    log(f"phase 4d: nqueens-{small_n} P={small_p} mxu_conv: graphed == eager (state, traces, stats, generator); "
        f"walls eager {pair['eager']['wall_s']:.4f} s, graphed {pair['graphed']['wall_s']:.4f} s; {card}")
    return out


def second_round_trace(device, problem, config, population, graphed, exchange_every=2) -> dict:
    """The benchmark's traced round (``bench_torch.run.traced_round``) on the
    second round of a fresh solver (the main path's, or phase 4c's roster),
    past the graphed path's capture: its steady state, where the benchmark
    traces a first round."""
    from bench_torch import run as bench_run
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver

    counted, counters = instrument(problem, device)

    class SecondRound:
        def trace_setup(self):
            s = PopulationSolver(counted, config, population=population, exchange_every=exchange_every,
                                 device=device, _graphed=graphed)
            s.execute_round()

            def step() -> int:
                counters.calls = 0
                s.execute_round()
                return counters.calls

            return step

    return bench_run.traced_round(SecondRound(), device)


def sync(device) -> None:
    import torch

    if is_cuda(device):
        torch.cuda.synchronize()


def pmc_pair(device, n, population, seed, max_steps, sample_cols=None, warm=False) -> dict:
    """Phase 5's comparison: ``pmc_solve`` from one seed, drawing on the
    device, with the eager loop (``_graphed=False``) and through a fresh
    ``PMCGraphs`` holder (the default: graphs on the card); the final
    ``PMCState``, the generator's state and the kernel's launches must be
    equal.  Each side's wall, steps, launches and peak memory, and the graphed
    side's capture time, after a warm-up solve of each side from another seed
    when ``warm``."""
    import torch

    from constraint_solver_tpu_torch.models.nqueens_parallel import PMCGraphs, pmc_solve
    from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
    from constraint_solver_tpu_torch.utils.convert import to_reference
    from constraint_solver_tpu_torch.utils.draws import TorchDraws

    cuda = is_cuda(device)
    out = {}
    for graphed in (False, True):
        kw = dict(sample_cols=sample_cols, _graphed=graphed)
        if warm:
            pmc_solve(n, TorchDraws(f"{seed}-warm-up", population, device), max_steps, **kw)
        holder = PMCGraphs() if graphed else None
        draws = TorchDraws(seed, population, device)
        sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        launches0 = nk.nqueens_neighborhood_scores.launches
        t0 = time.time()
        res = pmc_solve(n, draws, max_steps, graphs=holder, **kw)
        sync(device)
        wall = time.time() - t0
        steps = int(res.steps.max())
        out[graphed] = {
            "wall_s": wall, "steps": steps, "ms_per_step": 1e3 * wall / max(steps, 1),
            "launches": nk.nqueens_neighborhood_scores.launches - launches0,
            "best": float(res.score.min()), "state": to_reference(res),
            "generator": draws.state_dict()["generator"],
            "peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
            "capture_s": holder.capture_s if holder is not None else None,
            "units": len(holder._units) if holder is not None else None,
        }
    eager, graph = out[False], out[True]
    label = f"phase 5: nqueens-{n} P={population}" + (f" sample_cols={sample_cols}" if sample_cols else "")
    assert_tree_equal(graph["state"], eager["state"])
    if not torch.equal(graph["generator"], eager["generator"]):
        raise AssertionError(f"{label}: the generator's state differs after the graphed run")
    if graph["launches"] != eager["launches"]:
        raise AssertionError(f"{label}: kernel launches differ: graphed {graph['launches']}, eager {eager['launches']}")
    if cuda and graph["units"] != 1:
        raise AssertionError(f"{label}: the graphed solve made {graph['units']} units, not 1")
    keys = ("wall_s", "steps", "ms_per_step", "launches", "best", "peak_bytes", "capture_s")
    return {side: {k: v[k] for k in keys} for side, v in (("eager", eager), ("graphed", graph))}


def pmc_stretch(device, n, population, seed, steps, sample_cols, graphed) -> dict:
    """The benchmark's traced round (``bench_torch.run.traced_round``) over
    ``steps`` PMC steps of a solve under way: past a first call of 16 steps
    through the same holder, so a graphed stretch replays only."""
    from bench_torch import run as bench_run
    from constraint_solver_tpu_torch.models.nqueens_parallel import PMCGraphs, pmc_init, pmc_run
    from constraint_solver_tpu_torch.utils.draws import TorchDraws

    class Stretch:
        def trace_setup(self):
            draws = TorchDraws(seed, population, device)
            kw = dict(sample_cols=sample_cols, graphs=PMCGraphs() if graphed else None, _graphed=graphed)
            carry = pmc_run(pmc_init(n, draws), draws, 16, **kw)

            def step() -> int:
                return int((pmc_run(carry, draws, steps, **kw).steps - carry.steps).max())

            return step

    return bench_run.traced_round(Stretch(), device)


def phase_pmc(device, n=PMC_N, max_steps=5000, check_n=64, small=(64, 4), sampled=(64, 200), stretch=64,
              card=None) -> dict:
    """5. PMC nqueens-n through the kernel (the solve's launches are the
    ``pmc`` path's), a card == CPU check at ``check_n`` from host-side draws
    (the eager loop, by the rule), then graphed against eager, drawing on the
    device: nqueens-``small[0]`` with ``small[1]`` lanes, the nqueens-n solve
    after a warm-up and nqueens-n with ``sampled[0]`` columns for
    ``sampled[1]`` steps (its column sample one K6 launch a step), each with
    a profiled stretch of ``stretch`` steps on the card."""
    import torch

    from constraint_solver_tpu_torch.models.nqueens_parallel import pmc_solve
    from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
    from constraint_solver_tpu_torch.utils.convert import to_reference
    from constraint_solver_tpu_torch.utils.draws import TorchDraws

    card = card or (card_line() if is_cuda(device) else "cpu")
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
        f"moves/s {moves / ttz:.4g}, kernel launches {launches}; {card}"
    )

    def lanes(dev):
        return to_reference(pmc_solve(check_n, TorchDraws("pmc-64", 4, dev, draw_device="cpu"), max_steps=2000))

    assert_tree_equal(lanes(device), lanes("cpu"))
    log(f"phase 5: PMC nqueens-{check_n} P=4: card == CPU")

    result = {"ttz_s": ttz, "steps": steps, "moves_per_sec": moves / ttz, "launches": launches, "graphs": {}}
    runs = (
        (f"nqueens-{small[0]} P={small[1]}", dict(n=small[0], population=small[1], seed="pmc-graphs-small",
                                                   max_steps=2000), None),
        (f"nqueens-{n} P=1", dict(n=n, population=1, seed="pmc-graphs", max_steps=max_steps, warm=True), None),
        (f"nqueens-{n} P=1 sample_cols={sampled[0]}",
         dict(n=n, population=1, seed="pmc-graphs-sampled", max_steps=sampled[1], warm=True), sampled[0]),
    )
    for label, kw, sample_cols in runs:
        pair = pmc_pair(device, sample_cols=sample_cols, **kw)
        eager, graph = pair["eager"], pair["graphed"]
        log(f"phase 5: {label}: graphed == eager (state, steps, generator, {graph['launches']} kernel launches) "
            f"after {graph['steps']} steps, best {graph['best']}; walls eager {eager['wall_s']:.4f} s, graphed "
            f"{graph['wall_s']:.4f} s ({eager['ms_per_step']:.4f} / {graph['ms_per_step']:.4f} ms per step, "
            f"{graph['launches'] / max(graph['steps'], 1):.4f} kernel launches per step); capture "
            f"{graph['capture_s']:.4f} s (host, inside the graphed wall); peak memory eager {eager['peak_bytes']} B, "
            f"graphed {graph['peak_bytes']} B; {card}")
        if is_cuda(device) and kw["n"] == n:
            pair["stretch"] = {}
            for graphed in (False, True):
                trace = pmc_stretch(device, n, 1, kw["seed"] + "-stretch", stretch, sample_cols, graphed)
                pair["stretch"]["graphed" if graphed else "eager"] = trace
                log(f"phase 5: {label} profiled stretch, {'graphed' if graphed else 'eager'}: {trace['iterations']} "
                    f"steps in {trace['wall_s']:.4f} s, idle {trace['idle_share']:.4f}, busy "
                    f"{trace['busy_ms_per_iteration']:.4f} ms, {trace['device_kernels'] / trace['iterations']:.3f} "
                    f"device kernels and {trace['host_reads'] / trace['iterations']:.3f} host reads per step, "
                    f"B1 {trace['kernel']['ms_per_launch']:.6f} ms in {trace['kernel']['events']} events; "
                    f"top {[(o['name'][:40], round(o['ms'], 3), o['calls']) for o in trace['top_device_ops'][:5]]}; "
                    f"gaps {trace['idle_gaps']}; {card}")
        result["graphs"][label] = pair
    return result


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
    dense, counters = instrument(make_scheduling_problem(spec, proposer="dense", n_rand_swaps=256), device)
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
    counters.reset()
    t0 = time.time()
    s.run(max_rounds=rounds, chunk=4)
    sync(device)
    wall = time.time() - t0
    stats = s.stats()
    hard, soft = check_schedule(s, dense, d0, hols, "phase 7a")
    if hard != 0:
        raise AssertionError(f"phase 7a: dense arm ended at ({hard}, {soft}) after {stats['rounds']} rounds")
    ms_it = 1e3 * wall / max(counters.calls, 1)
    log(
        f"phase 7a: scheduling-{days}d-{emps}e dense P={population}: best ({hard}, {soft}) in {wall:.3f} s, "
        f"{stats['rounds']} rounds, {counters.calls} lockstep iterations ({ms_it:.4f} ms each), "
        f"{stats['ls_iterations']} descent iterations, moves/s {stats['moves_evaluated'] / wall:.4g}"
    )
    out["dense"] = {"best": [hard, soft], "wall_s": wall, **stats, "moves_per_sec": stats["moves_evaluated"] / wall,
                    "lockstep_iterations": counters.calls, "ms_per_iteration": ms_it}

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
    kernels = copies = reads = k1_events = 0
    busy_us = k1_us = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name.startswith(("Memcpy", "Memset")):
                copies += 1
            else:
                kernels += 1
            busy_us += e.time_range.elapsed_us()
            if K1_EVENT in e.name:
                k1_events += 1
                k1_us += e.time_range.elapsed_us()
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
        "k1_events": k1_events,
        "k1_ms_per_launch": k1_us / 1e3 / k1_events if k1_events else None,
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
    per-round traces and the stats.  On the card the compact and incremental
    modes must launch K1."""
    from constraint_solver_tpu_torch.models.qap import QAPSpec, make_qap_problem
    from constraint_solver_tpu_torch.ops import qap_row_min as qrm
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver
    from constraint_solver_tpu_torch.utils.convert import to_reference
    from constraint_solver_tpu_torch.utils.draws import TorchDraws

    config = qap_config("smoke-qap")
    solver = PopulationSolver(
        make_qap_problem(QAPSpec.random(n, seed=0), **QAP_MODES[mode]), config, population=population,
        device=device, draws=TorchDraws(config.seed, population, device, draw_device="cpu"),
    )
    launches0, k2_0 = qrm.qap_swap_row_min.launches, k2_launches()
    traces = [solver.execute_chunk_traced(2) for _ in range(rounds // 2)]
    if is_cuda(device) and mode != "dense" and qrm.qap_swap_row_min.launches == launches0:
        raise AssertionError(f"phase 8a: qap-{n} {mode} on the card never launched K1")
    if is_cuda(device):
        require_k2({k: v - k2_0[k] for k, v in k2_launches().items()}, f"phase 8a: qap-{n} {mode}")
    return to_reference(solver.state), np.concatenate(traces), solver.stats()


def qap_arm(device, n, population, mode, warm, rounds, label, capacity=8):
    """``warm`` warm-up rounds on one solver, then ``rounds`` timed rounds
    (chunk 2) on a fresh one, the int64 cost check and one profiled round.
    Returns the measurements and the timed solver."""
    import torch

    from constraint_solver_tpu_torch.models.qap import QAPSpec, make_qap_problem
    from constraint_solver_tpu_torch.ops import qap_row_min as qrm
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
    if is_cuda(device):
        torch.cuda.reset_peak_memory_stats(device)
    s = PopulationSolver(problem, config, population=population, device=device)
    counters.reset()
    k1_launches0, k2_0 = qrm.qap_swap_row_min.launches, k2_launches()
    t0 = time.time()
    s.run(max_rounds=rounds, chunk=2)
    sync(device)
    wall = time.time() - t0
    k1_launches = qrm.qap_swap_row_min.launches - k1_launches0
    k2 = {k: v - k2_0[k] for k, v in k2_launches().items()}
    if is_cuda(device) and mode != "dense" and k1_launches == 0:
        raise AssertionError(f"phase 8{label}: qap-{n} {mode} never launched K1")
    if is_cuda(device):
        require_k2(k2, f"phase 8{label}: qap-{n} {mode}")
    stats = s.stats()
    calls, perturb_s = counters.calls, counters.perturb_s()
    memory = (torch.cuda.max_memory_allocated(device), torch.cuda.memory_reserved(device)) if is_cuda(device) else None
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
        "peak_bytes": memory and memory[0], "reserved_bytes": memory and memory[1], "k1_launches": k1_launches,
        "k2_launches": k2,
    }
    if mode == "incremental":
        out["perturb_s"] = perturb_s
        out["rebuild_share"] = perturb_s / wall
    if is_cuda(device):
        out["profile"] = profile_round(s, counters)
    log(
        f"phase 8{label}: qap-{n} {mode} P={population}: {rounds} rounds in {wall:.3f} s, "
        f"{calls} lockstep iterations ({out['ms_per_iteration']:.3f} ms each), best {cost:.0f} "
        f"(int64 host cost {exact}), moves/s {out['moves_per_sec']:.4g}, K1 launches {k1_launches}, K2 {k2}, peak memory {out['peak_bytes']} B, "
        f"reserved {out['reserved_bytes']} B"
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
    to 4 rounds run straight, leaf for leaf, for qap-1024 compact (which
    launches K1) and for the nqueens main path (which launches B1)."""
    import os

    from constraint_solver_tpu_torch.models.nqueens import make_nqueens_problem
    from constraint_solver_tpu_torch.models.qap import QAPSpec, make_qap_problem
    from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
    from constraint_solver_tpu_torch.ops import qap_row_min as qrm
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

        nk.nqueens_neighborhood_scores.launches = qrm.qap_swap_row_min.launches = 0
        k2_reset()
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
        launches, k1_launches, k2 = nk.nqueens_neighborhood_scores.launches, qrm.qap_swap_row_min.launches, k2_launches()
        assert_tree_equal(to_reference(straight.state), to_reference(resumed.state))
        size = os.path.getsize(path)
        os.remove(path)
        out[name] = {"launches": launches, "k1_launches": k1_launches, "k2_launches": k2, "file_bytes": size,
                     "wall_s": time.time() - t0}
        log(
            f"phase 11b: {problem.name} P={population}: 2 rounds, save ({size} bytes), load, 2 rounds == 4 rounds "
            f"straight, leaf for leaf; launches B1 {launches}, K1 {k1_launches}, K2 {k2}"
        )
    if is_cuda(device) and (out["nqueens"]["launches"] == 0 or out["qap"]["k1_launches"] == 0):
        raise AssertionError(f"phase 11b: a checkpoint run never launched its kernel: {out}")
    if is_cuda(device):
        for name in out:
            require_k2(out[name]["k2_launches"], f"phase 11b: {name}", NQ_K2 if name == "nqueens" else None)
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
    k2_reset()  # read by the caller through ``k2_launches()``
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

    k7_0 = k67_launches()["K7"]
    rc, text, wall, launches = run_cli(nqueens, argv, device)
    k2, k7 = k2_launches(), k67_launches()["K7"] - k7_0
    rows = parse_board(text, n)
    score = int(printed(text, "result.score:"))
    pairs = attacking_pairs(rows)
    if score != 2 * pairs or rc != score:
        raise AssertionError(f"phase 12 {label}: printed score {score} (rc {rc}) != 2 x {pairs} attacking pairs")
    if is_cuda(device) and launches == 0:
        raise AssertionError(f"phase 12 {label}: the CLI never launched the kernel")
    if is_cuda(device) and "pmc" not in argv:  # min-conflicts keeps no fingerprints
        require_k2(k2, f"phase 12 {label}", NQ_K2)
        require_k67({"K7": k7}, f"phase 12 {label}")
    log(f"phase 12 {label}: {' '.join(argv)}: score {score} == 2 x numpy attacking pairs; wall {wall:.3f} s; "
        f"kernel launches {launches}, K2 {k2}, K7 {k7}; {printed(text, 'stats:')}")
    return {"score": score, "wall_s": wall, "launches": launches, "k2_launches": k2, "k7_launches": k7,
            "stats": printed(text, "stats:")}


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

    from constraint_solver_tpu_torch.ops import qap_row_min as qrm

    argv = ["--size", str(n), "--rounds", str(rounds)]
    qrm.qap_swap_row_min.launches = 0
    rc, text, wall, _ = run_cli(qap, argv, device)  # the CLI asserts its best against its host oracle
    k1_launches, k2 = qrm.qap_swap_row_min.launches, k2_launches()
    if is_cuda(device) and k1_launches == 0:
        raise AssertionError("phase 12 qap CLI: K1 never launched")
    if is_cuda(device):
        require_k2(k2, "phase 12 qap CLI")
    perm = np.array(json.loads(printed(text, "result.permutation:")))
    cost = float(printed(text, "result.cost:"))
    flow, dist = QAPSpec.random(n, seed=0).arrays()
    exact = qap_host_cost(flow, dist, perm)
    if rc != 0 or sorted(perm.tolist()) != list(range(n)) or abs(exact - cost) > 1e-3 * max(1.0, exact):
        raise AssertionError(f"phase 12 qap CLI: printed cost {cost} != int64 host cost {exact} (rc {rc})")
    log(f"phase 12 qap CLI: {' '.join(argv)}: cost {cost:.0f}, int64 host cost {exact}; wall {wall:.3f} s; "
        f"K1 launches {k1_launches}, K2 {k2}; {printed(text, 'stats:')}")
    return {"cost": cost, "cost_int64": exact, "wall_s": wall, "stats": printed(text, "stats:"),
            "k1_launches": k1_launches, "k2_launches": k2}


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
    holds the kernel's events, K6's, K7's, K2b's and K2a's ring form's, and the
    ``annotate`` span."""
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
    k2_events = {event: sum(c for name, c in names.items() if event in name)
                 for event in (K6_EVENT, K7_EVENT, K2B_EVENT, K2P_EVENT)}
    if (is_cuda(device) and (kernel_events == 0 or 0 in k2_events.values())) or names["smoke-round"] == 0:
        raise AssertionError(f"phase 12 trace: {kernel_events} kernel events, K2, K6 and K7 {k2_events}, "
                             f"{names['smoke-round']} spans in {path}")
    log(f"phase 12 trace: one nqueens-{n} P={population} round traced in {wall:.3f} s: {kernel_events} "
        f"{KERNEL_EVENT} events, K2, K6 and K7 {k2_events}, {sum(names.values())} events in all, {size} bytes")
    return {"kernel_events": kernel_events, "k2_events": k2_events, "events": sum(names.values()), "wall_s": wall}


def checked_roofline(solver, label, kernel_shape=None, k1_shape=None) -> dict:
    """``solver.roofline()`` with every share at most 1.05, the solver's state
    unchanged, and each kernel's counted calls equal to its launches in the
    chunk and its counted bytes to its bytes per call (B1 ``kernel_bytes(
    *kernel_shape)``, K1 ``kernel_work(*k1_shape)``, K6 ``kernel_work`` at
    the N-Queens shape) times them; K2a's, its ring form's, K2b's and K7's to
    the sum of each launch plan's ``work`` bytes times its launches.  An
    N-Queens solver (``kernel_shape`` given) must count K6, K7, K2b and the
    ring form, any other K2a, K2b and the ring form.
    A solved solver's chunk runs from a fresh initial state, made outside the
    count, whose fingerprint launches K2b: there K2's counted calls and bytes
    may fall short of the launched ones, never exceed them."""
    from constraint_solver_tpu_torch.ops import fingerprint as fpk
    from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
    from constraint_solver_tpu_torch.ops import nqueens_sample as ns
    from constraint_solver_tpu_torch.ops import qap_row_min as qrm
    from constraint_solver_tpu_torch.utils.convert import to_reference
    from constraint_solver_tpu_torch.utils.roofline import format_roofline

    before = to_reference(solver.state)
    k6_bytes = kernel_shape and ns.kernel_work(kernel_shape[0], kernel_shape[2], kernel_shape[1])[1]
    kernels = {nk.KERNEL_NAME: (nk.nqueens_neighborhood_scores, kernel_shape and kernel_bytes(*kernel_shape)),
               qrm.KERNEL_NAME: (qrm.qap_swap_row_min, k1_shape and qrm.kernel_work(*k1_shape)[1])}
    for wrapper, _ in kernels.values():
        wrapper.launches = 0
    k2_reset()
    # K6's and K7's counters are the paths' (not reset): their launches in the chunk are differences.
    k6_0, k7_0 = ns.nqueens_sample.launches, (fpk.nqueens_move_fp.launches, Counter(fpk.nqueens_move_fp.shapes))
    r = solver.roofline()
    assert_tree_equal(before, to_reference(solver.state))
    shares = {k: r[k] for k in ("mfu_bf16", "mfu_f32", "hbm_frac")}
    if not all(0.0 <= v <= 1.05 for v in shares.values()):
        raise AssertionError(f"phase 12 roofline {label}: a share above 1.05: {shares}")
    counted = {}
    for name, (wrapper, per_call) in kernels.items():
        kern = counted[name] = r["kernels"].get(name, {"calls": 0, "bytes": 0})
        if is_cuda(solver.device) and kern["calls"] != wrapper.launches:
            raise AssertionError(f"phase 12 roofline {label}: {kern['calls']} {name} calls counted, "
                                 f"{wrapper.launches} launched")
        if kern["calls"] and kern["bytes"] != per_call * kern["calls"]:
            raise AssertionError(f"phase 12 roofline {label}: {name} bytes {kern['bytes']} != "
                                 f"{per_call} x {kern['calls']}")
    kern = counted[ns.KERNEL_NAME] = r["kernels"].get(ns.KERNEL_NAME, {"calls": 0, "bytes": 0})
    k6 = ns.nqueens_sample.launches - k6_0
    if is_cuda(solver.device) and ((kernel_shape and kern["calls"] == 0) or kern["calls"] != k6
                                   or (kern["calls"] and kern["bytes"] != k6_bytes * kern["calls"])):
        raise AssertionError(f"phase 12 roofline {label}: K6 counted {kern['calls']} calls and {kern['bytes']} "
                             f"bytes, launched {k6} of {k6_bytes} bytes each")
    required = {fpk.NQ_MOVE_KERNEL} if kernel_shape else {fpk.HASH_KERNEL}
    required |= {fpk.ROWS_KERNEL, fpk.PROBE_KERNEL}
    for name, wrapper in ((fpk.HASH_KERNEL, fpk.hash_xor), (fpk.ROWS_KERNEL, fpk.fingerprint_i32),
                          (fpk.PROBE_KERNEL, fpk.hash_probe), (fpk.NQ_MOVE_KERNEL, fpk.nqueens_move_fp)):
        kern = counted[name] = r["kernels"].get(name, {"calls": 0, "bytes": 0})
        if not is_cuda(solver.device):
            continue
        launches, shapes = wrapper.launches, wrapper.shapes
        if wrapper is fpk.nqueens_move_fp:
            launches, shapes = launches - k7_0[0], shapes - k7_0[1]
        launched = sum(plan.work[1] * k for plan, k in shapes.items())  # each plan's bytes x its launches
        if r["counted_from"] == "current":
            ok = (kern["calls"], kern["bytes"]) == (launches, launched)
        else:
            ok = kern["calls"] <= launches and kern["bytes"] <= launched
        if (name in required and kern["calls"] == 0) or not ok:
            raise AssertionError(f"phase 12 roofline {label}: {name} counted {kern['calls']} calls and "
                                 f"{kern['bytes']} bytes, launched {launches} moving {launched}")
    log(f"phase 12 roofline {label}: {format_roofline(r)}; per round {r['flops_per_round']:.4g} operations, "
        f"{r['hbm_bytes_per_round']:.4g} bytes; kernels {counted}; state unchanged")
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
    out[f"qap_{qap_n}_incremental"] = r = checked_roofline(qap, f"qap-{qap_n} incremental P=4", k1_shape=(4, qap_n))
    if r["kernels"].get("qap_swap_row_min", {}).get("calls", 0) == 0:
        raise AssertionError(f"phase 12 roofline: qap-{qap_n} incremental's chunk never ran K1")
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


def phase_bench(device, cell=BENCH_CELL) -> dict:
    """14. The benchmark's ``cell`` through its runner, in this process, with one
    repeat (warm-up, the timed and checked solve, the traced round); the kernel's
    launches counted from 0 over the whole run."""
    import torch

    from bench_torch import run as bench_run
    from constraint_solver_tpu_torch.ops import nqueens_kernel as nk

    with open(bench_run.BENCHMARK) as f:
        names = [m for m, spec in json.load(f)["metrics"].items() if cell in spec["workloads"]]
    nk.nqueens_neighborhood_scores.launches = 0
    t0 = time.time()
    out = bench_run.run([cell], device, sets=[f"{cell}.traffic.repeats=1"])
    wall = time.time() - t0
    launches = nk.nqueens_neighborhood_scores.launches
    rec = out["records"][0]
    if not (out["ok"] and rec["correct"]):
        raise AssertionError(f"phase 14: {cell} failed its checks: {rec['failures']}")
    if rec["device"]["platform"] != "gpu" or rec["device"]["kind"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"phase 14: {cell} ran on {rec['device']}, not the card")
    for name in names:
        got = rec["metrics"].get(name, {})
        if not got.get("unit") or not isinstance(got.get("value"), (int, float)):
            raise AssertionError(f"phase 14: {cell}'s metric {name} is {got}")
    if len(rec["repeats"]) != 1 or not rec["breakdown"]["top_device_ops"] or launches == 0:
        raise AssertionError(f"phase 14: {cell}: {len(rec['repeats'])} repeats, breakdown "
                             f"{rec['breakdown']['top_device_ops']}, kernel launches {launches}")
    metrics = {name: rec["metrics"][name]["value"] for name in names}
    log(f"phase 14: bench_torch {cell}, one repeat: correct, on {rec['device']['kind']}, in {wall:.1f} s; "
        f"kernel launches {launches}; {metrics}")
    return {"wall_s": wall, "launches": launches, "metrics": metrics, "breakdown": rec["breakdown"]}


def phase_k3_solves(device, cells=("nqueens1000_p256", "nqueens16384_p16"), sets=()) -> dict:
    """K3's launches over one whole solve of each N-Queens cell of
    ``BENCHMARK.json`` (its configuration file and seed, ``run(max_rounds,
    chunk)`` from a fresh solver, as ``bench_torch/run.py`` times it; ``sets``
    as its ``--set``), by (P, R, C, E): E = 0 is a first pick, E > 0 a retry.
    Graphed, then eagerly with each retry's rescanned rows a lane recorded (a
    host read a retry): the same trajectory, so the same launches."""
    import torch

    from bench_torch import run as bench_run
    from constraint_solver_tpu_torch.core import problem as core_problem
    from constraint_solver_tpu_torch.ops import block_pick as bp
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver

    bench = json.loads(bench_run.BENCHMARK.read_text())
    chosen = bench_run.load_cells(bench, list(cells))
    bench_run.apply_overrides(chosen, sets)
    card = card_line() if is_cuda(device) else "cpu"
    out = {}
    pick = core_problem.block_pick
    for name, cell in chosen.items():
        config, traffic = cell["config"], cell["traffic"]
        seed = bench["seed"] + config.get("seed_suffix", "")
        kind = bench_run.KINDS[config["solver"]](config, traffic, device, seed)
        sides = {}
        for graphed in (True, False):
            rows = Counter()  # rows a lane rescans in one retry -> how many (lane, retry) pairs

            def recorded(hard, row_valid, row_min, row_arg, excl=None):
                got = pick(hard, row_valid, row_min, row_arg, excl)
                if excl is not None:
                    c = hard.shape[2]
                    flat = torch.arange(row_arg.shape[1], device=row_arg.device) * c + row_arg.long()
                    per_lane = ((flat[:, :, None] == excl[:, None, :]).any(dim=-1) & row_valid).sum(dim=1)
                    rows.update(per_lane.tolist())
                return got

            s = PopulationSolver(bench_run.counted(kind.problem, kind.iterations, False), kind.solver_config,
                                 population=config["population"], exchange_every=config["exchange_every"],
                                 cull_frac=config.get("cull_frac", 0.0), device=device, _graphed=graphed)
            shapes0, kind.iterations.calls = Counter(bp.block_pick.shapes), 0
            core_problem.block_pick = pick if graphed else recorded
            try:
                t0 = time.time()
                s.run(max_rounds=traffic["max_rounds"], chunk=traffic["chunk"])
                sync(device)
                wall = time.time() - t0
            finally:
                core_problem.block_pick = pick
            if s.get_best_score()[0] != 0:
                raise AssertionError(f"{name}: not solved: {s.get_best_score()} after {s.stats()}")
            shapes = {k: v - shapes0[k] for k, v in bp.block_pick.shapes.items() if v != shapes0[k]}
            first = sum(v for k, v in shapes.items() if k[3] == 0)
            side = {"wall_s": wall, "iterations": kind.iterations.calls, "rounds": s.stats()["rounds"],
                    "first_picks": first, "retries": sum(shapes.values()) - first,
                    "shapes": {str(k): v for k, v in shapes.items()}}
            if not graphed:
                side["rows_a_lane_a_retry"] = dict(sorted(rows.items()))
                side["rows_rescanned"] = sum(k * v for k, v in rows.items())
            sides["graphed" if graphed else "eager"] = side
            log(f"K3 over one {name} solve ({'graphed' if graphed else 'eager'}): {side}; {card}")
        if is_cuda(device) and sides["graphed"]["shapes"] != sides["eager"]["shapes"]:
            raise AssertionError(f"{name}: K3's launches differ, graphed {sides['graphed']['shapes']}, eager "
                                 f"{sides['eager']['shapes']}")
        out[name] = sides
    return out


def build_kernels() -> None:
    """Phase 1: compile the eight kernel libraries from the checkout's sources,
    one ``nvcc`` each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from constraint_solver_tpu_torch.ops import block_pick as bp
    from constraint_solver_tpu_torch.ops import fingerprint as fpk
    from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
    from constraint_solver_tpu_torch.ops import nqueens_move as nm
    from constraint_solver_tpu_torch.ops import nqueens_probes as npr
    from constraint_solver_tpu_torch.ops import nqueens_sample as ns
    from constraint_solver_tpu_torch.ops import qap_row_min as qrm
    from constraint_solver_tpu_torch.ops import sched_dense as sd

    def build(module):
        t = time.time()
        report = module.build_library(force=True)
        return module._LIB_PATH.name, report, time.time() - t

    t0 = time.time()
    modules = (nk, npr, qrm, fpk, bp, nm, sd, ns)
    with ThreadPoolExecutor(max_workers=len(modules)) as pool:
        built = [f.result() for f in [pool.submit(build, m) for m in modules]]
    for name, report, secs in built:
        log(f"phase 1: built {name} in {secs:.1f} s")
        for line in report.splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill")) or "error" in line.lower():
                log(f"  nvcc: {line.strip()}")
    log(f"phase 1: all {len(modules)} libraries in {time.time() - t0:.1f} s")


def main() -> None:
    import argparse

    import torch

    from constraint_solver_tpu_torch.ops import block_pick as bp
    from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
    from constraint_solver_tpu_torch.ops import nqueens_move as nm
    from constraint_solver_tpu_torch.ops import qap_row_min as qrm
    from constraint_solver_tpu_torch.ops import sched_dense as sd

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--kernel-only", action="store_true",
        help="run phases 1 and 2 to 2h only, print the kernels' measurements and stop (no result line)",
    )
    parser.add_argument(
        "--k3-solves", action="store_true",
        help="build the kernels, count K3's launches over one whole solve of each N-Queens cell, print them "
             "and stop (no result line)",
    )
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; the port's kernels run only on the card")

    device = torch.device("cuda", 0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_kernels()
    card = card_line()
    log(f"phase 1: card {card}")
    if args.k3_solves:
        solves = phase_k3_solves(device)
        log(card)
        log(json.dumps({"k3_solves": solves}))
        return

    kernel = phase_kernel(device)
    probe_entries, kernel["probe_shapes"] = phase_probes(device)
    k1 = phase_k1(device)
    k2 = phase_k2(device)
    k3 = phase_k3(device)
    k4 = phase_k4(device)
    k5 = phase_k5(device)
    k6, k7 = phase_k67(device)
    if args.kernel_only:
        log(card)
        log(json.dumps({"kernels": [kernel, *probe_entries, k1, *k2, k3, k4, k5, k6, k7]}))
        return
    phase_cross_device(device)
    main_run, main_solver = phase_main(device)
    k2_paths = {"nqueens_population": main_run["k2_launches"]}  # counted from 0 inside phase 4
    k3_paths = {"nqueens_population": main_run["k3_launches"]}
    k4_paths = {"nqueens_population": main_run["k4_launches"]}
    k67_paths = {"nqueens_population": main_run["k67_launches"]}
    nk.nqueens_neighborhood_scores.launches = bp.block_pick.launches = nm.nqueens_move.launches = 0
    k2_reset()
    k67_reset()
    graphs = phase_graphs(device, card=card)
    graphs_launches = nk.nqueens_neighborhood_scores.launches
    k2_paths["graphs_vs_eager"] = k2_launches()
    k3_paths["graphs_vs_eager"] = bp.block_pick.launches
    k4_paths["graphs_vs_eager"] = nm.nqueens_move.launches
    k67_paths["graphs_vs_eager"] = k67_launches()
    qrm.qap_swap_row_min.launches = sd.sched_dense.launches = 0
    k2_reset()
    graphs_domains = phase_graphs_domains(device, card=card)
    k1_paths = {"graphs_domains": qrm.qap_swap_row_min.launches}
    k2_paths["graphs_domains"] = k2_launches()
    k5_paths = {"graphs_domains": sd.sched_dense.launches}
    bp.block_pick.launches = nm.nqueens_move.launches = 0
    k67_reset()
    matrix_forms = phase_matrix_forms(device, card=card)
    k3_paths["matrix_forms"] = bp.block_pick.launches
    k4_paths["matrix_forms"] = nm.nqueens_move.launches
    k67_paths["matrix_forms"] = k67_launches()
    k67_reset()
    pmc_run = phase_pmc(device, card=card)
    k67_paths["pmc"] = k67_launches()  # K6 in the sampled-column runs; PMC keeps no fingerprints
    sd.sched_dense.launches = 0
    phase_schedule_cross_device(device)
    k5_paths["schedule_cross_device"] = sd.sched_dense.launches
    sd.sched_dense.launches = 0
    sched = phase_schedule_bench(device)
    k5_paths["schedule_bench"] = sd.sched_dense.launches
    qrm.qap_swap_row_min.launches = 0
    k2_reset()
    qap = phase_qap(device)
    k1_paths["qap"] = qrm.qap_swap_row_min.launches
    k2_paths["qap"] = k2_launches()
    ackley = phase_ackley(device)
    diagram = phase_diagram(device)
    sd.sched_dense.launches = 0
    phased = phase_phased(device)
    k5_paths["phased"] = sd.sched_dense.launches
    bp.block_pick.launches = nm.nqueens_move.launches = 0
    k67_reset()
    ckpt = phase_checkpoint(device)
    k3_paths["checkpoint_resume"] = bp.block_pick.launches
    k4_paths["checkpoint_resume"] = nm.nqueens_move.launches
    k67_paths["checkpoint_resume"] = k67_launches()
    bp.block_pick.launches = nm.nqueens_move.launches = sd.sched_dense.launches = 0
    k67_reset()
    surface = phase_surface(device, main_solver)
    k3_paths["surface"] = bp.block_pick.launches  # the nqueens CLI, the service, the trace and the roofline
    k4_paths["surface"] = nm.nqueens_move.launches
    k67_paths["surface"] = k67_launches()
    k5_paths["surface"] = sd.sched_dense.launches  # the scheduling CLI and the service's scheduling request
    missing = [path for path, n in k5_paths.items() if n == 0]
    if missing:
        raise AssertionError(f"K5 (sched_dense) never launched on the roster's paths {missing}: {k5_paths}")
    multi = phase_multi(device)
    bp.block_pick.launches = nm.nqueens_move.launches = 0
    k67_reset()
    bench = phase_bench(device)
    k3_paths["bench_nqueens"] = bp.block_pick.launches
    k4_paths["bench_nqueens"] = nm.nqueens_move.launches
    k67_paths["bench_nqueens"] = k67_launches()
    for path, launches in k67_paths.items():
        require_k67({k: v for k, v in launches.items() if path != "pmc" or k == "K6"}, f"the N-Queens path {path}")
    paths = {
        "nqueens_population": main_run["launches"],
        "graphs_vs_eager": graphs_launches,
        "pmc": pmc_run["launches"],
        "checkpoint_resume": ckpt["nqueens"]["launches"],
        "cli_nqueens": surface["cli_nqueens"]["launches"],
        "cli_pmc": surface["cli_pmc"]["launches"],
        "serve_nqueens": surface["serve"]["launches"],
        "sharded_nbr": sum(multi["sub"]["a"]["launches"]),
        "pop_sharded": sum(multi["sub"]["b"]["launches"]),
        "sharded_checkpoint": sum(multi["sub"]["e"]["launches"]),
        "bench_nqueens": bench["launches"],
    }
    kernel["launches"] = sum(paths.values())
    kernel["launches_by_path"] = paths
    k1_paths.update(checkpoint_resume=ckpt["qap"]["k1_launches"], cli_qap=surface["cli_qap"]["k1_launches"])
    k1["launches"] = sum(k1_paths.values())
    k1["launches_by_path"] = k1_paths
    k2_paths.update(checkpoint_resume_qap=ckpt["qap"]["k2_launches"],
                    checkpoint_resume_nqueens=ckpt["nqueens"]["k2_launches"],
                    cli_nqueens=surface["cli_nqueens"]["k2_launches"], cli_qap=surface["cli_qap"]["k2_launches"])
    for entry, key in zip(k2, ("K2a", "K2b", "K2a-ring")):
        entry["launches_by_path"] = {path: counts[key] for path, counts in k2_paths.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
    k3["launches"] = sum(k3_paths.values())
    k3["launches_by_path"] = k3_paths
    k4["launches"] = sum(k4_paths.values())
    k4["launches_by_path"] = k4_paths
    k5["launches"] = sum(k5_paths.values())
    k5["launches_by_path"] = k5_paths
    for entry, key in ((k6, "K6"), (k7, "K7")):
        entry["launches_by_path"] = {path: counts[key] for path, counts in k67_paths.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())

    log(json.dumps({
        "main_path": main_run, "graphs": graphs, "graphs_domains": graphs_domains, "matrix_forms": matrix_forms,
        "pmc": pmc_run, "scheduling": sched, "qap": qap, "ackley": ackley,
        "diagram": diagram, "phased": phased, "checkpoint": ckpt, "surface": surface, "multi_device": multi,
        "bench": bench, "card": card,
    }, default=str))
    log(card)
    log(json.dumps({"kernels": [kernel, *probe_entries, k1, *k2, k3, k4, k5, k6, k7]}))
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
