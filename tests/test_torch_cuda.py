"""Tests of the PyTorch port that need a CUDA device.

They import no JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a CUDA device each test skips: the CUDA kernel has no CPU mode.  The
kernel must equal its plain PyTorch version bit for bit (every value is a small
integer held in float32) at every launch plan (columns per block, staged or
not, 16- or 4-byte stores) and for inputs that are views with a storage
offset, and a solve on the card must equal the same solve on
the CPU from the same host-side draws: N-Queens, PMC (the kernel's second
caller), the dense scheduling block, QAP in its three modes and the diagram
layout.  The five probe kernels of ``bench/kernel_iso.py`` must equal their
plain versions bit for bit, staged or not, and the ported harness's loops must
give the CPU's sums.  The incremental QAP state must stay exact on the card.  The user
surface runs on the card too: the nqueens CLI launches the kernel, the HTTP
service answers a round, the roofline counts the kernel's launches, and
threads that reach the kernel's first use together build it once.  The descent
replayed as CUDA graphs equals the eager loop bit for bit, after a checkpoint's
``load`` too and on two threads at once, for N-Queens and for scheduling, QAP,
Ackley and the diagram layout; so does PMC's step loop (full block and sampled
columns), which ``ParallelMinConflictsSolver`` replays by default.  The matrix
forms of the N-Queens block (``block_impl="mxu_conv"``, ``"mxu_toeplitz"``)
equal the kernel's block bit for bit and replay as graphs too.  K3, the block
pick, equals its plain version bit for bit at ``chip_smoke.py`` phase 2e's
cases and on floats with NaN, counts through graph replays, and raises
instead of falling back.  K4, the masked N-Queens move with its best board,
equals its plain version bit for bit at phase 2f's cases and on edge shapes,
at its plan and at 1, 3 and 8 blocks a lane, adds the column scores by a
reduction (its SASS), counts through graph replays and raises.  K5, the
roster's dense neighborhood, equals its plain version on every output at phase
2g's cases and on edge shapes, counts through graph replays and raises.  QAP's
incremental move written in place, with the best carried by its permutation,
equals the select form bit for bit.  K6, the N-Queens column sample, and
K7, the N-Queens candidates' fingerprints, equal their plain versions bit for
bit at phase 2h's cases, at every placement of K6's plan and through graph
replays, raise instead of falling back, and a graphed headline solve keeps
the eager one's trajectory.  Two gloo
ranks sharing the card run the pop- and nbr-sharded N-Queens solves, equal to
the same sharded solves on the CPU (the rank bodies are in
``tests/torch_ranks.py``)."""

import datetime

import numpy as np
import pytest
import torch

from constraint_solver_tpu_torch.core.ils import SolverConfig
from constraint_solver_tpu_torch.models.ackley import make_ackley_problem
from constraint_solver_tpu_torch.models.diagram_layout import DiagramLayoutSpec, make_diagram_layout_problem
from constraint_solver_tpu_torch.models.nqueens import build_state, make_nqueens_problem, matrix_block, total_conflicts
from constraint_solver_tpu_torch.models.nqueens_parallel import (
    ParallelMinConflictsSolver,
    PMCGraphs,
    pmc_init,
    pmc_run,
    pmc_solve,
)
from constraint_solver_tpu_torch.models.qap import QAPSpec, make_qap_problem
from constraint_solver_tpu_torch.models.scheduling import ScheduleSpec, make_scheduling_problem
from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
from constraint_solver_tpu_torch.ops import nqueens_probes as npr
from constraint_solver_tpu_torch.parallel.population import PopulationSolver
from constraint_solver_tpu_torch.utils.convert import to_reference
from constraint_solver_tpu_torch.utils.draws import TorchDraws


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _inputs(rng, p, a, n, device):
    st = build_state(torch.as_tensor(rng.integers(0, n, size=(p, n)), device=device))
    c = torch.as_tensor(np.argsort(rng.random((p, n)), axis=1)[:, :a], device=device)
    r = st.rows.gather(1, c)
    removed = (st.rc.gather(1, r) - 1) + (st.dc.gather(1, r - c + n - 1) - 1) + (st.ac.gather(1, r + c) - 1)
    cur = total_conflicts(st.rows).to(torch.float32)
    return st.rc, st.dc, st.ac, c.to(torch.int32), r.to(torch.int32), removed, cur


STAGED_MAX_N = 11_617  # the largest n whose tables fit in a block's shared memory


@pytest.mark.cuda
@pytest.mark.parametrize(
    "p, a, n",
    [
        (256, 50, 1000), (1, 1000, 1000), (4, 64, 64), (4, 3, 8), (8, 5, 1003), (2, 3, 14000), (3, 1, 1),
        # A not a multiple of the plan's columns per block (1, 2, 4 and 8 warps)
        (3, 13, 1000), (32, 13, 1000), (16, 50, 1000), (128, 50, 1000),
        # n % 4 != 0 at a large A: 4-byte stores
        (16, 50, 1001),
        # n just below and just above the staging threshold, with and without 16-byte stores
        (2, 3, STAGED_MAX_N - 1), (2, 3, STAGED_MAX_N), (2, 3, STAGED_MAX_N + 1), (2, 3, STAGED_MAX_N + 3),
    ],
)
def test_cuda_kernel_matches_plain_version(cuda, p, a, n):
    args = _inputs(np.random.default_rng(n), p, a, n, cuda)
    before = nk.nqueens_neighborhood_scores.launches
    got = nk.nqueens_neighborhood_scores(*args)
    torch.cuda.synchronize()
    assert nk.nqueens_neighborhood_scores.launches == before + 1
    for want, g in zip(nk.nqueens_neighborhood_scores_ref(*args), got):
        assert want.dtype == g.dtype and torch.equal(want, g)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("p, a, n", [(256, 50, 1000), (16, 50, 1001), (2, 3, 14000)])
def test_cuda_kernel_takes_views_with_a_storage_offset(cuda, p, a, n, offset):
    """Contiguous views that start ``offset`` elements into their storage, so
    no table row is on 16 bytes: the wrapper documents that it takes them, and
    the kernel gives the plain version's bits."""
    args = _inputs(np.random.default_rng(offset), p, a, n, cuda)

    def shifted(t):
        view = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)[offset:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.storage_offset() == offset
        return view

    got = nk.nqueens_neighborhood_scores(*(shifted(t) for t in args))
    torch.cuda.synchronize()
    for want, g in zip(nk.nqueens_neighborhood_scores_ref(*args), got):
        assert want.dtype == g.dtype and torch.equal(want, g)


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back(cuda):
    args = list(_inputs(np.random.default_rng(0), 2, 3, 16, cuda))
    args[3] = args[3].long()
    with pytest.raises(TypeError):
        nk.nqueens_neighborhood_scores(*args)
    args[3] = args[3].int().cpu()
    with pytest.raises(ValueError):
        nk.nqueens_neighborhood_scores(*args)


PROBE_SHAPES = [
    (256, 50, 1000), (4, 3, 8), (3, 13, 130), (8, 5, 1003), (16, 41, 2048),
    # n_pad at and above each format's staging limit: f32 11,520, packed 19,328, int16 23,168
    (2, 3, 11520), (2, 3, 11521), (2, 3, 16384), (1, 5, 19328), (1, 5, 19329), (1, 5, 23168), (1, 5, 23169),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(npr.PROBES))
@pytest.mark.parametrize("p, a, n", PROBE_SHAPES)
def test_cuda_probe_matches_plain_version(cuda, name, p, a, n):
    """Each probe kernel of ``bench/kernel_iso.py`` equals its plain version bit
    for bit on the whole padded block, min and argmin, staged or not."""
    args = _inputs(np.random.default_rng(n), p, a, n, cuda)
    before = npr.WRAPPERS[name].launches
    got = npr.WRAPPERS[name](*args)
    torch.cuda.synchronize()
    assert npr.WRAPPERS[name].launches == before + 1
    want = npr.REFS[name](*args)
    assert len(got) == len(want) == (3 if npr.PROBES[name].with_min else 1)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.shape == g.shape and torch.equal(w, g)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["kern_i16min", "kern_packed"])
@pytest.mark.parametrize("n", [1003, 16300])
def test_cuda_probe_row_min_skips_the_padding_columns(cuda, name, n):
    """rc of 4s, dc and ac of 2s: every valid column's three terms sum to at
    least 5, a padding column's (rc 0 there) to at most 4, so only the kernel's
    mask keeps the padding out of the min."""
    rc, dc, ac, c, r, removed, cur = _inputs(np.random.default_rng(3), 4, 9, n, cuda)
    args = (torch.full_like(rc, 4.0), torch.full_like(dc, 2.0), torch.full_like(ac, 2.0), c, r, removed, cur)
    got = npr.WRAPPERS[name](*args)
    torch.cuda.synchronize()
    for w, g in zip(npr.REFS[name](*args), got):
        assert torch.equal(w, g)
    assert torch.all(got[0].amin(dim=-1) < got[1]) and torch.all(got[2] < n)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["kern_i16", "kern_i16min", "kern_packed"])
def test_cuda_probe_with_tables_from_global_memory(cuda, name):
    p, a, n = 4, 9, 16384
    rc, dc, ac, c, r, removed, cur = _inputs(np.random.default_rng(1), p, a, n, cuda)
    plan = npr.launch_plan(name, p, a, n)
    assert plan.staged
    want = npr.REFS[name](rc, dc, ac, c, r, removed, cur)
    outs = tuple(torch.empty_like(w) for w in want)
    tables = npr.prepare_tables(npr.PROBES[name].table, rc, dc, ac)
    npr._launch(name, tables, c, r, removed, cur, outs, p, a, n, plan._replace(staged=False, smem_bytes=0))
    torch.cuda.synchronize()
    assert all(torch.equal(w, g) for w, g in zip(want, outs))


@pytest.mark.cuda
def test_cuda_probe_harness_equals_cpu(cuda):
    """The ported harness's loops give the same sums on the card and on the CPU."""
    from constraint_solver_tpu_torch.bench import kernel_iso

    n, p, k = 200, 3, 4
    a = n // 20
    for kern in npr.WRAPPERS.values():
        loop = kernel_iso.build(kern, k)
        on_card = loop(*kernel_iso.inputs(n, p, a, cuda)).cpu()
        assert torch.equal(on_card, loop(*kernel_iso.inputs(n, p, a, "cpu")))
    for impl in ("slice", "conv", "toeplitz"):
        loop = kernel_iso.build_xla(impl, k)
        assert torch.equal(loop(*kernel_iso.inputs(n, p, a, cuda)).cpu(), loop(*kernel_iso.inputs(n, p, a, "cpu")))


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [None, False])
def test_cuda_solve_equals_cpu_solve(cuda, exact):
    def run(device):
        config = SolverConfig(
            seed="cuda-vs-cpu", local_search_max_iterations=20, best_solutions_capacity=4,
            all_solutions_capacity=32, restart_every=3, tabu_exact_filter=exact,
        )
        solver = PopulationSolver(
            make_nqueens_problem(40), config, population=6, exchange_every=2, device=device,
            draws=TorchDraws(config.seed, 6, device, draw_device="cpu"),
        )
        trace = np.concatenate([solver.execute_chunk_traced(2) for _ in range(2)])
        return to_reference(solver.state), trace

    (on_card, trace_card), (on_cpu, trace_cpu) = run(cuda), run("cpu")
    np.testing.assert_array_equal(trace_card, trace_cpu)
    compare(on_card, on_cpu)


def compare(a, b):
    if hasattr(a, "_fields"):
        for f in a._fields:
            compare(getattr(a, f), getattr(b, f))
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("sample_cols", [None, 16])
def test_cuda_pmc_launches_the_kernel_and_equals_cpu(cuda, sample_cols):
    def run(device):
        draws = TorchDraws("pmc", 4, device, draw_device="cpu")
        return pmc_solve(64, draws, max_steps=300, sample_cols=sample_cols)

    before = nk.nqueens_neighborhood_scores.launches
    on_card = run(cuda)
    torch.cuda.synchronize()
    assert nk.nqueens_neighborhood_scores.launches > before
    compare(to_reference(on_card), to_reference(run("cpu")))
    assert torch.equal(on_card.score.cpu(), total_conflicts(on_card.state.rows).cpu().float())


@pytest.mark.cuda
@pytest.mark.parametrize("sample_cols", [None, 16], ids=["full", "sampled"])
def test_cuda_graphed_pmc_equals_eager(cuda, sample_cols):
    """PMC's step loop replayed as CUDA graphs, drawing on the card, through one
    holder over two calls: the eager loop's carry, generator state and kernel
    launches."""

    def run(graphed):
        draws = TorchDraws("pmc-graphs", 4, cuda)
        holder = PMCGraphs() if graphed else None
        before = nk.nqueens_neighborhood_scores.launches
        kw = dict(sample_cols=sample_cols, graphs=holder, _graphed=graphed)
        carry = pmc_run(pmc_init(64, draws), draws, 13, **kw)
        out = pmc_run(carry, draws, 300, **kw)
        torch.cuda.synchronize()
        return holder, to_reference(out), draws.state_dict()["generator"], nk.nqueens_neighborhood_scores.launches - before

    (holder, got, generator, launches), (_, want, want_generator, want_launches) = run(True), run(False)
    compare(got, want)
    assert torch.equal(generator, want_generator) and launches == want_launches > 0
    (unit,) = holder._units.values()
    assert unit._step_graph is not None and holder.capture_s > 0


@pytest.mark.cuda
def test_cuda_pmc_solver_replays_graphs_by_default(cuda):
    graphed = ParallelMinConflictsSolver(64, seed="pmc-solver", population=4, device=cuda)
    eager = ParallelMinConflictsSolver(64, seed="pmc-solver", population=4, device=cuda, _graphed=False)
    (unit,) = graphed.graphs._units.values()
    assert unit._step_graph is not None and eager.graphs is None
    assert graphed.stats() == eager.stats()
    (score, _), state = graphed.get_best_solution()
    assert score == eager.get_best_solution()[0][0] == 0.0
    compare(state, eager.get_best_solution()[1])


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["mxu_conv", "mxu_toeplitz"])
@pytest.mark.parametrize("p, a, n", [(8, 50, 1000), (4, 64, 64), (1, 1000, 1000), (3, 13, 101)])
def test_cuda_matrix_forms_equal_the_kernel_block(cuda, impl, p, a, n):
    args = _inputs(np.random.default_rng(n + a), p, a, n, cuda)
    before = nk.nqueens_neighborhood_scores.launches
    want = nk.nqueens_neighborhood_scores(*args)
    got = matrix_block(impl, *args)
    torch.cuda.synchronize()
    assert nk.nqueens_neighborhood_scores.launches == before + 1  # the matrix form launches no B1
    for w, g in zip(want, got, strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["mxu_conv", "mxu_toeplitz"])
def test_cuda_graphed_matrix_forms_equal_eager(cuda, impl):
    def run(graphed):
        config = SolverConfig(seed=f"graphs-{impl}", local_search_max_iterations=20, all_solutions_capacity=32)
        s = PopulationSolver(make_nqueens_problem(40, block_impl=impl), config, population=6, exchange_every=2,
                             device=cuda, _graphed=graphed)
        trace = np.concatenate([s.execute_chunk_traced(2) for _ in range(2)])
        return s, to_reference(s.state), trace, s.draws.state_dict()["generator"]

    (graphed, *got), (_, *want) = run(True), run(False)
    compare(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert torch.equal(got[2], want[2]) and len(graphed.program.graphs._units) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("proposer", ["dense", "random"])
def test_cuda_scheduling_block_equals_cpu(cuda, proposer):
    d0 = datetime.date(2024, 1, 1)
    hol = {e: [d0 + datetime.timedelta(days=(17 * e + 11 * k) % 365) for k in range(10)] for e in range(20)}
    spec = ScheduleSpec.from_dates(d0, d0 + datetime.timedelta(days=364), 20, hol)
    problem = make_scheduling_problem(spec, proposer=proposer, n_rand_swaps=256)

    def block(device):
        draws = TorchDraws("sched", 8, device, draw_device="cpu")
        assign = problem.init(draws)
        nb = problem.neighborhood(assign, problem.score(assign), draws, torch.ones(8, dtype=torch.bool, device=device))
        return [x.cpu() for x in (nb.scores, nb.valid, nb.fp_deltas, *nb.moves)]

    for got, want in zip(block(cuda), block("cpu")):
        assert got.dtype == want.dtype and torch.equal(got, want)


def _qap_run(device, n, **kw):
    config = SolverConfig(
        seed="qap-cuda", local_search_max_iterations=30, best_solutions_capacity=4, all_solutions_capacity=64,
        all_solution_iteration_expiry=1000, restart_every=3,
    )
    solver = PopulationSolver(
        make_qap_problem(QAPSpec.random(n, seed=0), **kw), config, population=6, exchange_every=2, device=device,
        draws=TorchDraws(config.seed, 6, device, draw_device="cpu"),
    )
    trace = np.concatenate([solver.execute_chunk_traced(2) for _ in range(2)])
    return solver, trace


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [{}, {"compact": True}, {"incremental": True}], ids=["dense", "compact", "incremental"])
def test_cuda_qap_equals_cpu(cuda, mode):
    """QAP at n=64 from host-side draws: every score is an exact integer and
    every product exact in FP32, so the card's run equals the CPU's."""
    (on_card, trace_card), (on_cpu, trace_cpu) = _qap_run(cuda, 64, **mode), _qap_run("cpu", 64, **mode)
    np.testing.assert_array_equal(trace_card, trace_cpu)
    compare(to_reference(on_card.state), to_reference(on_cpu.state))


@pytest.mark.cuda
def test_cuda_qap_incremental_state_stays_exact(cuda):
    """The carried G and H of every lane after 4 rounds at n=512 equal
    D[p][:, p] and F G, computed apart (a host gather, a float64 product)."""
    n = 512
    solver, _ = _qap_run(cuda, n, incremental=True)
    flow, dist = QAPSpec.random(n, seed=0).arrays()
    st = solver.state.current_state
    for k, p in enumerate(st.p.cpu().numpy()):
        g = dist[np.ix_(p, p)]
        np.testing.assert_array_equal(st.g[k].cpu().numpy(), g)
        np.testing.assert_array_equal(st.h[k].cpu().numpy().astype(np.float64), flow.astype(np.float64) @ g)


# The ring path (n % 4 == 0) at the solvers' shapes and at a stage edge (4100:
# an odd strip count, a last tile of 4 columns), the ragged path at n % 4 != 0.
K1_SHAPES = [(1, 7), (3, 130), (4, 1000), (64, 256), (16, 1024), (4, 4096), (2, 30), (5, 1003), (3, 4098),
             (1, 4100)]


def _k1_inputs(kind, p, n, device, seed=0):
    """(h, g, flow, cur_score [P, 2]) on ``device``: "ties" holds values of 0
    and 1, so most rows' minima tie between partners; "zeros" signed zeros in
    every table and cur = -0.0, so every row ties at ±0; "float" non-integer
    floats, whose operations round; "nan" those with NaNs planted in a few
    rows, directly and through H's transpose, one below the diagonal, and on
    the first and last column of a tile (row 33 at b = 96 through G, row 40 at
    b = 159 through H[b, a])."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        h, g = (rng.integers(0, 2, (p, n, n)).astype(np.float32) for _ in range(2))
        flow = rng.integers(0, 2, (n, n)).astype(np.float32)
    elif kind == "zeros":
        h, g = (np.where(rng.random((p, n, n)) < 0.5, -0.0, 0.0).astype(np.float32) for _ in range(2))
        flow = np.where(rng.random((n, n)) < 0.5, -0.0, 0.0).astype(np.float32)
    else:
        h = rng.normal(0.0, 1e3, (p, n, n)).astype(np.float32)
        g = rng.normal(0.0, 1.0, (p, n, n)).astype(np.float32)
        flow = rng.normal(0.0, 10.0, (n, n)).astype(np.float32)
    if kind == "nan" and n > 4:
        g[0, 1, n - 1] = g[0, 1, 3] = h[p - 1, n - 1, 2] = g[p - 1, 4, 0] = np.nan
    if kind == "nan" and n > 200:
        g[0, 33, 96] = h[p - 1, 159, 40] = np.nan
    cur = np.stack([rng.normal(1e5, 1e3, p), np.zeros(p)], 1).astype(np.float32)
    if kind == "zeros":
        cur[:, 0] = -0.0
    return tuple(torch.from_numpy(a).to(device) for a in (h, g, flow, cur))


def _k1_equal(got, want):
    """rmin's bits and rarg equal (NaNs compared as NaN, whatever their payload)."""
    (rmin, rarg), (wmin, warg) = got, want
    assert rarg.dtype == warg.dtype == torch.int64 and torch.equal(rarg, warg)
    nan = rmin.isnan()
    assert torch.equal(nan, wmin.isnan())
    assert torch.equal(rmin[~nan].view(torch.int32), wmin[~nan].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ties", "zeros", "float", "nan"])
@pytest.mark.parametrize("p, n", K1_SHAPES)
def test_cuda_qap_row_min_matches_plain_version(cuda, p, n, kind):
    """K1 equals its plain version bit for bit on both paths of its plan,
    ``cur`` a strided view as the neighborhoods pass it; ties go to the smaller
    partner (±0 included), a NaN to the first NaN, row n - 1 gives (inf, 0)."""
    from constraint_solver_tpu_torch.ops import qap_row_min as qrm

    h, g, flow, cur_score = _k1_inputs(kind, p, n, cuda)
    before = qrm.qap_swap_row_min.launches
    got = qrm.qap_swap_row_min(h, g, flow, cur_score[:, 0])
    torch.cuda.synchronize()
    assert qrm.qap_swap_row_min.launches == before + 1
    _k1_equal(got, qrm.qap_swap_row_min_ref(h, g, flow, cur_score[:, 0]))
    assert got[0][:, -1].isinf().all() and (got[1][:, -1] == 0).all()
    if kind == "nan" and n > 4:
        assert got[0][0, 1].isnan() and int(got[1][0, 1]) == 3 and int(got[1][p - 1, 2]) == n - 1
    if kind == "nan" and n > 200:
        assert got[0][0, 33].isnan() and int(got[1][0, 33]) == 96
        assert got[0][p - 1, 40].isnan() and int(got[1][p - 1, 40]) == 159
    if kind == "zeros":
        assert (got[1][:, :-1] == torch.arange(1, n, device=cuda)).all() and (got[0][:, :-1] == 0).all()


@pytest.mark.cuda
def test_cuda_qap_row_min_takes_the_ragged_path_off_16_bytes(cuda):
    """Tables that start 4 bytes past 16 (a view with a storage offset) at n %
    4 == 0: the plan takes the ragged path, bit for bit the plain version."""
    from constraint_solver_tpu_torch.ops import qap_row_min as qrm

    p, n = 3, 256
    h, g, flow, cur_score = _k1_inputs("float", p, n, cuda)
    h = torch.cat([h.new_zeros(1), h.flatten()])[1:].view(p, n, n)
    assert h.data_ptr() % 16 == 4 and qrm._launch_plan(p, n, False).path == "ragged"
    got = qrm.qap_swap_row_min(h, g, flow, cur_score[:, 0])
    torch.cuda.synchronize()
    _k1_equal(got, qrm.qap_swap_row_min_ref(h, g, flow, cur_score[:, 0]))


@pytest.mark.cuda
def test_cuda_qap_row_min_launches_count_through_graph_replays(cuda):
    """A capture counts no K1 launch; each replay counts what it captured and
    rewrites the plain version's result.  A graphed QAP solve (compact and
    incremental) launches K1 as often as the eager one, bit for bit the same
    trajectory."""
    from collections import Counter

    from constraint_solver_tpu_torch.core import graphed
    from constraint_solver_tpu_torch.ops import qap_row_min as qrm

    fn = qrm.qap_swap_row_min
    h, g, flow, cur_score = _k1_inputs("float", 4, 256, cuda)
    want = qrm.qap_swap_row_min_ref(h, g, flow, cur_score[:, 0])
    fn(h, g, flow, cur_score[:, 0])  # built and loaded before the capture
    torch.cuda.synchronize()
    before = fn.launches
    seg = graphed.capture(lambda: fn(h, g, flow, cur_score[:, 0]), torch.cuda.CUDAGraph(), torch.cuda.Stream(cuda))
    assert fn.launches == before and seg.launches == Counter({(fn, (4, 256)): 1})
    for _ in range(3):
        seg.out[0].fill_(0.0)
        seg.replay()
    torch.cuda.synchronize()
    assert fn.launches == before + 3
    _k1_equal(seg.out, want)
    for domain in ("qap-compact", "qap-incremental"):
        counts = {}
        for graphed_run in (False, True):
            before = fn.launches
            s, *out = _domain_run(cuda, domain, None, graphed_run)
            counts[graphed_run] = (fn.launches - before, out)
        (eager_launches, want_out), (graph_launches, got_out) = counts[False], counts[True]
        assert graph_launches == eager_launches > 0 and len(s.program.graphs._units) == 1
        compare(got_out[0], want_out[0])
        np.testing.assert_array_equal(got_out[1], want_out[1])


@pytest.mark.cuda
def test_cuda_qap_row_min_raises_instead_of_falling_back(cuda, tmp_path, monkeypatch):
    """A build that fails raises, and so does a bad input: no plain version on
    the card."""
    from constraint_solver_tpu_torch.ops import qap_row_min as qrm

    h, g, flow, cur_score = _k1_inputs("float", 2, 16, cuda)
    with pytest.raises(TypeError):
        qrm.qap_swap_row_min(h.double(), g, flow, cur_score[:, 0])
    with pytest.raises(ValueError):
        qrm.qap_swap_row_min(h, g.cpu(), flow, cur_score[:, 0])
    monkeypatch.setattr(qrm, "_LIB_PATH", tmp_path / "libqap_row_min.so")
    monkeypatch.setattr(qrm, "_launch_fn", None)
    monkeypatch.setattr(nk.subprocess, "run",
                        lambda cmd, **kw: nk.subprocess.CompletedProcess(cmd, 1, "", "error: planted"))
    before = qrm.qap_swap_row_min.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        qrm.qap_swap_row_min(h, g, flow, cur_score[:, 0])
    assert qrm.qap_swap_row_min.launches == before


@pytest.mark.cuda
def test_cuda_diagram_layout_equals_cpu(cuda):
    def run(device):
        config = SolverConfig(
            seed="diagram-cuda", local_search_max_iterations=20, best_solutions_capacity=4,
            all_solutions_capacity=64, restart_every=3,
        )
        solver = PopulationSolver(
            make_diagram_layout_problem(DiagramLayoutSpec.random(12, 16, 10, seed=2)), config, population=4,
            exchange_every=2, device=device, draws=TorchDraws(config.seed, 4, device, draw_device="cpu"),
        )
        trace = np.concatenate([solver.execute_chunk_traced(2) for _ in range(2)])
        return to_reference(solver.state), trace

    (on_card, trace_card), (on_cpu, trace_cpu) = run(cuda), run("cpu")
    np.testing.assert_array_equal(trace_card, trace_cpu)
    compare(on_card, on_cpu)


@pytest.mark.cuda
def test_cuda_nqueens_cli_launches_the_kernel(cuda, capsys):
    from constraint_solver_tpu_torch.cli import nqueens

    before = nk.nqueens_neighborhood_scores.launches
    assert nqueens.main(["--board-size", "64", "--device", "cuda", "--quiet"]) == 0
    torch.cuda.synchronize()
    assert nk.nqueens_neighborhood_scores.launches > before
    assert "result.score: 0" in capsys.readouterr().out


@pytest.mark.cuda
def test_cuda_service_round(cuda):
    from constraint_solver_tpu_torch.serve.server import SolverService

    service = SolverService("cuda")
    sid = service.create({"problem": "nqueens", "boardSize": 32, "seed": "serve"})
    before = nk.nqueens_neighborhood_scores.launches
    r = service.round(sid)
    rows = np.array(r["result"]["rows"])
    assert nk.nqueens_neighborhood_scores.launches > before
    assert r["result"]["score"]["hard_score"] == float(total_conflicts(torch.as_tensor(rows)))
    service.delete(sid)


def _graphs_solver(device, exact, graphed, seed="graphs", in_place=True):
    """nqueens-40, 6 lanes, drawing on ``device``: on the card its descents
    replay as CUDA graphs unless ``graphed`` is False; ``in_place`` False
    strips the problem's masked move (the select form)."""
    config = SolverConfig(
        seed=seed, local_search_max_iterations=20, best_solutions_capacity=4,
        all_solutions_capacity=32, restart_every=3, tabu_exact_filter=exact,
    )
    problem = make_nqueens_problem(40)
    if not in_place:
        problem = problem._replace(in_place=None)
    return PopulationSolver(problem, config, population=6, exchange_every=2, device=device, _graphed=graphed)


def _graphs_run(solver, chunks=2):
    before = nk.nqueens_neighborhood_scores.launches
    trace = np.concatenate([solver.execute_chunk_traced(2) for _ in range(chunks)])
    return (to_reference(solver.state), trace, solver.stats(), solver.draws.state_dict()["generator"],
            nk.nqueens_neighborhood_scores.launches - before)


def _graphs_equal(a, b):
    compare(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2] == b[2] and torch.equal(a[3], b[3]) and a[4] == b[4] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [None, False])
def test_cuda_graphed_descent_equals_eager(cuda, exact):
    """The descent replayed as CUDA graphs follows the eager loop's trajectory
    bit for bit, draws the same numbers and counts the same kernel launches."""
    graphed = _graphs_solver(cuda, exact, True)
    got = _graphs_run(graphed)
    _graphs_equal(got, _graphs_run(_graphs_solver(cuda, exact, False)))
    assert len(graphed.program.graphs._units) == 1 and graphed.program.graphs.capture_s > 0


@pytest.mark.cuda
def test_cuda_graphed_single_lane_solver_equals_eager(cuda):
    """``Solver`` (one lane) owns its graphs too."""
    from constraint_solver_tpu_torch.core.ils import Solver

    def run(graphed):
        config = SolverConfig(seed="one-lane", local_search_max_iterations=30, all_solutions_capacity=32)
        s = Solver(make_nqueens_problem(40), config, device=cuda, _graphed=graphed)
        for _ in range(4):
            s.execute_round()
        return s, to_reference(s.state)

    (graphed, got), (_, want) = run(True), run(False)
    compare(got, want)
    assert len(graphed.graphs._units) == 1


@pytest.mark.cuda
def test_cuda_graphed_descent_resumes_from_a_checkpoint(cuda, tmp_path):
    """``load`` replaces the solver's tensors and the generator's state: the
    next descent copies them into the static carry, so a graphed solver that
    loads its own earlier checkpoint follows the same trajectory again."""
    s = _graphs_solver(cuda, False, True)
    s.execute_chunk_traced(2)
    path = str(tmp_path / "graphs")
    s.save(path)
    want = _graphs_run(s)
    s.load(path)
    _graphs_equal(_graphs_run(s), want)
    fresh = _graphs_solver(cuda, False, True)
    fresh.load(path)
    _graphs_equal(_graphs_run(fresh), want)


@pytest.mark.cuda
def test_cuda_graphed_solvers_on_two_threads(cuda):
    """Two graphed solvers captured and replayed on two threads at once (the
    service's handler threads) each equal the eager run, and the kernel's
    counter holds every launch."""
    import threading

    want = {
        exact: _graphs_run(_graphs_solver(cuda, exact, False, seed=f"threads-{exact}")) for exact in (None, False)
    }
    before = nk.nqueens_neighborhood_scores.launches
    got, errors = {}, []

    def work(exact):
        try:
            got[exact] = _graphs_run(_graphs_solver(cuda, exact, True, seed=f"threads-{exact}"))
        except Exception as e:  # re-raised below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=work, args=(exact,)) for exact in (None, False)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    for exact in (None, False):
        compare(got[exact][0], want[exact][0])
        np.testing.assert_array_equal(got[exact][1], want[exact][1])
        assert got[exact][2] == want[exact][2] and torch.equal(got[exact][3], want[exact][3])
    assert nk.nqueens_neighborhood_scores.launches - before == want[None][4] + want[False][4]


def _domain_problem(domain):
    spec = ScheduleSpec.from_dates(datetime.date(2022, 5, 9), datetime.date(2022, 6, 8), 7)
    qap = QAPSpec.random(24, seed=0)
    return {
        "scheduling-dense": lambda: make_scheduling_problem(spec, proposer="dense", n_rand_swaps=16),
        "scheduling-random": lambda: make_scheduling_problem(spec, window_size=24, proposer="random"),
        "scheduling-systematic": lambda: make_scheduling_problem(spec, proposer="systematic"),
        "qap-dense": lambda: make_qap_problem(qap),
        "qap-compact": lambda: make_qap_problem(qap, compact=True),
        "qap-incremental": lambda: make_qap_problem(qap, incremental=True),
        "ackley": lambda: make_ackley_problem(6),
        "diagram": lambda: make_diagram_layout_problem(DiagramLayoutSpec.random(8, 10, 8, seed=0)),
    }[domain]()


def _domain_run(device, domain, exact, graphed):
    """Two chunks of 2 rounds of ``domain`` with 6 lanes, drawing on ``device``:
    (solver, state, traces, stats, generator state)."""
    config = SolverConfig(
        seed=f"graphs-{domain}", local_search_max_iterations=20, best_solutions_capacity=4,
        all_solutions_capacity=32, restart_every=3, tabu_exact_filter=exact,
    )
    s = PopulationSolver(_domain_problem(domain), config, population=6, exchange_every=2, device=device,
                         _graphed=graphed)
    trace = np.concatenate([s.execute_chunk_traced(2) for _ in range(2)])
    return s, to_reference(s.state), trace, s.stats(), s.draws.state_dict()["generator"]


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False], ids=["exact-filter", "pick-then-check"])
@pytest.mark.parametrize("domain", ["scheduling-dense", "scheduling-random", "scheduling-systematic", "qap-dense",
                                    "qap-compact", "qap-incremental", "ackley", "diagram"])
def test_cuda_graphed_domains_equal_eager(cuda, domain, exact):
    """Every domain that opts in replays its descents as graphs on the card,
    bit for bit the eager trajectory, with the same draws."""
    graphed, *got = _domain_run(cuda, domain, exact, True)
    _, *want = _domain_run(cuda, domain, exact, False)
    compare(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] and torch.equal(got[3], want[3])
    assert len(graphed.program.graphs._units) == 1 and graphed.program.graphs.capture_s > 0


@pytest.mark.cuda
def test_cuda_qap_inplace_move_and_keyed_best_equal_the_select_form(cuda):
    """QAP incremental at n = 512, P = 4, graphed, two rounds: with the masked
    in-place move and the best carried by its permutation, and with
    ``in_place`` stripped (the select form), the state trees are equal bit for bit,
    and so are the traces and ``stats()``."""
    from constraint_solver_tpu_torch.utils.tree import tree_leaves

    problem = make_qap_problem(QAPSpec.random(512, seed=0), incremental=True)
    config = SolverConfig(seed="qap-inplace", local_search_max_iterations=50, best_solutions_capacity=4,
                          all_solutions_capacity=64, max_allow_no_improvement_for=5)
    runs = []
    for prob in (problem, problem._replace(in_place=None)):
        s = PopulationSolver(prob, config, population=4, device=cuda)
        runs.append((s.execute_chunk_traced(2), s.state, s.stats()))
        assert len(s.program.graphs._units) == 1 and s.program.graphs.capture_s > 0
    (trace, state, stats), (trace0, state0, stats0) = runs
    np.testing.assert_array_equal(trace, trace0)
    assert stats == stats0 and stats["ls_iterations"] > 0
    for x, y in zip(tree_leaves(state), tree_leaves(state0), strict=True):
        bits = (lambda t: t.view(torch.int32)) if x.dtype == torch.float32 else (lambda t: t)
        assert x.dtype == y.dtype and torch.equal(bits(x), bits(y))


@pytest.mark.cuda
def test_cuda_graphed_scheduling_and_nqueens_on_two_threads(cuda):
    """A scheduling solver and an N-Queens solver (the service's two kinds of
    client) captured and replayed on two threads at once each equal the eager
    run."""
    import threading

    def run(kind, graphed):
        if kind == "nqueens":
            return _graphs_run(_graphs_solver(cuda, None, graphed, seed="threads-nqueens"))[:4]
        return tuple(_domain_run(cuda, "scheduling-dense", None, graphed)[1:])

    want = {kind: run(kind, False) for kind in ("nqueens", "scheduling")}
    got, errors = {}, []

    def work(kind):
        try:
            got[kind] = run(kind, True)
        except Exception as e:  # re-raised below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=work, args=(kind,)) for kind in want]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    for kind in want:
        compare(got[kind][0], want[kind][0])
        np.testing.assert_array_equal(got[kind][1], want[kind][1])
        assert got[kind][2] == want[kind][2] and torch.equal(got[kind][3], want[kind][3])


@pytest.mark.cuda
def test_cuda_roofline_counts_the_kernel_launches(cuda):
    solver = PopulationSolver(
        make_nqueens_problem(64), SolverConfig(seed="roofline", local_search_max_iterations=20), population=8,
        exchange_every=2, device=cuda,
    )
    solver.run(max_rounds=1, chunk=1)
    before = nk.nqueens_neighborhood_scores.launches
    r = solver.roofline()
    launches = nk.nqueens_neighborhood_scores.launches - before
    kern = r["kernels"][nk.KERNEL_NAME]
    assert r["chip"] == "h100-sxm" and launches > 0 and kern["calls"] == launches
    assert kern["bytes"] == launches * nk.kernel_work(8, 64 // 20, 64)[1]
    assert all(0 < r[k] <= 1.05 for k in ("mfu_bf16", "mfu_f32", "hbm_frac"))


@pytest.mark.cuda
def test_cuda_concurrent_first_use_builds_once(cuda, tmp_path, monkeypatch):
    """Threads reach the kernel's first use together: ``nvcc`` runs once and
    every thread launches the one library."""
    import threading

    monkeypatch.setattr(nk, "_LIB_PATH", tmp_path / "libnqueens_scores.so")
    monkeypatch.setattr(nk, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(nk, "_launch_fn", None)
    compiles = []
    run = nk.subprocess.run
    monkeypatch.setattr(nk.subprocess, "run", lambda cmd, **kw: compiles.append(cmd) or run(cmd, **kw))
    args = _inputs(np.random.default_rng(0), 4, 5, 64, cuda)
    want = nk.nqueens_neighborhood_scores_ref(*args)
    barrier = threading.Barrier(4)
    got, errors = [], []

    def first_use():
        try:
            barrier.wait(timeout=60)
            out = nk.nqueens_neighborhood_scores(*args)
            torch.cuda.synchronize()
            got.append(out)
        except Exception as e:  # noqa: BLE001 — reported by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(compiles) == 1 and len(got) == 4
    for out in got:
        assert all(torch.equal(w, g) for w, g in zip(want, out))


@pytest.mark.cuda
def test_cuda_sharded_solves_equal_cpu(cuda, tmp_path):
    import torch_ranks

    ranks = torch_ranks.spawn(torch_ranks.cuda_sharded_body, 2, tmp_path, 48, 8, device="cuda:0")
    for out in ranks:
        for name in ("pop", "nbr"):
            card, cpu = out[(name, "cuda")], out[(name, "cpu")]
            np.testing.assert_array_equal(card["traces"], cpu["traces"])
            for want, got in zip(torch_ranks.tree_leaves_np(cpu["state"]), torch_ranks.tree_leaves_np(card["state"])):
                np.testing.assert_array_equal(got, want)
            assert card["launches"] > 0 and cpu["launches"] == 0


@pytest.mark.cuda
def test_cuda_fingerprint_kernels_match_plain_versions_at_the_solvers_shapes(cuda):
    """K2a and K2b at ``chip_smoke.py`` phase 2d's cases (the solvers' shapes,
    expanded views, adversarial values): bit for bit the plain versions."""
    import chip_smoke

    for label, _, fn, plain, args, _ in chip_smoke.k2_cases(cuda):
        got, want = fn(*args), plain(*args)
        torch.cuda.synchronize()
        assert got.dtype == torch.int64 and torch.equal(got, want), label


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 255, 256, 257, 1000, 2049, 16384])
@pytest.mark.parametrize("rows", [1, 3, 9, 257])
def test_cuda_fingerprint_rows_at_every_warp_grouping(cuda, rows, n):
    """K2b over 1, 2, 4 and 8 warps a row, ragged row counts, int32 and int64,
    a strided int32 view with a storage offset."""
    from constraint_solver_tpu_torch.ops import fingerprint as fpk

    gen = torch.Generator(device=cuda).manual_seed(rows * 100_003 + n)
    wide = torch.randint(-2**62, 2**62, (rows, n), generator=gen, device=cuda)
    narrow = torch.randint(-2**31, 2**31 - 1, (rows, 2 * n + 1), generator=gen, device=cuda,
                           dtype=torch.int32)[:, 1::2]
    for values in (wide, narrow):
        got = fpk.fingerprint_i32(values)
        torch.cuda.synchronize()
        assert torch.equal(got, fpk.fingerprint_i32_ref(values)), (values.dtype, values.stride())


@pytest.mark.cuda
def test_cuda_fingerprint_launches_count_through_graph_replays(cuda):
    """A capture counts no K2 launch; each replay counts what it captured and
    rewrites the result.  A graphed solve of every domain launches K2a and K2b
    as often as the eager one: K2b in each, K2a in each but the dense roster,
    whose fingerprint deltas K5 hashes itself."""
    from constraint_solver_tpu_torch.core import graphed
    from constraint_solver_tpu_torch.ops import fingerprint as fpk

    gen = torch.Generator(device=cuda).manual_seed(3)
    base = torch.randint(0, 2**32, (256, 2), generator=gen, device=cuda)
    idx, old, new = (torch.randint(0, 1000, (256,), generator=gen, device=cuda) for _ in range(3))
    want = fpk.fp_update_ref(base, idx, old, new)
    fpk.fp_update(base, idx, old, new)  # built and loaded before the capture
    torch.cuda.synchronize()
    before = fpk.hash_xor.launches
    seg = graphed.capture(lambda: fpk.fp_update(base, idx, old, new), torch.cuda.CUDAGraph(), torch.cuda.Stream(cuda))
    assert fpk.hash_xor.launches == before and sum(seg.launches.values()) == 1
    for _ in range(3):
        seg.out.fill_(0)
        seg.replay()
    torch.cuda.synchronize()
    assert fpk.hash_xor.launches == before + 3 and torch.equal(seg.out, want)
    for domain in ("scheduling-dense", "scheduling-random", "qap-incremental", "ackley", "diagram"):
        counts = {}
        for graphed_run in (False, True):
            before = (fpk.hash_xor.launches, fpk.fingerprint_i32.launches)
            _domain_run(cuda, domain, None, graphed_run)
            counts[graphed_run] = (fpk.hash_xor.launches - before[0], fpk.fingerprint_i32.launches - before[1])
        need = counts[True][1:] if domain == "scheduling-dense" else counts[True]
        assert counts[True] == counts[False] and min(need) > 0, (domain, counts)
        if domain == "scheduling-dense":
            assert counts[True][0] == 0, counts


@pytest.mark.cuda
def test_cuda_fingerprint_raises_instead_of_falling_back(cuda, tmp_path, monkeypatch):
    """A build that fails raises, and so does an operand on another device or
    of another dtype: no plain version on the card."""
    from constraint_solver_tpu_torch.ops import fingerprint as fpk

    x = torch.zeros(4, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        fpk.hash_xor(None, ((x, x.to(torch.int16)),))
    with pytest.raises(ValueError):
        fpk.hash_xor(None, ((x, x.cpu()),))
    monkeypatch.setattr(fpk, "_LIBRARY", nk.KernelLibrary(fpk._SRC, tmp_path / "libfingerprint.so",
                                                          fpk._LIBRARY.argtypes))
    monkeypatch.setattr(nk.subprocess, "run",
                        lambda cmd, **kw: nk.subprocess.CompletedProcess(cmd, 1, "", "error: planted"))
    before = (fpk.hash_xor.launches, fpk.fingerprint_i32.launches)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fpk.fp_update(torch.zeros((4, 2), dtype=torch.int64, device=cuda), x, x, x)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fpk.fingerprint_i32(x[None])
    assert (fpk.hash_xor.launches, fpk.fingerprint_i32.launches) == before


@pytest.mark.cuda
def test_cuda_tabu_probe_matches_plain_version_at_the_solvers_shapes(cuda):
    """K2a's ring form at ``chip_smoke.py`` phase 2d's cases (the picks, a
    retry, the roster's exact filter, adversarial rings): the pushed ring and
    the tabu or ok mask bit for bit the plain ``push`` and ``is_tabu``."""
    import chip_smoke

    for label, _, fn, plain, args, _ in chip_smoke.probe_cases(cuda):
        got, want = fn(*args), plain(*args)
        torch.cuda.synchronize()
        assert chip_smoke.outputs_equal(got, want), label


@pytest.mark.cuda
def test_cuda_tabu_probe_counts_through_graph_replays_and_raises(cuda, tmp_path, monkeypatch):
    """A capture of the ring form counts no launch, each replay counts one and
    rewrites the pushed ring and the mask; a graphed solve of every domain
    launches it as often as the eager one; an operand on another device and a
    failed build raise: no plain version on the card."""
    import chip_smoke
    from constraint_solver_tpu_torch.core import graphed
    from constraint_solver_tpu_torch.ops import fingerprint as fpk

    rng = np.random.default_rng(4)
    ring = chip_smoke.probe_ring(rng, cuda, 16, 256, fill=200)
    push = ring.fps[:, 7].clone()
    fps = chip_smoke.probe_candidates(rng, ring, 1, 0.5)
    valid = torch.ones((16, 1), dtype=torch.bool, device=cuda)
    want = fpk.hash_probe_ref(ring, push, fps, None, None, valid)
    ring.push_probe(push, fps, valid=valid)  # built and loaded before the capture
    torch.cuda.synchronize()
    before = fpk.hash_probe.launches
    seg = graphed.capture(lambda: ring.push_probe(push, fps, valid=valid), torch.cuda.CUDAGraph(),
                          torch.cuda.Stream(cuda))
    assert fpk.hash_probe.launches == before and sum(seg.launches.values()) == 1
    for _ in range(3):
        seg.out[1].fill_(False)
        seg.out[0].fps.fill_(0)
        seg.replay()
    torch.cuda.synchronize()
    assert fpk.hash_probe.launches == before + 3 and chip_smoke.outputs_equal(seg.out, want)
    for domain in ("scheduling-dense", "qap-incremental", "ackley", "diagram"):
        counts = {}
        for graphed_run in (False, True):
            before = fpk.hash_probe.launches
            _domain_run(cuda, domain, None, graphed_run)
            counts[graphed_run] = fpk.hash_probe.launches - before
        assert counts[True] == counts[False] > 0, (domain, counts)
    with pytest.raises(ValueError):
        ring.push_probe(push.cpu(), fps)
    monkeypatch.setattr(fpk, "_LIBRARY", nk.KernelLibrary(fpk._SRC, tmp_path / "libfingerprint.so",
                                                          fpk._LIBRARY.argtypes))
    monkeypatch.setattr(nk.subprocess, "run",
                        lambda cmd, **kw: nk.subprocess.CompletedProcess(cmd, 1, "", "error: planted"))
    before = fpk.hash_probe.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ring.push_probe(push, fps)
    assert fpk.hash_probe.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("rows, n", [(16, 16384), (4, 4096), (1, 1025), (3, 5000), (2, 1 << 20)])
def test_cuda_fingerprint_rows_split_over_the_sms(cuda, rows, n):
    """K2b's split plan (a few long rows, several blocks a row XOR-ing into a
    zeroed output): int32, int64 and a strided view bit for bit the plain
    version, eagerly and replayed in a CUDA graph, whose zeroing replays too."""
    from constraint_solver_tpu_torch.core import graphed
    from constraint_solver_tpu_torch.ops import fingerprint as fpk

    gen = torch.Generator(device=cuda).manual_seed(rows * 7 + n)
    wide = torch.randint(-2**62, 2**62, (rows, n), generator=gen, device=cuda)
    narrow = torch.randint(-2**31, 2**31 - 1, (rows, 2 * n), generator=gen, device=cuda, dtype=torch.int32)[:, ::2]
    for values in (wide, narrow, narrow.contiguous()):
        assert fpk._rows_plan(values.shape, values.stride(), values.dtype).splits > 1
        want = fpk.fingerprint_i32_ref(values)
        got = fpk.fingerprint_i32(values)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (values.dtype, values.stride())
    seg = graphed.capture(lambda: fpk.fingerprint_i32(wide), torch.cuda.CUDAGraph(), torch.cuda.Stream(cuda))
    for _ in range(3):
        seg.replay()
    torch.cuda.synchronize()
    assert torch.equal(seg.out, fpk.fingerprint_i32_ref(wide))


@pytest.mark.cuda
def test_cuda_block_pick_matches_plain_version_at_the_smoke_cases(cuda):
    """K3 at ``chip_smoke.py`` phase 2e's cases (the first pick and retries at
    (256, 50, 1000) and (16, 64, 16384), exclusions with -1 slots and invalid
    rows, lanes with no valid row, retries of 1, 3 and 8 rows at every cluster
    size the plan can take, the cluster merge's traps, a block off 16 bytes,
    one lane and 300 lanes, the ragged (5, 7, 1003)): bit for bit the plain
    version."""
    import chip_smoke
    from constraint_solver_tpu_torch.ops import block_pick as bp

    for label, args, _, slices in chip_smoke.k3_cases(cuda):
        got, want = bp.block_pick(*args, _slices=slices), bp.block_pick_ref(*args)
        torch.cuda.synchronize()
        assert got.dtype == torch.int64 and torch.equal(got, want), label


@pytest.mark.cuda
@pytest.mark.parametrize("p, r, c, e", [(1, 1, 1, 0), (3, 1, 4097, 8), (300, 3, 2, 256), (2, 700, 5, 8)])
def test_cuda_block_pick_on_floats_and_edge_shapes(cuda, p, r, c, e):
    """One row, one candidate, more rows than threads, every slot of the
    longest exclusion list; signed zeros, infinities and NaN, with the row
    minima by ``amin`` and ``argmin``."""
    from constraint_solver_tpu_torch.ops import block_pick as bp

    rng = np.random.default_rng(p * r * c + e)
    vals = np.array([0.0, -0.0, 1.0, 2.0, np.inf, -np.inf, np.nan, 3.0], dtype=np.float32)
    for share_nan in (0.0, 0.02):
        probs = np.array([3, 3, 3, 3, 1, 1, 0, 3], dtype=float)
        probs[6] = share_nan * probs.sum()
        hard = torch.from_numpy(rng.choice(vals, size=(p, r, c), p=probs / probs.sum())).to(cuda)
        row_min, row_arg = hard.amin(-1), hard.argmin(-1).to(torch.int32)
        row_valid = torch.from_numpy(rng.random((p, r)) < 0.8).to(cuda)
        flat = torch.arange(r, device=cuda) * c + row_arg.long()
        pick = torch.from_numpy(rng.integers(0, r, size=(p, e))).to(cuda)
        excl = torch.where(torch.from_numpy(rng.random((p, e)) < 0.3).to(cuda), -1, flat.gather(1, pick)).contiguous()
        for x in (None, excl):
            got = bp.block_pick(hard, row_valid, row_min, row_arg, x)
            torch.cuda.synchronize()
            assert torch.equal(got, bp.block_pick_ref(hard, row_valid, row_min, row_arg, x)), (share_nan, x is None)


@pytest.mark.cuda
def test_cuda_block_pick_counts_through_graph_replays_and_raises(cuda, tmp_path, monkeypatch):
    """A capture of K3 counts no launch, each replay counts one and rewrites
    the pick; a graphed N-Queens solve launches K3 as often as the eager one,
    in both tabu modes; an operand on another device and a failed build raise:
    no plain version on the card."""
    import chip_smoke
    from constraint_solver_tpu_torch.core import graphed
    from constraint_solver_tpu_torch.ops import block_pick as bp

    cases = {label: args for label, args, _, slices in chip_smoke.k3_cases(cuda) if slices is None}
    for label in ("8 excluded row minima (256, 50, 1000)", "8 excluded row minima (16, 64, 16384)"):
        args = cases[label]  # one block a lane, then a cluster of 8
        want = bp.block_pick_ref(*args)
        bp.block_pick(*args)  # built and loaded before the capture
        torch.cuda.synchronize()
        before = bp.block_pick.launches
        seg = graphed.capture(lambda: bp.block_pick(*args), torch.cuda.CUDAGraph(), torch.cuda.Stream(cuda))
        assert bp.block_pick.launches == before and sum(seg.launches.values()) == 1
        for _ in range(3):
            seg.out.fill_(-1)
            seg.replay()
        torch.cuda.synchronize()
        assert bp.block_pick.launches == before + 3 and torch.equal(seg.out, want), label
    for exact in (None, False):
        counts = {}
        for graphed_run in (False, True):
            before = bp.block_pick.launches
            _graphs_run(_graphs_solver(cuda, exact, graphed_run))
            counts[graphed_run] = bp.block_pick.launches - before
        assert counts[True] == counts[False] > 0, (exact, counts)
    with pytest.raises(ValueError):
        bp.block_pick(args[0], args[1].cpu(), *args[2:])
    monkeypatch.setattr(bp, "_LIBRARY", nk.KernelLibrary(bp._SRC, tmp_path / "libblock_pick.so",
                                                         bp._LIBRARY.argtypes))
    monkeypatch.setattr(nk.subprocess, "run",
                        lambda cmd, **kw: nk.subprocess.CompletedProcess(cmd, 1, "", "error: planted"))
    before = bp.block_pick.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        bp.block_pick(*args)
    assert bp.block_pick.launches == before


@pytest.mark.cuda
def test_cuda_nqueens_move_matches_plain_version_at_the_smoke_cases(cuda):
    """K4 at ``chip_smoke.py`` phase 2f's cases ((256, 50, 1000), (16, 64,
    16384) and the ragged (5, 7, 16383); masks all on, all off and mixed,
    each without and with a best board; same-row moves; the columns 0 and n
    - 1 and a chunk's first and last), each at its launch plan and at S = 1
    and 8: every leaf of the state and the best board bit for bit the plain
    version's, floats by their bits."""
    import chip_smoke

    for case in chip_smoke.k4_cases(cuda):
        want = chip_smoke.k4_run(case, ref=True)
        for slices in (None, 1, 8):
            got = chip_smoke.k4_run(case, slices)
            torch.cuda.synchronize()
            assert chip_smoke.k4_equal(got, want), (case.label, slices)


@pytest.mark.cuda
def test_cuda_nqueens_move_plan_on_this_card(cuda):
    """The plan reads the card's SMs: on a card of at least 128 (an H100 has
    132) a lane of the nqueens-16384 cell is a cluster of 8 blocks and the
    headline's lanes are one block each."""
    from constraint_solver_tpu_torch.ops import block_pick as bp
    from constraint_solver_tpu_torch.ops import nqueens_move as nm

    sms = bp._sms(cuda.index)
    assert nm._launch_plan(256, 1000, sms).slices == 1
    if sms >= 128:
        assert nm._launch_plan(16, 16384, sms).slices == 8


@pytest.mark.cuda
def test_cuda_nqueens_move_adds_the_column_scores_by_reduction(cuda):
    """The column scores are updated by a reduction whose result is unused
    (RED ... ADD.F32 in the kernel's SASS), never by an atomic that returns
    the old value."""
    import os
    import subprocess

    from torch.utils.cpp_extension import CUDA_HOME

    from constraint_solver_tpu_torch.ops import nqueens_move as nm

    nm.build_library()
    cuobjdump = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(nm._LIB_PATH)], capture_output=True, text=True, check=True).stdout
    lines = [line for line in sass.splitlines() if "ADD.F32" in line and ("RED" in line or "ATOM" in line)]
    assert lines and all("RED" in line for line in lines), lines


@pytest.mark.cuda
@pytest.mark.parametrize("p, a, n", [(1, 1, 1), (3, 2, 2), (2, 3, 4097), (2, 3, 40000), (70, 5, 33), (3, 4, 2049)])
def test_cuda_nqueens_move_on_edge_shapes(cuda, p, a, n):
    """One column, a board of two, a ragged row of columns, more columns than
    a block loads at once (the pass loops), more lanes than one wave; a
    contiguous [P, A] sample and a strided one; without and with a best
    board, at the plan and at S = 1, 3 and 8 (a chunk of no item too)."""
    from constraint_solver_tpu_torch.models.nqueens import NQMoves

    import chip_smoke

    rng = np.random.default_rng(p * a * n)
    st = build_state(torch.as_tensor(rng.integers(0, n, size=(p, n)), device=cuda))
    perm = torch.as_tensor(np.argsort(rng.random((p, n)), axis=1), device=cuda)
    idx = torch.as_tensor(rng.integers(0, a * n, size=p), device=cuda)
    mask = torch.as_tensor(rng.random(p) < 0.7, device=cuda)
    best = torch.as_tensor(rng.integers(0, n, size=(p, n)), device=cuda)
    save = torch.as_tensor(rng.random(p) < 0.5, device=cuda)
    for cols in (perm[:, :a], perm[:, :a].contiguous()):
        for b, sv in ((None, None), (best, save)):
            case = chip_smoke.K4Case("edge", st, NQMoves(cols, n), idx, mask, b, sv, False)
            want = chip_smoke.k4_run(case, ref=True)
            for slices in (None, 1, 3, 8):
                got = chip_smoke.k4_run(case, slices)
                torch.cuda.synchronize()
                assert chip_smoke.k4_equal(got, want), (cols.stride(), b is None, slices)


@pytest.mark.cuda
def test_cuda_nqueens_move_counts_through_graph_replays_and_raises(cuda, tmp_path, monkeypatch):
    """A capture of K4 writes nothing and counts no launch, a replay counts
    one and writes the move; a graphed N-Queens solve launches K4 as often as
    the eager one and equals the select form, in both tabu modes; an operand
    on another device and a failed build raise: no plain version on the card."""
    import chip_smoke
    from constraint_solver_tpu_torch.ops import nqueens_move as nm

    case = next(c for c in chip_smoke.k4_cases(cuda) if c.label == f"mixed, best {chip_smoke.K4_SHAPES[1]}")
    st, moves, idx, mask = case.state, case.moves, case.idx, case.mask
    nm.nqueens_move(st, moves, idx, mask)  # built and loaded before the capture
    chip_smoke.k4_graph_replay(cuda, case)
    for exact in (None, False):
        counts, runs = {}, {}
        for graphed_run in (False, True):
            before = nm.nqueens_move.launches
            runs[graphed_run] = _graphs_run(_graphs_solver(cuda, exact, graphed_run))
            counts[graphed_run] = nm.nqueens_move.launches - before
        assert counts[True] == counts[False] > 0, (exact, counts)
        _graphs_equal(runs[True], runs[False])
        _graphs_equal(_graphs_run(_graphs_solver(cuda, exact, True, in_place=False)), runs[True])
    with pytest.raises(ValueError):
        nm.nqueens_move(st, moves, idx, mask.cpu())
    monkeypatch.setattr(nm, "_LIBRARY", nk.KernelLibrary(nm._SRC, tmp_path / "libnqueens_move.so",
                                                         nm._LIBRARY.argtypes))
    monkeypatch.setattr(nk.subprocess, "run",
                        lambda cmd, **kw: nk.subprocess.CompletedProcess(cmd, 1, "", "error: planted"))
    before = nm.nqueens_move.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        nm.nqueens_move(st, moves, idx, mask)
    assert nm.nqueens_move.launches == before


@pytest.mark.cuda
def test_cuda_sched_dense_matches_plain_version_at_the_smoke_cases(cuda):
    """K5 at ``chip_smoke.py`` phase 2g's cases (the roster's (64, 365, 20,
    256, 4), 730 x 40 at P = 128, 31 d x 7 e with holidays, a Friday start, D
    < 15, no random swaps, lanes on two employees): every output equal to the
    plain version's, padding slots included."""
    import chip_smoke

    from constraint_solver_tpu_torch.ops import sched_dense as sd

    for case in chip_smoke.k5_cases(cuda):
        got = sd.sched_dense(*case.args)
        torch.cuda.synchronize()
        assert chip_smoke.k5_equal(got, sd.sched_dense_ref(*case.args)), case.label


@pytest.mark.cuda
@pytest.mark.parametrize("days, emps, p, n_rand, n_off", [
    (1, 3, 2, 0, 0), (2, 2, 3, 5, 0), (9, 3, 4, 16, 0), (15, 1, 3, 8, 4), (50, 256, 2, 300, 2),
    (4096, 2, 1, 16, 1), (31, 7, 200, 16, 4), (15, 3, 1100, 4, 2), (4096, 256, 1, 16, 2), (2048, 128, 1, 16, 1),
    (40, 6, 1, 2100, 4),
])
def test_cuda_sched_dense_on_edge_shapes(cuda, days, emps, p, n_rand, n_off):
    """Each branch of the launch plan (``sched_dense._launch_plan`` on 132
    SMs): one day (a cluster of 1 block), two days (2 blocks: D below the
    cluster the SMs ask for), no diagonal, one employee, the most employees,
    the most days the kernel takes (4 chunks of 128 days a block), more random
    swaps than a block's threads and two batches of them (2,100 at P = 1),
    clusters of 2 blocks at P = 200, one block a lane with diagonals at P =
    1,100, the window flags, the plane and the holiday rows in global memory
    (4096 x 256), only the holiday rows there (2048 x 128); ``cur_score`` and
    the draws as strided views: every output equal to the plain version's."""
    from constraint_solver_tpu_torch.models.scheduling import make_tables
    from constraint_solver_tpu_torch.ops import sched_dense as sd

    start = datetime.date(2022, 5, 13)
    spec = ScheduleSpec.from_dates(start, start + datetime.timedelta(days=days - 1), emps,
                                   {0: [start + datetime.timedelta(days=k) for k in range(0, days, 5)]})
    rng = np.random.default_rng(days * emps)
    a = torch.as_tensor(rng.integers(0, emps, size=(p, days)), device=cuda)
    cur = torch.as_tensor(rng.integers(0, 50, size=(p, 3)), dtype=torch.float32, device=cuda)[:, 1:]
    draws = [torch.as_tensor(rng.integers(lo, max(lo + 1, days), size=(p, 2 * k)), device=cuda)[:, ::2]
             for lo, k in ((0, n_rand), (1, n_rand), (14, n_off))]
    args = (a, cur, make_tables(spec, cuda), spec.start_weekday, *draws)
    got = sd.sched_dense(*args)
    torch.cuda.synchronize()
    want = sd.sched_dense_ref(*args)
    for name, x, y in zip(sd.DenseOut._fields, got, want):
        assert x.dtype == y.dtype and torch.equal(x, y), name


@pytest.mark.cuda
def test_cuda_sched_dense_counts_through_graph_replays_and_raises(cuda, tmp_path, monkeypatch):
    """A capture of K5 counts no launch, a replay counts its one launch and
    writes every output; a graphed dense roster solve launches K5 as often as
    the eager one, in both tabu modes; an operand on another device, a shape
    the kernels do not take and a failed build raise: no plain version on the
    card."""
    import chip_smoke
    from constraint_solver_tpu_torch.ops import sched_dense as sd

    case = chip_smoke.k5_cases(cuda)[2]  # 31 d x 7 e with holidays
    sd.sched_dense(*case.args)  # built and loaded before the capture
    chip_smoke.k5_graph_replay(cuda, case)
    for exact in (True, False):
        counts = {}
        for graphed_run in (False, True):
            before = sd.sched_dense.launches
            _domain_run(cuda, "scheduling-dense", exact, graphed_run)
            counts[graphed_run] = sd.sched_dense.launches - before
        assert counts[True] == counts[False] > 0, (exact, counts)
    a, cur, tables, start, rs_d1, rs_off, delta = case.args
    with pytest.raises(ValueError):
        sd.sched_dense(a, cur.cpu(), tables, start, rs_d1, rs_off, delta)
    wide = a.new_zeros((a.shape[0], sd.MAX_DAYS + 1))
    wide_tables = tables._replace(holiday_de=tables.holiday_de.new_zeros((sd.MAX_DAYS + 1, 7)))
    with pytest.raises(ValueError, match="at most"):
        sd.sched_dense(wide, cur, wide_tables, start, rs_d1, rs_off, delta)
    monkeypatch.setattr(sd, "_LIBRARY", nk.KernelLibrary(sd._SRC, tmp_path / "libsched_dense.so",
                                                         sd._LIBRARY.argtypes))
    monkeypatch.setattr(nk.subprocess, "run",
                        lambda cmd, **kw: nk.subprocess.CompletedProcess(cmd, 1, "", "error: planted"))
    before = sd.sched_dense.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        sd.sched_dense(*case.args)
    assert sd.sched_dense.launches == before


@pytest.mark.cuda
def test_cuda_nqueens_sample_matches_plain_version_at_the_smoke_cases(cuda):
    """K6 at ``chip_smoke.py`` phase 2h's cases (both N-Queens cells' (P, n, A)
    on random and near-solved boards, keys that tie everywhere, no conflicted
    column, A = n, a ragged n, and every branch of the plan at shapes where
    the plan takes it): every output equal to the plain version's."""
    import chip_smoke

    from constraint_solver_tpu_torch.ops import nqueens_sample as ns

    for case in chip_smoke.k6_cases(cuda):
        got = ns.nqueens_sample(*case.args)
        torch.cuda.synchronize()
        assert chip_smoke.k6_equal(got, ns.nqueens_sample_ref(*case.args)), case.label


@pytest.mark.cuda
@pytest.mark.parametrize("p, n, a, kind, branch", [
    (256, 1000, 50, "gumbel", (True, True, True)), (16, 16384, 64, "ties", (True, True, True)),
    (3, 1, 1, "gumbel", (True, True, True)), (1, 2, 2, "ties", (True, True, True)),
    (5, 300, 129, "gumbel", (True, True, True)), (2, 4097, 4097, "ties", (True, True, False)),
    (5, 1000, 257, "gumbel", (True, True, False)), (2, 57000, 64, "ties", (False, True, True)),
    (2, 60000, 300, "gumbel", (False, True, False)), (1, 16385, 16385, "ties", (True, False, False)),
    (1, 60001, 16385, "gumbel", (False, False, False)),
])
def test_cuda_nqueens_sample_at_every_placement(cuda, p, n, a, kind, branch):
    """Each branch of the plan (keys and survivors in shared memory or a
    global scratch, the survivors placed by rank or by the bitonic sort) at
    shapes where the plan takes it, at the cells' shapes and at edges: one
    column, A = n on 4,097 (threads of 1,024 and a sort of 8,192), A just
    above a power of two and just above 256, the keys just past shared memory,
    the survivors just past it (A = 16,385, a sort of 32,768)."""
    import chip_smoke

    from constraint_solver_tpu_torch.ops import nqueens_sample as ns

    plan = ns._launch_plan(p, n, a)
    assert (plan.keys_shared, plan.cands_shared, plan.rank_sort) == branch
    rng = np.random.default_rng(n + a)
    args = chip_smoke.k6_args(rng, rng.integers(0, n, (p, n)), a, cuda, kind)
    got = ns.nqueens_sample(*args)
    torch.cuda.synchronize()
    assert chip_smoke.k6_equal(got, ns.nqueens_sample_ref(*args))


@pytest.mark.cuda
def test_cuda_nqueens_move_fp_matches_plain_version_at_the_smoke_cases(cuda):
    """K7 at phase 2h's cases (a pick at both cells' shapes, the exact filter's
    [P, A·n], int32 candidates through a stride, the last candidate): equal to
    its plain version and to the chain it replaces (the decode, then K2a)."""
    import chip_smoke

    from constraint_solver_tpu_torch.ops import fingerprint as fpk

    for case in chip_smoke.k7_cases(cuda):
        got = fpk.nqueens_move_fp(*case.args)
        torch.cuda.synchronize()
        want = fpk.nqueens_move_fp_ref(*case.args)
        assert torch.equal(got, want) and torch.equal(chip_smoke.k7_chain(*case.args), want), case.label


@pytest.mark.cuda
def test_cuda_nqueens_sample_and_move_fp_count_through_graph_replays_and_raise(cuda, tmp_path, monkeypatch):
    """A capture of K6 and K7 counts no launch and a replay one of each; a
    graphed N-Queens solve launches each as often as the eager one, in both
    tabu modes; operands on two devices and a failed build raise: no plain
    version on the card."""
    import chip_smoke

    from constraint_solver_tpu_torch.ops import fingerprint as fpk
    from constraint_solver_tpu_torch.ops import nqueens_sample as ns

    k6, k7 = chip_smoke.k6_cases(cuda)[0], chip_smoke.k7_cases(cuda)[0]
    ns.nqueens_sample(*k6.args)  # built and loaded before the capture
    fpk.nqueens_move_fp(*k7.args)
    chip_smoke.k67_graph_replay(cuda, k6, k7)
    for exact in (None, False):
        counts = {}
        for graphed_run in (False, True):
            before = chip_smoke.k67_launches()
            _graphs_run(_graphs_solver(cuda, exact, graphed_run))
            counts[graphed_run] = {k: v - before[k] for k, v in chip_smoke.k67_launches().items()}
        assert counts[True] == counts[False] and min(counts[True].values()) > 0, (exact, counts)
    with pytest.raises(ValueError):
        ns.nqueens_sample(k6.args[0].cpu(), *k6.args[1:])
    with pytest.raises(ValueError):
        fpk.nqueens_move_fp(k7.args[0].cpu(), *k7.args[1:])
    monkeypatch.setattr(ns, "_LIBRARY", nk.KernelLibrary(ns._SRC, tmp_path / "libnqueens_sample.so",
                                                         ns._LIBRARY.argtypes))
    monkeypatch.setattr(nk.subprocess, "run",
                        lambda cmd, **kw: nk.subprocess.CompletedProcess(cmd, 1, "", "error: planted"))
    before = ns.nqueens_sample.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ns.nqueens_sample(*k6.args)
    assert ns.nqueens_sample.launches == before


@pytest.mark.cuda
def test_cuda_graphed_headline_solve_keeps_its_trajectory(cuda):
    """The headline configuration (nqueens-1000, 256 lanes, the benchmark's
    solver settings), 4 rounds graphed against eager from one seed: the state
    trees, stats, the generator's state and the launches of K6 and K7 equal."""
    import chip_smoke

    out = {}
    for graphed in (False, True):
        before = chip_smoke.k67_launches()
        s = PopulationSolver(make_nqueens_problem(1000), chip_smoke.main_config(), population=256, exchange_every=2,
                             device=cuda, _graphed=graphed)
        s.run(max_rounds=4, chunk=2)
        torch.cuda.synchronize()
        launches = {k: v - before[k] for k, v in chip_smoke.k67_launches().items()}
        out[graphed] = (to_reference(s.state), s.stats(), s.draws.state_dict()["generator"], launches)
    (state_e, stats_e, gen_e, k67_e), (state_g, stats_g, gen_g, k67_g) = out[False], out[True]
    compare(state_g, state_e)
    stats_e.pop("moves_per_sec", None)
    stats_g.pop("moves_per_sec", None)
    assert stats_g == stats_e and torch.equal(gen_g, gen_e)
    assert k67_g == k67_e and min(k67_g.values()) > 0, (k67_e, k67_g)
