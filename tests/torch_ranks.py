"""Rank bodies of the port's multi-device tests (``tests/test_torch_mesh.py``,
``test_torch_sharded.py``, ``test_torch_population_mesh.py``,
``test_torch_seq.py`` and the sharded neighborhood of ``test_torch_qap.py``).

Each test file starts one group of gloo ranks on the CPU for the whole module
(``spawn``), and every rank runs one body below, which does all of that file's
checks and returns what the tests compare, as numpy arrays.  The bodies import
torch and the port; a body that follows JAX keys imports
``tests/jax_key_draws.py`` (and with it JAX, kept on the CPU as
``tests/conftest.py`` keeps it).  The rendezvous is a file under the test's
temporary directory, so test workers running at once never share a port.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch

from constraint_solver_tpu_torch.core.ils import SolverConfig
from constraint_solver_tpu_torch.parallel import distributed
from constraint_solver_tpu_torch.parallel.mesh import (
    all_gather,
    all_gather_tree,
    all_reduce,
    all_reduce_tree,
    make_mesh,
    ppermute,
    use_mesh,
    world_any,
)
from constraint_solver_tpu_torch.utils.convert import to_reference

D0 = datetime.date(2022, 5, 9)


def spawn(body, world: int, tmp_path, *args, device="cpu") -> list:
    """``body(rank, world, *args)`` on ``world`` gloo ranks, one CPU thread
    each, every rank's current device ``device``; the results in rank order."""
    init = "file://" + os.path.join(str(tmp_path), "rendezvous")
    return distributed.run_ranks(body, world, args, backend="gloo", device=device, init_method=init,
                                 timeout_s=600, threads=1)


def tree_leaves_np(tree) -> list:
    """The leaves of a state tree of numpy arrays, in field order."""
    if isinstance(tree, tuple):
        return [leaf for part in tree for leaf in tree_leaves_np(part)]
    return [tree]


def _jax_key_draws():
    """``tests/jax_key_draws.py``, with JAX kept on the CPU."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax_key_draws

    return jax_key_draws


def _jax_draws(key_data, lo, hi):
    return _jax_key_draws().JaxKeyDraws.lanes(key_data, lo, hi)


def _log_weights(n):
    return _jax_key_draws().reference_log_weights(n)


# -- test_torch_mesh.py ---------------------------------------------------


def mesh_body(rank, world):
    """The groups of a 2 x 2 mesh, every collective on small tensors, and the
    world-agreed done check."""
    mesh = make_mesh(2, 2)
    pop, nbr = mesh.axis("pop"), mesh.axis("nbr")
    me = torch.tensor([float(rank)])
    x = torch.arange(6, dtype=torch.float32).view(2, 3) + 10 * rank
    out = {
        "coords": (pop.index, nbr.index),
        "pop_members": all_gather(me, pop).tolist(),
        "nbr_members": all_gather(me, nbr).tolist(),
        "world_members": all_gather(me, mesh.world).tolist(),
        "gather0": all_gather(x, pop).numpy(),
        "gather1": all_gather(x, nbr, dim=1).numpy(),
        "gather_bool": all_gather(torch.tensor([rank % 2 == 0]), mesh.world).tolist(),
        "sum": all_reduce(x, pop).numpy(),
        "max": all_reduce(x, nbr, "max").numpy(),
        "min": all_reduce(x, mesh.world, "min").numpy(),
        "int64": all_reduce(torch.tensor([2**40 + rank]), mesh.world).item(),
        "shift+1": ppermute(me, mesh.world, 1).item(),
        "shift-1": ppermute(me, mesh.world, -1).item(),
        "pop_shift": ppermute(me, pop, 1).item(),
    }
    tree = (torch.tensor([[rank, -rank]]), torch.tensor([[0.5 * rank]]))
    g = all_gather_tree(tree, mesh.world)
    r = all_reduce_tree(tree, pop)
    out["tree_gather"] = [t.numpy() for t in g]
    out["tree_gather_dtypes"] = [str(t.dtype) for t in g]
    out["tree_sum"] = [t.numpy() for t in r]
    with use_mesh(mesh):
        out["any_one"] = world_any(torch.tensor([rank == 3]))
        out["any_none"] = world_any(torch.tensor([False, False]))
    out["any_local"] = world_any(torch.tensor([rank == 3]))  # no active mesh: this rank alone
    whole = distributed.global_mesh(n_nbr=2)
    out["global_mesh"] = (whole.shape, whole.index("pop"), whole.index("nbr"))
    out["coordinator"] = distributed.is_coordinator()
    seq = make_mesh(1, 4, ("pop", "seq"))  # a second mesh over the same world
    out["seq_members"] = all_gather(me, seq.axis("seq")).tolist()
    out["seq_pop_size"] = seq.axis("pop").size
    return out


# -- test_torch_sharded.py ------------------------------------------------


def sharded_config(**kw):
    """The JAX package's ``tests/test_sharded.py`` configuration."""
    return dict(
        seed="42", local_search_max_iterations=150, best_solutions_capacity=8, all_solutions_capacity=64,
        all_solution_iteration_expiry=150, iterated_local_search_max_iterations=100,
        max_allow_no_improvement_for=5, **kw,
    )


def _lane_bests(solver):
    scores = solver.state.elite.get_best()[0]
    return all_gather(scores, solver.mesh.axis("pop")).numpy()


def sharded_body(rank, world, runs, key_data, ckpt_path):
    """``runs``: {name: (n, solver kwargs, run kwargs)} of 2 x 2 sharded
    nqueens runs from the JAX lane keys ``key_data[name]``; then the driver's
    parity with a checkpoint, and the candidate list over a 1 x 4 mesh."""
    from constraint_solver_tpu_torch.models.nqueens import build_state, make_nqueens_problem, total_conflicts
    from constraint_solver_tpu_torch.parallel.sharded import ShardedPopulationSolver
    from constraint_solver_tpu_torch.utils.draws import TorchDraws

    mesh = make_mesh(2, 2)
    line = make_mesh(1, 4)
    pop = mesh.axis("pop")
    out = {}
    for name, (n, kw, run_kw) in runs.items():
        problem = make_nqueens_problem(n, sample_cols=4, nbr_axis="nbr", nbr_shards=2, nbr_keep=16,
                                       log_weights=_log_weights(n))
        lo = pop.index * 4
        s = ShardedPopulationSolver(problem, SolverConfig(**sharded_config()), population=8, mesh=mesh,
                                    device="cpu", draws=_jax_draws(key_data[name], lo, lo + 4), **kw)
        s.run(**run_kw)
        out[name] = {"state": to_reference(s.state), "lane_bests": _lane_bests(s), "best": s.get_best_solution(),
                     "stats": s.stats(), "info": s.get_iteration_info()}

    # Driver parity: stepping, stats, a checkpoint written by rank 0 and read
    # by every rank, and the same continuation after it.
    problem = make_nqueens_problem(16, sample_cols=4, nbr_axis="nbr", nbr_shards=2, nbr_keep=16)
    config = SolverConfig(**sharded_config())

    def solver():
        return ShardedPopulationSolver(problem, config, population=8, mesh=mesh, device="cpu")

    a = solver()
    parity = {"finished_at_0": a.is_finished()}
    a.execute_round()
    parity["info_1"] = a.get_iteration_info()
    a.run(max_rounds=9, chunk=3)
    parity["stats"] = a.stats()
    parity["width"] = problem.width
    a.save(ckpt_path)
    b = solver()
    b.load(ckpt_path)
    parity["best_saved"], parity["best_loaded"] = a.get_best_solution()[0], b.get_best_solution()[0]
    for s in (a, b):
        s.run(max_rounds=4, chunk=2)
    parity["after_a"], parity["after_b"] = to_reference(a.state), to_reference(b.state)
    parity["traced"] = a.execute_chunk_traced(2)
    out["parity"] = parity

    # Every gathered candidate carries the score a full rescore gives its move.
    problem = make_nqueens_problem(12, sample_cols=4, nbr_axis="nbr", nbr_shards=4, nbr_keep=8)
    rows = torch.as_tensor(np.random.default_rng(2).integers(0, 12, size=(3, 12)))
    state = build_state(rows)
    with use_mesh(line):
        draws = TorchDraws("candidates", 3, "cpu")
        nb = problem.neighborhood(state, problem.score(state), draws, torch.ones(3, dtype=torch.bool))
    applied = rows[:, None, :].repeat(1, nb.valid.shape[1], 1)
    applied.scatter_(2, nb.moves.cols[..., None], nb.moves.rows[..., None])
    out["candidates"] = {
        "scores": nb.scores.numpy(), "valid": nb.valid.numpy(), "rescored": total_conflicts(applied).numpy(),
        "width": nb.valid.shape[1],
    }
    return out


# -- test_torch_population_mesh.py -------------------------------------------


def population_cases():
    """name -> (problem factory, config keywords, solver keywords): nqueens and
    scheduling with the exchange and the cull, as ``test_torch_population.py``
    and ``test_torch_scheduling_population.py`` configure them."""
    from constraint_solver_tpu_torch.models.nqueens import make_nqueens_problem
    from constraint_solver_tpu_torch.models.scheduling import ScheduleSpec, make_scheduling_problem

    spec = ScheduleSpec.from_dates(D0, D0 + datetime.timedelta(days=30), 7)
    common = dict(local_search_max_iterations=6, best_solutions_capacity=3, all_solutions_capacity=16,
                  all_solution_iteration_expiry=40, restart_every=4)
    return {
        "nqueens": (lambda: make_nqueens_problem(16), dict(seed="mesh-nq", **common),
                    dict(exchange_every=2, cull_frac=0.25)),
        "scheduling": (lambda: make_scheduling_problem(spec), dict(seed="mesh-sched", **common),
                       dict(exchange_every=2, cull_frac=0.25, cull_rank="hard")),
    }


def phased_solver(mesh=None):
    """Scheduling, the dense proposer until round 3, then the random window."""
    from constraint_solver_tpu_torch.models.scheduling import ScheduleSpec, make_scheduling_problem
    from constraint_solver_tpu_torch.parallel.phased import Phase, PhasedPopulationSolver

    spec = ScheduleSpec.from_dates(D0, D0 + datetime.timedelta(days=30), 7)
    kw = dict(seed="mesh-phased", local_search_max_iterations=8, best_solutions_capacity=4,
              all_solutions_capacity=32)
    phases = [
        Phase(make_scheduling_problem(spec), SolverConfig(**kw), until_round=3),
        Phase(make_scheduling_problem(spec, proposer="random", window_size=32),
              SolverConfig(**kw, iterated_local_search_max_iterations=6)),
    ]
    return PhasedPopulationSolver(phases, population=8, exchange_every=2, cull_frac=0.25, device="cpu", mesh=mesh)


def population_solver(name, mesh=None):
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver

    make, config, kw = population_cases()[name]
    return PopulationSolver(make(), SolverConfig(**config), population=8, device="cpu", mesh=mesh, **kw)


def population_mesh_body(rank, world, dense_ckpt, sharded_ckpt):
    """Pop-4 runs of ``population_cases`` and the phased solver (states and
    traces), a checkpoint written after 2 sharded rounds, and 2 rounds resumed
    from a one-device checkpoint."""
    mesh = make_mesh(4, 1)
    out = {}
    for name in population_cases():
        s = population_solver(name, mesh)
        traces = [s.execute_chunk_traced(2) for _ in range(3)]
        out[name] = {"state": to_reference(s.state), "traces": np.concatenate(traces), "stats": s.stats(),
                     "best": s.get_best_solution(), "score": s.get_best_score()}
    s = phased_solver(mesh)
    s.run(chunk=2)
    out["phased"] = {"state": to_reference(s.state), "stats": s.stats(), "best": s.get_best_solution()}

    s = population_solver("nqueens", mesh)
    s.run(max_rounds=2, chunk=2)
    s.save(sharded_ckpt)
    resumed = population_solver("nqueens", mesh)
    resumed.load(dense_ckpt)
    resumed.run(max_rounds=2, chunk=2)
    out["resumed"] = to_reference(resumed.state)
    return out


# -- test_torch_seq.py -------------------------------------------------------


def schedule_spec(days, emps, holidays=None):
    from constraint_solver_tpu_torch.models.scheduling import ScheduleSpec

    return ScheduleSpec.from_dates(D0, D0 + datetime.timedelta(days=days - 1), emps, holidays)


def seq_config(rounds):
    """The JAX package's ``tests/test_seq_solver.py`` configuration."""
    return dict(seed="seqsolve", local_search_max_iterations=30, iterated_local_search_max_iterations=rounds,
                all_solutions_capacity=64, all_solution_iteration_expiry=200, best_solutions_capacity=8,
                max_allow_no_improvement_for=5)


def seq_body(rank, world, scorer_cases, solo_key_data, pop_key_data, ckpt_path):
    """The sharded scorer over 2 and 4 ranks; the date-sharded solver over 4
    ranks (one lane) and over 2 x 2 (four lanes) from JAX keys; a checkpoint
    round trip and an uneven day count with the production draws."""
    from constraint_solver_tpu_torch.parallel.seq_shard import make_sharded_schedule_score
    from constraint_solver_tpu_torch.parallel.seq_solver import SeqShardedSolver

    meshes = {2: make_mesh(2, 2, ("pop", "seq")), 4: make_mesh(1, 4, ("pop", "seq"))}
    out = {"scores": {}}
    for name, (spec, shards, assigns) in scorer_cases.items():
        try:
            score = make_sharded_schedule_score(spec, meshes[shards])
        except ValueError as e:
            out["scores"][name] = str(e)
            continue
        out["scores"][name] = score(torch.as_tensor(assigns)).numpy()

    hol = {0: [D0 + datetime.timedelta(days=5)], 3: [D0 + datetime.timedelta(days=k) for k in (10, 40)]}
    solo = SeqShardedSolver(schedule_spec(64, 7, hol), SolverConfig(**seq_config(12)), meshes[4], window_size=32,
                            device="cpu", draws=_jax_draws(solo_key_data, 0, 1))
    out["solo"] = []
    for _ in range(3):
        for _ in range(4):
            solo.execute_round()
        out["solo"].append(to_reference(solo._dense_state(solo.state)))
    out["solo_local"] = to_reference(solo.state)  # this rank's days
    out["solo_best"] = solo.get_best_solution()
    out["solo_stats"] = solo.stats()

    mesh = meshes[2]
    lo = mesh.index("pop") * 2
    spec = schedule_spec(64, 7, {1: [D0 + datetime.timedelta(days=9)]})
    popseq = SeqShardedSolver(spec, SolverConfig(**seq_config(8)), mesh, window_size=32, population=4,
                              exchange_every=4, k_exchange=2, device="cpu",
                              draws=_jax_draws(pop_key_data, lo, lo + 2))
    popseq.run(max_rounds=8, chunk=4)
    out["popseq"] = to_reference(popseq._dense_state(popseq.state))
    out["popseq_best"] = popseq.get_best_solution()

    def uneven():
        return SeqShardedSolver(schedule_spec(61, 5), SolverConfig(**seq_config(8)), mesh, window_size=16,
                                population=4, exchange_every=4, k_exchange=2, device="cpu")

    full = uneven()
    full.run(max_rounds=8, chunk=4)
    part = uneven()
    part.run(max_rounds=4, chunk=4)
    part.save(ckpt_path)
    resumed = uneven()
    resumed.load(ckpt_path)
    out["resumed_at"] = resumed.get_iteration_info()["current"]
    resumed.run(max_rounds=4, chunk=4)
    out["full"], out["resumed"] = to_reference(full.state), to_reference(resumed.state)
    out["full_best"], out["resumed_best"] = full.get_best_solution(), resumed.get_best_solution()
    return out


# -- test_torch_qap.py --------------------------------------------------------


def qap_config():
    return dict(seed="qap-nbr", local_search_max_iterations=8, best_solutions_capacity=4, all_solutions_capacity=32,
                all_solution_iteration_expiry=100, restart_every=3)


def qap_body(rank, world, n, perms, key_data):
    """The sharded QAP neighborhood of permutations ``perms`` over a 1 x 2
    mesh, and 4 rounds of a sharded population from JAX lane keys."""
    from constraint_solver_tpu_torch.models.qap import QAPSpec, make_qap_problem
    from constraint_solver_tpu_torch.parallel.sharded import ShardedPopulationSolver
    from constraint_solver_tpu_torch.utils.draws import TorchDraws

    mesh = make_mesh(1, 2)
    problem = make_qap_problem(QAPSpec.random(n, seed=0), nbr_axis="nbr", nbr_shards=2, nbr_keep=16)
    p = torch.as_tensor(perms)
    with use_mesh(mesh):
        nb = problem.neighborhood(p, problem.score(p), TorchDraws("qap", p.shape[0], "cpu"),
                                  torch.ones(p.shape[0], dtype=torch.bool))
    s = ShardedPopulationSolver(problem, SolverConfig(**qap_config()), population=key_data.shape[0], mesh=mesh,
                                exchange_every=2, device="cpu", draws=_jax_draws(key_data, 0, key_data.shape[0]))
    for _ in range(4):
        s.execute_round()
    return {"scores": nb.scores.numpy(), "a": nb.moves.a.numpy(), "b": nb.moves.b.numpy(), "valid": nb.valid.numpy(),
            "state": to_reference(s.state), "best": s.get_best_solution()}


# -- test_torch_cuda.py ---------------------------------------------------------


def cuda_sharded_body(rank, world, n, population, devices=("cuda", "cpu")):
    """Two ranks sharing one card: the 2-rank (pop) and (nbr) sharded N-Queens
    solves on the card and on the CPU from the same host-side draws, and the
    card's kernel launches."""
    from constraint_solver_tpu_torch.models.nqueens import make_nqueens_problem
    from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver
    from constraint_solver_tpu_torch.utils.draws import TorchDraws

    config = SolverConfig(seed="cuda-sharded", local_search_max_iterations=30, best_solutions_capacity=4,
                          all_solutions_capacity=64, restart_every=3)
    meshes = {"pop": make_mesh(2, 1), "nbr": make_mesh(1, 2)}
    problems = {"pop": make_nqueens_problem(n),
                "nbr": make_nqueens_problem(n, nbr_axis="nbr", nbr_shards=2, nbr_keep=16)}
    out = {}
    for name, mesh in meshes.items():
        for device in devices:
            nk.nqueens_neighborhood_scores.launches = 0
            s = PopulationSolver(problems[name], config, population=population, exchange_every=2, mesh=mesh,
                                 device=device, draws=TorchDraws(config.seed, population, device, draw_device="cpu"))
            traces = [s.execute_chunk_traced(2) for _ in range(2)]
            out[(name, device)] = {"state": to_reference(s.state), "traces": np.concatenate(traces),
                                   "launches": nk.nqueens_neighborhood_scores.launches}
    return out
