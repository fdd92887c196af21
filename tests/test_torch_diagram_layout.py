"""The PyTorch port's diagram layout domain against the JAX package's
``models/diagram_layout.py`` and its host oracle.

Every score is a small integer or half-integer held in float32, and the
overlap and connector products sum 0/1 and small-integer terms, so the port
must equal the JAX package bit for bit: neighborhoods on the same layouts,
perturbations from the same JAX keys, and whole population trajectories from
the same draws (``tests/jax_key_draws.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from constraint_solver_tpu.core.ils import SolverConfig as JConfig
from constraint_solver_tpu.models import diagram_layout as jd
from constraint_solver_tpu.parallel import population as jpop
from constraint_solver_tpu.utils.seeding import seed_string_to_key
from constraint_solver_tpu_torch.core.ils import SolverConfig
from constraint_solver_tpu_torch.models import diagram_layout as td
from constraint_solver_tpu_torch.parallel import population as tpop
from constraint_solver_tpu_torch.utils.convert import from_reference, to_reference
from jax_key_draws import JaxKeyDraws
from test_torch_population import assert_tree_equal


def _problems(*args, **kw):
    jspec, tspec = jd.DiagramLayoutSpec.random(*args, **kw), td.DiagramLayoutSpec.random(*args, **kw)
    assert tuple(jspec) == tuple(tspec)
    return tspec, jd.make_diagram_layout_problem(jspec), td.make_diagram_layout_problem(tspec)


def _layouts(spec, rng, p):
    sizes, _ = spec.arrays()
    return np.stack([rng.integers(0, spec.grid - sizes + 1) for _ in range(p)])


def _draws(p, seed):
    draws = JaxKeyDraws(jax.random.split(jax.random.key(seed), p))
    draws.round_keys()
    return draws


def test_score_matches_oracle_and_known_layouts():
    spec, _, tp = _problems(8, 10, 8, seed=3)
    pos = _layouts(spec, np.random.default_rng(0), 6)
    for lane, s in zip(pos, tp.score(torch.from_numpy(pos))):
        assert tuple(s.tolist()) == td.layout_score_naive(spec, lane)
    chain = td.make_diagram_layout_problem(td.DiagramLayoutSpec.chain(4, grid=4, size=1))
    assert chain.score(torch.tensor([[[0, 0], [1, 0], [2, 0], [3, 0]]])).tolist() == [[0.0, 3.0]]
    stack = td.make_diagram_layout_problem(td.DiagramLayoutSpec.chain(3, grid=4, size=2))
    assert stack.score(torch.zeros((1, 3, 2), dtype=torch.int64)).tolist() == [[3.0, 0.0]]
    with pytest.raises(ValueError, match="larger than grid"):
        td.make_diagram_layout_problem(td.DiagramLayoutSpec(((5, 1),), (), 4))


def test_neighborhood_bit_equal_to_jax_and_to_full_rescores():
    p = 3
    spec, jp, tp = _problems(8, 10, 8, seed=3)
    pos = _layouts(spec, np.random.default_rng(1), p)
    pt, pj = torch.from_numpy(pos), jnp.asarray(pos, jnp.int32)
    nb = tp.neighborhood(pt, tp.score(pt), _draws(p, 0), torch.ones(p, dtype=torch.bool))
    key = jax.random.key(0)
    jnb = jax.vmap(lambda q: jp.neighborhood(q, jp.score(q), key))(pj)
    np.testing.assert_array_equal(nb.scores.numpy(), np.asarray(jnb.scores))
    np.testing.assert_array_equal(nb.valid.numpy(), np.asarray(jnb.valid))
    idx = torch.arange(nb.valid.shape[1]).expand(nb.valid.shape)
    fps = tp.move_fp(pt, tp.fingerprint(pt), None, idx)
    want_fps = jax.vmap(
        lambda q, mv: jax.vmap(lambda i: jp.move_fp(q, jp.fingerprint(q), mv, i))(jnp.arange(idx.shape[1]))
    )(pj, jnb.moves)
    np.testing.assert_array_equal(fps.numpy().astype(np.uint32), np.asarray(want_fps))
    rng = np.random.default_rng(2)
    for lane in range(p):
        for i in rng.choice(np.flatnonzero(nb.valid[lane].numpy()), 24, replace=False):
            i_t = torch.full((p,), int(i))
            moved = tp.apply_move(pt, None, i_t)
            want = jax.vmap(lambda q, mv: jp.apply_move(q, mv, int(i)))(pj, jnb.moves)
            np.testing.assert_array_equal(moved.numpy(), np.asarray(want))
            assert tuple(nb.scores[lane, i].tolist()) == td.layout_score_naive(spec, moved[lane].numpy())
            np.testing.assert_array_equal(tp.fingerprint(moved)[lane].numpy(), fps[lane, i].numpy())


def test_init_and_perturbation_equal_jax_and_stay_in_grid():
    p = 6
    spec, jp, tp = _problems(10, 12, 8, seed=4)
    sizes, _ = spec.arrays()
    keys = jax.random.split(jax.random.key(5), p)
    draws = JaxKeyDraws(keys)
    pos = tp.init(draws)
    want = jax.vmap(jp.init)(jax.vmap(jax.random.split)(keys)[:, 1])
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want))
    is_elite = torch.tensor([True, False] * (p // 2))
    for _ in range(3):
        draws.round_keys()
        got = tp.perturb(pos, is_elite, draws)
        want = jax.vmap(jp.perturb)(jnp.asarray(pos.numpy(), jnp.int32), jnp.asarray(is_elite.numpy()), draws._perturb_key)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got >= 0).all() and (got.numpy() + sizes <= spec.grid).all()
        pos = got


def test_population_trajectory_matches_jax():
    """A PopulationSolver on 8 boxes on an 8x8 grid (P=4, exchange every 2
    rounds, culling a quarter, a restart at round 3), leaf for leaf."""
    p = 4
    seed = "diagram-traj"
    kw = dict(
        seed=seed, local_search_max_iterations=10, best_solutions_capacity=3, all_solutions_capacity=16,
        all_solution_iteration_expiry=40, restart_every=3, max_allow_no_improvement_for=4,
    )
    spec, jp, tp = _problems(8, 10, 8, seed=3)
    jsolver = jpop.PopulationSolver(jp, JConfig(**kw), population=p, exchange_every=2, cull_frac=0.25)
    tsolver = tpop.PopulationSolver(
        tp, SolverConfig(**kw), population=p, exchange_every=2, cull_frac=0.25,
        draws=JaxKeyDraws(jax.random.split(seed_string_to_key(seed), p)), device="cpu",
    )
    assert tsolver.program.ls_params.tabu_exact_filter
    assert_tree_equal(jsolver.state, to_reference(tsolver.state))
    for _ in range(3):
        np.testing.assert_array_equal(tsolver.execute_chunk_traced(2), jsolver.execute_chunk_traced(2))
        assert_tree_equal(jsolver.state, to_reference(tsolver.state))
    assert tsolver.stats() == jsolver.stats()
    (score_t, pos_t), (score_j, pos_j) = tsolver.get_best_solution(), jsolver.get_best_solution()
    assert score_t == score_j == td.layout_score_naive(spec, pos_t)
    np.testing.assert_array_equal(pos_t, pos_j)
    assert_tree_equal(jsolver.state, to_reference(from_reference(jsolver.state, "cpu")))
    back = from_reference(to_reference(tsolver.state), "cpu")
    assert back.current_state.dtype == torch.int64
    assert_tree_equal(to_reference(tsolver.state), to_reference(back))


def test_torch_draws_reach_zero_overlaps():
    spec, _, tp = _problems(6, 6, 8, seed=1, max_size=2)
    solver = tpop.PopulationSolver(
        tp,
        SolverConfig(
            seed="42", local_search_max_iterations=100, best_solutions_capacity=8, all_solutions_capacity=64,
            all_solution_iteration_expiry=1_000, max_allow_no_improvement_for=5,
        ),
        population=4, exchange_every=2, device="cpu",
    )
    solver.run(max_rounds=6, chunk=2)
    (hard, soft), pos = solver.get_best_solution()
    assert hard == 0.0 and (hard, soft) == td.layout_score_naive(spec, pos)
