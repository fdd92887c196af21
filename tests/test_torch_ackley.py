"""The PyTorch port's Ackley domain against the JAX package's ``models/ackley.py``.

``cos``, ``exp`` and ``sqrt`` may differ between PyTorch and XLA in the last
bit, so scores are held to a relative tolerance of 1e-5 (``SCORE_RTOL``; the
JAX package's own device-vs-host test allows 2e-5).  Everything else follows
the same float32 arithmetic from the same draws and must be equal bit for bit:
the points (the candidate values x ± step, the clamped perturbation), the
fingerprints of their bit patterns, and every counter of a whole population
trajectory."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from constraint_solver_tpu.core.ils import SolverConfig as JConfig
from constraint_solver_tpu.parallel import population as jpop
from constraint_solver_tpu.utils.seeding import seed_string_to_key
from constraint_solver_tpu_torch.core.ils import SolverConfig
from constraint_solver_tpu_torch.models import ackley as ta
from constraint_solver_tpu_torch.parallel import population as tpop
from constraint_solver_tpu_torch.utils.convert import from_reference, to_reference
from jax_key_draws import JaxKeyDraws

# The JAX package's ``models`` exports a function named ``ackley`` over the module.
ja = importlib.import_module("constraint_solver_tpu.models.ackley")

SCORE_RTOL = 1e-5
_SCORE_FIELDS = ("current_score", "scores")
GOLDEN_20D = [0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0] * 2


def assert_tree_close(want, got, path="state"):
    """Leaf for leaf: scores within ``SCORE_RTOL``, every other leaf exact."""
    if hasattr(got, "_fields"):
        for f in got._fields:
            assert_tree_close(getattr(want, f), getattr(got, f), f"{path}.{f}")
        return
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
    if path.rsplit(".", 1)[-1] in _SCORE_FIELDS:
        np.testing.assert_allclose(got, want, rtol=SCORE_RTOL, err_msg=path)
    else:
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize(
    "x, want", [([0.0, 0.0], 0.0), ([1.0, 1.0], 3.625384938440363), (GOLDEN_20D, 13.12408690638194)]
)
def test_golden_constants(x, want):
    assert abs(ta.ackley_np(np.array(x)) - want) < 1e-12
    assert abs(ta.ackley_np(np.array(x)) - ja.ackley_np(np.array(x))) == 0.0


def test_ackley_matches_jax_and_host():
    rng = np.random.default_rng(0)
    for d in (2, 5, 10, 20):
        xs = rng.uniform(ta.X_MIN, ta.X_MAX, size=(16, d)).astype(np.float32)
        got = ta.ackley(torch.from_numpy(xs)).numpy()
        np.testing.assert_allclose(got, np.asarray(ja.ackley(jnp.asarray(xs))), rtol=SCORE_RTOL)
        np.testing.assert_allclose(got, ta.ackley_np(xs), rtol=2e-5, atol=2e-5)


def test_neighborhood_moves_and_perturbation_match_jax():
    d, p = 5, 4
    jp, tp = ja.make_ackley_problem(d), ta.make_ackley_problem(d)
    keys = jax.random.split(jax.random.key(3), p)
    draws = JaxKeyDraws(keys)
    x = tp.init(draws)
    xj = jax.vmap(jp.init)(jax.vmap(jax.random.split)(keys)[:, 1])
    np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
    draws.round_keys()
    on = torch.ones(p, dtype=torch.bool)
    nb = tp.neighborhood(x, tp.score(x), draws, on)
    jnb = jax.vmap(lambda xi, k: jp.neighborhood(xi, jp.score(xi), k))(xj, draws._nb_key)
    np.testing.assert_array_equal(nb.moves.numpy(), np.asarray(jnb.moves[1]))
    np.testing.assert_allclose(nb.scores.numpy(), np.asarray(jnb.scores), rtol=SCORE_RTOL)
    idx = torch.arange(2 * d).expand(p, 2 * d)
    fps = tp.move_fp(x, tp.fingerprint(x), nb.moves, idx)
    for i in range(2 * d):
        moved = tp.apply_move(x, nb.moves, idx[:, i])
        want = jax.vmap(lambda xi, m0, m1: jp.apply_move(xi, (m0, m1), i))(xj, jnb.moves[0], jnb.moves[1])
        np.testing.assert_array_equal(moved.numpy(), np.asarray(want))
        np.testing.assert_array_equal(fps[:, i].numpy(), tp.fingerprint(moved).numpy())
        np.testing.assert_array_equal(tp.fingerprint(moved).numpy().astype(np.uint32), np.asarray(jax.vmap(jp.fingerprint)(want)))
    is_elite = torch.tensor([True, False, True, False])
    for _ in range(3):
        draws.round_keys()
        got = tp.perturb(x, is_elite, draws)
        want = jax.vmap(jp.perturb)(jnp.asarray(x.numpy()), jnp.asarray(is_elite.numpy()), draws._perturb_key)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got.abs() <= ta.X_MAX).all()
        x = got


def test_population_trajectory_matches_jax():
    """A d=5, P=4 PopulationSolver (exchange every 2 rounds, a restart at round
    3): points and fingerprints bit-equal, scores within ``SCORE_RTOL``."""
    d, p = 5, 4
    seed = "ackley-traj"
    kw = dict(
        seed=seed, local_search_max_iterations=30, best_solutions_capacity=4, all_solutions_capacity=32,
        all_solution_iteration_expiry=100, restart_every=3, max_allow_no_improvement_for=10,
    )
    jsolver = jpop.PopulationSolver(ja.make_ackley_problem(d), JConfig(**kw), population=p, exchange_every=2)
    tsolver = tpop.PopulationSolver(
        ta.make_ackley_problem(d), SolverConfig(**kw), population=p, exchange_every=2,
        draws=JaxKeyDraws(jax.random.split(seed_string_to_key(seed), p)), device="cpu",
    )
    assert tsolver.program.ls_params.tabu_exact_filter
    assert_tree_close(jsolver.state, to_reference(tsolver.state))
    for _ in range(3):
        trace_t, trace_j = tsolver.execute_chunk_traced(2), jsolver.execute_chunk_traced(2)
        np.testing.assert_allclose(trace_t, trace_j, rtol=SCORE_RTOL)
        assert_tree_close(jsolver.state, to_reference(tsolver.state))
    assert tsolver.stats() == jsolver.stats()
    (score_t, x_t), (score_j, x_j) = tsolver.get_best_solution(), jsolver.get_best_solution()
    np.testing.assert_allclose(score_t, score_j, rtol=SCORE_RTOL)
    np.testing.assert_array_equal(x_t, x_j)
    np.testing.assert_allclose(score_t[0], ta.ackley_np(x_t), rtol=2e-5, atol=2e-5)
    assert_tree_close(jsolver.state, to_reference(from_reference(jsolver.state, "cpu")))
    back = from_reference(to_reference(tsolver.state), "cpu")
    assert back.current_state.dtype == torch.float32
    assert_tree_close(to_reference(tsolver.state), to_reference(back))


def test_torch_draws_reach_the_optimum():
    """The production draw source drives d=2 to |f| <= 1e-2."""
    solver = tpop.PopulationSolver(
        ta.make_ackley_problem(2),
        SolverConfig(seed="42", local_search_max_iterations=2_000, max_allow_no_improvement_for=10),
        population=8, exchange_every=2, device="cpu",
    )
    solver.run(max_rounds=40, chunk=2)
    (value, _), x = solver.get_best_solution()
    assert abs(value) <= 1e-2 and abs(ta.ackley_np(x) - value) < 2e-5
