"""The PyTorch port's systematic scheduling proposer against the JAX package's
(``proposer="systematic"``: every day rotated through its E − 1 successor
employees, each candidate a full state scored by ``score``).

The neighborhood must be bit-equal on the JAX test's 5 × 3 example and on a
14 × 4 state, and a P = 4 population trajectory fed the same JAX-key draws
(``tests/jax_key_draws.py``) must equal the JAX package's leaf for leaf for 3
rounds: the proposer draws nothing, so it must call ``draws.advance`` as the
other draw-free proposers do."""

import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from constraint_solver_tpu.core.ils import SolverConfig as JConfig
from constraint_solver_tpu.models import scheduling as js
from constraint_solver_tpu.parallel import population as jpop
from constraint_solver_tpu.utils.seeding import seed_string_to_key
from constraint_solver_tpu_torch.core.ils import Solver, SolverConfig
from constraint_solver_tpu_torch.models import scheduling as ts
from constraint_solver_tpu_torch.parallel import population as tpop
from constraint_solver_tpu_torch.utils.convert import to_reference
from jax_key_draws import JaxKeyDraws
from test_torch_population import assert_tree_equal

D0 = datetime.date(2022, 5, 9)


def _problems(days, emps):
    end = D0 + datetime.timedelta(days=days - 1)
    return (
        js.make_scheduling_problem(js.ScheduleSpec.from_dates(D0, end, emps), proposer="systematic"),
        ts.make_scheduling_problem(ts.ScheduleSpec.from_dates(D0, end, emps), proposer="systematic"),
    )


@pytest.mark.parametrize(
    "days, emps, assign",
    [(5, 3, [[0, 1, 2, 0, 1]]), (14, 4, np.random.default_rng(3).integers(0, 4, (3, 14)).tolist())],
    ids=["5d3e", "14d4e"],
)
def test_neighborhood_bit_equal_to_jax(days, emps, assign):
    jp, tp = _problems(days, emps)
    assert tp.width == jp.width == days * (emps - 1)
    a = torch.tensor(assign)
    p = a.shape[0]
    draws = JaxKeyDraws(jax.random.split(jax.random.key(0), p))
    draws.round_keys()
    nb = tp.neighborhood(a, tp.score(a), draws, torch.ones(p, dtype=torch.bool))
    aj = jnp.asarray(assign, jnp.int32)
    jnb = jax.jit(jax.vmap(lambda x: jp.neighborhood(x, jp.score(x), jax.random.key(0))))(aj)
    np.testing.assert_array_equal(nb.moves.numpy(), np.asarray(jnb.moves))
    np.testing.assert_array_equal(nb.scores.numpy(), np.asarray(jnb.scores))
    np.testing.assert_array_equal(nb.valid.numpy(), np.asarray(jnb.valid))
    assert nb.fp_deltas is None and jnb.fp_deltas is None

    w = nb.valid.shape[1]
    fps = tp.move_fp(a, tp.fingerprint(a), nb.moves, torch.arange(w).expand(p, w))
    all_fps = jax.vmap(lambda x, mv: jax.vmap(lambda i: jp.move_fp(x, jp.fingerprint(x), mv, i))(jnp.arange(w)))
    want = jax.jit(all_fps)(aj, jnb.moves)
    apply = jax.jit(jax.vmap(jp.apply_move, in_axes=(0, 0, None)))
    np.testing.assert_array_equal(fps.numpy().astype(np.uint32), np.asarray(want))
    for i in (0, w // 2, w - 1):
        moved = tp.apply_move(a, nb.moves, torch.full((p,), i))
        np.testing.assert_array_equal(moved.numpy(), np.asarray(apply(aj, jnb.moves, i)))
        np.testing.assert_array_equal(tp.fingerprint(moved).numpy(), fps[:, i].numpy())


def test_population_trajectory_matches_jax():
    """A P = 4 PopulationSolver on 14 d × 4 e, exchange every 2 rounds, 3 rounds
    with a restart at round 3, leaf for leaf."""
    p = 4
    seed = "sched-systematic"
    kw = dict(
        seed=seed, local_search_max_iterations=8, best_solutions_capacity=3, all_solutions_capacity=16,
        all_solution_iteration_expiry=40, restart_every=3, max_allow_no_improvement_for=4,
    )
    jp, tp = _problems(14, 4)
    jsolver = jpop.PopulationSolver(jp, JConfig(**kw), population=p, exchange_every=2)
    tsolver = tpop.PopulationSolver(
        tp, SolverConfig(**kw), population=p, exchange_every=2,
        draws=JaxKeyDraws(jax.random.split(seed_string_to_key(seed), p)), device="cpu",
    )
    assert tsolver.program.ls_params.tabu_exact_filter
    for _ in range(3):
        np.testing.assert_array_equal(tsolver.execute_chunk_traced(1), jsolver.execute_chunk_traced(1))
        assert_tree_equal(jsolver.state, to_reference(tsolver.state))
    assert tsolver.stats() == jsolver.stats()


def test_systematic_solver_improves():
    """The JAX package's systematic solver test on the port, over 10 rounds
    where the JAX test runs 30."""
    _, tp = _problems(14, 4)
    solver = Solver(
        tp,
        SolverConfig(seed="1", local_search_max_iterations=200, iterated_local_search_max_iterations=10,
                     max_allow_no_improvement_for=5),
        device="cpu",
    )
    start = float(tp.score(solver.state.current_state)[0, 0])
    solver.run(chunk=10)
    (hard, _), best = solver.get_best_solution()
    assert hard <= start and hard <= 2
    assert (hard, _) == tuple(tp.score(torch.as_tensor(best)[None])[0].tolist())
