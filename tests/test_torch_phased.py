"""The PyTorch port's ``PhasedPopulationSolver`` against the JAX package's, after
``tests/test_phased.py``.

Both solvers draw from the same JAX keys (``tests/jax_key_draws.py``), so the
phase handoff must be exact: identical phases equal a plain population, a
switch to another program happens at the boundary round and leaves every state
leaf equal to the JAX package's, checkpoints resume in the right phase, and the
moves of each phase are counted at its own width.  All phases share one draw
source and one round counter."""

import datetime

import jax
import pytest

from constraint_solver_tpu.core.ils import SolverConfig as JConfig
from constraint_solver_tpu.models import scheduling as js
from constraint_solver_tpu.parallel import phased as jph
from constraint_solver_tpu.utils.seeding import seed_string_to_key
from constraint_solver_tpu_torch.core.ils import SolverConfig
from constraint_solver_tpu_torch.models import scheduling as ts
from constraint_solver_tpu_torch.parallel import phased as tph
from constraint_solver_tpu_torch.parallel.population import PopulationSolver
from constraint_solver_tpu_torch.utils.convert import to_reference
from jax_key_draws import JaxKeyDraws
from test_torch_population import assert_tree_equal

P = 4


def _spec(mod, days=21, emps=5):
    d0 = datetime.date(2024, 1, 1)
    hol = {e: [d0 + datetime.timedelta(days=(3 * e) % days)] for e in range(emps)}
    return mod.ScheduleSpec.from_dates(d0, d0 + datetime.timedelta(days=days - 1), emps, hol)


def _kw(ls=12, bail=5, rounds=8, seed="ph"):
    return dict(
        seed=seed, local_search_max_iterations=ls, best_solutions_capacity=8, all_solutions_capacity=64,
        all_solution_iteration_expiry=200, iterated_local_search_max_iterations=rounds,
        max_allow_no_improvement_for=bail,
    )


def _pair(swaps, bounds, **kw):
    """The JAX and port phased solvers for dense phases with ``swaps`` random
    swaps each, ending at ``bounds`` (None for the last)."""
    jphases, tphases = [], []
    for n_swaps, until in zip(swaps, bounds):
        jphases.append(jph.Phase(js.make_scheduling_problem(_spec(js), proposer="dense", n_rand_swaps=n_swaps),
                                 JConfig(**_kw(**kw)), until))
        tphases.append(tph.Phase(ts.make_scheduling_problem(_spec(ts), proposer="dense", n_rand_swaps=n_swaps),
                                 SolverConfig(**_kw(**kw)), until))
    seed = _kw(**kw)["seed"]
    jsolver = jph.PhasedPopulationSolver(jphases, population=P, exchange_every=2)
    tsolver = tph.PhasedPopulationSolver(
        tphases, population=P, exchange_every=2, draws=JaxKeyDraws(jax.random.split(seed_string_to_key(seed), P)),
        device="cpu",
    )
    return jsolver, tsolver


def test_identical_phases_match_plain_population_and_jax():
    jsolver, tsolver = _pair([8, 8], [4, None])
    tsolver.run(chunk=2)
    jsolver.run(chunk=2)
    assert_tree_equal(jsolver.state, to_reference(tsolver.state))
    plain = PopulationSolver(
        ts.make_scheduling_problem(_spec(ts), proposer="dense", n_rand_swaps=8), SolverConfig(**_kw()),
        population=P, exchange_every=2, draws=JaxKeyDraws(jax.random.split(seed_string_to_key("ph"), P)), device="cpu",
    )
    plain.run(chunk=2)
    assert plain.get_best_score() == tsolver.get_best_score() == jsolver.get_best_score()
    assert_tree_equal(to_reference(plain.state), to_reference(tsolver.state))


def test_phase_switch_changes_program_at_exact_round():
    """Distinct phases: chunks clip at the boundary, the state equals the JAX
    package's after each call, and the moves follow each phase's width."""
    jsolver, tsolver = _pair([4, 16], [4, None], ls=10)
    widths = [ph.problem.width for ph in tsolver.phases]
    assert widths[0] != widths[1] and widths == [ph.problem.width for ph in jsolver.phases]
    for kw in (dict(max_rounds=3, chunk=8), dict(chunk=8)):
        tsolver.run(**kw)
        jsolver.run(**kw)
        assert_tree_equal(jsolver.state, to_reference(tsolver.state))
        st, sj = tsolver.stats(), jsolver.stats()
        assert {k: v for k, v in st.items() if k != "moves_per_sec"} == {k: v for k, v in sj.items() if k != "moves_per_sec"}
    assert st["phase"] == 1 and (st["rounds"] == 8 or tsolver.get_best_score() == (0.0, 0.0))
    assert min(widths) * st["ls_iterations"] <= st["moves_evaluated"] <= max(widths) * st["ls_iterations"]


def test_phased_checkpoint_resume_enters_correct_phase(tmp_path):
    def build():
        return _pair([4, 16], [4, None], ls=10, rounds=8, seed="ck")[1]

    full = build()
    full.run(chunk=2)
    part = build()
    part.run(max_rounds=6, chunk=2)
    ckpt = str(tmp_path / "phased_ck")
    part.save(ckpt)
    resumed = build()
    resumed.load(ckpt)
    assert resumed.stats()["phase"] == 1
    resumed.run(chunk=2)
    assert resumed.get_best_score() == full.get_best_score()
    assert resumed.stats()["moves_evaluated"] == full.stats()["moves_evaluated"]
    assert_tree_equal(to_reference(full.state), to_reference(resumed.state))


def test_phase_validation():
    p = ts.make_scheduling_problem(_spec(ts), proposer="dense", n_rand_swaps=4)
    cfg = SolverConfig(**_kw())
    with pytest.raises(ValueError, match="at least one"):
        tph.PhasedPopulationSolver([], population=2, device="cpu")
    bad_caps = SolverConfig(seed="x", best_solutions_capacity=4, all_solutions_capacity=64, all_solution_iteration_expiry=200)
    with pytest.raises(ValueError, match="capacities"):
        tph.PhasedPopulationSolver(
            [tph.Phase(p, cfg, until_round=4), tph.Phase(p, bad_caps)], population=2, device="cpu"
        )
    with pytest.raises(ValueError, match="until_round"):
        tph.PhasedPopulationSolver([tph.Phase(p, cfg), tph.Phase(p, cfg)], population=2, device="cpu")
    with pytest.raises(ValueError, match="increase"):
        tph.PhasedPopulationSolver(
            [tph.Phase(p, cfg, until_round=8), tph.Phase(p, cfg, until_round=4), tph.Phase(p, cfg)], population=2,
            device="cpu",
        )


def test_execute_round_banks_moves_at_phase_boundary():
    """Stepping with ``execute_round`` across a boundary counts moves as
    ``run(chunk=1)`` does, and as the JAX package does."""
    jstepped, stepped = _pair([4, 16], [3, None], ls=10)
    _, chunked = _pair([4, 16], [3, None], ls=10)
    for _ in range(5):
        stepped.execute_round()
        jstepped.execute_round()
    chunked.run(max_rounds=5, chunk=1)
    ss, sc, sj = stepped.stats(), chunked.stats(), jstepped.stats()
    assert ss["rounds"] == sc["rounds"] == sj["rounds"] == 5
    assert ss["ls_iterations"] == sc["ls_iterations"] == sj["ls_iterations"]
    assert ss["moves_evaluated"] == sc["moves_evaluated"] == sj["moves_evaluated"]
    widths = [ph.problem.width for ph in stepped.phases]
    assert all(ss["moves_evaluated"] != ss["ls_iterations"] * w for w in widths)
    assert_tree_equal(jstepped.state, to_reference(stepped.state))
