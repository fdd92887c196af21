"""The port's date-sharded scorer and solver (``parallel/seq_shard.py``,
``parallel/seq_solver.py``) on four gloo ranks on the CPU, mirroring
``tests/test_seq_shard.py`` and ``tests/test_seq_solver.py``:

- the sharded scorer over 2 and 4 ranks equals the JAX package's one-device
  scorer on random 365-day and (uneven) 200-day schedules, and too few days per
  rank is refused;
- the one-lane solver over 4 ranks follows the JAX one-device ``Solver`` with
  the random proposer from the same key, every leaf after every 4 rounds, and
  the 2 x 2 (pop, seq) solver the JAX one-device ``PopulationSolver``;
- with 61 days over 2 ranks (one padding day), a checkpoint round trip
  continues as a run that never stopped, and the best's score is its rescore.

Every score is a small integer in float32: the comparisons are bit for bit."""

import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_ranks
from constraint_solver_tpu.core.ils import Solver as JSolver
from constraint_solver_tpu.core.ils import SolverConfig as JConfig
from constraint_solver_tpu.models.scheduling import ScheduleSpec as JSpec
from constraint_solver_tpu.models.scheduling import make_scheduling_problem as j_make
from constraint_solver_tpu.parallel.population import PopulationSolver as JPopulation
from constraint_solver_tpu.utils.seeding import seed_string_to_key
from constraint_solver_tpu_torch.models.scheduling import make_scheduling_problem
from constraint_solver_tpu_torch.utils.convert import reference_share
from test_torch_population import assert_tree_equal

D0 = torch_ranks.D0
HOL_365 = {0: [datetime.date(2022, 6, 1)], 3: [datetime.date(2022, 12, 25), datetime.date(2022, 12, 26)]}
HOL_SOLO = {0: [D0 + datetime.timedelta(days=5)], 3: [D0 + datetime.timedelta(days=k) for k in (10, 40)]}
HOL_POP = {1: [D0 + datetime.timedelta(days=9)]}


def _assigns(days, emps, count, seed):
    return np.random.default_rng(seed).integers(0, emps, size=(count, days))


def _scorer_cases():
    spec365, spec200 = torch_ranks.schedule_spec(365, 12, HOL_365), torch_ranks.schedule_spec(200, 7)
    return {
        "365d_over_2": (spec365, 2, _assigns(365, 12, 6, 0)),
        "365d_over_4": (spec365, 4, _assigns(365, 12, 6, 1)),
        "200d_over_4": (spec200, 4, _assigns(200, 7, 4, 2)),
        "40d_over_4": (torch_ranks.schedule_spec(40, 5), 4, _assigns(40, 5, 1, 3)),
    }


def _key_data(population):
    key = seed_string_to_key("seqsolve")
    keys = key[None] if population == 1 else jax.random.split(key, population)
    return np.asarray(jax.random.key_data(keys))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq")
    return torch_ranks.spawn(torch_ranks.seq_body, 4, tmp, _scorer_cases(), _key_data(1), _key_data(4),
                             str(tmp / "popseq.npz"))


def _jspec(days, emps, holidays=None):
    return JSpec.from_dates(D0, D0 + datetime.timedelta(days=days - 1), emps, holidays)


@pytest.mark.parametrize("name", ["365d_over_2", "365d_over_4", "200d_over_4"])
def test_sharded_score_equals_jax_dense_scorer(name, ranks):
    spec, _, assigns = _scorer_cases()[name]
    dense = j_make(_jspec(spec.num_days, spec.num_employees, HOL_365 if spec.num_days == 365 else None)).score
    want = np.stack([np.asarray(dense(jnp.asarray(a, jnp.int32))) for a in assigns])
    for out in ranks:
        np.testing.assert_array_equal(out["scores"][name], want)


def test_too_small_shards_rejected(ranks):
    for out in ranks:
        assert out["scores"]["40d_over_4"] == "each shard needs >= 13 days; got 10 (40 days over 4 shards)"


def test_seq_sharded_solve_equals_jax_dense_trajectory(ranks):
    spec = _jspec(64, 7, HOL_SOLO)
    dense = JSolver(j_make(spec, window_size=32, proposer="random"), JConfig(**torch_ranks.seq_config(12)))
    for chunk in range(3):
        for _ in range(4):
            dense.execute_round()
        want = reference_share(jax.tree.map(lambda x: x[None], dense.state), slice(None))  # a lane axis
        for rank, out in enumerate(ranks):
            assert_tree_equal(want, out["solo"][chunk], f"rank {rank} after {4 * (chunk + 1)} rounds")
    for rank, out in enumerate(ranks):  # each rank holds its 16 days of every solution
        assert_tree_equal(reference_share(want, slice(None), days=(16 * rank, 16 * (rank + 1), 64)),
                          out["solo_local"], f"rank {rank}'s days")
    (score, best), (j_score, j_best) = ranks[0]["solo_best"], dense.get_best_solution()
    assert score == j_score
    np.testing.assert_array_equal(best, j_best)
    assert ranks[0]["solo_stats"]["ls_iterations"] == dense.stats()["ls_iterations"]


def test_popseq_solve_equals_jax_dense_population(ranks):
    spec = _jspec(64, 7, HOL_POP)
    dense = JPopulation(j_make(spec, window_size=32, proposer="random"), JConfig(**torch_ranks.seq_config(8)),
                        population=4, exchange_every=4, k_exchange=2)
    dense.run(max_rounds=8, chunk=4)
    want = jax.device_get(dense.state)
    for rank, out in enumerate(ranks):
        assert_tree_equal(want, out["popseq"], f"rank {rank}")
    (score, best), (j_score, j_best) = ranks[0]["popseq_best"], dense.get_best_solution()
    assert score == j_score
    np.testing.assert_array_equal(best, j_best)


def test_popseq_checkpoint_roundtrip_uneven_days(ranks):
    for out in ranks:
        assert out["resumed_at"] == 4
        assert_tree_equal(out["full"], out["resumed"])
        assert out["full_best"][0] == out["resumed_best"][0]
        np.testing.assert_array_equal(out["full_best"][1], out["resumed_best"][1])
    (hard, soft), assign = ranks[0]["full_best"]
    assert assign.shape == (61,)
    import torch

    rescore = make_scheduling_problem(torch_ranks.schedule_spec(61, 5)).score(torch.as_tensor(assign)[None])[0]
    assert (hard, soft) == (float(rescore[0]), float(rescore[1]))
