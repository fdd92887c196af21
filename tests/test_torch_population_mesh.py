"""``PopulationSolver(mesh=)`` and ``PhasedPopulationSolver(mesh=)`` over a
4-rank ``pop`` axis (gloo ranks on the CPU) against the port's one-device runs
from the same seed: every rank draws for the whole population and keeps its
lanes, and every loop decision is world-agreed, so each rank's lanes must equal
the one-device run's, bit for bit, with the exchange (a global top-k) and the
cull (global ranks) on, for N-Queens and for scheduling.  Checkpoints move
between the two layouts: a sharded run's file resumes in the one-device solver
and a one-device file in the sharded one, each continuing as a run that never
stopped."""

import numpy as np
import pytest

import torch_ranks
from constraint_solver_tpu_torch.utils.convert import to_reference
from test_torch_population import assert_tree_equal

P, WORLD = 8, 4


def _lanes(rank):
    return slice(rank * P // WORLD, (rank + 1) * P // WORLD)


def _share(state, rank):
    from constraint_solver_tpu_torch.utils.tree import tree_map

    return tree_map(lambda x: x[_lanes(rank)], state)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("population_mesh")
    dense = torch_ranks.population_solver("nqueens")
    dense.run(max_rounds=2, chunk=2)
    dense.save(str(tmp / "dense.npz"))
    return str(tmp / "dense.npz"), str(tmp / "sharded.npz"), tmp


@pytest.fixture(scope="module")
def ranks(ckpts):
    dense_ckpt, sharded_ckpt, tmp = ckpts
    return torch_ranks.spawn(torch_ranks.population_mesh_body, WORLD, tmp, dense_ckpt, sharded_ckpt)


@pytest.mark.parametrize("name", ["nqueens", "scheduling"])
def test_pop_sharded_run_equals_one_device_run(name, ranks):
    dense = torch_ranks.population_solver(name)
    traces = np.concatenate([dense.execute_chunk_traced(2) for _ in range(3)])
    want = to_reference(dense.state)
    for rank, out in enumerate(ranks):
        assert_tree_equal(_share(want, rank), out[name]["state"], f"rank {rank}")
        np.testing.assert_array_equal(out[name]["traces"], traces)
        assert _counts(out[name]["stats"]) == _counts(dense.stats())
        assert out[name]["score"] == dense.get_best_score()
        (score, best), (d_score, d_best) = out[name]["best"], dense.get_best_solution()
        assert score == d_score
        assert_tree_equal(d_best, best) if hasattr(best, "_fields") else np.testing.assert_array_equal(best, d_best)


def test_phased_over_a_pop_mesh_equals_one_device(ranks):
    dense = torch_ranks.phased_solver()
    dense.run(chunk=2)
    want = to_reference(dense.state)
    for rank, out in enumerate(ranks):
        assert_tree_equal(_share(want, rank), out["phased"]["state"], f"rank {rank}")
        assert _counts(out["phased"]["stats"]) == _counts(dense.stats())
        assert out["phased"]["best"][0] == dense.get_best_solution()[0]


def _counts(stats):
    return {k: v for k, v in stats.items() if k != "moves_per_sec"}  # a rate of each run's own wall


def _straight():
    s = torch_ranks.population_solver("nqueens")
    s.run(max_rounds=2, chunk=2)
    s.run(max_rounds=2, chunk=2)
    return to_reference(s.state)


def test_sharded_checkpoint_resumes_in_the_one_device_solver(ranks, ckpts):
    _, sharded_ckpt, _ = ckpts
    resumed = torch_ranks.population_solver("nqueens")
    resumed.load(sharded_ckpt)
    assert resumed.get_iteration_info()["current"] == 2
    resumed.run(max_rounds=2, chunk=2)
    assert_tree_equal(_straight(), to_reference(resumed.state))


def test_one_device_checkpoint_resumes_in_the_sharded_solver(ranks):
    want = _straight()
    for rank, out in enumerate(ranks):
        assert_tree_equal(_share(want, rank), out["resumed"], f"rank {rank}")
