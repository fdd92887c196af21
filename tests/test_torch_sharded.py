"""The port's two-axis sharded solver (``parallel/sharded.py``) on four gloo
ranks on the CPU, a 2 x 2 (pop, nbr) mesh, mirroring ``tests/test_sharded.py``:

- from the JAX sharded solver's lane keys, every lane's state (boards,
  counters, scores, fingerprints, tabu rings, archives, round counters) after
  the run equals the JAX ``ShardedPopulationSolver``'s on the fake 8-device
  mesh, bit for bit, for nqueens-16 and nqueens-24 (``sample_cols=4``,
  ``nbr_keep=16``), with the exchange on, off, and with the cull;
- with the exchange on every lane's archive holds the global best;
- the driver's API: stepping, stats, a checkpoint written by rank 0 and read
  by every rank, the same continuation after it;
- every candidate of the gathered list carries its move's full rescore."""

import jax
import numpy as np
import pytest

import torch_ranks
from constraint_solver_tpu.core.ils import SolverConfig as JConfig
from constraint_solver_tpu.models.nqueens import make_nqueens_problem as j_make
from constraint_solver_tpu.parallel.mesh import make_mesh as j_mesh
from constraint_solver_tpu.parallel.sharded import ShardedPopulationSolver as JSharded
from constraint_solver_tpu.utils.seeding import seed_string_to_key
from constraint_solver_tpu_torch.utils.convert import reference_share
from test_torch_population import assert_tree_equal

P = 8
# name: (n, solver keywords, run keywords), the JAX tests' runs.
RUNS = {
    "n16": (16, {}, {"max_rounds": 12, "chunk": 4}),
    "n24_exchange": (24, {"k_exchange": 4, "exchange_every": 5}, {"max_rounds": 10, "chunk": 5}),
    "n24_isolated": (24, {"k_exchange": 0}, {"max_rounds": 10, "chunk": 5}),
    "n16_cull": (16, {"cull_frac": 0.25, "exchange_every": 5}, {"max_rounds": 20, "chunk": 5}),
}


def _key_data():
    return np.asarray(jax.random.key_data(jax.random.split(seed_string_to_key("42"), P)))


@pytest.fixture(scope="module")
def jax_runs():
    out = {}
    mesh = j_mesh(n_pop=2, n_nbr=2)
    for name, (n, kw, run_kw) in RUNS.items():
        problem = j_make(n, sample_cols=4, nbr_axis="nbr", nbr_shards=2, nbr_keep=16)
        s = JSharded(problem, JConfig(**torch_ranks.sharded_config()), population=P, mesh=mesh, **kw)
        s.run(**run_kw)
        out[name] = {"state": jax.device_get(s.state), "best": s.get_best_solution(), "stats": s.stats(),
                     "info": s.get_iteration_info()}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    key_data = {name: _key_data() for name in RUNS}
    return torch_ranks.spawn(torch_ranks.sharded_body, 4, tmp, RUNS, key_data, str(tmp / "sharded.npz"))


@pytest.mark.parametrize("name", list(RUNS))
def test_sharded_lanes_equal_the_jax_sharded_solver(name, ranks, jax_runs):
    want = jax_runs[name]
    for rank, out in enumerate(ranks):
        lanes = slice(rank // 2 * P // 2, (rank // 2 + 1) * P // 2)
        assert_tree_equal(reference_share(want["state"], lanes), out[name]["state"], f"rank {rank} {name}")
        (score, best), (j_score, j_best) = out[name]["best"], want["best"]
        assert score == j_score
        np.testing.assert_array_equal(best.rows, j_best.rows)
        assert out[name]["info"] == want["info"]
        stats = {k: v for k, v in out[name]["stats"].items() if k != "moves_per_sec"}
        assert stats == {k: v for k, v in want["stats"].items() if k != "moves_per_sec"}


def test_exchange_on_vs_off(ranks):
    on, off = ranks[0]["n24_exchange"]["lane_bests"], ranks[0]["n24_isolated"]["lane_bests"]
    assert (on == on[0]).all(), on  # every lane's archive holds the global best
    assert on.mean() <= off.mean()
    assert on[:, 0].max() <= off[:, 0].max()
    for out in ranks[1:]:
        np.testing.assert_array_equal(out["n24_exchange"]["lane_bests"], on)


def test_cull_path_improves(ranks):
    (hard, _), _ = ranks[0]["n16_cull"]["best"]
    assert hard <= 2


def test_driver_api_parity_with_checkpoint(ranks):
    for out in ranks:
        parity = out["parity"]
        assert parity["finished_at_0"] is False
        assert parity["info_1"] == {"current": 1, "total": 100}
        stats = parity["stats"]
        assert stats["ls_iterations"] > 0
        assert stats["moves_evaluated"] == stats["ls_iterations"] * parity["width"]
        assert stats["moves_per_sec"] > 0
        assert parity["best_saved"] == parity["best_loaded"]
        assert_tree_equal(parity["after_a"], parity["after_b"])
        assert parity["traced"].shape == (2, 3)


def test_candidate_list_consistent_with_full_rescore(ranks):
    cand = ranks[0]["candidates"]
    assert cand["width"] == 4 * 8  # four shards keep 8 each
    assert cand["valid"].any()
    lane, idx = np.nonzero(cand["valid"])
    np.testing.assert_array_equal(cand["scores"][lane, idx, 0], cand["rescored"][lane, idx])
    for out in ranks[1:]:  # the list is the same on every rank of the axis
        np.testing.assert_array_equal(out["candidates"]["scores"], cand["scores"])
