"""The PyTorch port's parallel min-conflicts (``models/nqueens_parallel.py``)
against the JAX package.

Both sides draw from the same JAX keys (``tests/jax_key_draws.py``).  The JAX
reference is its XLA path (``use_pallas=False``): its Pallas path hands the
kernel's tuple to ``jnp.argmin`` and raises (ROADMAP C1).  The port scores every
step through ``ops/nqueens_kernel.nqueens_neighborhood_scores``, whose plain
version runs on the CPU.  Equality is exact: boards and step counts are
integers, scores small integers in float32."""

import jax
import numpy as np
import pytest
import torch

from constraint_solver_tpu.models import nqueens_parallel as jpmc
from constraint_solver_tpu.utils.seeding import seed_string_to_key
from constraint_solver_tpu_torch.models import nqueens_parallel as tpmc
from constraint_solver_tpu_torch.models.nqueens import total_conflicts
from constraint_solver_tpu_torch.utils.convert import to_reference
from jax_key_draws import JaxKeyDraws, reference_log_weights


def assert_tree_equal(want, got, path="pmc"):
    if hasattr(got, "_fields"):
        for f in got._fields:
            assert_tree_equal(getattr(want, f), getattr(got, f), f"{path}.{f}")
        return
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=path)


def _lanes(tree):
    return jax.tree.map(lambda x: x[None], tree)


@pytest.mark.parametrize("n, max_steps", [(8, 2000), (16, 2000), (32, 2000), (32, 7)])
def test_solve_matches_jax(n, max_steps):
    key = jax.random.key(n)
    want = jpmc.pmc_solve(n, key, max_steps=max_steps)
    got = tpmc.pmc_solve(n, JaxKeyDraws(key[None]), max_steps=max_steps)
    assert_tree_equal(_lanes(want), to_reference(got))
    if max_steps == 2000:
        assert float(got.score[0]) == 0.0 and int(total_conflicts(got.state.rows)[0]) == 0


def test_sampled_columns_match_jax():
    n, a = 64, 16
    key = jax.random.key(4)
    want = jpmc.pmc_solve(n, key, max_steps=3000, sample_cols=a)
    got = tpmc.pmc_solve(
        n, JaxKeyDraws(key[None]), max_steps=3000, sample_cols=a, log_weights=reference_log_weights(n)
    )
    assert_tree_equal(_lanes(want), to_reference(got))
    assert float(got.score[0]) == 0.0


def test_population_matches_jax():
    """Four lanes, each stopping at its own step, as under ``vmap``."""
    n, p = 24, 4
    keys = jax.random.split(jax.random.key(11), p)
    want = jax.vmap(lambda k: jpmc.pmc_solve(n, k, max_steps=500))(keys)
    got = tpmc.pmc_solve(n, JaxKeyDraws(keys), max_steps=500)
    assert_tree_equal(want, to_reference(got))
    assert len(set(np.asarray(want.steps).tolist())) > 1  # lanes stop at different steps


def test_chunked_run_equals_one_run_and_matches_jax():
    n = 20
    key = jax.random.key(3)
    carry = jpmc.pmc_init(n, key)
    carry = jpmc.pmc_run(carry, 5)
    want = jpmc.pmc_run(carry, 40)
    draws = JaxKeyDraws(key[None])
    got = tpmc.pmc_run(tpmc.pmc_init(n, draws), draws, 5)
    assert_tree_equal(_lanes(carry), to_reference(got))
    got = tpmc.pmc_run(got, draws, 40)
    assert_tree_equal(_lanes(want), to_reference(got))


def test_solver_wrapper_matches_jax():
    want = jpmc.ParallelMinConflictsSolver(16, seed="7", population=4)
    got = tpmc.ParallelMinConflictsSolver(
        16, seed="7", population=4, draws=JaxKeyDraws(jax.random.split(seed_string_to_key("7"), 4)), device="cpu"
    )
    (w_score, _), w_state = want.get_best_solution()
    (g_score, _), g_state = got.get_best_solution()
    assert g_score == w_score == 0.0
    np.testing.assert_array_equal(g_state.rows.astype(np.int32), w_state.rows)
    assert got.stats() == want.stats()


def test_pmc_goes_through_the_kernel_wrapper(monkeypatch):
    calls = []
    wrapper = tpmc.nqueens_neighborhood_scores

    def counting(*args):
        calls.append(args[3].shape)
        return wrapper(*args)

    monkeypatch.setattr(tpmc, "nqueens_neighborhood_scores", counting)
    out = tpmc.pmc_solve(32, tpmc.TorchDraws("k", 2, "cpu"), max_steps=50)
    assert len(calls) > 0 and calls[0] == (2, 32)  # the full [n, n] block per lane
    calls.clear()
    tpmc.pmc_solve(64, tpmc.TorchDraws("k", 2, "cpu"), max_steps=5, sample_cols=16)
    assert calls[0] == (2, 16)
    assert torch.equal(out.score, total_conflicts(out.state.rows).to(torch.float32))


def test_torch_draws_solve_and_are_deterministic():
    a = tpmc.ParallelMinConflictsSolver(40, seed="x", population=2, device="cpu")
    b = tpmc.ParallelMinConflictsSolver(40, seed="x", population=2, device="cpu")
    (score, _), state = a.get_best_solution()
    assert score == 0.0 and sorted(state.rows.tolist()) == list(range(40))
    np.testing.assert_array_equal(state.rows, b.get_best_solution()[1].rows)
    assert a.stats() == b.stats() and a.stats()["moves_evaluated"] > 0
