"""The PyTorch port's dense scheduling proposer, moves and perturbation against
the JAX package (whole trajectories: ``tests/test_torch_scheduling_population.py``).

Shares its helpers with ``tests/test_torch_scheduling.py``; equality is exact
throughout (small integers in float32, uint32 fingerprints)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from constraint_solver_tpu.models import scheduling as js
from constraint_solver_tpu_torch.models import scheduling as ts
from constraint_solver_tpu_torch.utils.draws import TorchDraws
from jax_key_draws import JaxKeyDraws
from test_torch_scheduling import NB_CASES, _assert_nb_equal, _assignments, _eq, _nb_pair, _specs


@pytest.mark.parametrize("name", NB_CASES)
def test_dense_neighborhood_matches_jax(name):
    *_, nb_j, nb_t = _nb_pair(name, "dense", n_rand_swaps=16)
    _assert_nb_equal(nb_j, nb_t)


def test_dense_neighborhood_matches_jax_at_bench_size():
    *_, nb_j, nb_t = _nb_pair("365d20e", "dense", p=2, n_rand_swaps=32)
    _assert_nb_equal(nb_j, nb_t)


@pytest.mark.parametrize("proposer", ["dense", "random"])
@pytest.mark.parametrize("name", ["31d7e-hol", "15d3e", "9d3e", "30d4e-fri"])
def test_port_block_equals_full_rescore_of_applied_moves(name, proposer):
    """The port alone: every valid candidate's score and fingerprint equal the
    full score and fingerprint of the applied move."""
    tp = ts.make_scheduling_problem(_specs(name)[1], proposer=proposer, n_rand_swaps=16)
    draws = TorchDraws(name, 3, "cpu")
    ta = tp.init(draws)
    nb = tp.neighborhood(ta, tp.score(ta), draws, torch.ones(3, dtype=torch.bool))
    p, w = nb.valid.shape
    idx = torch.arange(w).expand(p, w)
    applied = torch.stack([tp.apply_move(ta, nb.moves, idx[:, i]) for i in range(w)], dim=1)
    want = tp.score(applied.reshape(p * w, -1)).view(p, w, 2)
    assert torch.equal(want[nb.valid], nb.scores[nb.valid])
    fps = tp.fingerprint(applied)
    cur = tp.fingerprint(ta)
    assert torch.equal((cur[:, None] ^ nb.fp_deltas)[nb.valid], fps[nb.valid])
    assert torch.equal(tp.move_fp(ta, cur, nb.moves, idx)[nb.valid], fps[nb.valid])


@pytest.mark.parametrize("proposer", ["dense", "random"])
def test_apply_move_and_move_fp_match_jax(proposer):
    kw = dict(n_rand_swaps=16) if proposer == "dense" else dict(window_size=24)
    jp, tp, ja, ta, nb_j, nb_t = _nb_pair("31d7e-hol", proposer, **kw)  # compiled by the tests above
    rng = np.random.default_rng(11)
    idx = rng.integers(0, nb_t.valid.shape[1], size=4)
    want = jax.jit(jax.vmap(jp.apply_move))(ja, nb_j.moves, jnp.asarray(idx, jnp.int32))
    _eq(want, tp.apply_move(ta, nb_t.moves, torch.from_numpy(idx)), np.int32)
    jfp = jax.jit(jax.vmap(jp.fingerprint))(ja)
    want_fp = jax.jit(jax.vmap(jp.move_fp))(ja, jfp, nb_j.moves, jnp.asarray(idx, jnp.int32))
    _eq(want_fp, tp.move_fp(ta, tp.fingerprint(ta), nb_t.moves, torch.from_numpy(idx)), np.uint32)
    _eq(jfp, tp.fingerprint(ta), np.uint32)


@pytest.mark.parametrize("name", ["31d7e", "365d20e"])
def test_perturb_and_init_match_jax(name):
    jspec, tspec = _specs(name)
    jp, tp = js.make_scheduling_problem(jspec), ts.make_scheduling_problem(tspec)
    p = 6
    rng = np.random.default_rng(5)
    assign = _assignments(rng, p, jspec)
    is_elite = rng.random(p) < 0.5
    keys = jax.random.split(jax.random.key(9), p)
    want = jax.jit(jax.vmap(jp.perturb))(jnp.asarray(assign), jnp.asarray(is_elite), keys)
    draws = JaxKeyDraws(keys)
    draws._perturb_key = keys
    got = tp.perturb(torch.from_numpy(assign).long(), torch.from_numpy(is_elite), draws)
    _eq(want, got, np.int32)
    assert (got != torch.from_numpy(assign)).any()
    draws._perm_key = keys
    _eq(jax.vmap(jp.init)(keys), tp.init(draws), np.int32)
