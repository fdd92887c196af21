"""The PyTorch port's seeding, draws, ``ops/lex.py`` and ``ops/fingerprint.py``
against the JAX package.

Inputs come from ``numpy.random.default_rng(seed)`` and go through the JAX function
(on the CPU) and its port.  Equality is bitwise: every score is an integer held in
float32 and every fingerprint a uint32 (the port holds it in int64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from constraint_solver_tpu.ops import fingerprint as jfp
from constraint_solver_tpu.ops import lex as jlex
from constraint_solver_tpu.utils.seeding import hash_str as jhash_str
from constraint_solver_tpu.utils.seeding import seed_string_to_key
from constraint_solver_tpu_torch.ops import fingerprint as tfp
from constraint_solver_tpu_torch.ops import lex as tlex
from constraint_solver_tpu_torch.utils.draws import TorchDraws
from constraint_solver_tpu_torch.utils.seeding import hash_str, seed_string_to_int


def _eq(jax_out, torch_out, dtype=None):
    want = np.asarray(jax_out)
    got = torch_out.numpy()
    if dtype is not None:
        got = got.astype(dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", ["42", "bench", "", "ünïcode seed"])
def test_seed_matches_jax_key(seed):
    assert hash_str(seed) == jhash_str(seed)
    # The JAX package hands the same integer to jax.random.key (which keeps its
    # low 32 bits while 64-bit mode is off).
    want = np.asarray(jax.random.key_data(seed_string_to_key(seed)))
    got = np.asarray(jax.random.key_data(jax.random.key(seed_string_to_int(seed))))
    np.testing.assert_array_equal(got, want)
    assert want[1] == seed_string_to_int(seed) & 0xFFFFFFFF


def _scores(rng, shape, hi=4):
    """Small-integer (hard, soft) scores: many ties."""
    return rng.integers(0, hi, size=shape + (2,)).astype(np.float32)


def test_lex_less_leq_make_score():
    rng = np.random.default_rng(0)
    a, b = _scores(rng, (64,), 3), _scores(rng, (64,), 3)
    _eq(jlex.lex_less(a, b), tlex.lex_less(torch.from_numpy(a), torch.from_numpy(b)))
    _eq(jlex.lex_leq(a, b), tlex.lex_leq(torch.from_numpy(a), torch.from_numpy(b)))
    hard = rng.integers(0, 9, 7).astype(np.float32)
    _eq(jlex.make_score(hard), tlex.make_score(torch.from_numpy(hard)))
    _eq(jlex.make_score(3.0, 2.0), tlex.make_score(3.0, 2.0))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fn", ["lex_argmin", "lex_argmax", "lex_min"])
def test_lex_reductions_with_ties_and_masks(fn, masked):
    rng = np.random.default_rng(1)
    scores = _scores(rng, (6, 17))
    valid = rng.random((6, 17)) < 0.5
    valid[0] = False  # an all-invalid row: both sides fall back to the same index
    args_j = (jnp.asarray(scores),) + ((jnp.asarray(valid),) if masked else ())
    args_t = (torch.from_numpy(scores),) + ((torch.from_numpy(valid),) if masked else ())
    want = jax.vmap(getattr(jlex, fn))(*args_j)
    _eq(want, getattr(tlex, fn)(*args_t), np.asarray(want).dtype)


def test_lex_argmin_matches_python_sort():
    rng = np.random.default_rng(2)
    scores = _scores(rng, (20, 17), 5)
    got = tlex.lex_argmin(torch.from_numpy(scores)).numpy()
    for p in range(20):
        assert got[p] == min(range(17), key=lambda i: (scores[p, i, 0], scores[p, i, 1], i))


@pytest.mark.parametrize("k", [1, 5, 32])
def test_lex_top_k_with_payload(k):
    rng = np.random.default_rng(3)
    scores = _scores(rng, (32,), 3)  # heavy ties: the order of equal scores is tested
    payload = rng.integers(0, 1000, size=(32, 3)).astype(np.int32)
    want = jlex.lex_top_k(jnp.asarray(scores), k, jnp.asarray(payload))
    got = tlex.lex_top_k(torch.from_numpy(scores), k, torch.from_numpy(payload))
    for w, g in zip(want, got):
        _eq(w, g)


def test_mix32_and_position_hash():
    rng = np.random.default_rng(4)
    h = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    _eq(jfp._mix32(jnp.asarray(h)), tfp._mix32(torch.from_numpy(h.astype(np.int64))), np.uint32)
    idx = rng.integers(0, 5000, size=(8, 33)).astype(np.int32)
    val = rng.integers(0, 2**32, size=(8, 33), dtype=np.uint64).astype(np.uint32)
    _eq(
        jfp.position_hash(jnp.asarray(idx), jnp.asarray(val)),
        tfp.position_hash(torch.from_numpy(idx), torch.from_numpy(val.astype(np.int64))),
        np.uint32,
    )


@pytest.mark.parametrize("n", [1, 2, 7, 64, 1000])
def test_fingerprint_matches_jax(n):
    rng = np.random.default_rng(5)
    boards = rng.integers(0, max(n, 2), size=(5, n)).astype(np.int32)
    _eq(jax.vmap(jfp.fingerprint_i32)(jnp.asarray(boards)), tfp.fingerprint_i32(torch.from_numpy(boards)), np.uint32)


def test_fp_update_matches_jax_and_full_rehash():
    rng = np.random.default_rng(6)
    values = rng.integers(0, 100, size=(4, 64)).astype(np.int32)
    fp = tfp.fingerprint_i32(torch.from_numpy(values))
    idx = rng.integers(0, 64, size=4)
    new = rng.integers(0, 1000, size=4).astype(np.int32)
    old = values[np.arange(4), idx]
    got = tfp.fp_update(fp, torch.from_numpy(idx), torch.from_numpy(old), torch.from_numpy(new))
    want = jfp.fp_update(
        jnp.asarray(np.asarray(fp).astype(np.uint32)), jnp.asarray(idx, jnp.int32),
        jnp.asarray(old).astype(jnp.uint32), jnp.asarray(new).astype(jnp.uint32),
    )
    _eq(want, got, np.uint32)
    values[np.arange(4), idx] = new
    np.testing.assert_array_equal(got.numpy(), tfp.fingerprint_i32(torch.from_numpy(values)).numpy())


def test_xor_reduce_matches_jax_on_odd_lengths():
    rng = np.random.default_rng(7)
    for n in (3, 5, 9, 127):
        x = rng.integers(0, 2**32, size=(2, n, 2), dtype=np.uint64).astype(np.uint32)
        _eq(jfp._xor_reduce(jnp.asarray(x)), tfp._xor_reduce(torch.from_numpy(x.astype(np.int64))), np.uint32)


def test_torch_draws_ranges_and_determinism():
    a = TorchDraws("42", 6, "cpu")
    b = TorchDraws("42", 6, "cpu")
    perm = a.permutation(9)
    assert torch.equal(perm, b.permutation(9))
    assert torch.equal(perm.sort(dim=-1).values, torch.arange(9).expand(6, 9))
    hi = torch.tensor([1, 2, 3, 4, 5, 6])
    pd = a.perturb(9, hi, 9)
    assert ((pd.n_alter >= 1) & (pd.n_alter <= hi)).all()
    assert ((pd.new_rows >= 0) & (pd.new_rows < 9)).all() and pd.u.shape == (6, 9)
    gumbel, num = a.neighborhood(9, hi, torch.ones(6, dtype=torch.bool))
    assert gumbel.dtype == torch.float32 and torch.isfinite(gumbel).all()
    assert ((num >= 1) & (num <= hi)).all()
    valid = torch.zeros((6, 4), dtype=torch.bool)
    valid[:, 2] = True
    acc = a.accept(valid, (1.0, 5.0, 1.0))
    assert (acc.elite_idx == 2).all() and ((acc.choice >= 0) & (acc.choice <= 2)).all()


def test_torch_draws_accept_weights():
    draws = TorchDraws("7", 20000, "cpu")
    choice = draws.accept(torch.ones((20000, 2), dtype=torch.bool), (1.0, 5.0, 1.0)).choice
    freq = torch.bincount(choice, minlength=3).double() / 20000
    # 1:5:1 within 5 standard deviations of a binomial at p = 5/7.
    assert abs(float(freq[1]) - 5 / 7) < 5 * (5 / 7 * 2 / 7 / 20000) ** 0.5
    assert abs(float(freq[0]) - float(freq[2])) < 0.02


def test_torch_draws_host_generator_is_device_independent():
    """Draws made on the CPU generator are the same whatever device receives them."""
    a = TorchDraws("x", 3, "cpu", draw_device="cpu")
    b = TorchDraws("x", 3, "cpu")
    assert torch.equal(a.permutation(5), b.permutation(5))


@pytest.mark.parametrize("k, temp", [(1, 1.0), (4, 0.5), (8, 1e-12), (40, 2.0)])
def test_noisy_lex_select_matches_jax(k, temp):
    """Heavy ties, ties at the k-th value, masked rows and an all-invalid row,
    the same Gumbel noise on both sides."""
    rng = np.random.default_rng(k)
    p, w = 7, 33
    scores = _scores(rng, (p, w), 3)
    valid = rng.random((p, w)) < 0.7
    valid[0] = False
    keys = jax.random.split(jax.random.key(k), p)
    want = jax.vmap(lambda s, v, key: jlex.noisy_lex_select(s, v, k, temp, key))(
        jnp.asarray(scores), jnp.asarray(valid), keys
    )
    noise = jax.vmap(lambda key: jax.random.gumbel(key, (w,)))(keys)
    got = tlex.noisy_lex_select(
        torch.from_numpy(scores), torch.from_numpy(valid), k, temp, torch.from_numpy(np.array(noise))
    )
    _eq(want, got, np.int32)


def test_noisy_lex_select_keeps_every_tie_at_the_kth_value():
    # k = 2: one best, then four candidates tied at the 2nd value; the last of
    # them carries the largest noise and must win at a high temperature.
    scores = torch.tensor([[[0.0, 1.0], [0.0, 3.0], [0.0, 3.0], [0.0, 3.0], [0.0, 3.0], [1.0, 0.0]]])
    valid = torch.ones((1, 6), dtype=torch.bool)
    noise = torch.tensor([[0.0, 0.0, 0.0, 0.0, 50.0, 100.0]])
    assert int(tlex.noisy_lex_select(scores, valid, 2, 1e6, noise)) == 4
    valid[0, 4] = False
    assert int(tlex.noisy_lex_select(scores, valid, 2, 1e6, noise)) in (0, 1, 2, 3)


def test_torch_draws_scheduling_and_pmc_methods():
    draws = TorchDraws("s", 5, "cpu")
    active = torch.ones(5, dtype=torch.bool)
    assign = draws.assignment(31, 7)
    assert assign.shape == (5, 31) and int(assign.min()) >= 0 and int(assign.max()) < 7
    pd = draws.perturb(31, torch.full((5,), 15), 7)
    assert int(pd.new_rows.max()) < 7 and pd.u.shape == (5, 31)
    rm = draws.random_moves(100, 31, 7, active)
    assert rm.u_type.shape == (5, 100) and int(rm.off.min()) >= 1 and int(rm.off.max()) < 31
    assert int(rm.d1.max()) < 31 and int(rm.new_emp.max()) < 7
    ds = draws.dense_swaps(16, 4, 31, active)
    assert ds.rs_d1.shape == (5, 16) and int(ds.delta.min()) >= 14 and int(ds.delta.max()) < 31
    assert draws.dense_swaps(0, 0, 1, active).delta.shape == (5, 0)
    assert torch.isfinite(draws.select_noise(9, active)).all()
    conflicted = torch.zeros((5, 12), dtype=torch.bool)
    conflicted[:, 3] = conflicted[:, 7] = True
    pm = draws.pmc_step(12, 12, conflicted, active, sampled=True)
    assert set(pm.kick_col.tolist()) <= {3, 7} and pm.u.shape == (5, 12) and pm.gumbel.shape == (5, 12)
    assert int(pm.kick_row.max()) < 12 and draws.pmc_step(12, 4, conflicted, active, False).gumbel is None


def test_torch_draws_continuous_domain_and_checkpoint_methods():
    draws = TorchDraws("c", 6, "cpu")
    active = torch.ones(6, dtype=torch.bool)
    u = draws.uniform((5,), -32.768, 32.768)
    assert u.shape == (6, 5) and u.dtype == torch.float32 and float(u.abs().max()) <= 32.768
    step = draws.step(1e-3, 0.5, active)
    assert step.shape == (6,) and float(step.min()) >= 1e-3 and float(step.max()) < 0.5
    draws.advance(active)
    pn = draws.perturb_normal(5)
    assert int(pn.n_alter.min()) >= 0 and int(pn.n_alter.max()) < 5 and pn.noise.shape == (6, 5)
    hi = torch.tensor([1, 2, 3, 1, 2, 3])
    pc = draws.perturb_cells(7, hi)
    assert ((pc.n_alter >= 1) & (pc.n_alter <= hi)).all() and pc.cells.shape == (6, 7, 2)
    assert float(pc.cells.min()) >= 0.0 and float(pc.cells.max()) < 1.0
    assert draws.perturb(9, hi, None).new_rows is None
    valid = torch.zeros((6, 4), dtype=torch.bool)
    valid[:, 1] = valid[:, 3] = True
    assert set(draws.reseed_pick(valid).tolist()) <= {1, 3}
    saved = draws.state_dict()
    want = draws.uniform((3,), 0.0, 1.0)
    other = TorchDraws("other", 6, "cpu")
    other.load_state_dict({k: v.numpy() for k, v in saved.items()})
    assert torch.equal(other.uniform((3,), 0.0, 1.0), want)


def test_fingerprint_f32_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(-32.768, 32.768, size=(4, 7)).astype(np.float32)
    x[0, :2] = (0.0, -0.0)  # distinct bit patterns, distinct fingerprints
    _eq(jax.vmap(jfp.fingerprint_f32)(jnp.asarray(x)), tfp.fingerprint_f32(torch.from_numpy(x)), np.uint32)
