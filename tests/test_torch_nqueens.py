"""The PyTorch port's N-Queens model and its neighborhood-scoring kernel against
the JAX package.

Inputs come from ``numpy.random.default_rng(seed)`` and, where a function draws
random numbers, from the same JAX keys on both sides (``tests/jax_key_draws.py``).
Equality is bitwise: every score and counter is an integer held in float32,
boards are integers and fingerprints uint32.

The kernel's plain version (``nqueens_neighborhood_scores_ref``) is held against
the Pallas kernel in interpret mode, as ``tests/test_pallas_kernels.py`` runs it,
and at n=14000, where interpret mode is too slow, against the JAX package's
non-Pallas block.  The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from constraint_solver_tpu.models import nqueens as jnq
from constraint_solver_tpu.ops.nqueens_pallas import nqueens_neighborhood_scores as pallas_scores
from constraint_solver_tpu_torch.models import nqueens as tnq
from constraint_solver_tpu_torch.ops import nqueens_kernel as tk
from constraint_solver_tpu_torch.utils.convert import from_reference, to_reference
from jax_key_draws import JaxKeyDraws, reference_log_weights


def _boards(rng, p, n, permutation=False):
    if permutation:
        return np.stack([rng.permutation(n) for _ in range(p)]).astype(np.int32)
    return rng.integers(0, n, size=(p, n)).astype(np.int32)


def _kernel_inputs(rng, p, n, a):
    """Counters of random boards, A distinct columns per lane, their rows,
    removed terms and current totals, as torch tensors."""
    st = tnq.build_state(torch.from_numpy(_boards(rng, p, n)))
    c = torch.from_numpy(np.stack([rng.choice(n, size=a, replace=False) for _ in range(p)]))
    r = st.rows.gather(1, c)
    removed = (st.rc.gather(1, r) - 1) + (st.dc.gather(1, r - c + n - 1) - 1) + (st.ac.gather(1, r + c) - 1)
    cur = tnq.total_conflicts(st.rows).to(torch.float32)
    return st, c.to(torch.int32), r.to(torch.int32), removed, cur


def _assert_equal(want, got):
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("a", [1, 3, 5])
@pytest.mark.parametrize("n", [8, 16, 33, 128])
def test_plain_kernel_matches_pallas_interpret(n, a):
    rng = np.random.default_rng(n * 10 + a)
    st, c, r, removed, cur = _kernel_inputs(rng, 3, n, a)
    scores, row_min, row_arg = tk.nqueens_neighborhood_scores_ref(st.rc, st.dc, st.ac, c, r, removed, cur)
    for p in range(3):
        want = pallas_scores(
            jnp.asarray(st.rows[p].numpy(), jnp.int32), jnp.asarray(st.rc[p].numpy()),
            jnp.asarray(st.dc[p].numpy()), jnp.asarray(st.ac[p].numpy()),
            jnp.asarray(c[p].numpy()), jnp.asarray(r[p].numpy()),
            jnp.asarray(removed[p].numpy()), jnp.float32(cur[p]), interpret=True,
        )
        for w, g in zip(want, (scores[p], row_min[p], row_arg[p])):
            _assert_equal(w, g.numpy())


def test_plain_kernel_matches_jax_block_at_n14000():
    """n past the TPU kernel's int32 key-packing bound: the JAX package's
    non-Pallas block (XLA) is the reference."""
    n, a = 14000, 3
    rng = np.random.default_rng(14)
    st = tnq.build_state(torch.from_numpy(_boards(rng, 1, n)))
    jst = jnq.NQState(*(jnp.asarray(x[0].numpy().astype(np.int32 if x.dtype == torch.int64 else np.float32)) for x in st))
    problem = jnq.make_nqueens_problem(n, sample_cols=a)
    cur = problem.score(jst)
    nb = problem.neighborhood(jst, cur, jax.random.key(3))
    c = torch.from_numpy(np.asarray(nb.moves[0]).reshape(a, n)[:, 0].astype(np.int64))[None]
    r = st.rows.gather(1, c)
    removed = (st.rc.gather(1, r) - 1) + (st.dc.gather(1, r - c + n - 1) - 1) + (st.ac.gather(1, r + c) - 1)
    scores, row_min, row_arg = tk.nqueens_neighborhood_scores_ref(
        st.rc, st.dc, st.ac, c.int(), r.int(), removed, torch.tensor([float(cur[0])])
    )
    want = np.asarray(nb.scores)[:, 0].reshape(a, n)
    _assert_equal(want, scores[0].numpy())
    _assert_equal(want.min(axis=1), row_min[0].numpy())
    _assert_equal(want.argmin(axis=1).astype(np.int32), row_arg[0].numpy())


def test_wrapper_takes_plain_version_on_cpu_and_checks_inputs():
    rng = np.random.default_rng(0)
    st, c, r, removed, cur = _kernel_inputs(rng, 2, 12, 3)
    args = (st.rc, st.dc, st.ac, c, r, removed, cur)
    before = tk.nqueens_neighborhood_scores.launches
    for w, g in zip(tk.nqueens_neighborhood_scores_ref(*args), tk.nqueens_neighborhood_scores(*args)):
        assert torch.equal(w, g)
    assert tk.nqueens_neighborhood_scores.launches == before  # no kernel on the CPU
    with pytest.raises(TypeError):
        tk.nqueens_neighborhood_scores(st.rc, st.dc, st.ac, c.long(), r, removed, cur)
    with pytest.raises(ValueError):
        tk.nqueens_neighborhood_scores(st.rc, st.dc[:, :-1], st.ac, c, r, removed, cur)
    with pytest.raises(ValueError):
        tk.nqueens_neighborhood_scores(st.rc, st.dc, st.ac, c.t().contiguous().t(), r, removed, cur)
    meta = [x.to("meta") for x in args]
    with pytest.raises(ValueError, match="no kernel"):
        tk.nqueens_neighborhood_scores(*meta)


def _jax_state(boards):
    return jax.vmap(jnq.build_state)(jnp.asarray(boards))


@pytest.mark.parametrize("n", [1, 5, 8, 31])
def test_counters_and_scores_match_jax(n):
    rng = np.random.default_rng(n)
    boards = np.concatenate([_boards(rng, 3, n), _boards(rng, 2, n, permutation=True)])
    t = torch.from_numpy(boards)
    for want, got in zip(jax.vmap(jnq.line_counts)(jnp.asarray(boards)), tnq.line_counts(t)):
        _assert_equal(want, got.numpy())
    _assert_equal(jax.vmap(jnq.total_conflicts)(jnp.asarray(boards)), tnq.total_conflicts(t).numpy())
    _assert_equal(jax.vmap(jnq.col_scores)(jnp.asarray(boards)), tnq.col_scores(t).numpy())
    want = _jax_state(boards)
    got = to_reference(tnq.build_state(t))
    for f in want._fields:
        _assert_equal(getattr(want, f), getattr(got, f))
    jp, tp = jnq.make_nqueens_problem(n), tnq.make_nqueens_problem(n)
    ts = tnq.build_state(t)
    _assert_equal(jax.vmap(jp.score)(want), tp.score(ts).numpy())
    _assert_equal(jax.vmap(jp.fingerprint)(want), tp.fingerprint(ts).numpy().astype(np.uint32))


def _near_solved(rng, p, n):
    """Solved boards (the even-n construction, valid for n % 6 in {0, 4}) with
    one queen moved: only a few conflicted columns."""
    assert n % 6 in (0, 4)
    sol = [2 * i + 1 for i in range(n // 2)] + [2 * i for i in range(n // 2)]
    assert int(jnq.total_conflicts(jnp.asarray(sol, jnp.int32))) == 0
    boards = np.tile(np.asarray(sol, np.int32), (p, 1))
    for b in boards:
        b[rng.integers(0, n)] = rng.integers(0, n)
    return boards


@pytest.mark.parametrize(
    "n, a, kind", [(10, None, "random"), (24, 4, "random"), (24, 4, "perm"), (12, 6, "near")]
)
def test_neighborhood_matches_jax(n, a, kind):
    rng = np.random.default_rng(n + (a or 0))
    p = 5
    if kind == "near":
        boards = _near_solved(rng, p, n)
    else:
        boards = _boards(rng, p, n, permutation=kind == "perm")
    jp = jnq.make_nqueens_problem(n, sample_cols=a)
    tp = tnq.make_nqueens_problem(n, sample_cols=a, log_weights=reference_log_weights(n))
    jst = _jax_state(boards)
    keys = jax.random.split(jax.random.key(n), p)
    k_nb = jax.vmap(jax.random.split)(keys)[:, 1]  # the descent's split
    nb_j = jax.jit(jax.vmap(jp.neighborhood))(jst, jax.vmap(jp.score)(jst), k_nb)

    draws = JaxKeyDraws(keys)
    draws._ls_key = keys
    tst = from_reference(jst, "cpu")
    nb_t = tp.neighborhood(tst, tp.score(tst), draws, torch.ones(p, dtype=torch.bool))
    _assert_equal(nb_j.scores, nb_t.scores.numpy())
    _assert_equal(nb_j.valid, nb_t.valid.numpy())
    _assert_equal(nb_j.hint_idx, nb_t.hint_idx.numpy().astype(np.int32))
    _assert_equal(nb_j.n_valid, nb_t.n_valid.numpy().astype(np.int32))
    idx = torch.arange(nb_t.valid.shape[1]).expand(p, -1)
    cols = nb_t.moves.cols.gather(1, idx // n)
    _assert_equal(nb_j.moves[0], cols.numpy().astype(np.int32))
    _assert_equal(nb_j.moves[1], (idx % n).numpy().astype(np.int32))
    if kind == "near":
        assert ((tst.cs > 0).sum(dim=-1) < a).any()  # A exceeds the conflicted columns


def test_move_fp_and_apply_move_match_jax_and_rebuild():
    n, p = 16, 6
    rng = np.random.default_rng(3)
    boards = _boards(rng, p, n)
    jp = jnq.make_nqueens_problem(n, sample_cols=3)
    tp = tnq.make_nqueens_problem(n, sample_cols=3, log_weights=reference_log_weights(n))
    jst = _jax_state(boards)
    keys = jax.random.split(jax.random.key(1), p)
    nb_j = jax.jit(jax.vmap(jp.neighborhood))(jst, jax.vmap(jp.score)(jst), jax.vmap(jax.random.split)(keys)[:, 1])
    draws = JaxKeyDraws(keys)
    draws._ls_key = keys
    tst = from_reference(jst, "cpu")
    nb_t = tp.neighborhood(tst, tp.score(tst), draws, torch.ones(p, dtype=torch.bool))
    idx = rng.integers(0, 3 * n, size=p)
    fp_j = jax.vmap(jp.fingerprint)(jst)
    want_fp = jax.jit(jax.vmap(jp.move_fp))(jst, fp_j, nb_j.moves, jnp.asarray(idx, jnp.int32))
    got_fp = tp.move_fp(tst, tp.fingerprint(tst), nb_t.moves, torch.from_numpy(idx))
    _assert_equal(want_fp, got_fp.numpy().astype(np.uint32))
    # [P, W] candidates at once (the exact filter's form).
    all_idx = torch.arange(3 * n).expand(p, -1)
    got_all = tp.move_fp(tst, tp.fingerprint(tst), nb_t.moves, all_idx)
    want_all = jax.vmap(
        lambda s, f, m: jax.vmap(lambda i: jp.move_fp(s, f, m, i))(jnp.arange(3 * n))
    )(jst, fp_j, nb_j.moves)
    _assert_equal(want_all, got_all.numpy().astype(np.uint32))

    want = jax.jit(jax.vmap(jp.apply_move))(jst, nb_j.moves, jnp.asarray(idx, jnp.int32))
    got = tp.apply_move(tst, nb_t.moves, torch.from_numpy(idx))
    ref = to_reference(got)
    rebuilt = to_reference(tnq.build_state(got.rows))
    for f in want._fields:
        _assert_equal(getattr(want, f), getattr(ref, f))
        _assert_equal(getattr(rebuilt, f), getattr(ref, f))
    assert torch.equal(tp.fingerprint(got), got_fp)


@pytest.mark.parametrize("n", [8, 40])
def test_perturb_and_init_match_jax(n):
    p = 6
    rng = np.random.default_rng(n)
    jp = jnq.make_nqueens_problem(n)
    tp = tnq.make_nqueens_problem(n)
    jst = _jax_state(_boards(rng, p, n))
    is_elite = rng.random(p) < 0.5
    keys = jax.random.split(jax.random.key(n), p)
    want = jax.jit(jax.vmap(jp.perturb))(jst, jnp.asarray(is_elite), keys)
    draws = JaxKeyDraws(keys)
    draws._perturb_key = keys
    got = to_reference(tp.perturb(from_reference(jst, "cpu"), torch.from_numpy(is_elite), draws))
    for f in want._fields:
        _assert_equal(getattr(want, f), getattr(got, f))
    want_init = jax.jit(jax.vmap(jp.init))(keys)
    draws._perm_key = keys
    got_init = to_reference(tp.init(draws))
    for f in want_init._fields:
        _assert_equal(getattr(want_init, f), getattr(got_init, f))
