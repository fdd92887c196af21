"""The PyTorch port's engine (``core/history.py``, ``core/local_search.py``,
``core/ils.py``) against the JAX package.

Inputs come from ``numpy.random.default_rng(seed)``; random draws come from the
same JAX keys on both sides (``tests/jax_key_draws.py``), lane by lane, so the
port's batched engine is compared with the JAX engine ``vmap``ped over lanes.
Equality is bitwise: every score and counter is an integer held in float32 and
every fingerprint a uint32."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from constraint_solver_tpu.core import history as jh
from constraint_solver_tpu.core.ils import IlsState as JIlsState
from constraint_solver_tpu.core.ils import Solver as JSolver
from constraint_solver_tpu.core.ils import SolverConfig as JConfig
from constraint_solver_tpu.core.ils import ils_init as j_ils_init
from constraint_solver_tpu.core.ils import ils_round as j_ils_round
from constraint_solver_tpu.core.local_search import ls_execute as j_ls_execute
from constraint_solver_tpu.models.nqueens import build_state as j_build_state
from constraint_solver_tpu.models.nqueens import make_nqueens_problem as j_make
from constraint_solver_tpu.utils.seeding import seed_string_to_key
from constraint_solver_tpu_torch.core import history as th
from constraint_solver_tpu_torch.core.ils import Solver, SolverConfig, ils_init, ils_round
from constraint_solver_tpu_torch.core.local_search import ls_execute
from constraint_solver_tpu_torch.models.nqueens import make_nqueens_problem
from constraint_solver_tpu_torch.utils.convert import from_reference, to_reference
from jax_key_draws import JaxKeyDraws, reference_log_weights


def assert_tree_equal(want, got, path="state"):
    """Every leaf of the JAX tree ``want`` equals the port's (converted) tree."""
    if hasattr(got, "_fields"):
        for f in got._fields:
            assert_tree_equal(getattr(want, f), getattr(got, f), f"{path}.{f}")
        return
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=path)


def _u32(x):
    return jnp.asarray(np.asarray(x, np.uint32))


def _fps(rng, p, k):
    return rng.integers(0, 4, size=(p, k, 2)).astype(np.uint32)  # few values: many duplicates


@pytest.mark.parametrize("capacity, expiry", [(4, 100), (8, 2), (3, 10_000)])
def test_tabu_ring_matches_jax(capacity, expiry):
    """Pushes with duplicates (refresh in place), wrap-around and age expiry."""
    p = 5
    rng = np.random.default_rng(capacity)
    jring = jax.vmap(lambda _: jh.TabuRing.create(capacity, expiry))(jnp.arange(p))
    tring = th.TabuRing.create(p, capacity, expiry, "cpu")
    probe = _fps(rng, p, 6)
    for fp in _fps(rng, p, 12).transpose(1, 0, 2):
        jring = jax.vmap(jh.TabuRing.push)(jring, _u32(fp))
        tring = tring.push(torch.from_numpy(fp.astype(np.int64)))
        assert_tree_equal(jring, to_reference(tring))
        want = jax.vmap(jh.TabuRing.is_tabu)(jring, _u32(probe))
        np.testing.assert_array_equal(tring.is_tabu(torch.from_numpy(probe.astype(np.int64))).numpy(), np.asarray(want))


def test_tabu_ring_membership_and_expiry():
    ring = th.TabuRing.create(1, 4, expiry=100, device="cpu")
    fp_a = torch.tensor([[1, 2]])
    ring = ring.push(fp_a)
    assert bool(ring.is_tabu(fp_a[:, None])[0, 0])
    assert not bool(ring.is_tabu(torch.tensor([[[3, 4]]]))[0, 0])
    for i in range(4):
        ring = ring.push(torch.tensor([[10 + i, 20 + i]]))
    assert not bool(ring.is_tabu(fp_a[:, None])[0, 0])


@pytest.mark.parametrize("capacity", [2, 4])
def test_elite_archive_matches_jax(capacity):
    """Inserts with ties, duplicates, a full archive and rejections; best,
    membership and slot reads."""
    p, n = 4, 3
    rng = np.random.default_rng(capacity)
    example = jnp.zeros((p, n), jnp.int32)
    jarch = jax.vmap(lambda s: jh.EliteArchive.create(capacity, s))(example)
    tarch = th.EliteArchive.create(capacity, torch.zeros((p, n), dtype=torch.int64))
    for _ in range(10):
        hard = rng.integers(0, 4, size=p).astype(np.float32)
        soft = rng.integers(0, 2, size=p).astype(np.float32)
        score = np.stack([hard, soft], -1)
        fp = rng.integers(0, 3, size=(p, 2)).astype(np.uint32)
        state = rng.integers(0, 9, size=(p, n)).astype(np.int32)
        jarch = jax.vmap(jh.EliteArchive.insert)(jarch, jnp.asarray(score), _u32(fp), jnp.asarray(state))
        tarch = tarch.insert(
            torch.from_numpy(score), torch.from_numpy(fp.astype(np.int64)), torch.from_numpy(state.astype(np.int64))
        )
        got = to_reference(tarch)
        for f in ("scores", "fps", "valid"):
            np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(jarch, f)))
        np.testing.assert_array_equal(got.states.astype(np.int32), np.asarray(jarch.states))
        jb = jax.vmap(jh.EliteArchive.get_best)(jarch)
        tb = tarch.get_best()
        np.testing.assert_array_equal(tb[0].numpy(), np.asarray(jb[0]))
        np.testing.assert_array_equal(tb[1].numpy().astype(np.uint32), np.asarray(jb[1]))
        np.testing.assert_array_equal(tb[2].numpy(), np.asarray(jb[2]))
        probe = rng.integers(0, 3, size=(p, 2)).astype(np.uint32)
        np.testing.assert_array_equal(
            tarch.contains_fp(torch.from_numpy(probe.astype(np.int64))).numpy(),
            np.asarray(jax.vmap(jh.EliteArchive.contains_fp)(jarch, _u32(probe))),
        )


def test_elite_archive_insert_best_worst():
    arch = th.EliteArchive.create(2, torch.zeros((1, 3), dtype=torch.int64))

    def mk(h, v):
        return torch.tensor([[float(h), 0.0]]), torch.tensor([[h, h]]), torch.full((1, 3), v)

    arch = arch.insert(*mk(5, 1))
    arch = arch.insert(*mk(3, 2))
    arch = arch.insert(*mk(4, 3))  # full: replaces the worst (5)
    score, _, best = arch.get_best()
    assert float(score[0, 0]) == 3 and int(best[0, 0]) == 2
    arch = arch.insert(*mk(9, 4))  # worse than the worst: rejected
    assert sorted(arch.scores[arch.valid][:, 0].tolist()) == [3.0, 4.0]
    arch2 = arch.insert(*mk(3, 9))  # duplicate fingerprint: dropped
    assert torch.equal(arch2.scores, arch.scores)


def _config(**kw):
    base = dict(
        seed="5", local_search_max_iterations=12, best_solutions_capacity=3,
        all_solutions_capacity=16, all_solution_iteration_expiry=30, restart_every=3,
    )
    base.update(kw)
    return base


@pytest.mark.parametrize("exact", [None, False])
@pytest.mark.parametrize("n", [8, 20])
def test_ls_execute_matches_jax(n, exact):
    """One descent per lane from random boards, one lane disabled, in both
    tabu modes (the exact filter at these widths, and pick-then-check)."""
    p = 5
    rng = np.random.default_rng(n)
    kw = _config(tabu_exact_filter=exact)
    jp, tp = j_make(n), make_nqueens_problem(n, log_weights=reference_log_weights(n))
    jparams = JConfig(**kw).ls_params(jp.width)
    tparams = SolverConfig(**kw).ls_params(tp.width)
    assert jparams.tabu_exact_filter == tparams.tabu_exact_filter == (exact is None)
    boards = jnp.asarray(rng.integers(0, n, size=(p, n)), jnp.int32)
    jstart = jax.vmap(j_build_state)(boards)
    descend = jax.jit(jax.vmap(lambda s, t, k, e: j_ls_execute(jp, jparams, s, t, k, e)))
    # A first descent fills the ring with the states around the start, so the
    # compared second descent from the same start meets tabu candidates.
    jring = jax.vmap(lambda _: jh.TabuRing.create(16, 30))(jnp.arange(p))
    jring = descend(jstart, jring, jax.random.split(jax.random.key(-n), p), jnp.ones(p, bool))[2]
    keys = jax.random.split(jax.random.key(n), p)
    enabled = np.array([True, True, False, True, True])
    want = descend(jstart, jring, keys, jnp.asarray(enabled))
    draws = JaxKeyDraws(keys)
    draws._ls_key = keys
    got = ls_execute(
        tp, tparams, from_reference(jstart, "cpu"), from_reference(jring, "cpu"), draws,
        torch.from_numpy(enabled),
    )
    assert_tree_equal(want[0], to_reference(got[0]), "best_state")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert_tree_equal(want[2], to_reference(got[2]), "tabu")
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert int(got[3][2]) == 0 and int(got[3].max()) > 1


@functools.lru_cache(maxsize=None)
def _jax_round(n):
    """The JAX round over lanes, with the round number as a traced scalar (one
    compile for every round number)."""
    jp, cfg = j_make(n), JConfig(**_config())
    return jax.jit(
        jax.vmap(
            lambda s, r: j_ils_round(jp, cfg.ls_params(jp.width), cfg.ils_params(), s, round_scalar=r),
            in_axes=(0, None),
        )
    )


@pytest.mark.parametrize("round_no", [1, 3])
def test_ils_round_matches_jax(round_no):
    """One ILS round on every lane, on a plain round and on a restart round,
    with lanes in each acceptance mode."""
    n, p = 12, 4
    kw = _config()
    jp, tp = j_make(n), make_nqueens_problem(n, log_weights=reference_log_weights(n))
    jcfg, tcfg = JConfig(**kw), SolverConfig(**kw)
    keys = jax.random.split(jax.random.key(round_no), p)
    jst = jax.jit(jax.vmap(lambda k: j_ils_init(jp, jcfg, k)))(keys)
    draws = JaxKeyDraws(keys)
    tst = from_reference(jst, "cpu")
    assert_tree_equal(jst, to_reference(tst))
    # Lanes of every acceptance mode: reference 1:5:1, greedy, and SA.
    temps = np.asarray([-1.0, 0.0, 0.5, 4.0], np.float32)
    jst = jst._replace(round=jst.round + (round_no - 1), accept_temp=jnp.asarray(temps))
    tst = tst._replace(round=tst.round + (round_no - 1), accept_temp=torch.from_numpy(temps))
    want = _jax_round(n)(jst, jnp.int32(round_no))
    got = ils_round(tp, tcfg.ls_params(tp.width), tcfg.ils_params(), tst, draws, round_no)
    assert_tree_equal(want, to_reference(got))


def test_ils_init_matches_jax():
    n, p = 9, 3
    jp, tp = j_make(n), make_nqueens_problem(n)
    keys = jax.random.split(jax.random.key(0), p)
    jst = jax.jit(jax.vmap(lambda k, t: j_ils_init(jp, JConfig(**_config()), k, accept_temp=t)))(
        keys, jnp.asarray([-1.0, 0.0, 2.0])
    )
    got = ils_init(tp, SolverConfig(**_config()), JaxKeyDraws(keys), torch.tensor([-1.0, 0.0, 2.0]))
    assert_tree_equal(jst, to_reference(got))
    assert isinstance(jst, JIlsState)


def test_solver_matches_jax_solver():
    """The single-lane driver, round by round, through a restart."""
    n = 10
    kw = _config(seed="single")
    jsolver = JSolver(j_make(n), JConfig(**kw))
    tsolver = Solver(
        make_nqueens_problem(n, log_weights=reference_log_weights(n)), SolverConfig(**kw),
        draws=JaxKeyDraws(seed_string_to_key("single")[None]),
    )
    def with_lane_axis(st):  # the JAX Solver's state has none
        return jax.tree.map(lambda x: x[None], st)

    assert_tree_equal(with_lane_axis(jsolver.state), to_reference(tsolver.state))
    for _ in range(4):
        jsolver.execute_round()
        tsolver.execute_round()
        assert_tree_equal(with_lane_axis(jsolver.state), to_reference(tsolver.state))
    assert tsolver.get_iteration_info() == jsolver.get_iteration_info()
    assert tsolver.get_best_score() == jsolver.get_best_score()
    (score, state), (jscore, jstate) = tsolver.get_best_solution(), jsolver.get_best_solution()
    assert score == jscore
    np.testing.assert_array_equal(state.rows, jstate.rows)
    assert tsolver.stats() == jsolver.stats()


def test_solver_solves_nqueens_8_with_torch_draws():
    solver = Solver(make_nqueens_problem(8), SolverConfig(seed="42", local_search_max_iterations=50))
    solver.run(chunk=4)
    (hard, soft), state = solver.get_best_solution()
    assert (hard, soft) == (0.0, 0.0)
    rows = state.rows
    assert len(set(rows.tolist())) == 8
    assert len({r - c for c, r in enumerate(rows)}) == 8 and len({r + c for c, r in enumerate(rows)}) == 8
    assert not solver.is_finished()
    stats = solver.stats()
    assert stats["ls_iterations"] > 0 and stats["moves_per_sec"] > 0
    solver.cancel()
    before = solver.get_iteration_info()["current"]
    solver.run()
    assert solver.get_iteration_info()["current"] == before
