"""The PyTorch port's QAP domain (dense, compact and incremental proposers)
against the JAX package's ``models/qap.py``.

Every score is an integer below 2^24 held in float32 at these sizes, every
product of the proposers is exact, and every argmin takes the first index, so
the port must equal the JAX package bit for bit: neighborhoods on the same
permutation, perturbations from the same JAX keys, and whole population
trajectories from the same draws (``tests/jax_key_draws.py``)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from constraint_solver_tpu.core.ils import SolverConfig as JConfig
from constraint_solver_tpu.models import qap as jq
from constraint_solver_tpu.ops.lex import lex_argmin as j_lex_argmin
from constraint_solver_tpu.parallel import population as jpop
from constraint_solver_tpu.utils.seeding import seed_string_to_key
from constraint_solver_tpu_torch.core.ils import SolverConfig
from constraint_solver_tpu_torch.models import qap as tq
from constraint_solver_tpu_torch.ops.lex import lex_argmin
from constraint_solver_tpu_torch.parallel import population as tpop
from constraint_solver_tpu_torch.utils.convert import from_reference, to_reference
from constraint_solver_tpu_torch.utils.tree import tree_leaves
from jax_key_draws import JaxKeyDraws
from test_torch_population import assert_tree_equal

MODES = {"dense": {}, "compact": {"compact": True}, "incremental": {"incremental": True}}


def _problems(n, seed, max_val=10, **kw):
    spec = jq.QAPSpec.random(n, seed=seed, max_val=max_val)
    return spec, jq.make_qap_problem(spec, **kw), tq.make_qap_problem(tq.QAPSpec.random(n, seed, max_val), **kw)


def _perms(rng, p, n):
    return np.stack([rng.permutation(n) for _ in range(p)])


def _moves(nb, n):
    """(a, b) of every candidate of a port neighborhood, [P, W] each."""
    idx = torch.arange(nb.valid.shape[1]).expand(nb.valid.shape)
    if nb.moves.partner is None:
        return idx // n, idx % n
    return idx, nb.moves.partner


def _draws(p, seed):
    """A JAX-key draw source inside a round (its descent keys exist)."""
    draws = JaxKeyDraws(jax.random.split(jax.random.key(seed), p))
    draws.round_keys()
    return draws


def _swapped(p, a, b):
    q = p.copy()
    q[a], q[b] = q[b], q[a]
    return q


def test_spec_matches_jax_and_score_matches_naive():
    spec, _, tp = _problems(12, 1)
    tspec = tq.QAPSpec.random(12, seed=1)
    for want, got in zip(spec.arrays(), tspec.arrays()):
        np.testing.assert_array_equal(want, got)
    flow, dist = spec.arrays()
    perms = _perms(np.random.default_rng(2), 5, 12)
    scores = tp.score(torch.from_numpy(perms))
    for p, s in zip(perms, scores):
        assert float(s[0]) == tq.qap_cost_naive(flow, dist, p) and float(s[1]) == 0.0


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
def test_swap_deltas_match_full_rescores(compact):
    spec, _, tp = _problems(10, 3, compact=compact)
    flow, dist = spec.arrays()
    perms = _perms(np.random.default_rng(4), 2, 10)
    p = torch.from_numpy(perms)
    nb = tp.neighborhood(p, tp.score(p), _draws(2, 0), torch.ones(2, dtype=torch.bool))
    a, b = _moves(nb, 10)
    assert (nb.valid.sum(-1) == nb.n_valid).all()
    assert int(nb.n_valid[0]) == (9 if compact else 45)
    for lane in range(2):
        for i in torch.nonzero(nb.valid[lane]).flatten().tolist():
            q = _swapped(perms[lane], int(a[lane, i]), int(b[lane, i]))
            assert float(nb.scores[lane, i, 0]) == tq.qap_cost_naive(flow, dist, q)


@pytest.mark.parametrize("mode", ["dense", "compact"])
def test_neighborhood_bit_equal_to_jax(mode):
    """Scores, validity, candidate count and decoded moves at n=12, and the
    fingerprint and result of applying every valid candidate."""
    n, p = 12, 3
    _, jp, tp = _problems(n, 5, **MODES[mode])
    perms = _perms(np.random.default_rng(6), p, n)
    pj = jnp.asarray(perms, jnp.int32)
    key = jax.random.key(0)
    jnb = jax.vmap(lambda q: jp.neighborhood(q, jp.score(q), key))(pj)
    pt = torch.from_numpy(perms)
    tnb = tp.neighborhood(pt, tp.score(pt), _draws(p, 0), torch.ones(p, dtype=torch.bool))
    np.testing.assert_array_equal(tnb.scores.numpy(), np.asarray(jnb.scores))
    np.testing.assert_array_equal(tnb.valid.numpy(), np.asarray(jnb.valid))
    np.testing.assert_array_equal(tnb.n_valid.numpy(), np.asarray(jnb.n_valid))
    a, b = _moves(tnb, n)
    np.testing.assert_array_equal(a.numpy(), np.broadcast_to(np.asarray(jnb.moves[0]), a.shape))
    np.testing.assert_array_equal(b.numpy(), np.broadcast_to(np.asarray(jnb.moves[1]), b.shape))
    idx = torch.arange(tnb.valid.shape[1]).expand(tnb.valid.shape)
    fp = tp.fingerprint(pt)
    got_fps = tp.move_fp(pt, fp, tnb.moves, idx)
    want_fps = jax.vmap(
        lambda q, m0, m1: jax.vmap(lambda i: jp.move_fp(q, jp.fingerprint(q), (m0, m1), i))(jnp.arange(m0.shape[-1]))
    )(pj, jnb.moves[0], jnb.moves[1])
    np.testing.assert_array_equal(got_fps.numpy().astype(np.uint32), np.asarray(want_fps))
    win = lex_argmin(tnb.scores, tnb.valid)
    applied = tp.apply_move(pt, tnb.moves, win)
    want = jax.vmap(lambda q, m0, m1, i: jp.apply_move(q, (m0, m1), i))(
        pj, jnb.moves[0], jnb.moves[1], jax.vmap(j_lex_argmin)(jnb.scores, jnb.valid)
    )
    np.testing.assert_array_equal(applied.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tp.fingerprint(applied).numpy(), got_fps[torch.arange(p), win].numpy())


def test_compact_winner_equals_dense_winner():
    for seed in range(4):
        _, _, dense = _problems(12, seed, max_val=5)
        _, _, comp = _problems(12, seed, max_val=5, compact=True)
        p = torch.from_numpy(_perms(np.random.default_rng(seed), 4, 12))
        cur = dense.score(p)
        draws = _draws(4, seed)
        on = torch.ones(4, dtype=torch.bool)
        nb_d, nb_c = dense.neighborhood(p, cur, draws, on), comp.neighborhood(p, cur, draws, on)
        wd, wc = lex_argmin(nb_d.scores, nb_d.valid), lex_argmin(nb_c.scores, nb_c.valid)
        lane = torch.arange(4)
        (ad, bd), (ac, bc) = _moves(nb_d, 12), _moves(nb_c, 12)
        assert torch.equal(ad[lane, wd], ac[lane, wc]) and torch.equal(bd[lane, wd], bc[lane, wc])
        assert torch.equal(nb_d.scores[lane, wd], nb_c.scores[lane, wc])


def test_incremental_state_tracks_exactly_through_descent():
    """Walking a greedy descent, the carried G stays exactly D[p][:, p] and H
    exactly F G, the winner is the compact proposer's, and every score equals
    the host oracle."""
    n, p = 14, 3
    spec, _, inc = _problems(n, 0, max_val=7, incremental=True)
    _, _, comp = _problems(n, 0, max_val=7, compact=True)
    flow, dist = spec.arrays()
    draws = JaxKeyDraws(jax.random.split(jax.random.key(1), p))
    on = torch.ones(p, dtype=torch.bool)
    st = inc.init(draws)
    draws.round_keys()
    perm, cur = st.p, inc.score(st)
    lane = torch.arange(p)
    for _ in range(12):
        nb_i, nb_c = inc.neighborhood(st, cur, draws, on), comp.neighborhood(perm, cur, draws, on)
        assert torch.equal(nb_i.scores, nb_c.scores)
        w = lex_argmin(nb_i.scores, nb_i.valid)
        assert torch.equal(w, lex_argmin(nb_c.scores, nb_c.valid))
        assert torch.equal(
            inc.move_fp(st, inc.fingerprint(st), nb_i.moves, w), comp.move_fp(perm, comp.fingerprint(perm), nb_c.moves, w)
        )
        st, perm, cur = inc.apply_move(st, nb_i.moves, w), comp.apply_move(perm, nb_c.moves, w), nb_i.scores[lane, w]
        assert torch.equal(st.p, perm)
        for k in range(p):
            pn = st.p[k].numpy()
            g_want = dist[np.ix_(pn, pn)]
            np.testing.assert_array_equal(st.g[k].numpy(), g_want)
            np.testing.assert_array_equal(st.h[k].numpy(), flow @ g_want)
            assert float(cur[k, 0]) == tq.qap_cost_naive(flow, dist, pn)
    draws.round_keys()
    st2 = inc.perturb(st, torch.tensor([False, True, False]), draws)
    for k in range(p):
        pn = st2.p[k].numpy()
        assert sorted(pn.tolist()) == list(range(n))
        np.testing.assert_array_equal(st2.g[k].numpy(), dist[np.ix_(pn, pn)])
        np.testing.assert_array_equal(st2.h[k].numpy(), flow @ dist[np.ix_(pn, pn)])


def test_perturbation_equals_jax_and_keeps_permutations():
    n, p = 40, 6
    _, jp, tp = _problems(n, 7)
    keys = jax.random.split(jax.random.key(8), p)
    perms = _perms(np.random.default_rng(9), p, n)
    is_elite = np.array([True, False] * (p // 2))
    draws = JaxKeyDraws(keys)
    for _ in range(3):
        draws.round_keys()
        want = jax.vmap(jp.perturb)(jnp.asarray(perms, jnp.int32), jnp.asarray(is_elite), draws._perturb_key)
        got = tp.perturb(torch.from_numpy(perms), torch.from_numpy(is_elite), draws)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for row in got.numpy():
            assert sorted(row.tolist()) == list(range(n))
        perms = got.numpy()


def test_asymmetric_or_nonzero_diagonal_is_rejected():
    flow = np.ones((4, 4)) - np.eye(4)
    dist = flow.copy()
    tq.make_qap_problem(tq.QAPSpec(flow, dist))
    skew = dist.copy()
    skew[0, 1] = 2
    with pytest.raises(ValueError, match="symmetric"):
        tq.make_qap_problem(tq.QAPSpec(flow, skew))
    with pytest.raises(ValueError, match="diagonal"):
        tq.make_qap_problem(tq.QAPSpec(flow + np.eye(4), dist))
    # The sharded neighborhood's errors, the JAX package's.
    for make, spec in ((tq.make_qap_problem, tq.QAPSpec(flow, dist)), (jq.make_qap_problem, jq.QAPSpec.random(4))):
        with pytest.raises(ValueError, match="must divide over 3 nbr shards"):
            make(spec, nbr_axis="nbr", nbr_shards=3)
        with pytest.raises(ValueError, match="incremental excludes nbr_axis"):
            make(spec, nbr_axis="nbr", nbr_shards=2, incremental=True)


@pytest.mark.parametrize("mode", list(MODES))
def test_population_finds_brute_force_optimum_n7(mode):
    """Eight lanes from the production draw source reach the optimum of an
    n=7 instance, found by enumerating all 5040 permutations."""
    spec = tq.QAPSpec.random(7, seed=9)
    flow, dist = spec.arrays()
    best = min(tq.qap_cost_naive(flow, dist, np.asarray(perm)) for perm in itertools.permutations(range(7)))
    solver = tpop.PopulationSolver(
        tq.make_qap_problem(spec, **MODES[mode]),
        SolverConfig(
            seed="q", local_search_max_iterations=60, best_solutions_capacity=8, all_solutions_capacity=64,
            all_solution_iteration_expiry=200, iterated_local_search_max_iterations=12,
            max_allow_no_improvement_for=5,
        ),
        population=8, exchange_every=4, device="cpu",
    )
    solver.run(chunk=4)
    (cost, _), state = solver.get_best_solution()
    perm = state.p if mode == "incremental" else state
    assert cost == best and sorted(perm.tolist()) == list(range(7))
    assert cost == tq.qap_cost_naive(flow, dist, perm)


@pytest.mark.parametrize(
    "mode, extra",
    [
        ("dense", {}),
        ("compact", {}),
        ("incremental", {}),
        ("compact", {"select_topk": 4, "select_temp": 0.5}),
        ("dense", {"tabu_exact_filter": False}),
    ],
    ids=["dense", "compact", "incremental", "compact-topk", "dense-pick-then-check"],
)
def test_population_trajectory_matches_jax(mode, extra):
    """Whole PopulationSolver runs at n=12, P=4 (exchange every 2 rounds,
    culling a quarter of the lanes, a restart at round 3), leaf for leaf.  The
    QAP proposers draw nothing, so the noisy selection's noise follows the
    draw source's ``advance``."""
    n, p = 12, 4
    seed = f"qap-{mode}-{len(extra)}"
    kw = dict(
        seed=seed, local_search_max_iterations=8, best_solutions_capacity=3, all_solutions_capacity=16,
        all_solution_iteration_expiry=40, restart_every=3, max_allow_no_improvement_for=4, **extra,
    )
    _, jp, tp = _problems(n, 11, **MODES[mode])
    jsolver = jpop.PopulationSolver(jp, JConfig(**kw), population=p, exchange_every=2, cull_frac=0.25)
    tsolver = tpop.PopulationSolver(
        tp, SolverConfig(**kw), population=p, exchange_every=2, cull_frac=0.25,
        draws=JaxKeyDraws(jax.random.split(seed_string_to_key(seed), p)), device="cpu",
    )
    assert tsolver.program.ls_params.tabu_exact_filter == ("tabu_exact_filter" not in extra)
    assert_tree_equal(jsolver.state, to_reference(tsolver.state))
    for _ in range(3):
        np.testing.assert_array_equal(tsolver.execute_chunk_traced(2), jsolver.execute_chunk_traced(2))
        assert_tree_equal(jsolver.state, to_reference(tsolver.state))
    assert tsolver.stats() == jsolver.stats()
    (score_t, state_t), (score_j, state_j) = tsolver.get_best_solution(), jsolver.get_best_solution()
    assert score_t == score_j
    for want, got in zip(jax.tree.leaves(state_j), tree_leaves(state_t)):
        np.testing.assert_array_equal(got, want)
    assert_tree_equal(jsolver.state, to_reference(from_reference(jsolver.state, "cpu")))
    back = from_reference(to_reference(tsolver.state), "cpu")
    assert_tree_equal(to_reference(tsolver.state), to_reference(back))


def test_sharded_neighborhood_and_population_equal_jax_nbr_axis(tmp_path):
    """The sharded neighborhood (``nbr_axis``) of qap-16 over two gloo ranks
    equals the JAX one under ``shard_map`` on two devices: every gathered
    score, swap and validity flag; and 4 rounds of a sharded population of 4
    lanes from the JAX lane keys equal the JAX ``ShardedPopulationSolver``."""
    from jax.sharding import PartitionSpec

    from constraint_solver_tpu.parallel.mesh import make_mesh as j_mesh
    from constraint_solver_tpu.parallel.sharded import ShardedPopulationSolver as JSharded

    import torch_ranks

    n, p = 16, 4
    perms = _perms(np.random.default_rng(5), 3, n)
    mesh = j_mesh(n_pop=1, n_nbr=2)
    # The JAX part under the mesh, which the block restores on exit.
    with jax.set_mesh(mesh):
        jp = jq.make_qap_problem(jq.QAPSpec.random(n, seed=0), nbr_axis="nbr", nbr_shards=2, nbr_keep=16)

        def nbr(perms):
            return jax.vmap(lambda q: jp.neighborhood(q, jp.score(q), jax.random.key(0)))(perms)

        want = jax.jit(jax.shard_map(nbr, mesh=mesh, in_specs=PartitionSpec(), out_specs=PartitionSpec(),
                                     check_vma=False))(jnp.asarray(perms, jnp.int32))
        keys = jax.random.split(seed_string_to_key("qap-nbr"), p)
        js = JSharded(jp, JConfig(**torch_ranks.qap_config()), population=p, mesh=mesh, exchange_every=2)
        for _ in range(4):
            js.execute_round()
    ranks = torch_ranks.spawn(torch_ranks.qap_body, 2, tmp_path, n, perms,
                              np.asarray(jax.random.key_data(keys)))
    for out in ranks:
        np.testing.assert_array_equal(out["scores"], np.asarray(want.scores))
        np.testing.assert_array_equal(out["a"], np.asarray(want.moves[0]))
        np.testing.assert_array_equal(out["b"], np.asarray(want.moves[1]))
        np.testing.assert_array_equal(out["valid"], np.asarray(want.valid))
        assert_tree_equal(jax.device_get(js.state), out["state"])
        with jax.set_mesh(mesh):
            assert out["best"][0] == js.get_best_solution()[0]
