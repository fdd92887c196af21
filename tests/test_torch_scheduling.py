"""The PyTorch port's scheduling model (``models/scheduling.py``) against the JAX
package: the spec, the score, the random and rescore proposers and the region
deltas (the dense proposer and whole trajectories are in
``tests/test_torch_scheduling_dense.py``).

Assignments and moves come from ``numpy.random.default_rng(seed)``; where a
function draws, both sides draw from the same JAX keys (``tests/jax_key_draws.py``).
Equality is exact throughout: every score is a small integer held in float32,
every fingerprint a uint32 (held in int64 by the port)."""

import dataclasses
import datetime
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from constraint_solver_tpu.models import scheduling as js
from constraint_solver_tpu_torch.models import scheduling as ts
from jax_key_draws import JaxKeyDraws

D0 = datetime.date(2022, 5, 9)  # the reference CLI start date (a Monday)


def _spec(mod, days, emps, holidays=None, start=D0):
    return mod.ScheduleSpec.from_dates(start, start + datetime.timedelta(days=days - 1), emps, holidays)


def _bench_holidays(days, emps):
    d0 = datetime.date(2024, 1, 1)
    return d0, {e: [d0 + datetime.timedelta(days=(17 * e + 11 * k) % days) for k in range(10)] for e in range(emps)}


# (days, employees, holidays, start): the specs of the JAX package's delta and
# dense tests, plus the bench instance.
CASES = {
    "31d7e": (31, 7, None, D0),
    "31d7e-hol": (31, 7, {0: [D0 + datetime.timedelta(days=3)],
                          2: [D0 + datetime.timedelta(days=k) for k in (5, 6, 20)]}, D0),
    "15d3e": (15, 3, None, D0),
    "14d2e": (14, 2, None, D0),
    "9d3e": (9, 3, None, D0),
    "7d4e": (7, 4, None, D0),
    "3d2e": (3, 2, None, D0),
    "42d5e": (42, 5, {1: [D0 + datetime.timedelta(days=k) for k in range(0, 42, 7)]}, D0),
    "60d5e": (60, 5, {1: [D0 + datetime.timedelta(days=k) for k in range(0, 60, 7)]}, D0),
    "23d4e-fri": (23, 4, None, datetime.date(2022, 5, 13)),
    "30d4e-fri": (30, 4, None, datetime.date(2022, 5, 13)),
    "365d20e": (365, 20, _bench_holidays(365, 20)[1], _bench_holidays(365, 20)[0]),
}
NB_CASES = ["31d7e-hol", "15d3e", "14d2e", "9d3e", "3d2e", "42d5e", "30d4e-fri"]


def _specs(name):
    days, emps, hol, start = CASES[name]
    return _spec(js, days, emps, hol, start), _spec(ts, days, emps, hol, start)


def _eq(want, got, dtype=None):
    want = np.asarray(want)
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if dtype is not None:
        got = got.astype(dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def assert_tree_equal(want, got, path="state"):
    if hasattr(got, "_fields"):
        for f in got._fields:
            assert_tree_equal(getattr(want, f), getattr(got, f), f"{path}.{f}")
        return
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=path)


def _assignments(rng, p, spec):
    return rng.integers(0, spec.num_employees, size=(p, spec.num_days)).astype(np.int32)


def test_spec_matches_jax_and_is_hashable():
    jspec, tspec = _specs("365d20e")
    assert dataclasses.astuple(jspec) == dataclasses.astuple(tspec)
    assert hash(tspec) == hash(_specs("365d20e")[1])
    np.testing.assert_array_equal(tspec.holiday_array(), jspec.holiday_array())
    np.testing.assert_array_equal(tspec.is_weekend(), jspec.is_weekend())
    assert tspec.holiday_array().sum() == 200


@pytest.mark.parametrize("name", list(CASES))
def test_score_matches_jax(name):
    jspec, tspec = _specs(name)
    rng = np.random.default_rng(len(name))
    assign = _assignments(rng, 6, jspec)
    assign[0] = 0  # one employee every day: every constraint fires
    want = jax.jit(jax.vmap(js.make_scheduling_problem(jspec).score))(jnp.asarray(assign))
    _eq(want, ts.make_scheduling_problem(tspec).score(torch.from_numpy(assign).long()))


@functools.lru_cache(maxsize=None)
def _jax_neighborhood(jp):
    """The JAX neighborhood over lanes, compiled once per problem and shape."""
    return jax.jit(lambda a, k: jax.vmap(jp.neighborhood)(a, jax.vmap(jp.score)(a), k))


def _nb_pair(name, proposer, p=4, seed=0, **kw):
    """The JAX and port neighborhoods of random assignments from the same keys."""
    jspec, tspec = _specs(name)
    jp = js.make_scheduling_problem(jspec, proposer=proposer, **kw)
    tp = ts.make_scheduling_problem(tspec, proposer=proposer, **kw)
    assign = _assignments(np.random.default_rng(seed), p, jspec)
    keys = jax.random.split(jax.random.key(seed + 100), p)
    k_nb = jax.vmap(jax.random.split)(keys)[:, 1]  # the descent's split
    ja = jnp.asarray(assign)
    nb_j = _jax_neighborhood(jp)(ja, k_nb)
    draws = JaxKeyDraws(keys)
    draws._ls_key = keys
    ta = torch.from_numpy(assign).long()
    nb_t = tp.neighborhood(ta, tp.score(ta), draws, torch.ones(p, dtype=torch.bool))
    return jp, tp, ja, ta, nb_j, nb_t


def _assert_nb_equal(nb_j, nb_t):
    _eq(nb_j.scores, nb_t.scores)
    _eq(nb_j.valid, nb_t.valid)
    _eq(nb_j.fp_deltas, nb_t.fp_deltas, np.uint32)
    for wm, gm in zip(nb_j.moves, nb_t.moves):
        _eq(wm, gm, np.asarray(wm).dtype)


@pytest.mark.parametrize("proposer", ["random", "rescore"])
@pytest.mark.parametrize("name", NB_CASES)
def test_random_and_rescore_neighborhoods_match_jax(name, proposer):
    *_, nb_j, nb_t = _nb_pair(name, proposer, window_size=24)
    _assert_nb_equal(nb_j, nb_t)


def test_region_deltas_match_jax():
    """Both region passes on random moves, overlapping regions included."""
    d_days, n_emp, w = 40, 5, 64
    rng = np.random.default_rng(2)
    assign = rng.integers(0, n_emp, size=d_days)
    weekend = (np.arange(d_days) % 7) >= 5
    a_pad = np.concatenate([np.full(13, -1), assign, np.full(13, -1)])
    wk_pad = np.concatenate([np.zeros(13, bool), weekend, np.zeros(13, bool)])
    d1 = rng.integers(0, d_days, size=w)
    d2 = (d1 + rng.integers(1, 20, size=w)) % d_days
    is_swap = rng.random(w) < 0.8
    e1, e2 = assign[d1], assign[d2]
    n1 = np.where(is_swap, e2, rng.integers(0, n_emp, size=w))
    n2 = np.where(is_swap, e1, e2)
    for dj, dx, excl in ((d1, d2, False), (d2, d1, True)):
        sl = np.stack([a_pad[d : d + 27] for d in dj])
        wk = np.stack([wk_pad[d : d + 27] for d in dj])
        i32 = lambda x: jnp.asarray(x, jnp.int32)  # noqa: E731
        want = jax.vmap(lambda *a: js.region_deltas(*a, excl, d_days))(
            i32(sl), jnp.asarray(wk), i32(d1), i32(n1), i32(d2), i32(n2), i32(e1), i32(e2), i32(dj), i32(dx)
        )
        t = lambda x: torch.from_numpy(np.asarray(x)).long()[None]  # noqa: E731
        got = ts.region_deltas(
            t(sl), torch.from_numpy(wk)[None], t(d1), t(n1), t(d2), t(n2), t(e1), t(e2), t(dj), t(dx),
            excl, d_days,
        )
        for wv, gv in zip(want, got):
            _eq(wv, gv[0])


def test_unported_proposer_raises():
    """Every proposer of the JAX package is ported (``systematic`` is held
    against it in ``tests/test_torch_scheduling_systematic.py``); a name it does
    not have raises."""
    spec = _specs("31d7e")[1]
    assert ts.make_scheduling_problem(spec, proposer="systematic").width == 31 * 6
    with pytest.raises(ValueError, match="tabu"):
        ts.make_scheduling_problem(spec, proposer="tabu")
