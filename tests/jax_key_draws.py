"""Test-only draw source for the PyTorch port that follows the JAX key tree.

It keeps one JAX key per lane and splits it exactly where the JAX package does,
calling the same ``jax.random`` functions with the same keys and shapes:

- ``ils_init`` and ``pmc_init``: ``key, k_init = split(key)``; ``init`` permutes
  (N-Queens, QAP), draws ``randint(k_init, (D,), 0, E)`` (scheduling) or
  ``uniform(k_init, shape, lo, hi)`` (Ackley, diagram layout) with ``k_init``;
- ``ils_round``: ``key, k_restart, k_perturb, k_ls, k_elite, k_accept = split(key, 6)``;
- each descent iteration: ``key, k_nb = split(key)`` for the lanes still running.
  ``k_nb`` is kept for the iteration: the proposer draws from it (N-Queens
  ``k_gumbel, k_num = split(k_nb)``; the scheduling window's ``split(k_nb, 4)``;
  the dense block's ``k_off, k_rs = split(k_nb)`` and ``split(k_rs)``; Ackley's
  step ``uniform(k_nb)`` itself; QAP and the diagram layout draw nothing, and
  ``advance`` only splits), and the noisy selection draws its Gumbel noise from
  ``fold_in(k_nb, 0x6E6F6973)``;
- the perturbation's ``split(k_perturb, 4)``: N-Queens and scheduling draw
  (uniform, randint [1, hi], uniform (n,), randint values), QAP the first three
  of those, Ackley (uniform, randint [0, n), uniform (n,), normal (n,)) and the
  diagram layout (uniform, randint [1, hi], uniform (n,), uniform (n, 2));
- ``EliteArchive.get_random``'s ``categorical`` and the acceptance's ``choice``
  and ``uniform``, both on ``k_accept``;
- ``reseed_from_elites``: ``key, k_pick = split(key)`` and ``get_random``'s
  ``categorical`` on ``k_pick``;
- each PMC step: ``key, k_u, k_kcol, k_krow, k_gum = split(key, 5)`` for the
  lanes still running (a stopped lane keeps its key).

So the port (``constraint_solver_tpu_torch``) and the JAX package consume identical
draws, and whole trajectories can be compared bit for bit.  Build it from the
per-lane keys the JAX solver starts from: ``split(seed_key, P)`` for a
``PopulationSolver`` or a PMC population, ``seed_key[None]`` for a ``Solver`` or
a single PMC solve.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from constraint_solver_tpu_torch.utils.draws import (
    AcceptDraws,
    CellPerturbDraws,
    DenseSwapDraws,
    NormalPerturbDraws,
    PerturbDraws,
    PMCDraws,
    RandomMoveDraws,
)

_NOISE_SALT = 0x6E6F6973  # core/local_search.py's fold_in constant


def _t(x, device, dtype=None):
    return torch.tensor(np.asarray(x), device=device, dtype=dtype)


def _np(x: torch.Tensor):
    return jnp.asarray(x.cpu().numpy())


def _keep_inactive(new_keys, keys, active):
    data = jnp.where(active[:, None], jax.random.key_data(new_keys), jax.random.key_data(keys))
    return jax.random.wrap_key_data(data)


@partial(jax.jit, static_argnums=1)
def _permutation(keys, n):
    return jax.vmap(lambda k: jax.random.permutation(k, jnp.arange(n, dtype=jnp.int32)))(keys)


@partial(jax.jit, static_argnums=(1, 2))
def _assignment(keys, d, e):
    return jax.vmap(lambda k: jax.random.randint(k, (d,), 0, e, jnp.int32))(keys)


@jax.jit
def _split6(keys):
    return jax.vmap(lambda k: jax.random.split(k, 6))(keys)


@partial(jax.jit, static_argnums=(1, 2, 3))
def _uniform(keys, shape, lo, hi):
    return jax.vmap(lambda k: jax.random.uniform(k, shape, jnp.float32, lo, hi))(keys)


@partial(jax.jit, static_argnums=(1, 3))
def _perturb(keys, n, hi, values):
    def one(key, hi):
        k_strat, k_n, k_u, k_rows = jax.random.split(key, 4)
        rows = () if values is None else (jax.random.randint(k_rows, (n,), 0, values, jnp.int32),)
        return (
            jax.random.uniform(k_strat),
            jax.random.randint(k_n, (), 1, hi + 1),
            jax.random.uniform(k_u, (n,)),
            *rows,
        )

    return jax.vmap(one)(keys, hi)


@partial(jax.jit, static_argnums=1)
def _perturb_normal(keys, n):
    def one(key):
        k_strat, k_n, k_u, k_noise = jax.random.split(key, 4)
        return (
            jax.random.uniform(k_strat),
            jax.random.randint(k_n, (), 0, n),
            jax.random.uniform(k_u, (n,)),
            jax.random.normal(k_noise, (n,), jnp.float32),
        )

    return jax.vmap(one)(keys)


@partial(jax.jit, static_argnums=1)
def _perturb_cells(keys, n, hi):
    def one(key, hi):
        k_strat, k_n, k_sel, k_pos = jax.random.split(key, 4)
        return (
            jax.random.uniform(k_strat),
            jax.random.randint(k_n, (), 1, hi + 1),
            jax.random.uniform(k_sel, (n,)),
            jax.random.uniform(k_pos, (n, 2)),
        )

    return jax.vmap(one)(keys, hi)


@jax.jit
def _split_nb(keys, active):
    split = jax.vmap(jax.random.split)(keys)
    return _keep_inactive(split[:, 0], keys, active), split[:, 1]


@partial(jax.jit, static_argnums=1)
def _nqueens_nb(k_nb, n, amount):
    def one(k, amount):
        k_gumbel, k_num = jax.random.split(k)
        return jax.random.gumbel(k_gumbel, (n,)), jax.random.randint(k_num, (), 1, amount + 1)

    return jax.vmap(one)(k_nb, amount)


@partial(jax.jit, static_argnums=(1, 2, 3))
def _random_moves(k_nb, w, d, e):
    def one(k):
        k_type, k_d1, k_off, k_emp = jax.random.split(k, 4)
        return (
            jax.random.uniform(k_type, (w,)),
            jax.random.randint(k_d1, (w,), 0, d, jnp.int32),
            jax.random.randint(k_off, (w,), 1, max(d, 2), jnp.int32),
            jax.random.randint(k_emp, (w,), 0, e, jnp.int32),
        )

    return jax.vmap(one)(k_nb)


@partial(jax.jit, static_argnums=(1, 2, 3))
def _dense_swaps(k_nb, n_rand, n_off, d):
    def one(k):
        k_off, k_rs = jax.random.split(k)
        k_rs1, k_rs2 = jax.random.split(k_rs)
        return (
            jax.random.randint(k_rs1, (n_rand,), 0, d, jnp.int32),
            jax.random.randint(k_rs2, (n_rand,), 1, d, jnp.int32),
            jax.random.randint(k_off, (n_off,), 14, d, jnp.int32),
        )

    return jax.vmap(one)(k_nb)


@partial(jax.jit, static_argnums=1)
def _select_noise(k_nb, w):
    return jax.vmap(lambda k: jax.random.gumbel(jax.random.fold_in(k, _NOISE_SALT), (w,)))(k_nb)


@partial(jax.jit, static_argnums=(1, 2))
def _step(k_nb, lo, hi):
    return jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float32, lo, hi))(k_nb)


@jax.jit
def _reseed_pick(keys, valid):
    def one(key, v):
        key, k_pick = jax.random.split(key)
        return key, jax.random.categorical(k_pick, jnp.where(v, 0.0, -jnp.inf))

    return jax.vmap(one)(keys, valid)


@jax.jit
def _accept(k_elite, k_accept, valid, w):
    def one(ke, ka, v):
        idx = jax.random.categorical(ke, jnp.where(v, 0.0, -jnp.inf))
        return idx, jax.random.choice(ka, 3, p=w / w.sum()), jax.random.uniform(ka)

    return jax.vmap(one)(k_elite, k_accept, valid)


@partial(jax.jit, static_argnums=(1, 2, 5))
def _pmc_step(keys, n, a, conflicted, active, sampled):
    def one(key, conf):
        key2, k_u, k_kcol, k_krow, k_gum = jax.random.split(key, 5)
        gum = jax.random.gumbel(k_gum, (n,)) if sampled else jnp.zeros((0,), jnp.float32)
        return (
            key2,
            jax.random.uniform(k_u, (a,)),
            jax.random.categorical(k_kcol, jnp.where(conf, 0.0, -jnp.inf)),
            jax.random.randint(k_krow, (), 0, n, jnp.int32),
            gum,
        )

    new_keys, u, col, row, gum = jax.vmap(one)(keys, conflicted)
    return _keep_inactive(new_keys, keys, active), u, col, row, gum


class JaxKeyDraws:
    """``utils/draws.py``'s interface, drawing with per-lane JAX keys."""

    def __init__(self, lane_keys: jax.Array, device="cpu"):
        self.population = int(lane_keys.shape[0])
        self.device = torch.device(device)
        split = jax.vmap(jax.random.split)(lane_keys)
        self._key, self._perm_key = split[:, 0], split[:, 1]
        self._perturb_key = self._ls_key = self._elite_key = self._accept_key = None
        self._nb_key = None  # the current descent iteration's k_nb

    @classmethod
    def lanes(cls, lane_key_data: np.ndarray, lo: int, hi: int, device="cpu") -> "JaxKeyDraws":
        """The source of lanes [lo, hi) of a population whose per-lane keys
        have the key data ``lane_key_data`` (``jax.random.key_data`` of
        ``split(seed_key, P)``, as numpy): one rank's lanes of a sharded
        solver, which draws from the keys the JAX sharded solver gives them."""
        return cls(jax.random.wrap_key_data(jnp.asarray(lane_key_data[lo:hi])), device)

    def _i64(self, x):
        return _t(x, self.device, torch.int64)

    def permutation(self, n: int) -> torch.Tensor:
        return self._i64(_permutation(self._perm_key, n))

    def assignment(self, d: int, e: int) -> torch.Tensor:
        return self._i64(_assignment(self._perm_key, d, e))

    def uniform(self, shape: tuple, lo: float, hi: float) -> torch.Tensor:
        return _t(_uniform(self._perm_key, tuple(shape), lo, hi), self.device)

    def round_keys(self) -> None:
        ks = _split6(self._key)
        self._key, self._perm_key, self._perturb_key = ks[:, 0], ks[:, 1], ks[:, 2]
        self._ls_key, self._elite_key, self._accept_key = ks[:, 3], ks[:, 4], ks[:, 5]

    def perturb(self, n: int, hi: torch.Tensor, values: int | None) -> PerturbDraws:
        u_strat, n_alter, u, *rows = _perturb(self._perturb_key, n, _np(hi).astype(jnp.int32), values)
        return PerturbDraws(
            _t(u_strat, self.device), self._i64(n_alter), _t(u, self.device),
            self._i64(rows[0]) if rows else None,
        )

    def perturb_normal(self, n: int) -> NormalPerturbDraws:
        u_strat, n_alter, u, noise = _perturb_normal(self._perturb_key, n)
        return NormalPerturbDraws(
            _t(u_strat, self.device), self._i64(n_alter), _t(u, self.device), _t(noise, self.device)
        )

    def perturb_cells(self, n: int, hi: torch.Tensor) -> CellPerturbDraws:
        u_strat, n_alter, u, cells = _perturb_cells(self._perturb_key, n, _np(hi).astype(jnp.int32))
        return CellPerturbDraws(
            _t(u_strat, self.device), self._i64(n_alter), _t(u, self.device), _t(cells, self.device)
        )

    def _next_nb(self, active: torch.Tensor) -> jax.Array:
        self._ls_key, self._nb_key = _split_nb(self._ls_key, _np(active))
        return self._nb_key

    def neighborhood(self, n: int, amount: torch.Tensor, active: torch.Tensor):
        gumbel, num = _nqueens_nb(self._next_nb(active), n, _np(amount).astype(jnp.int32))
        return _t(gumbel, self.device), self._i64(num)

    def random_moves(self, w: int, d: int, e: int, active: torch.Tensor) -> RandomMoveDraws:
        u, d1, off, emp = _random_moves(self._next_nb(active), w, d, e)
        return RandomMoveDraws(_t(u, self.device), self._i64(d1), self._i64(off), self._i64(emp))

    def dense_swaps(self, n_rand: int, n_off: int, d: int, active: torch.Tensor) -> DenseSwapDraws:
        return DenseSwapDraws(*map(self._i64, _dense_swaps(self._next_nb(active), n_rand, n_off, d)))

    def step(self, lo: float, hi: float, active: torch.Tensor) -> torch.Tensor:
        return _t(_step(self._next_nb(active), lo, hi), self.device)

    def advance(self, active: torch.Tensor) -> None:
        self._next_nb(active)

    def select_noise(self, w: int, active: torch.Tensor) -> torch.Tensor:
        return _t(_select_noise(self._nb_key, w), self.device)

    def accept(self, elite_valid: torch.Tensor, weights) -> AcceptDraws:
        idx, choice, u = _accept(
            self._elite_key, self._accept_key, _np(elite_valid), jnp.asarray(weights, jnp.float32)
        )
        return AcceptDraws(self._i64(idx), self._i64(choice), _t(u, self.device))

    def reseed_pick(self, elite_valid: torch.Tensor) -> torch.Tensor:
        self._key, idx = _reseed_pick(self._key, _np(elite_valid))
        return self._i64(idx)

    def pmc_step(self, n: int, a: int, conflicted, active, sampled: bool) -> PMCDraws:
        self._key, u, col, row, gum = _pmc_step(self._key, n, a, _np(conflicted), _np(active), sampled)
        return PMCDraws(
            _t(u, self.device), self._i64(col), self._i64(row),
            _t(gum, self.device) if sampled else None,
        )

    _KEYS = ("_key", "_perm_key", "_perturb_key", "_ls_key", "_elite_key", "_accept_key", "_nb_key")

    def state_dict(self) -> dict:
        """The key data of every key held (a checkpoint stores numpy arrays)."""
        return {
            name: np.asarray(jax.random.key_data(getattr(self, name)))
            for name in self._KEYS if getattr(self, name) is not None
        }

    def load_state_dict(self, state: dict) -> None:
        for name in self._KEYS:
            setattr(self, name, jax.random.wrap_key_data(jnp.asarray(state[name])) if name in state else None)


def reference_log_weights(n: int) -> np.ndarray:
    """The JAX package's column log-weights log(cs + 1e-4) for cs ∈ [0, 3n),
    computed with XLA's float32 log, as ``models/nqueens.py`` computes them."""
    return np.asarray(jnp.log(jnp.arange(3 * n, dtype=jnp.float32) + 1e-4))
