"""Test-only draw source for the PyTorch port that follows the JAX key tree.

It keeps one JAX key per lane and splits it exactly where the JAX package does,
calling the same ``jax.random`` functions with the same keys and shapes:

- ``ils_init``: ``key, k_init = split(key)``; ``init`` permutes with ``k_init``;
- ``ils_round``: ``key, k_restart, k_perturb, k_ls, k_elite, k_accept = split(key, 6)``;
- each descent iteration: ``key, k_nb = split(key)`` for the lanes still running,
  then the neighborhood's ``k_gumbel, k_num = split(k_nb)``;
- the perturbation's ``split(k_perturb, 4)``;
- ``EliteArchive.get_random``'s ``categorical`` and the acceptance's ``choice``
  and ``uniform``, both on ``k_accept``.

So the port (``constraint_solver_tpu_torch``) and the JAX package consume identical
draws, and whole trajectories can be compared bit for bit.  Build it from the
per-lane keys the JAX solver starts from: ``split(seed_key, P)`` for a
``PopulationSolver``, ``seed_key[None]`` for a ``Solver``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from constraint_solver_tpu_torch.utils.draws import AcceptDraws, PerturbDraws


def _t(x, device, dtype=None):
    return torch.tensor(np.asarray(x), device=device, dtype=dtype)


@partial(jax.jit, static_argnums=1)
def _permutation(keys, n):
    return jax.vmap(lambda k: jax.random.permutation(k, jnp.arange(n, dtype=jnp.int32)))(keys)


@jax.jit
def _split6(keys):
    return jax.vmap(lambda k: jax.random.split(k, 6))(keys)


@partial(jax.jit, static_argnums=1)
def _perturb(keys, n, hi):
    def one(key, hi):
        k_strat, k_n, k_u, k_rows = jax.random.split(key, 4)
        return (
            jax.random.uniform(k_strat),
            jax.random.randint(k_n, (), 1, hi + 1),
            jax.random.uniform(k_u, (n,)),
            jax.random.randint(k_rows, (n,), 0, n, jnp.int32),
        )

    return jax.vmap(one)(keys, hi)


@partial(jax.jit, static_argnums=1)
def _neighborhood(keys, n, amount, active):
    def one(key, amount):
        key2, k_nb = jax.random.split(key)
        k_gumbel, k_num = jax.random.split(k_nb)
        return (
            key2,
            jax.random.gumbel(k_gumbel, (n,)),
            jax.random.randint(k_num, (), 1, amount + 1),
        )

    new_keys, gumbel, num = jax.vmap(one)(keys, amount)
    data = jnp.where(active[:, None], jax.random.key_data(new_keys), jax.random.key_data(keys))
    return jax.random.wrap_key_data(data), gumbel, num


@jax.jit
def _accept(k_elite, k_accept, valid, w):
    def one(ke, ka, v):
        idx = jax.random.categorical(ke, jnp.where(v, 0.0, -jnp.inf))
        return idx, jax.random.choice(ka, 3, p=w / w.sum()), jax.random.uniform(ka)

    return jax.vmap(one)(k_elite, k_accept, valid)


class JaxKeyDraws:
    """``utils/draws.py``'s interface, drawing with per-lane JAX keys."""

    def __init__(self, lane_keys: jax.Array, device="cpu"):
        self.population = int(lane_keys.shape[0])
        self.device = torch.device(device)
        split = jax.vmap(jax.random.split)(lane_keys)
        self._key, self._perm_key = split[:, 0], split[:, 1]
        self._perturb_key = self._ls_key = self._elite_key = self._accept_key = None

    def permutation(self, n: int) -> torch.Tensor:
        return _t(_permutation(self._perm_key, n), self.device, torch.int64)

    def round_keys(self) -> None:
        ks = _split6(self._key)
        self._key, self._perm_key, self._perturb_key = ks[:, 0], ks[:, 1], ks[:, 2]
        self._ls_key, self._elite_key, self._accept_key = ks[:, 3], ks[:, 4], ks[:, 5]

    def perturb(self, n: int, hi: torch.Tensor) -> PerturbDraws:
        u_strat, n_alter, u, new_rows = _perturb(
            self._perturb_key, n, jnp.asarray(hi.cpu().numpy(), jnp.int32)
        )
        return PerturbDraws(
            _t(u_strat, self.device),
            _t(n_alter, self.device, torch.int64),
            _t(u, self.device),
            _t(new_rows, self.device, torch.int64),
        )

    def neighborhood(self, n: int, amount: torch.Tensor, active: torch.Tensor):
        self._ls_key, gumbel, num = _neighborhood(
            self._ls_key, n,
            jnp.asarray(amount.cpu().numpy(), jnp.int32),
            jnp.asarray(active.cpu().numpy()),
        )
        return _t(gumbel, self.device), _t(num, self.device, torch.int64)

    def accept(self, elite_valid: torch.Tensor, weights) -> AcceptDraws:
        idx, choice, u = _accept(
            self._elite_key, self._accept_key,
            jnp.asarray(elite_valid.cpu().numpy()),
            jnp.asarray(weights, jnp.float32),
        )
        return AcceptDraws(
            _t(idx, self.device, torch.int64), _t(choice, self.device, torch.int64), _t(u, self.device)
        )


def reference_log_weights(n: int) -> np.ndarray:
    """The JAX package's column log-weights log(cs + 1e-4) for cs ∈ [0, 3n),
    computed with XLA's float32 log, as ``models/nqueens.py`` computes them."""
    return np.asarray(jnp.log(jnp.arange(3 * n, dtype=jnp.float32) + 1e-4))
