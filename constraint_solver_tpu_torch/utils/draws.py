"""Random draws for the solver, behind one small interface.

The JAX package threads ``jax.random`` keys through its state and splits them at
fixed places (``population_init``, ``ils_init``, ``ils_round``, each local-search
iteration, the neighborhood and the perturbation).  Divergence: the port does not
reproduce ``jax.random``.  Even a bit-exact threefry port would not give bit-exact
Gumbel draws, because XLA's float32 ``log`` and PyTorch's differ in the last bit
on some inputs, and it would cost some hundred elementwise launches per draw on
the card.  Instead, every random choice on the solver's path goes through a
``Draws`` object, with one method per call site, drawing for all P lanes at once:

- ``permutation(n)``: the random boards of ``init`` and the periodic restart;
- ``round_keys()``: marks the start of an ILS round (a JAX key split per lane);
- ``perturb(n, hi)``: the perturbation's strategy, count, positions and rows;
- ``neighborhood(n, amount, active)``: the Gumbel noise of the weighted column
  sample and the number of columns, for the lanes still in their descent;
- ``accept(elite_valid, weights)``: the acceptance choice and the random elite.

``TorchDraws`` is the production source: one ``torch.Generator`` seeded from the
solver's seed string.  A test-only source that follows the JAX key tree exactly
lives with the tests, so that the port and the JAX package can be fed identical
draws and whole trajectories compared.
"""

from __future__ import annotations

from typing import NamedTuple, Protocol, Sequence

import torch

from constraint_solver_tpu_torch.utils.seeding import seed_string_to_generator


class PerturbDraws(NamedTuple):
    u_strat: torch.Tensor   # float32[P]    strategy draw: change the board iff < 100/110
    n_alter: torch.Tensor   # int64[P]      how many positions change, in [1, hi]
    u: torch.Tensor         # float32[P, n] position draws: the n_alter smallest change
    new_rows: torch.Tensor  # int64[P, n]   the new rows, in [0, n)


class AcceptDraws(NamedTuple):
    elite_idx: torch.Tensor  # int64[P]  a uniformly chosen valid archive slot
    choice: torch.Tensor     # int64[P]  0 / 1 / 2 with probability weights / sum(weights)
    u: torch.Tensor          # float32[P] the Metropolis draw of annealing lanes


class Draws(Protocol):
    population: int
    device: torch.device

    def permutation(self, n: int) -> torch.Tensor: ...

    def round_keys(self) -> None: ...

    def perturb(self, n: int, hi: torch.Tensor) -> PerturbDraws: ...

    def neighborhood(
        self, n: int, amount: torch.Tensor, active: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]: ...

    def accept(self, elite_valid: torch.Tensor, weights: Sequence[float]) -> AcceptDraws: ...


class TorchDraws:
    """Draws from one ``torch.Generator`` seeded from the seed string.

    The generator lives on ``draw_device`` (default: ``device``) and every draw
    is moved to ``device``.  Drawing on the CPU for a CUDA solver makes a run's
    draws independent of the device, so a run on the card and a run on the CPU
    from one seed follow the same trajectory."""

    def __init__(
        self,
        seed: str,
        population: int,
        device: torch.device | str,
        draw_device: torch.device | str | None = None,
    ):
        self.population = population
        self.device = torch.device(device)
        self._draw_device = torch.device(draw_device) if draw_device is not None else self.device
        self._gen = seed_string_to_generator(seed, self._draw_device)

    def _rand(self, *shape: int, dtype=torch.float32) -> torch.Tensor:
        return torch.rand(
            (self.population, *shape), generator=self._gen, device=self._draw_device, dtype=dtype
        )

    def _randint(self, lo: int, hi: torch.Tensor) -> torch.Tensor:
        """One integer per lane, uniform in [lo, hi[p]] (inclusive)."""
        span = hi.to(self._draw_device, torch.int64) - lo + 1
        pick = (self._rand(dtype=torch.float64) * span).long()
        return lo + torch.minimum(pick, span - 1)

    def _out(self, *tensors: torch.Tensor):
        return tuple(t.to(self.device) for t in tensors)

    def permutation(self, n: int) -> torch.Tensor:
        (perm,) = self._out(torch.argsort(self._rand(n), dim=-1))
        return perm

    def round_keys(self) -> None:
        """Nothing to do: the generator's stream carries on."""

    def perturb(self, n: int, hi: torch.Tensor) -> PerturbDraws:
        u_strat = self._rand()
        n_alter = self._randint(1, hi)
        u = self._rand(n)
        new_rows = torch.randint(
            0, n, (self.population, n), generator=self._gen, device=self._draw_device
        )
        return PerturbDraws(*self._out(u_strat, n_alter, u, new_rows))

    def neighborhood(self, n: int, amount: torch.Tensor, active: torch.Tensor):
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(self._rand(n).clamp_min(tiny)))
        num_cols = self._randint(1, amount)
        return self._out(gumbel, num_cols)

    def accept(self, elite_valid: torch.Tensor, weights: Sequence[float]) -> AcceptDraws:
        valid = elite_valid.to(self._draw_device)
        elite_idx = torch.argmax(torch.where(valid, self._rand(valid.shape[-1]), -1.0), dim=-1)
        w = torch.tensor(weights, dtype=torch.float64, device=self._draw_device)
        cum = torch.cumsum(w / w.sum(), 0)[:-1]
        choice = (self._rand(1, dtype=torch.float64) >= cum).sum(-1)
        return AcceptDraws(*self._out(elite_idx, choice, self._rand()))
