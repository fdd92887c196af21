"""Random draws for the solver, behind one small interface.

The JAX package threads ``jax.random`` keys through its state and splits them at
fixed places (``population_init``, ``ils_init``, ``ils_round``, each local-search
iteration, the neighborhood and the perturbation).  Divergence: the port does not
reproduce ``jax.random``.  Even a bit-exact threefry port would not give bit-exact
Gumbel draws, because XLA's float32 ``log`` and PyTorch's differ in the last bit
on some inputs, and it would cost some hundred elementwise launches per draw on
the card.  Instead, every random choice on the solver's path goes through a
``Draws`` object, with one method per call site, drawing for all P lanes at once:

- ``permutation(n)``: the random boards of the N-Queens ``init``, the periodic
  restart, and PMC's ``pmc_init``; the QAP permutations;
- ``assignment(d, e)``: the random schedules of the scheduling ``init`` and
  restart, one employee in [0, e) per day;
- ``uniform(shape, lo, hi)``: the Ackley points and the diagram layout's
  cells of ``init`` and restart;
- ``round_keys()``: marks the start of an ILS round (a JAX key split per lane);
- ``perturb(n, hi, values)``: the perturbation's strategy, count, positions and
  new values in [0, values) (N-Queens, scheduling); QAP passes ``values=None``
  and gets no new values;
- ``perturb_normal(n)``: Ackley's perturbation, with the count in [0, n) and
  standard normal noise;
- ``perturb_cells(n, hi)``: the diagram layout's perturbation, with fresh
  uniform [n, 2] cells;
- ``neighborhood(n, amount, active)``: the N-Queens Gumbel column noise and the
  number of columns;
- ``random_moves(w, d, e, active)``: the scheduling random window (move type,
  first day, day offset, new employee);
- ``dense_swaps(n_rand, n_off, d, active)``: the dense scheduling block's random
  swap pairs and diagonal offsets;
- ``step(lo, hi, active)``: Ackley's move size, uniform in [lo, hi);
- ``advance(active)``: a descent iteration whose proposer draws nothing (QAP,
  diagram layout);
- ``select_noise(w, active)``: the Gumbel noise of the noisy selection, drawn
  in the same descent iteration as, and after, the neighborhood's draws;
- ``accept(elite_valid, weights)``: the acceptance choice and the random elite;
- ``reseed_pick(elite_valid)``: the archive slot ``reseed_from_elites`` takes;
- ``pmc_step(n, a, conflicted, active, sampled)``: one parallel min-conflicts
  step (acceptance draws, the plateau kick, the column noise).

The neighborhood-time methods take the [P] mask of lanes still running: a
source that follows JAX keys advances only their keys, as ``vmap`` of a
``while_loop`` does.  Each descent iteration calls exactly one of
``neighborhood``, ``random_moves``, ``dense_swaps``, ``step`` and ``advance``.

``TorchDraws`` is the production source: one ``torch.Generator`` seeded from the
solver's seed string; ``state_dict``/``load_state_dict`` carry its state
through a checkpoint.  ``LaneSlice`` keeps one rank's lanes of a source that
draws for the whole population (the multi-device solvers).  A test-only source
that follows the JAX key tree exactly
lives with the tests, so that the port and the JAX package can be fed identical
draws and whole trajectories compared.
"""

from __future__ import annotations

from typing import NamedTuple, Protocol, Sequence

import torch

from constraint_solver_tpu_torch.utils.seeding import seed_string_to_generator


class PerturbDraws(NamedTuple):
    u_strat: torch.Tensor          # float32[P]    strategy draw: change the solution iff < 100/110
    n_alter: torch.Tensor          # int64[P]      how many positions change, in [1, hi]
    u: torch.Tensor                # float32[P, n] position draws: the n_alter smallest change
    new_rows: torch.Tensor | None  # int64[P, n]   the new values, in [0, values)


class NormalPerturbDraws(NamedTuple):
    u_strat: torch.Tensor  # float32[P]    change the point iff < 100/110
    n_alter: torch.Tensor  # int64[P]      how many dimensions change, in [0, n)
    u: torch.Tensor        # float32[P, n] the n_alter smallest draws change
    noise: torch.Tensor    # float32[P, n] standard normal noise


class CellPerturbDraws(NamedTuple):
    u_strat: torch.Tensor  # float32[P]       change the layout iff < 100/110
    n_alter: torch.Tensor  # int64[P]         how many boxes move, in [1, hi]
    u: torch.Tensor        # float32[P, n]    the n_alter smallest draws move
    cells: torch.Tensor    # float32[P, n, 2] uniform in [0, 1): the new cells


class RandomMoveDraws(NamedTuple):
    u_type: torch.Tensor   # float32[P, W] a move is a swap iff < 0.8
    d1: torch.Tensor       # int64[P, W]   first day, in [0, d)
    off: torch.Tensor      # int64[P, W]   offset of the second day, in [1, max(d, 2))
    new_emp: torch.Tensor  # int64[P, W]   ChangeDay's new employee, in [0, e)


class DenseSwapDraws(NamedTuple):
    rs_d1: torch.Tensor   # int64[P, n_rand] random swaps' first day, in [0, d)
    rs_off: torch.Tensor  # int64[P, n_rand] their offset, in [1, d)
    delta: torch.Tensor   # int64[P, n_off]  diagonal offsets, in [14, d)


class AcceptDraws(NamedTuple):
    elite_idx: torch.Tensor  # int64[P]  a uniformly chosen valid archive slot
    choice: torch.Tensor     # int64[P]  0 / 1 / 2 with probability weights / sum(weights)
    u: torch.Tensor          # float32[P] the Metropolis draw of annealing lanes


class PMCDraws(NamedTuple):
    u: torch.Tensor                # float32[P, A] damped acceptance draws
    kick_col: torch.Tensor         # int64[P]      a uniformly chosen conflicted column
    kick_row: torch.Tensor         # int64[P]      its new row, in [0, n)
    gumbel: torch.Tensor | None    # float32[P, n] column noise (sampled columns only)


class Draws(Protocol):
    population: int
    device: torch.device

    def permutation(self, n: int) -> torch.Tensor: ...

    def assignment(self, d: int, e: int) -> torch.Tensor: ...

    def uniform(self, shape: tuple, lo: float, hi: float) -> torch.Tensor: ...

    def round_keys(self) -> None: ...

    def perturb(self, n: int, hi: torch.Tensor, values: int | None) -> PerturbDraws: ...

    def perturb_normal(self, n: int) -> NormalPerturbDraws: ...

    def perturb_cells(self, n: int, hi: torch.Tensor) -> CellPerturbDraws: ...

    def neighborhood(
        self, n: int, amount: torch.Tensor, active: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]: ...

    def random_moves(self, w: int, d: int, e: int, active: torch.Tensor) -> RandomMoveDraws: ...

    def dense_swaps(self, n_rand: int, n_off: int, d: int, active: torch.Tensor) -> DenseSwapDraws: ...

    def step(self, lo: float, hi: float, active: torch.Tensor) -> torch.Tensor: ...

    def advance(self, active: torch.Tensor) -> None: ...

    def select_noise(self, w: int, active: torch.Tensor) -> torch.Tensor: ...

    def accept(self, elite_valid: torch.Tensor, weights: Sequence[float]) -> AcceptDraws: ...

    def reseed_pick(self, elite_valid: torch.Tensor) -> torch.Tensor: ...

    def pmc_step(
        self, n: int, a: int, conflicted: torch.Tensor, active: torch.Tensor, sampled: bool
    ) -> PMCDraws: ...

    def state_dict(self) -> dict: ...

    def load_state_dict(self, state: dict) -> None: ...


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

    def _ints(self, lo: int, hi: int, *shape: int) -> torch.Tensor:
        """Integers uniform in [lo, hi), [P, *shape]."""
        return torch.randint(
            lo, hi, (self.population, *shape), generator=self._gen, device=self._draw_device
        )

    def _gumbel(self, n: int) -> torch.Tensor:
        tiny = torch.finfo(torch.float32).tiny
        return -torch.log(-torch.log(self._rand(n).clamp_min(tiny)))

    def _out(self, *tensors: torch.Tensor):
        return tuple(t.to(self.device) for t in tensors)

    def permutation(self, n: int) -> torch.Tensor:
        (perm,) = self._out(torch.argsort(self._rand(n), dim=-1))
        return perm

    def assignment(self, d: int, e: int) -> torch.Tensor:
        (assign,) = self._out(self._ints(0, e, d))
        return assign

    def uniform(self, shape: tuple, lo: float, hi: float) -> torch.Tensor:
        (u,) = self._out(lo + (hi - lo) * self._rand(*shape))
        return u

    def round_keys(self) -> None:
        """Nothing to do: the generator's stream carries on."""

    def perturb(self, n: int, hi: torch.Tensor, values: int | None) -> PerturbDraws:
        u_strat = self._rand()
        n_alter = self._randint(1, hi)
        u = self._rand(n)
        out = self._out(u_strat, n_alter, u)
        if values is None:
            return PerturbDraws(*out, None)
        return PerturbDraws(*out, *self._out(self._ints(0, values, n)))

    def perturb_normal(self, n: int) -> NormalPerturbDraws:
        u_strat = self._rand()
        n_alter = self._ints(0, n)
        u = self._rand(n)
        noise = torch.randn(
            (self.population, n), generator=self._gen, device=self._draw_device, dtype=torch.float32
        )
        return NormalPerturbDraws(*self._out(u_strat, n_alter, u, noise))

    def perturb_cells(self, n: int, hi: torch.Tensor) -> CellPerturbDraws:
        u_strat = self._rand()
        n_alter = self._randint(1, hi)
        return CellPerturbDraws(*self._out(u_strat, n_alter, self._rand(n), self._rand(n, 2)))

    def neighborhood(self, n: int, amount: torch.Tensor, active: torch.Tensor):
        gumbel = self._gumbel(n)
        num_cols = self._randint(1, amount)
        return self._out(gumbel, num_cols)

    def random_moves(self, w: int, d: int, e: int, active: torch.Tensor) -> RandomMoveDraws:
        return RandomMoveDraws(*self._out(
            self._rand(w), self._ints(0, d, w), self._ints(1, max(d, 2), w), self._ints(0, e, w)
        ))

    def dense_swaps(self, n_rand: int, n_off: int, d: int, active: torch.Tensor) -> DenseSwapDraws:
        rs_d1 = self._ints(0, d, n_rand) if n_rand else self._empty()
        rs_off = self._ints(1, d, n_rand) if n_rand else self._empty()
        delta = self._ints(14, d, n_off) if n_off else self._empty()
        return DenseSwapDraws(*self._out(rs_d1, rs_off, delta))

    def _empty(self) -> torch.Tensor:
        return torch.zeros((self.population, 0), dtype=torch.int64, device=self._draw_device)

    def step(self, lo: float, hi: float, active: torch.Tensor) -> torch.Tensor:
        return self.uniform((), lo, hi)

    def advance(self, active: torch.Tensor) -> None:
        """Nothing to do: the generator's stream carries on."""

    def select_noise(self, w: int, active: torch.Tensor) -> torch.Tensor:
        (g,) = self._out(self._gumbel(w))
        return g

    def _valid_slot(self, elite_valid: torch.Tensor) -> torch.Tensor:
        """A uniformly chosen True slot of each lane's mask (0 if none)."""
        valid = elite_valid.to(self._draw_device)
        return torch.argmax(torch.where(valid, self._rand(valid.shape[-1]), -1.0), dim=-1)

    def accept(self, elite_valid: torch.Tensor, weights: Sequence[float]) -> AcceptDraws:
        elite_idx = self._valid_slot(elite_valid)
        w = torch.tensor(weights, dtype=torch.float64, device=self._draw_device)
        cum = torch.cumsum(w / w.sum(), 0)[:-1]
        choice = (self._rand(1, dtype=torch.float64) >= cum).sum(-1)
        return AcceptDraws(*self._out(elite_idx, choice, self._rand()))

    def reseed_pick(self, elite_valid: torch.Tensor) -> torch.Tensor:
        (idx,) = self._out(self._valid_slot(elite_valid))
        return idx

    def pmc_step(self, n: int, a: int, conflicted: torch.Tensor, active: torch.Tensor, sampled: bool):
        u = self._rand(a)
        conf = conflicted.to(self._draw_device)
        kick_col = torch.argmax(torch.where(conf, self._rand(n), -1.0), dim=-1)
        out = self._out(u, kick_col, self._ints(0, n))
        gumbel = self._out(self._gumbel(n))[0] if sampled else None
        return PMCDraws(*out, gumbel)

    def state_dict(self) -> dict:
        """The generator's state, a CPU uint8 tensor."""
        return {"generator": self._gen.get_state()}

    def load_state_dict(self, state: dict) -> None:
        self._gen.set_state(torch.as_tensor(state["generator"], dtype=torch.uint8).cpu())


class LaneSlice:
    """The draws of lanes [lo, hi) of a source that draws for the whole
    population: the multi-device solvers' draws per rank.

    Every rank draws what the whole population would and keeps its lanes, so a
    rank's lanes see exactly the numbers a one-device run from the same seed
    gives them (a sharded run equals the dense run bit for bit, the world-agreed
    loops of ``parallel/mesh.py`` keeping the number of draws equal), ranks that
    hold the same lanes (a neighborhood or date group) see identical draws, and
    a checkpoint needs one rank's source state.  A lane-shaped argument is
    embedded into a whole-population one whose other lanes hold a valid filler
    (every draw of a lane depends only on that lane's arguments)."""

    def __init__(self, inner, lo: int, hi: int):
        if not 0 <= lo < hi <= inner.population:
            raise ValueError(f"lanes [{lo}, {hi}) of a {inner.population}-lane source")
        self.inner, self.lo, self.hi = inner, lo, hi
        self.population = hi - lo
        self.device = inner.device

    def _whole(self, x: torch.Tensor, fill) -> torch.Tensor:
        out = torch.full((self.inner.population, *x.shape[1:]), fill, dtype=x.dtype, device=x.device)
        out[self.lo : self.hi] = x
        return out

    def _mine(self, out):
        if out is None:
            return None
        if isinstance(out, tuple):
            parts = [self._mine(x) for x in out]
            return type(out)(*parts) if hasattr(out, "_fields") else tuple(parts)
        return out[self.lo : self.hi]

    def permutation(self, n: int) -> torch.Tensor:
        return self._mine(self.inner.permutation(n))

    def assignment(self, d: int, e: int) -> torch.Tensor:
        return self._mine(self.inner.assignment(d, e))

    def uniform(self, shape: tuple, lo: float, hi: float) -> torch.Tensor:
        return self._mine(self.inner.uniform(shape, lo, hi))

    def round_keys(self) -> None:
        self.inner.round_keys()

    def perturb(self, n: int, hi: torch.Tensor, values: int | None) -> PerturbDraws:
        return self._mine(self.inner.perturb(n, self._whole(hi, 1), values))

    def perturb_normal(self, n: int) -> NormalPerturbDraws:
        return self._mine(self.inner.perturb_normal(n))

    def perturb_cells(self, n: int, hi: torch.Tensor) -> CellPerturbDraws:
        return self._mine(self.inner.perturb_cells(n, self._whole(hi, 1)))

    def neighborhood(self, n: int, amount: torch.Tensor, active: torch.Tensor):
        return self._mine(self.inner.neighborhood(n, self._whole(amount, 1), self._whole(active, False)))

    def random_moves(self, w: int, d: int, e: int, active: torch.Tensor) -> RandomMoveDraws:
        return self._mine(self.inner.random_moves(w, d, e, self._whole(active, False)))

    def dense_swaps(self, n_rand: int, n_off: int, d: int, active: torch.Tensor) -> DenseSwapDraws:
        return self._mine(self.inner.dense_swaps(n_rand, n_off, d, self._whole(active, False)))

    def step(self, lo: float, hi: float, active: torch.Tensor) -> torch.Tensor:
        return self._mine(self.inner.step(lo, hi, self._whole(active, False)))

    def advance(self, active: torch.Tensor) -> None:
        self.inner.advance(self._whole(active, False))

    def select_noise(self, w: int, active: torch.Tensor) -> torch.Tensor:
        return self._mine(self.inner.select_noise(w, self._whole(active, False)))

    def accept(self, elite_valid: torch.Tensor, weights: Sequence[float]) -> AcceptDraws:
        return self._mine(self.inner.accept(self._whole(elite_valid, True), weights))

    def reseed_pick(self, elite_valid: torch.Tensor) -> torch.Tensor:
        return self._mine(self.inner.reseed_pick(self._whole(elite_valid, True)))

    def pmc_step(self, n: int, a: int, conflicted: torch.Tensor, active: torch.Tensor, sampled: bool) -> PMCDraws:
        return self._mine(
            self.inner.pmc_step(n, a, self._whole(conflicted, True), self._whole(active, False), sampled)
        )

    def state_dict(self) -> dict:
        return self.inner.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state)
