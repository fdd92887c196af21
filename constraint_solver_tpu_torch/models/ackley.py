"""Ackley test-function domain (port of ``constraint_solver_tpu/models/ackley.py``).

Same semantics as the JAX package:

- init: uniform in [-32.768, 32.768]^d;
- neighborhood: one step size ~ U[min_move, max_move) per descent iteration
  and lane, candidates x_i ± step for every dimension (2d moves);
- perturbation: w.p. 100/110 add N(0, 1) to a random subset of n_alter ~ U[0, d)
  dimensions, clamped to the box; w.p. 10/110 do nothing;
- is_best: |f(x)| <= epsilon_best.

Every function takes lane-batched tensors: a point is float32[P, d].

Divergences from the JAX package:

- **Implicit moves.** ``Neighborhood.moves`` is the [P, 2d] tensor of new
  values; candidate ``idx`` changes dimension ``idx % d``.
- **Draws.** The step comes from ``draws.step`` and the perturbation from
  ``draws.perturb_normal`` (``utils/draws.py``).
- **Last-bit differences in f.** ``cos``, ``exp`` and ``sqrt`` in PyTorch and
  in XLA may differ in the last bit, so scores agree with the JAX package to
  about 1e-6 relative, not bit for bit.  Positions and fingerprints (the bit
  patterns of the points) follow the same arithmetic and agree exactly while
  no two candidates are that close.

The problem is ``capturable`` (``core/problem.py``): on the card the solvers
replay its descent iterations as CUDA graphs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from constraint_solver_tpu_torch.core.problem import Neighborhood, Problem, replayable
from constraint_solver_tpu_torch.ops.fingerprint import fingerprint_f32, fp_update
from constraint_solver_tpu_torch.ops.lex import make_score

X_MIN, X_MAX = -32.768, 32.768
_A, _B = 20.0, 0.2
_C = 2.0 * math.pi


def ackley_np(x: np.ndarray, a: float = _A, b: float = _B, c: float = _C) -> float:
    """float64 host Ackley over the last axis (the JAX package's ``ackley_np``)."""
    x = np.asarray(x, np.float64)
    d = x.shape[-1]
    sq = np.sum(x * x, axis=-1) / d
    cs = np.sum(np.cos(c * x), axis=-1) / d
    return -a * np.exp(-b * np.sqrt(sq)) - np.exp(cs) + a + math.e


def ackley(x: torch.Tensor, a: float = _A, b: float = _B, c: float = _C) -> torch.Tensor:
    """float32 Ackley over the last axis.  Divisions are by a tensor filled on
    ``x``'s device: CUDA multiplies by the reciprocal of a Python scalar
    divisor, and a tensor made from host data is a copy a CUDA graph cannot
    capture."""
    d = torch.full((), x.shape[-1], dtype=x.dtype, device=x.device)
    sq = (x * x).sum(dim=-1) / d
    cs = torch.cos(c * x).sum(dim=-1) / d
    return -a * torch.exp(-b * torch.sqrt(sq)) - torch.exp(cs) + a + math.e


def make_ackley_problem(
    dimensions: int,
    min_move_size: float = 1e-3,
    max_move_size: float = 0.5,
    epsilon_best: float = 1e-2,
) -> Problem:
    d = dimensions

    def init(draws):
        return draws.uniform((d,), X_MIN, X_MAX)

    def score(x):
        return make_score(ackley(x))

    def is_best(s):
        return s[..., 0].abs() <= epsilon_best

    def neighborhood(x, _cur_score, draws, active):
        step = draws.step(min_move_size, max_move_size, active)  # [P]
        eye = torch.eye(d, device=x.device)
        deltas = torch.cat([eye, -eye]) * step[:, None, None]  # [P, 2d, d]
        scores = make_score(ackley(x[:, None, :] + deltas))
        new_vals = torch.cat([x + step[:, None], x - step[:, None]], dim=1)  # [P, 2d]
        valid = torch.ones(new_vals.shape, dtype=torch.bool, device=x.device)
        return Neighborhood(scores=scores, moves=new_vals, valid=valid)

    def move_fp(x, cur_fp, new_vals, idx):
        flat = (idx.shape[0], -1)
        dim = idx % d
        old = x.gather(1, dim.reshape(flat)).view(idx.shape)
        new = new_vals.gather(1, idx.reshape(flat)).view(idx.shape)
        fp = cur_fp.view(cur_fp.shape[0], *(1,) * (idx.dim() - 1), 2)
        return fp_update(fp, dim, old.view(torch.int32), new.view(torch.int32))

    def apply_move(x, new_vals, idx):
        return x.scatter(1, (idx % d)[:, None], new_vals.gather(1, idx[:, None]))

    def perturb(x, _is_elite, draws):
        dr = draws.perturb_normal(d)
        do_change = dr.u_strat < (100.0 / 110.0)
        kth = torch.sort(dr.u, dim=-1).values.gather(1, (dr.n_alter - 1).clamp_min(0)[:, None])
        kth = torch.where(dr.n_alter[:, None] > 0, kth, -1.0)
        alter = dr.u <= kth
        perturbed = torch.clamp(x + dr.noise, X_MIN, X_MAX)
        return torch.where(do_change[:, None] & alter, perturbed, x)

    return Problem(
        name=f"ackley-{d}d",
        init=init,
        score=score,
        is_best=is_best,
        fingerprint=fingerprint_f32,
        neighborhood=replayable(neighborhood),
        move_fp=move_fp,
        apply_move=apply_move,
        perturb=perturb,
        width=2 * d,
        capturable=True,
    )
