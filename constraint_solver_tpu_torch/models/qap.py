"""Quadratic Assignment Problem (port of ``constraint_solver_tpu/models/qap.py``).

Same semantics as the JAX package: place n facilities on n locations
(permutation ``p``) minimizing

    cost(p) = sum_{i,j} F[i, j] * D[p[i], p[j]]

with symmetric flow F and distance D (zero diagonals).  With G = D[p][:, p]
and H = F G, the swap delta of every facility pair (a, b) is

    delta[a, b] = 2 * (H[a,b] + H[b,a] - H[a,a] - H[b,b] + 2 * F[a,b] * G[a,b])

so one [n, n] x [n, n] product per lane scores all n(n-1)/2 swaps.  Three
proposers, as in the JAX package:

- dense: every swap a < b as one [n²] candidate list;
- ``compact=True``: one candidate per facility row, its best partner b > a (a
  row-wise min and first-index argmin of the same block).  The lexicographic
  winner is the dense winner's;
- ``incremental=True``: the state carries G and H (``QAPState``); a swap updates
  them exactly instead of rebuilding them, and only the perturbation (once per
  round) rebuilds H with the product.  Selection is the compact row minimum.

Every function takes lane-batched tensors: a permutation is int64[P, n], G and
H are float32[P, n, n].

Divergences from the JAX package:

- **G by a gather.** G = D[p][:, p] is two gathers, not the two one-hot
  matmuls of the TPU code: the same integers, and no product is involved.
- **H in full FP32.** ``H = F @ G`` is ``torch.matmul`` in float32; the module
  never enables TF32 (PyTorch's default leaves it off for matmuls).  Every entry
  of F, D, G and H is an integer below 2^24, so the product is exact.
- **Incremental updates by column differences.** The JAX ``st.g @ d`` and
  ``st.h @ d`` with d = e_a - e_b are the column differences ``G[:, a] - G[:,
  b]``; G' = P G P is the swap of rows and columns a and b of G; H' is the
  rank-1 update with the two column fix-ups of the JAX code.  All exact.
- **The incremental move in place, the best by its permutation.** The JAX
  package's descent selects the whole state tree (p, G, H) per lane, for the
  step, for the best and for the lanes still running, and XLA fuses those
  selects into the update.  Eagerly or in a CUDA graph each select of G or H is
  a pass of its own over [P, n, n] floats, ten an iteration.  So the incremental
  problem has ``in_place`` (``core/problem.py``): the move is written into the
  carry's own G, H and p, with b := a (a swap with itself) in the lanes that do
  not step, and the descent carries its best as p and rebuilds G and H from it
  once, at its end.  The answers
  are unchanged bit for bit: the lanes outside the mask keep their G, H and p,
  and G and H are functions of p whose every entry is an integer below 2^24,
  so the rebuilt G and H equal the carried ones.
- **The row minimum is a kernel (K1).** The compact and incremental
  neighborhoods reduce the swap-delta block to each row's best partner with
  ``ops/qap_row_min.py`` ``qap_swap_row_min``: on the card one pass of the
  hand-written CUDA kernel ``csrc/qap_row_min.cu`` over H, G and F, which
  stands for the fused delta + min + argmin that XLA makes of the JAX
  package's ``neighborhood_compact`` and ``neighborhood_inc``
  (``constraint_solver_tpu/models/qap.py:202-224`` and ``:325-341``); on the
  CPU its plain version, the eager expression of ``swap_deltas``, the mask and
  ``torch.min``.  The two are equal bit for bit.  The dense neighborhood keeps
  ``swap_deltas`` and the sharded one its row-block form as torch ops: they
  take no row minimum.
- **Implicit moves.** ``QAPMoves(partner, n)``: a dense candidate ``idx`` is
  the swap (idx // n, idx % n); a compact one is (idx, partner[:, idx]).  No
  [P, n²] index arrays are built.
- **Symmetry is checked (ROADMAP C2).** ``make_qap_problem`` raises
  ``ValueError`` when F or D is not symmetric or has a nonzero diagonal.  The
  JAX package accepts any matrix, and its incremental update and its delta
  formula then silently give wrong scores.
- **Compact plus noisy selection (ROADMAP C4), as in the JAX package.** With
  ``select_topk > 1`` the engine samples among the n per-row minima, not among
  the global top-k swaps (several of which may share a row).  Tabu retries of
  pick-then-check likewise see the best swap of each other row.
- ``QAPSpec`` holds numpy arrays or nested tuples; the JAX package's tuples
  exist to be hashable for its ``lru_cache`` and take seconds to build at
  n = 4096.

Without ``nbr_axis`` every mode is ``capturable`` (``core/problem.py``): on the
card the solvers replay its descent iterations as CUDA graphs.  F and D reach
the device at the first ``score`` there, before any capture, and every product
is exact, so a captured GEMM gives the eager one's integers whatever its
algorithm.

The sharded neighborhood (``nbr_axis``, ``nbr_shards``, ``nbr_keep``), as in the
JAX package: each rank of the active mesh's ``nbr_axis`` scores its n/shards
row block of the swap-delta matrix (two [n/S, n] x [n, n] products per lane,
the rows of H and of Hᵀ = G F), gathers the [n] diagonal of H over the axis,
keeps its ``nbr_keep`` best swaps a < b in ``lax.top_k`` order and gathers
(score, a, b, valid) over the axis in one collective; the moves are explicit
(``QAPPairs``).  n must divide over the shards, and ``incremental`` excludes
``nbr_axis`` (both ``ValueError``, as there).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from constraint_solver_tpu_torch.core.problem import InPlace, Neighborhood, Problem, replayable
from constraint_solver_tpu_torch.ops import qap_row_min as row_min_ops
from constraint_solver_tpu_torch.ops.fingerprint import fingerprint_i32, hash_xor
from constraint_solver_tpu_torch.ops.lex import make_score
from constraint_solver_tpu_torch.parallel.mesh import active_axis, all_gather, gather_best


class QAPSpec(NamedTuple):
    flow: object  # [n][n] integers: numpy array or nested tuples
    dist: object

    @staticmethod
    def random(n: int, seed: int = 0, max_val: int = 10) -> "QAPSpec":
        """A random symmetric instance with zero diagonals (the JAX package's
        generator: the same numpy draws, so the same instance)."""
        rng = np.random.default_rng(seed)

        def sym(m):
            m = np.triu(m, 1)
            return m + m.T

        flow = sym(rng.integers(0, max_val + 1, (n, n)))
        dist = sym(rng.integers(0, max_val + 1, (n, n)))
        return QAPSpec(flow=flow, dist=dist)

    def arrays(self):
        return np.asarray(self.flow, np.float32), np.asarray(self.dist, np.float32)


def qap_cost_naive(flow: np.ndarray, dist: np.ndarray, p: np.ndarray) -> float:
    """Host oracle: direct double sum."""
    return float(np.sum(flow * dist[np.ix_(p, p)]))


class QAPState(NamedTuple):
    """State of the ``incremental=True`` proposer, each [P, ...]."""

    p: torch.Tensor  # int64[P, n]
    g: torch.Tensor  # float32[P, n, n], exactly D[p][:, p]
    h: torch.Tensor  # float32[P, n, n], F @ G


class QAPMoves(NamedTuple):
    """Implicit swaps: with ``partner`` None, candidate ``idx`` swaps (idx // n,
    idx % n); else (idx, partner[:, idx])."""

    partner: torch.Tensor | None  # int64[P, n] best partner per row (compact)
    n: int


class QAPPairs(NamedTuple):
    """Explicit swaps (the sharded neighborhood's gathered list): ``idx``
    swaps facilities ``a[idx]`` and ``b[idx]``."""

    a: torch.Tensor  # int64[P, W]
    b: torch.Tensor  # int64[P, W]


def _check_symmetric(name: str, m: np.ndarray) -> None:
    if not np.array_equal(m, m.T) or np.any(np.diagonal(m) != 0):
        raise ValueError(f"QAP {name} matrix must be symmetric with a zero diagonal")


def make_qap_problem(
    spec: QAPSpec,
    nbr_axis: str | None = None,
    nbr_shards: int = 1,
    nbr_keep: int = 64,
    compact: bool = False,
    incremental: bool = False,
) -> Problem:
    """Build the QAP problem (see the module docstring for the proposers and
    the sharded neighborhood)."""
    flow_np, dist_np = spec.arrays()
    _check_symmetric("flow", flow_np)
    _check_symmetric("dist", dist_np)
    n = flow_np.shape[0]
    if nbr_axis is not None and n % nbr_shards != 0:
        raise ValueError(f"n={n} must divide over {nbr_shards} nbr shards")
    if incremental and nbr_axis is not None:
        raise ValueError("incremental excludes nbr_axis sharding")
    rows_per = n // nbr_shards
    tables: dict[torch.device, tuple] = {}

    def mats(device: torch.device):
        """(F, D) on ``device``, made once per device."""
        if device not in tables:
            tables[device] = (torch.from_numpy(flow_np).to(device), torch.from_numpy(dist_np).to(device))
        return tables[device]

    def permuted_dist(p):
        """G = D[p][:, p] for every lane, [P, n, n]: a row gather, then a
        column gather with the permutation broadcast over rows."""
        dist = mats(p.device)[1]
        rows = dist[p]
        return rows.gather(2, p[:, None, :].expand(rows.shape))

    def gh_from_p(p):
        g = permuted_dist(p)
        return g, torch.matmul(mats(p.device)[0], g)

    def row_min(h, g, cur_score):
        """The compact list: each row's best partner b > a, from K1 on the
        card (``ops/qap_row_min.py``), its plain version on the CPU."""
        rmin, rarg = row_min_ops.qap_swap_row_min(h, g, mats(h.device)[0], cur_score[:, 0])
        return Neighborhood(
            scores=make_score(rmin),
            moves=QAPMoves(rarg, n),
            valid=torch.isfinite(rmin),  # row n-1 has no partner b > a
            n_valid=torch.full((h.shape[0],), n - 1, dtype=torch.int64, device=h.device),
        )

    def init(draws):
        return draws.permutation(n)

    def score(p):
        return make_score((mats(p.device)[0] * permuted_dist(p)).sum(dim=(1, 2)))

    def is_best(s):
        return torch.zeros_like(s[..., 0], dtype=torch.bool)  # optimum unknown in general

    def neighborhood(p, cur_score, draws, active):
        draws.advance(active)
        g, h = gh_from_p(p)
        cand = cur_score[:, 0, None, None] + row_min_ops.swap_deltas(h, g, mats(p.device)[0])
        iota = torch.arange(n, device=p.device)
        valid = (iota[:, None] < iota[None, :]).reshape(1, n * n).expand(p.shape[0], n * n)
        return Neighborhood(
            scores=make_score(cand.reshape(p.shape[0], n * n)),
            moves=QAPMoves(None, n),
            valid=valid,
            n_valid=torch.full((p.shape[0],), n * (n - 1) // 2, dtype=torch.int64, device=p.device),
        )

    def neighborhood_compact(p, cur_score, draws, active):
        draws.advance(active)
        g, h = gh_from_p(p)
        return row_min(h, g, cur_score)

    def neighborhood_sharded(p, cur_score, draws, active):
        draws.advance(active)
        axis = active_axis(nbr_axis, nbr_shards)
        flow = mats(p.device)[0]
        g = permuted_dist(p)
        r0 = axis.index * rows_per
        f_rows = flow[r0 : r0 + rows_per]                   # [R, n]
        g_rows = g[:, r0 : r0 + rows_per]                   # [P, R, n]
        h_rows = torch.matmul(f_rows, g)                    # H's rows
        ht_rows = torch.matmul(g_rows, flow)                # Hᵀ's rows: G F, F and G symmetric
        hd_local = (f_rows * g_rows).sum(-1)                # H[a, a] of my rows
        hd = all_gather(hd_local, axis, dim=1)              # [P, n]
        delta = 2.0 * (h_rows + ht_rows - hd_local[:, :, None] - hd[:, None, :] + 2.0 * f_rows * g_rows)
        lanes = p.shape[0]
        cand = (cur_score[:, 0, None, None] + delta).reshape(lanes, rows_per * n)
        iota = torch.arange(n, device=p.device)
        a_idx = (r0 + torch.arange(rows_per, device=p.device))[:, None].expand(rows_per, n).reshape(-1)
        b_idx = iota.repeat(rows_per)
        valid = (a_idx < b_idx).expand(lanes, -1)
        cand, valid, a_g, b_g = gather_best(
            cand, valid, min(nbr_keep, rows_per * n), lambda keep: (a_idx[keep], b_idx[keep]), axis
        )
        return Neighborhood(scores=make_score(cand), moves=QAPPairs(a_g, b_g), valid=valid)

    def decode(moves, idx):
        """Facility pairs (a, b) of flat candidates idx[P, ...]."""
        if isinstance(moves, QAPPairs):
            flat = idx.reshape(idx.shape[0], -1)
            return moves.a.gather(1, flat).view(idx.shape), moves.b.gather(1, flat).view(idx.shape)
        if moves.partner is None:
            return idx // n, idx % n
        flat = idx.reshape(idx.shape[0], -1)
        return idx, moves.partner.gather(1, flat).view(idx.shape)

    def swap_fp(p, cur_fp, moves, idx):
        a, b = decode(moves, idx)
        flat = (idx.shape[0], -1)
        pa = p.gather(1, a.reshape(flat)).view(idx.shape)
        pb = p.gather(1, b.reshape(flat)).view(idx.shape)
        fp = cur_fp.view(cur_fp.shape[0], *(1,) * (idx.dim() - 1), 2)
        return hash_xor(fp, ((a, pa), (a, pb), (b, pb), (b, pa)))  # one K2a launch for both positions

    def swap(p, a, b):
        lane = torch.arange(p.shape[0], device=p.device)
        out = p.clone()
        out[lane, a] = p[lane, b]
        out[lane, b] = p[lane, a]
        return out

    def apply_move(p, moves, idx):
        return swap(p, *decode(moves, idx))

    def perturb(p, is_elite, draws):
        """Random subset rotation: k ~ U[1, n/20] near elites, else U[1, n/2],
        positions (the k smallest draws) pass their values on cyclically."""
        hi = torch.where(is_elite, max(1, n // 20), max(1, n // 2))
        dr = draws.perturb(n, hi, None)
        do_change = dr.u_strat < (100.0 / 110.0)
        kth = torch.sort(dr.u, dim=-1).values.gather(1, (dr.n_alter - 1)[:, None])
        sel = dr.u <= kth
        # The selected slots first, in draw order; each takes the value of the
        # previous one and the first takes the last's.
        order = torch.argsort(torch.where(sel, dr.u, torch.inf), dim=-1, stable=True)
        vals = p.gather(1, order)
        iota = torch.arange(n, device=p.device)
        rotated = torch.where(iota < dr.n_alter[:, None], torch.roll(vals, 1, dims=1), vals)
        first = vals.gather(1, (dr.n_alter - 1).clamp_min(0)[:, None])
        rotated[:, :1] = torch.where(dr.n_alter[:, None] > 0, first, rotated[:, :1])
        p_new = p.scatter(1, order, rotated)
        return torch.where(do_change[:, None], p_new, p)

    if incremental:

        def init_inc(draws):
            p = init(draws)
            return QAPState(p, *gh_from_p(p))

        def score_inc(st):
            return make_score((mats(st.g.device)[0] * st.g).sum(dim=(1, 2)))

        def neighborhood_inc(st, cur_score, draws, active):
            draws.advance(active)
            return row_min(st.h, st.g, cur_score)

        def apply_move_inc(st, moves, idx):
            # With d = e_a - e_b: gu = G d, fu = F d, hu = H d (column
            # differences) and s = d.T G d.  G' = P G P swaps rows and columns
            # a and b; H' = H - fu gu.T + (s fu - hu) e_a.T + (hu - s fu) e_b.T.
            a, b = decode(moves, idx)
            flow = mats(st.g.device)[0]
            lane = torch.arange(st.p.shape[0], device=st.p.device)
            gu = st.g[lane, :, a] - st.g[lane, :, b]
            hu = st.h[lane, :, a] - st.h[lane, :, b]
            fu = flow[:, a].T - flow[:, b].T
            s = gu[lane, a] - gu[lane, b]
            g2 = st.g.clone()
            g2[lane, a], g2[lane, b] = st.g[lane, b], st.g[lane, a]
            col_a, col_b = g2[lane, :, a], g2[lane, :, b]
            g2[lane, :, a], g2[lane, :, b] = col_b, col_a
            h2 = torch.addcmul(st.h, fu[:, :, None], gu[:, None, :], value=-1.0)
            fix = s[:, None] * fu - hu
            h2[lane, :, a] += fix
            h2[lane, :, b] -= fix
            return QAPState(swap(st.p, a, b), g2, h2)

        def move_in_place(st, moves, idx, mask):
            # apply_move_inc in the lanes of mask, written into st's own
            # buffers in the same order.  Every other lane swaps a with itself:
            # its gu, hu and fu are +0, so H gains -(+0 * +0) = -0, which
            # leaves every float as it was (±0 too), and its column fixes keep
            # the old columns.
            a, b = decode(moves, idx)
            b = torch.where(mask, b, a)
            flow = mats(st.g.device)[0]
            lane = torch.arange(st.p.shape[0], device=st.p.device)
            gu = st.g[lane, :, a] - st.g[lane, :, b]
            hu = st.h[lane, :, a] - st.h[lane, :, b]
            fu = flow[:, a].T - flow[:, b].T
            s = gu[lane, a] - gu[lane, b]
            for m, at_a, at_b in ((st.g, (lane, a), (lane, b)),                       # rows
                                  (st.g, (lane, slice(None), a), (lane, slice(None), b)),  # columns
                                  (st.p, (lane, a), (lane, b))):
                va, vb = m[at_a], m[at_b]
                m[at_a], m[at_b] = vb, va
            st.h.addcmul_(fu[:, :, None], gu[:, None, :], value=-1.0)
            fix = s[:, None] * fu - hu
            keep = ~mask[:, None]
            col_a = st.h[lane, :, a]
            st.h[lane, :, a] = torch.where(keep, col_a, col_a + fix)
            col_b = st.h[lane, :, b]
            st.h[lane, :, b] = torch.where(keep, col_b, col_b - fix)

        def perturb_inc(st, is_elite, draws):
            # Perturb the permutation, then rebuild G and H (once per round).
            p2 = perturb(st.p, is_elite, draws)
            return QAPState(p2, *gh_from_p(p2))

        return Problem(
            name=f"qap-{n}-inc",
            init=init_inc,
            score=score_inc,
            is_best=is_best,
            fingerprint=lambda st: fingerprint_i32(st.p),
            neighborhood=replayable(neighborhood_inc),
            move_fp=lambda st, cur_fp, moves, idx: swap_fp(st.p, cur_fp, moves, idx),
            apply_move=apply_move_inc,
            perturb=perturb_inc,
            width=n * n,
            capturable=True,
            in_place=InPlace(move_in_place, key=lambda st: st.p,
                             rebuild=lambda p: QAPState(p, *gh_from_p(p))),
        )

    if nbr_axis is not None:
        nbr_fn = neighborhood_sharded
    else:
        nbr_fn = neighborhood_compact if compact else neighborhood
    return Problem(
        name=f"qap-{n}" + ("-compact" if compact and nbr_axis is None else ""),
        init=init,
        score=score,
        is_best=is_best,
        fingerprint=fingerprint_i32,
        neighborhood=replayable(nbr_fn),
        move_fp=swap_fp,
        apply_move=apply_move,
        perturb=perturb,
        width=n * n,
        capturable=nbr_axis is None,
    )
