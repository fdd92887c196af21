"""Diagram layout: boxes on a grid (port of ``constraint_solver_tpu/models/diagram_layout.py``).

Same semantics as the JAX package: place B axis-aligned boxes of integer sizes
on a G x G grid of cells (state ``pos``: the top-left cell of each box),
minimizing lexicographically

    hard = number of overlapping box pairs
    soft = total Manhattan distance between the centers of connected boxes

The whole B x G x G neighborhood ("relocate box b to cell (x, y)") is scored by
delta evaluation: the overlaps of a relocated box factor into x and y interval
tests, so ``new_overlaps[b, x, y] = sum_j ox[b, j, x] * oy[b, j, y]`` is one
batched product, and the connector lengths separate per axis.

Every function takes lane-batched tensors: ``pos`` is int64[P, B, 2].

Divergences from the JAX package:

- **Positions are int64**, PyTorch's index type (int32 in the JAX package).
- **Implicit moves.** Candidate ``idx`` relocates box ``idx // G²`` to cell
  ``((idx // G) % G, idx % G)``; no [B·G²] index arrays are built.
- **Products in FP32.** The overlap product and the connector contractions are
  ``torch.einsum`` in float32 over 0/1 and small-integer operands: exact in
  any summation order, as on the TPU.
- **Draws** come from a ``Draws`` source (``utils/draws.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from constraint_solver_tpu_torch.core.problem import Neighborhood, Problem
from constraint_solver_tpu_torch.ops.fingerprint import fingerprint_i32, fp_update
from constraint_solver_tpu_torch.ops.lex import make_score


class DiagramLayoutSpec(NamedTuple):
    """B boxes with integer cell sizes, E connectors, on a G x G grid.

    sizes: ((w, h), ...) per box, in grid cells (>= 1).
    edges: ((a, b), ...) connector endpoints (box indices).
    grid:  G — box b at (x, y) occupies [x, x + w_b) x [y, y + h_b).
    """

    sizes: tuple
    edges: tuple
    grid: int

    @staticmethod
    def random(n_boxes: int, n_edges: int, grid: int, seed: int = 0, max_size: int = 3) -> "DiagramLayoutSpec":
        """Random instance: uniform box sizes, distinct random connectors (the
        JAX package's generator: the same numpy draws, so the same instance)."""
        rng = np.random.default_rng(seed)
        sizes = rng.integers(1, max_size + 1, (n_boxes, 2))
        pairs = [(a, b) for a in range(n_boxes) for b in range(a + 1, n_boxes)]
        take = min(n_edges, len(pairs))
        chosen = rng.choice(len(pairs), size=take, replace=False)
        edges = tuple(pairs[i] for i in sorted(chosen))
        return DiagramLayoutSpec(sizes=tuple(map(tuple, sizes.tolist())), edges=edges, grid=grid)

    @staticmethod
    def chain(n_boxes: int, grid: int, size: int = 2) -> "DiagramLayoutSpec":
        """Uniform boxes connected in a path."""
        return DiagramLayoutSpec(
            sizes=tuple((size, size) for _ in range(n_boxes)),
            edges=tuple((i, i + 1) for i in range(n_boxes - 1)),
            grid=grid,
        )

    def arrays(self):
        sizes = np.asarray(self.sizes, np.int32)  # [B, 2]
        edges = np.asarray(self.edges, np.int32).reshape(-1, 2) if self.edges else np.zeros((0, 2), np.int32)
        return sizes, edges


def layout_score_naive(spec: DiagramLayoutSpec, pos: np.ndarray):
    """Host oracle: direct O(B^2 + E) rescore of one layout. Returns (hard, soft)."""
    sizes, edges = spec.arrays()
    pos = np.asarray(pos)
    b = len(sizes)
    hard = 0
    for i in range(b):
        for j in range(i + 1, b):
            ox = (pos[i, 0] < pos[j, 0] + sizes[j, 0]) and (pos[j, 0] < pos[i, 0] + sizes[i, 0])
            oy = (pos[i, 1] < pos[j, 1] + sizes[j, 1]) and (pos[j, 1] < pos[i, 1] + sizes[i, 1])
            hard += int(ox and oy)
    centers = pos * 2 + sizes  # doubled centers, exact in ints
    soft = 0.0
    for a, c in edges:
        soft += abs(int(centers[a, 0]) - int(centers[c, 0])) + abs(int(centers[a, 1]) - int(centers[c, 1]))
    return float(hard), float(soft) / 2.0


def make_diagram_layout_problem(spec: DiagramLayoutSpec) -> Problem:
    sizes_np, edges_np = spec.arrays()
    n_boxes = sizes_np.shape[0]
    grid = spec.grid
    if np.any(sizes_np > grid):
        raise ValueError("box larger than grid")
    # Symmetric connector-multiplicity matrix A[i, j].
    adj_np = np.zeros((n_boxes, n_boxes), np.float32)
    for a, c in edges_np:
        adj_np[a, c] += 1.0
        adj_np[c, a] += 1.0
    tables: dict[torch.device, tuple] = {}

    def consts(device: torch.device):
        """(sizes int64[B, 2], adj float32[B, B], max_pos int64[B, 2], cells
        int64[G]) on ``device``, made once per device."""
        if device not in tables:
            sizes = torch.from_numpy(sizes_np).long().to(device)
            tables[device] = (
                sizes,
                torch.from_numpy(adj_np).to(device),
                grid - sizes,  # highest legal top-left cell per box and axis
                torch.arange(grid, device=device),
            )
        return tables[device]

    def centers2(pos, sizes):
        """Doubled box centers (exact integers), float32[P, B, 2]."""
        return (pos * 2 + sizes).float()

    def overlap_pairs(pos, sizes):
        """bool[P, B, B] pair overlap matrix (diagonal False)."""
        hi = pos + sizes
        ov = (pos[:, :, None, :] < hi[:, None, :, :]) & (pos[:, None, :, :] < hi[:, :, None, :])
        eye = torch.eye(n_boxes, dtype=torch.bool, device=pos.device)
        return ov[..., 0] & ov[..., 1] & ~eye

    def edge_lengths(c2, adj):
        """Doubled connector length of each box, float32[P, B]."""
        dxy = (c2[:, :, None, :] - c2[:, None, :, :]).abs().sum(-1)
        return (adj * dxy).sum(-1)

    def score(pos):
        sizes, adj, _, _ = consts(pos.device)
        hard = overlap_pairs(pos, sizes).sum(dim=(1, 2)).float() / 2
        soft = edge_lengths(centers2(pos, sizes), adj).sum(-1) / 4.0  # pairs twice, doubled centers
        return make_score(hard, soft)

    def init(draws):
        u = draws.uniform((n_boxes, 2), 0.0, 1.0)
        return (u * (consts(u.device)[2] + 1).float()).long()

    def is_best(s):
        return torch.zeros_like(s[..., 0], dtype=torch.bool)  # soft optimum unknown in general

    def fingerprint(pos):
        return fingerprint_i32(pos.reshape(pos.shape[0], -1))

    def neighborhood(pos, cur_score, draws, active):
        draws.advance(active)
        sizes, adj, max_pos, cells = consts(pos.device)
        lo = pos.float()
        hi = (pos + sizes).float()
        cf = cells.float()
        # ox[p, b, j, c]: box b placed at coordinate c overlaps box j on x.
        c_ = cf[None, None, None, :]
        w = sizes[:, 0].float()[None, :, None, None]
        h = sizes[:, 1].float()[None, :, None, None]
        ox = (c_ < hi[:, None, :, 0, None]) & (lo[:, None, :, 0, None] < c_ + w)
        oy = (c_ < hi[:, None, :, 1, None]) & (lo[:, None, :, 1, None] < c_ + h)
        noself = ~torch.eye(n_boxes, dtype=torch.bool, device=pos.device)[None, :, :, None]
        oxf = (ox & noself).float()
        oyf = (oy & noself).float()
        new_ov = torch.einsum("pbjx,pbjy->pbxy", oxf, oyf)
        cur_ov_b = overlap_pairs(pos, sizes).sum(dim=2).float()
        d_hard = new_ov - cur_ov_b[:, :, None, None]  # [P, B, G, G]

        # Soft: connector Manhattan length separates per axis.
        c2 = centers2(pos, sizes)
        candx = 2.0 * cf[None, :] + sizes[:, 0].float()[:, None]  # [B, G]
        candy = 2.0 * cf[None, :] + sizes[:, 1].float()[:, None]
        newx = torch.einsum("bj,pbjx->pbx", adj, (candx[None, :, None, :] - c2[:, None, :, 0, None]).abs())
        newy = torch.einsum("bj,pbjx->pbx", adj, (candy[None, :, None, :] - c2[:, None, :, 1, None]).abs())
        cur_edge_b = edge_lengths(c2, adj)
        d_soft = (newx[:, :, :, None] + newy[:, :, None, :] - cur_edge_b[:, :, None, None]) / 2.0

        cand = cur_score[:, None, None, None, :] + torch.stack([d_hard, d_soft], dim=-1)
        # Placements that stick out of the grid, and the no-op cell, are invalid.
        vx = cells[None, :] <= max_pos[:, 0, None]  # [B, G]
        vy = cells[None, :] <= max_pos[:, 1, None]
        noop = (cells[None, None, :, None] == pos[:, :, 0, None, None]) & (
            cells[None, None, None, :] == pos[:, :, 1, None, None]
        )
        valid = vx[None, :, :, None] & vy[None, :, None, :] & ~noop
        p = pos.shape[0]
        return Neighborhood(scores=cand.reshape(p, -1, 2), moves=None, valid=valid.reshape(p, -1))

    def decode(idx):
        """(box, x, y) of flat candidates ``idx``."""
        return idx // (grid * grid), (idx // grid) % grid, idx % grid

    def move_fp(pos, cur_fp, _moves, idx):
        b, x, y = decode(idx)
        flat = (idx.shape[0], -1)
        old = pos.gather(1, b.reshape(flat)[..., None].expand(-1, -1, 2)).view(*idx.shape, 2)
        fp = cur_fp.view(cur_fp.shape[0], *(1,) * (idx.dim() - 1), 2)
        fp = fp_update(fp, 2 * b, old[..., 0], x)
        return fp_update(fp, 2 * b + 1, old[..., 1], y)

    def apply_move(pos, _moves, idx):
        b, x, y = decode(idx)
        lane = torch.arange(pos.shape[0], device=pos.device)
        out = pos.clone()
        out[lane, b] = torch.stack([x, y], dim=-1)
        return out

    def perturb(pos, is_elite, draws):
        """Relocate k ~ U[1, B/20] boxes near elites, else U[1, B/2], to random cells."""
        hi = torch.where(is_elite, max(1, n_boxes // 20), max(1, n_boxes // 2))
        dr = draws.perturb_cells(n_boxes, hi)
        do_change = dr.u_strat < (100.0 / 110.0)
        kth = torch.sort(dr.u, dim=-1).values.gather(1, (dr.n_alter - 1)[:, None])
        sel = (dr.u <= kth)[:, :, None]
        fresh = (dr.cells * (consts(pos.device)[2] + 1).float()).long()
        return torch.where(do_change[:, None, None] & sel, fresh, pos)

    return Problem(
        name=f"diagram-{n_boxes}b-{grid}g",
        init=init,
        score=score,
        is_best=is_best,
        fingerprint=fingerprint,
        neighborhood=neighborhood,
        move_fp=move_fp,
        apply_move=apply_move,
        perturb=perturb,
        width=n_boxes * grid * grid,
    )


def layout_to_boxes(spec: DiagramLayoutSpec, pos, cell: float = 60.0, pad: float = 10.0):
    """Grid layout ``pos`` [B, 2] (host numpy, as ``get_best_solution`` returns
    it, or a tensor) → ``GeomBox`` list for the C++ visibility-graph pipeline."""
    from constraint_solver_tpu_torch.diagram.geometry import GeomBox, Padding, Ports

    sizes, _ = spec.arrays()
    pos = pos.cpu().numpy() if isinstance(pos, torch.Tensor) else np.asarray(pos)
    return [
        GeomBox(
            rect=(
                float(x) * cell + pad, float(y) * cell + pad, float(x + w) * cell - pad, float(y + h) * cell - pad
            ),
            padding=Padding.uniform(pad / 2.0),
            ports=Ports(1, 1, 1, 1),
        )
        for (x, y), (w, h) in zip(pos, sizes)
    ]
