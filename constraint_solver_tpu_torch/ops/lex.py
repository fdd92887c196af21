"""Lexicographic (hard, soft) score operations (port of ``constraint_solver_tpu/ops/lex.py``).

Every score is a ``float32[..., 2]`` tensor, hard channel first, minimized
lexicographically, and every argmin or argmax breaks ties to the lowest index,
as in the JAX package.  Three PyTorch details decide the form:

- ``torch.argmax`` refuses a bool tensor, so masks are cast to ``uint8`` (it
  returns the first maximal index, as ``jnp.argmax`` does);
- ``torch.topk`` orders ties differently from ``lax.top_k``, so ``lex_top_k``
  is two stable sorts (soft first, then hard), which is the stable two-key
  ``lax.sort`` of the JAX package;
- ``noisy_lex_select`` takes the k-th smallest *value* (``torch.kthvalue``),
  which does not depend on how ties are ordered, and divides by the
  temperature held in a tensor filled on the device (no copy from the host):
  CUDA's division by a Python scalar multiplies by its reciprocal, which is
  not bit-equal to a division.  Divergence: its
  Gumbel noise is an argument (a ``Draws`` source makes it) instead of a key.
"""

from __future__ import annotations

import torch

INF_SCORE = float("inf")


def make_score(hard, soft=0.0) -> torch.Tensor:
    """Pack hard/soft values (or broadcastable tensors) into a [..., 2] score.
    A number ``soft`` is filled on ``hard``'s device: no copy from the host,
    which a CUDA graph could not capture."""
    hard = torch.as_tensor(hard, dtype=torch.float32)
    if isinstance(soft, (int, float)):
        soft = torch.full((), soft, dtype=torch.float32, device=hard.device)
    else:
        soft = torch.as_tensor(soft, dtype=torch.float32, device=hard.device)
    return torch.stack([hard, soft.expand(hard.shape)], dim=-1)


def lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b lexicographically; a, b are [..., 2] scores."""
    return (a[..., 0] < b[..., 0]) | ((a[..., 0] == b[..., 0]) & (a[..., 1] < b[..., 1]))


def lex_leq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a <= b lexicographically."""
    return (a[..., 0] < b[..., 0]) | ((a[..., 0] == b[..., 0]) & (a[..., 1] <= b[..., 1]))


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 if there is none)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def lex_argmin(scores: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Index of the lexicographic minimum of ``scores`` [..., W, 2] over W.

    Invalid entries are never selected unless every entry is invalid; ties go
    to the lowest index."""
    hard, soft = scores[..., 0], scores[..., 1]
    if valid is not None:
        hard = torch.where(valid, hard, INF_SCORE)
    tie = hard == hard.amin(dim=-1, keepdim=True)
    soft_m = torch.where(tie, soft, INF_SCORE)
    return first_true(tie & (soft_m == soft_m.amin(dim=-1, keepdim=True)))


def lex_min(scores: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Lexicographic minimum score of [..., W, 2] (returns [..., 2])."""
    idx = lex_argmin(scores, valid)
    return torch.take_along_dim(scores, idx[..., None, None], dim=-2).squeeze(-2)


def lex_argmax(scores: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Index of the lexicographic maximum (worst) of ``scores`` [..., W, 2]."""
    hard, soft = scores[..., 0], scores[..., 1]
    if valid is not None:
        hard = torch.where(valid, hard, -INF_SCORE)
    tie = hard == hard.amax(dim=-1, keepdim=True)
    soft_m = torch.where(tie, soft, -INF_SCORE)
    return first_true(tie & (soft_m == soft_m.amax(dim=-1, keepdim=True)))


def noisy_lex_select(
    scores: torch.Tensor,
    valid: torch.Tensor,
    k: int,
    temp: float,
    gumbel: torch.Tensor,
    scale: float = 4096.0,
) -> torch.Tensor:
    """Sample an index from the lexicographic top-``k`` of ``scores`` [..., W, 2]
    by the Gumbel-max trick: P(i) ∝ exp(-w_i / temp) over the k best valid
    candidates, with ``w = hard * scale + soft`` (exact while hard < 2^24 / scale
    and soft < scale are integers).  Every candidate tied at the k-th value is
    eligible.  ``gumbel`` [..., W] is the noise."""
    w = scores[..., 0] * scale + scores[..., 1]
    w = torch.where(valid, w, INF_SCORE)
    k = min(k, w.shape[-1])
    kth = torch.kthvalue(w, k, dim=-1, keepdim=True).values
    in_topk = valid & (w <= kth)
    logit = torch.where(in_topk, -w / w.new_full((), max(temp, 1e-9)) + gumbel, -INF_SCORE)
    return torch.argmax(logit, dim=-1)


def lex_argsort(scores: torch.Tensor) -> torch.Tensor:
    """Indices that sort scores [N, 2] ascending lexicographically, ties in
    index order (``jnp.lexsort((soft, hard))``)."""
    perm = torch.sort(scores[:, 1], stable=True).indices
    return perm[torch.sort(scores[perm, 0], stable=True).indices]


def lex_top_k(scores: torch.Tensor, k: int, *payload: torch.Tensor):
    """Smallest-k scores of [N, 2] with payload rows [N, ...], ascending
    lexicographically, ties in index order.  Returns ``(top_scores [k, 2],
    *top_payload)``."""
    perm_k = lex_argsort(scores)[:k]
    return scores[perm_k], *(p[perm_k] for p in payload)
