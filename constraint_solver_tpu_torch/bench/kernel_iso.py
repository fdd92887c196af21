"""Timing of the N-Queens probe kernels and plain PyTorch block variants on the card.

Port of ``bench/kernel_iso.py``:

    python -m constraint_solver_tpu_torch.bench.kernel_iso --packed --i16 --mxu
    python -m constraint_solver_tpu_torch.bench.kernel_iso --device cpu --n 64 --p 2 --k 3

Each arm is a ``loop`` over K iterations that scores the [A, n] candidate block
of all P lanes at the sampled columns cc = (c + i) mod n and adds each lane's
block minimum over the first n columns to a float32 sum (``kernel_iso.py``
``:233-241``, ``:283-291``, ``:339-346``).  The arms:

- ``build(kern)`` with one of the probe kernels of ``ops/nqueens_probes.py``:
  ``base f32`` and ``noroll (timing only)`` always, ``packed 1-roll + min``
  (``build_packed``) with ``--packed``, ``i16 tables`` and ``i16 + row
  min/argmin`` with ``--i16``;
- ``build_xla(impl)`` with ``--mxu``: the block in plain PyTorch, the windows
  of the diagonal tables by ``unfold`` and a gather (``"slice"``), by a grouped
  ``conv1d`` with one-hot impulses (``"conv"``, float32 with cuDNN's TF32 off),
  or by a batched matmul of one-hot rows against the Toeplitz tables
  (``"toeplitz"``, float32 with TF32 off).  They stand for the JAX harness's
  XLA arms of the same names.

Every arm but noroll computes the same sums.  ``timeit`` takes the best of 3
calls after a warm-up, each ended by ``torch.cuda.synchronize()``.  The
knobs are arguments with the JAX harness's defaults (``--n 1000 --p 256 --k
50``, A = max(1, n // 20)); ``--device`` (``cuda`` by default) takes the place
of ``ISO_CPU``, and without a card only ``--device cpu`` runs.  The inputs come
from a ``torch.Generator`` seeded with 0: random permutation boards, A columns
per lane drawn with replacement, their rows, removed terms and totals of 0; they
are not the JAX harness's ``jax.random`` draws.
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.nn.functional as F

from constraint_solver_tpu_torch.models.nqueens import build_state
from constraint_solver_tpu_torch.ops import nqueens_probes as probes

N, P, K = 1000, 256, 50  # the JAX harness's defaults (ISO_N, ISO_P, ISO_K)


def _sync(out: torch.Tensor) -> torch.Tensor:
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    return out


def timeit(fn, *args) -> tuple[float, torch.Tensor]:
    """(best wall in s of 3 calls after a warm-up, the last call's result)."""
    out = _sync(fn(*args))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = _sync(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out


def _loop(block_min, k: int):
    def loop(rc, dc, ac, c, r, rem, cur):
        n = rc.shape[1]
        acc = torch.zeros(rc.shape[0], dtype=torch.float32, device=rc.device)
        for i in range(k):
            cc = (c + i) % n
            acc = acc + block_min(rc, dc, ac, cc, r, rem, cur)
        return acc

    return loop


def build(kern, k: int = K):
    """The loop over probe kernel ``kern`` (a wrapper of ``ops/nqueens_probes.py``)."""

    def block_min(rc, dc, ac, cc, r, rem, cur):
        n = rc.shape[1]
        return kern(rc, dc, ac, cc, r, rem, cur)[0][:, :, :n].amin(dim=(1, 2))

    return _loop(block_min, k)


def build_packed(k: int = K):
    """The loop over the packed probe (``kernel_iso.py`` ``build_packed``)."""
    return build(probes.kern_packed, k)


class _NoTF32:
    """Float32 convolutions and matrix products in full float32 inside the block."""

    def __enter__(self):
        self.saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved


def build_xla(impl: str, k: int = K):
    """The loop over the block in plain PyTorch, its table windows by
    ``impl`` in ("slice", "conv", "toeplitz")."""
    if impl not in ("slice", "conv", "toeplitz"):
        raise ValueError(f"unknown block impl {impl!r}")

    def block_min(rc, dc, ac, cc, r, rem, cur):
        p, n = rc.shape
        a = cc.shape[1]
        rp = torch.arange(n, device=rc.device)
        c64 = cc.long()
        if impl == "slice":
            lanes = torch.arange(p, device=rc.device)[:, None]
            dc_at = dc.unfold(1, n, 1)[lanes, (n - 1) - c64]
            ac_at = ac.unfold(1, n, 1)[lanes, c64]
        elif impl == "conv":
            imp_d = (rp == ((n - 1) - c64).unsqueeze(-1)).float()
            imp_a = (rp == c64.unsqueeze(-1)).float()
            with _NoTF32():  # cross-correlation of each lane's table with its A impulses
                dc_at = F.conv1d(dc.unsqueeze(0), imp_d.reshape(p * a, 1, n), groups=p).view(p, a, n)
                ac_at = F.conv1d(ac.unsqueeze(0), imp_a.reshape(p * a, 1, n), groups=p).view(p, a, n)
        else:
            t_d = dc.unfold(1, n, 1).flip(1)  # t_d[p, k, i] = dc[p, n-1-k + i]
            t_a = ac.unfold(1, n, 1)  # t_a[p, k, i] = ac[p, k + i]
            onehot = (c64.unsqueeze(-1) == rp).float()
            with _NoTF32():
                dc_at, ac_at = onehot @ t_d, onehot @ t_a
        d = r - cc + (n - 1)
        anti = r + cc
        dp = rp - c64.unsqueeze(-1) + (n - 1)
        ap = rp + c64.unsqueeze(-1)
        added = (
            (rc.unsqueeze(1) - (rp == r.unsqueeze(-1)).float())
            + (dc_at - (dp == d.unsqueeze(-1)).float())
            + (ac_at - (ap == anti.unsqueeze(-1)).float())
        )
        row = cur[:, None, None] + 2.0 * (added - rem.unsqueeze(-1))
        return row.amin(dim=(1, 2))

    return _loop(block_min, k)


def inputs(n: int, p: int, a: int, device) -> tuple:
    """(rc, dc, ac, c, r, rem, cur) of P random permutation boards, from a
    generator seeded with 0."""
    gen = torch.Generator().manual_seed(0)
    rows = torch.rand((p, n), generator=gen).argsort(dim=1)
    c = torch.randint(0, n, (p, a), generator=gen, dtype=torch.int32)
    r = rows.gather(1, c.long()).to(torch.int32)
    st = build_state(rows.to(device))
    rem = torch.zeros((p, a), dtype=torch.float32, device=device)
    cur = torch.zeros((p,), dtype=torch.float32, device=device)
    return st.rc, st.dc, st.ac, c.to(device), r.to(device), rem, cur


def main(argv=None) -> dict:
    """Time each arm and print one line for it; returns the arms' times and sums."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=N, help="board size")
    parser.add_argument("--p", type=int, default=P, help="lanes")
    parser.add_argument("--k", type=int, default=K, help="iterations per timed call")
    parser.add_argument("--packed", action="store_true", help="add the packed probe")
    parser.add_argument("--i16", action="store_true", help="add the two int16 probes")
    parser.add_argument("--mxu", action="store_true", help="add the plain slice, conv and Toeplitz blocks")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("kernel_iso: no CUDA device; the probe kernels run only on the card (or pass --device cpu)")
    device = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {name}", flush=True)
    n, p, k = args.n, args.p, args.k
    a = max(1, n // 20)
    data = inputs(n, p, a, device)

    variants = [("base f32", build(probes.kern_base, k)), ("noroll (timing only)", build(probes.kern_noroll, k))]
    if args.packed:
        variants += [("packed 1-roll + min", build_packed(k))]
    if args.i16:
        variants += [("i16 tables", build(probes.kern_i16, k)),
                     ("i16 + row min/argmin", build(probes.kern_i16min, k))]
    if args.mxu:
        variants += [("torch slice block", build_xla("slice", k)), ("torch conv block", build_xla("conv", k)),
                     ("torch toeplitz block", build_xla("toeplitz", k))]
    print(f"n={n} P={p} A={a} K={k}", flush=True)
    arms = {}
    for arm, fn in variants:
        wall, acc = timeit(fn, *data)
        print(f"{arm:24s} {wall * 1000:8.1f} ms / {k} iters = {1000 * wall / k:6.2f} ms/iter", flush=True)
        arms[arm] = {"ms": wall * 1e3, "ms_per_iter": wall * 1e3 / k, "acc": acc.cpu()}
    if args.packed:
        delta = (arms["base f32"]["acc"] - arms["packed 1-roll + min"]["acc"]).abs().max()
        print(f"packed-vs-f32 accumulated-min delta: {float(delta)}", flush=True)
    return {"device": name, "n": n, "p": p, "a": a, "k": k, "arms": arms}


if __name__ == "__main__":
    main()
