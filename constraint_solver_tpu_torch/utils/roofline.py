"""Roofline accounting of a solver's chunk of rounds
(port of ``constraint_solver_tpu/utils/roofline.py``).

Per solver, as in the JAX package: the achieved FLOP/s and its share of the
card's peaks, the achieved memory rate and its share of the HBM peak, and the
arithmetic intensity (operations per byte), from the work of one chunk scaled
by the solver's measured rounds and wall.

Divergences from the JAX package:

- **Counted, not cost-analysed.** XLA's ``cost_analysis`` has no counterpart.
  ``counting()`` runs code under a ``TorchDispatchMode`` that sees every aten
  op: its bytes are the op's tensor inputs plus its outputs, its operations
  ``torch.utils.flop_counter``'s formula for products and one per output
  element for everything else.  Views (``func.is_view``) alias their input
  and move nothing, so they count nothing.  Indexing moves only the elements
  its integer indices select (``_indexing_work``): ``x[idx]`` counts the
  indices and the selected elements read and written, ``x[idx] = v`` in
  place the indices, ``v`` and the elements written, not the whole of ``x``
  (QAP's in-place move indexes rows and columns of [P, n, n] tensors).
- **Kernels count by their own formula.** A kernel wrapper reports each call
  through ``active_count().kernel(name, operations, bytes)`` and the ops it
  issues inside are not counted: its ``ctypes`` launch is invisible to the
  mode, and on the CPU its plain version's gathers are not the kernel's work.
  So the CPU and the card count the same work.
- **The solver does not advance.** The JAX version compiles a fresh program
  and never runs it; ``solver_roofline`` runs one chunk on a copy of the
  solver's state, with the draw source's ``state_dict`` restored after it, and
  discards the result.  Data-dependent loops (the descent's early exit) count
  what this chunk ran.  A solved solver's lanes only count their rounds (the
  engine skips the descent of a lane whose best ``is_best``), so when every lane
  has converged the chunk runs from a fresh initial state drawn from the
  solver's own source (restored after it) instead; ``counted_from`` says which
  (``"current"`` or ``"initial"``).  The JAX cost analysis counts the program,
  whatever the state, so it reads the same before and after a solve.
- **Under a mesh** every rank runs the counted chunk (it holds collectives),
  the counts are summed over the world, and the shares are taken against the
  peaks of the distinct cards the ranks occupy (by device index, the ranks of
  one host), with the slowest rank's wall.
- **The peaks are those of the card the port targets**, NVIDIA's H100 SXM data
  sheet: dense BF16 tensor 989.4 TFLOP/s (``mfu_bf16``), FP32 outside the
  tensor cores 67 TFLOP/s (``mfu_f32``), HBM3 3.35 TB/s (``hbm_frac``); and a
  rough ``cpu`` entry.  ``vpu_frac`` (the TPU's vector unit) has no
  counterpart and is dropped: the FP32 rate outside the tensor cores is
  ``mfu_f32``'s peak.

The count is per thread: ``counting()`` sees only the ops of the thread that
entered it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections import Counter
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from constraint_solver_tpu_torch.parallel.mesh import all_gather, all_reduce, use_mesh, world_any
from constraint_solver_tpu_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class ChipPeaks:
    name: str
    tensor_bf16: float  # FLOP/s, dense, tensor cores
    fp32: float         # FLOP/s, outside the tensor cores
    hbm_bw: float       # bytes/s


PEAKS = {
    "h100": ChipPeaks("h100-sxm", 989.4e12, 67e12, 3.35e12),  # NVIDIA's data sheet, SXM, 700 W
    "cpu": ChipPeaks("cpu", 1e11, 1e11, 5e10),  # rough host figures
}

_TLS = threading.local()


def detect_peaks(device) -> ChipPeaks:
    """The peaks of ``device``: the H100's for a CUDA device that is one, the
    rough host figures for the CPU; any other card raises (no peaks known)."""
    device = torch.device(device)
    if device.type == "cpu":
        return PEAKS["cpu"]
    name = torch.cuda.get_device_name(device)
    if "H100" not in name:
        raise ValueError(f"no published peaks for {name!r}")
    return PEAKS["h100"]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _numel(tree) -> int:
    return sum(t.numel() for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _indexing_work(func, args, out) -> tuple[int, int] | None:
    """(operations, bytes) of an indexing op by the elements it selects, or
    None for any other op and for boolean indices (counted as whole tensors)."""
    name = func._overloadpacket.__name__
    if name not in ("index", "index_put_", "_index_put_impl_"):
        return None
    x, indices = args[0], [i for i in args[1] if i is not None]
    if any(i.dtype == torch.bool for i in indices):
        return None
    index_bytes = _nbytes(indices)
    if name == "index":  # x[indices]: each output element read once and written once
        return _numel(out), index_bytes + 2 * _nbytes(out)
    # x[indices] = values, in place: the indexed dims give way to the indices' broadcast shape.
    kept = x.numel() // max(1, int(torch.Size([x.shape[d] for d, i in enumerate(args[1]) if i is not None]).numel()))
    written = kept * torch.broadcast_shapes(*(i.shape for i in indices)).numel()
    accumulate = len(args) > 3 and bool(args[3])  # reads the old elements too
    return written, index_bytes + _nbytes(args[2]) + (1 + accumulate) * written * x.element_size()


class WorkCount(TorchDispatchMode):
    """Operations and bytes of the aten ops run under it, plus the work that
    kernel wrappers report by formula (``kernel``).  ``kernels`` holds, per
    kernel name, its calls, operations and bytes."""

    def __init__(self):
        super().__init__()
        # Imported here: ``torch.utils.flop_counter`` imports triton where it is
        # installed, and importing the port must not.
        from torch.utils.flop_counter import flop_registry

        self._formulas = flop_registry
        self.flops = 0
        self.bytes = 0
        self.kernels: dict[str, Counter] = {}
        self._muted = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._muted and not func.is_view:
            indexing = _indexing_work(func, args, out)
            if indexing is not None:
                self.flops += indexing[0]
                self.bytes += indexing[1]
                return out
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
            formula = self._formulas.get(func._overloadpacket)
            self.flops += formula(*args, **kwargs, out_val=out) if formula is not None else _numel(out)
        return out

    @contextlib.contextmanager
    def kernel(self, name: str, flops: int, nbytes: int):
        """One call of kernel ``name`` doing ``flops`` operations and moving
        ``nbytes`` bytes; the ops issued inside the block are not counted, nor
        is a kernel called inside a block that is (a plain version that calls
        another kernel's wrapper: its work is the outer kernel's)."""
        if self._muted:
            yield
            return
        entry = self.kernels.setdefault(name, Counter())
        entry.update(calls=1, flops=flops, bytes=nbytes)
        self.flops += flops
        self.bytes += nbytes
        with self.muted():
            yield

    @contextlib.contextmanager
    def muted(self):
        """The ops issued inside the block are not counted (a wrapper reading
        its call's data for the work it reports)."""
        self._muted += 1
        try:
            yield
        finally:
            self._muted -= 1


def active_count() -> WorkCount | None:
    """The count this thread runs under, if any (kernel wrappers report to it)."""
    return getattr(_TLS, "count", None)


@contextlib.contextmanager
def counting():
    """Count the work of the block (this thread's ops only)."""
    count = WorkCount()
    _TLS.count = count
    try:
        with count:
            yield count
    finally:
        _TLS.count = None


def roofline(
    flops_per_call: float,
    bytes_per_call: float,
    calls: int,
    wall_s: float,
    peaks: ChipPeaks,
) -> dict[str, Any]:
    """Measured roofline point: achieved FLOP/s and bytes/s, and their shares
    of each peak."""
    f = flops_per_call * calls / wall_s
    b = bytes_per_call * calls / wall_s
    return {
        "chip": peaks.name,
        "flops_per_sec": f,
        "hbm_bytes_per_sec": b,
        "mfu_bf16": f / peaks.tensor_bf16,
        "mfu_f32": f / peaks.fp32,
        "hbm_frac": b / peaks.hbm_bw,
        "intensity_flops_per_byte": (flops_per_call / bytes_per_call) if bytes_per_call else float("inf"),
    }


def solver_roofline(solver, advance: Callable[[Any, int, int], Any], chunk: int = 2, init=None) -> dict[str, Any]:
    """Roofline of ``solver`` over its measured solve: one chunk of ``chunk``
    rounds, ``advance(state, base, chunk)``, counted on a copy of the solver's
    state (the draw source restored after it), gives the work per round; the
    solver's executed rounds over its measured wall give the rate.  When every
    lane has converged, the chunk runs from ``init()`` (a fresh initial state
    from the solver's draws) at round 0 instead.  ``kernels`` holds each
    kernel's calls, operations and bytes in the chunk."""
    mesh = getattr(solver, "mesh", None)
    saved = solver.draws.state_dict()
    try:
        with use_mesh(mesh):
            best, _, _ = solver.state.elite.get_best()
            done = solver.state.elite.valid.any(dim=-1) & solver.problem.is_best(best)
            fresh = init is not None and not world_any(~done)
            state, base = (init(), 0) if fresh else (tree_map(torch.clone, solver.state), solver._round)
            with counting() as count:
                advance(state, base, chunk)
    finally:
        solver.draws.load_state_dict(saved)
    names = sorted(count.kernels)
    totals = torch.tensor(
        [count.flops, count.bytes, solver._wall] + [count.kernels[k][f] for k in names for f in _KERNEL_FIELDS],
        dtype=torch.float64,
    )
    n_cards = 1
    if mesh is not None and mesh.world.size > 1:
        totals = all_reduce(totals.to(mesh.device), mesh.world).cpu()
        totals[2] = all_reduce(torch.tensor([solver._wall], dtype=torch.float64, device=mesh.device),
                               mesh.world, "max").item()
        dev = solver.device
        index = torch.tensor([dev.index if dev.type == "cuda" else -1], device=mesh.device)
        n_cards = len(set(all_gather(index, mesh.world).tolist()))
    flops, nbytes, wall_s = (float(x) for x in totals[:3])
    kernels = {
        k: {f: int(totals[3 + i * len(_KERNEL_FIELDS) + j]) for j, f in enumerate(_KERNEL_FIELDS)}
        for i, k in enumerate(names)
    }
    per_round_flops = flops / chunk
    per_round_bytes = nbytes / chunk
    rounds = solver._round
    one = detect_peaks(solver.device)
    peaks = ChipPeaks(one.name if n_cards == 1 else f"{n_cards}x {one.name}", one.tensor_bf16 * n_cards,
                      one.fp32 * n_cards, one.hbm_bw * n_cards)
    out = roofline(per_round_flops, per_round_bytes, max(rounds, 1), max(wall_s, 1e-9), peaks)
    out.update(
        flops_per_round=per_round_flops,
        hbm_bytes_per_round=per_round_bytes,
        rounds=rounds,
        wall_s=wall_s,
        chunk=chunk,
        counted_from="initial" if fresh else "current",
        ranks=mesh.world.size if mesh is not None else 1,
        cards=n_cards,
        kernels=kernels,
    )
    return out


_KERNEL_FIELDS = ("calls", "flops", "bytes")


def format_roofline(r: dict[str, Any]) -> str:
    return (
        f"[{r['chip']}] {r['flops_per_sec']:.3g} FLOP/s "
        f"(MFU bf16 {100 * r['mfu_bf16']:.2f}%, f32 {100 * r['mfu_f32']:.2f}%), "
        f"HBM {r['hbm_bytes_per_sec'] / 1e9:.1f} GB/s "
        f"({100 * r['hbm_frac']:.1f}% of peak), "
        f"intensity {r['intensity_flops_per_byte']:.2f} flop/B"
    )
