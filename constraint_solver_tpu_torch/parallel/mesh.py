"""Process meshes and the collectives of the multi-device layer
(port of ``constraint_solver_tpu/parallel/mesh.py``).

The JAX package lays a ``jax.sharding.Mesh`` with two named axes over its
devices, ``pop`` (independent trajectories) and ``nbr`` (one trajectory's
neighborhood; ``seq``, the schedule's days, for the date-sharded solver), and
``shard_map`` binds the axis names for the collectives.  Here every rank is one
process of a ``torch.distributed`` world, and a ``Mesh`` gives each rank its
coordinates, row-major as ``jax.make_mesh`` reshapes its device list: rank r of
an (n_pop, n_nbr) mesh sits at pop ``r // n_nbr``, nbr ``r % n_nbr``.  Each
``Axis`` holds the process group of the ranks that share this rank's other
coordinate, this rank's index on the axis and the axis' size.

Collectives (``all_gather`` tiled along a dim, ``all_reduce`` sum/max/min,
``ppermute`` a fixed shift along an axis, and ``all_gather_tree`` /
``all_reduce_tree`` for a whole state tree in one call):

- **Transport.** NCCL refuses two ranks on one card, so the ranks that share
  one card run gloo, for which PyTorch's backend table lists CUDA tensors in
  ``broadcast`` and ``all_reduce`` only.  ``all_gather`` and ``ppermute`` are
  therefore an ``all_reduce`` SUM of a zero-filled buffer holding this rank's
  part in its slot: one code path for every backend and device.  It is exact: x + 0 = x for
  every float (a -0.0 arrives as +0.0) and every integer; bools travel as
  uint8.  It moves (axis size)× the bytes of a native all_gather.  The tree
  forms pack every leaf into one float64 buffer, exact for float32 values and
  for integers below 2^53 (boards, counters, fingerprints).
- **The active mesh.** ``use_mesh(mesh)`` makes ``mesh`` the one that problem
  functions read (``current_mesh()``), as ``shard_map`` binds the JAX axis
  names and ``jax.set_mesh`` sets the ambient mesh.  A solver enters its mesh
  around its own calls, and a solver without one enters ``None``, so two solvers
  in one process do not mix.
- **World agreement** (``world_any``): the port's form of the JAX package's
  ``fixed_trip``.  The port ends its loops by host reads (the descent's done
  check, the solved check per chunk, a cancel).  Under a mesh, ranks that end a
  loop at different trips would issue different numbers of collectives (a hang)
  or draw different numbers of times (diverging streams), so such a decision is
  one small ``all_reduce`` over the whole world.  Without a mesh, or on one
  rank, it is the plain read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from constraint_solver_tpu_torch.utils.tree import tree_leaves, tree_map

_TLS = threading.local()
_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


class Axis(NamedTuple):
    name: str
    size: int
    index: int   # this rank's coordinate on the axis
    group: Any   # the torch.distributed process group; None when size == 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (pop, nbr)-style grid of the world's ranks; ``axis(name)`` gives the
    group along one axis, ``world`` the whole world."""

    axis_names: tuple
    sizes: tuple
    axes: tuple  # one Axis per name
    world: Axis
    device: torch.device  # where host decisions travel: the CPU, or the rank's card under NCCL

    @property
    def shape(self) -> dict:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    def axis(self, name: str) -> Axis:
        if name not in self.axis_names:
            raise ValueError(f"mesh has axes {self.axis_names}, not {name!r}")
        return self.axes[self.axis_names.index(name)]

    def index(self, name: str) -> int:
        return self.axis(name).index


def make_mesh(n_pop: int | None = None, n_nbr: int = 1, names: tuple = ("pop", "nbr")) -> Mesh:
    """The mesh of shape (n_pop, n_nbr) over the whole world; ``n_pop``
    defaults to world size // ``n_nbr``.  ``names`` are the two axes' names
    (``("pop", "seq")`` for the date-sharded solver).  Without an initialised
    process group the world is this one process.

    Every rank must call it, in the same order as every other mesh it makes:
    ``dist.new_group`` is collective over the world, for the groups a rank is
    not in too."""
    initialised = dist.is_available() and dist.is_initialized()
    world_size = dist.get_world_size() if initialised else 1
    rank = dist.get_rank() if initialised else 0
    if n_pop is None:
        n_pop = world_size // n_nbr
    if n_pop * n_nbr != world_size:
        raise ValueError(f"mesh {n_pop}x{n_nbr} needs {n_pop * n_nbr} ranks, the world has {world_size}")
    sizes = (n_pop, n_nbr)
    coords = (rank // n_nbr, rank % n_nbr)
    axes = []
    for a, name in enumerate(names):
        group = None
        if sizes[a] > 1:
            # One group per line of the grid along axis a, created by every
            # rank in the same order.
            for other in range(sizes[1 - a]):
                members = [i * n_nbr + other if a == 0 else other * n_nbr + i for i in range(sizes[a])]
                g = dist.new_group(members)
                if coords[1 - a] == other:
                    group = g
        axes.append(Axis(name, sizes[a], coords[a], group))
    world = Axis("world", world_size, rank, dist.group.WORLD if world_size > 1 else None)
    nccl = initialised and dist.get_backend() == "nccl"
    device = torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")
    return Mesh(tuple(names), sizes, tuple(axes), world, device)


def current_mesh() -> Mesh | None:
    """The mesh entered by ``use_mesh`` in this thread, if any."""
    return getattr(_TLS, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None):
    """Make ``mesh`` (or no mesh) the active one for the block."""
    prev = current_mesh()
    _TLS.mesh = mesh
    try:
        yield mesh
    finally:
        _TLS.mesh = prev


def world_any(flag: torch.Tensor) -> bool:
    """Whether ``flag`` holds a True on any rank of the active mesh's world
    (on this rank alone without a mesh): one int32 ``all_reduce`` on the
    mesh's ``device`` under a mesh."""
    mesh = current_mesh()
    if mesh is None or mesh.world.size == 1:
        return bool(flag.any())
    return bool(all_reduce(flag.any().to(mesh.device, torch.int32).reshape(1), mesh.world).item() > 0)


def _reduce(buf: torch.Tensor, axis: Axis, op: str = "sum") -> None:
    """The one place a collective is issued; ``_reduce.calls`` counts them."""
    dist.all_reduce(buf, op=getattr(dist.ReduceOp, _OPS[op]), group=axis.group)
    _reduce.calls += 1


_reduce.calls = 0


def collective_calls() -> int:
    """Collectives this process has issued (for per-iteration accounting)."""
    return _reduce.calls


def all_reduce(x: torch.Tensor, axis: Axis, op: str = "sum") -> torch.Tensor:
    """``op`` ("sum", "max" or "min") of ``x`` over the axis, a new tensor."""
    if axis.size == 1:
        return x.clone()
    is_bool = x.dtype == torch.bool
    y = x.to(torch.uint8) if is_bool else x.clone()
    _reduce(y, axis, op)
    return y.bool() if is_bool else y


def _slotted_sum(x: torch.Tensor, axis: Axis, slot: int) -> torch.Tensor:
    """[size, *x.shape]: ``x`` in row ``slot`` of a zero buffer, summed over the axis."""
    is_bool = x.dtype == torch.bool
    buf = torch.zeros((axis.size, *x.shape), dtype=torch.uint8 if is_bool else x.dtype, device=x.device)
    buf[slot] = x
    _reduce(buf, axis)
    return buf.bool() if is_bool else buf


def all_gather(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """Every member's ``x`` concatenated along ``dim`` in axis order (the JAX
    ``all_gather(..., tiled=True)``); every member's ``x`` has one shape."""
    if axis.size == 1:
        return x
    return torch.cat(list(_slotted_sum(x, axis, axis.index)), dim=dim)


def ppermute(x: torch.Tensor, axis: Axis, shift: int) -> torch.Tensor:
    """Member i sends ``x`` to member (i + shift) mod size and returns what it
    received, from member (i - shift) mod size."""
    if axis.size == 1:
        return x
    return _slotted_sum(x, axis, (axis.index + shift) % axis.size)[axis.index]


def _pack(tree) -> tuple[torch.Tensor, list]:
    """Leaves [L, ...] → one float64 [L, m] buffer, and what unpacks it."""
    leaves = tree_leaves(tree)
    lead = leaves[0].shape[0]
    spec = [(leaf.shape, leaf.dtype) for leaf in leaves]
    buf = torch.cat([leaf.reshape(lead, -1).to(torch.float64) for leaf in leaves], dim=1)
    return buf, spec


def _unpack(buf: torch.Tensor, spec: list, tree):
    out, col = [], 0
    for shape, dtype in spec:
        width = 1
        for s in shape[1:]:
            width *= s
        out.append(buf[:, col : col + width].reshape(buf.shape[0], *shape[1:]).to(dtype))
        col += width
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


def all_gather_tree(tree, axis: Axis):
    """``all_gather`` along dim 0 of every leaf of ``tree`` (leaves with one
    leading size), in one collective."""
    if axis.size == 1:
        return tree
    buf, spec = _pack(tree)
    return _unpack(all_gather(buf, axis), spec, tree)


def all_reduce_tree(tree, axis: Axis):
    """The SUM over the axis of every leaf of ``tree``, in one collective."""
    if axis.size == 1:
        return tree
    buf, spec = _pack(tree)
    return _unpack(all_reduce(buf, axis), spec, tree)


def active_axis(name: str, size: int) -> Axis:
    """Axis ``name`` of the active mesh, which must have ``size`` ranks: where
    a sharded neighborhood (``nbr_axis``) finds its ranks."""
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError(f"a sharded neighborhood needs an active mesh with a {name!r} axis")
    axis = mesh.axis(name)
    if axis.size != size:
        raise ValueError(f"nbr_shards={size}, the mesh's {name!r} axis has {axis.size} ranks")
    return axis


def gather_best(values: torch.Tensor, valid: torch.Tensor, k: int, moves_at, axis: Axis):
    """The sharded neighborhoods' collective: each lane's ``k`` smallest valid
    ``values`` [P, W] (float32) in ``lax.top_k`` order of the negated values
    (ascending, the lowest index first among ties, the invalid ones last as
    +inf) with the int64 moves ``moves_at(indices)`` returns for them,
    gathered over ``axis`` in one collective (the scores travel as their
    bits).  Returns (values [P, S·k], valid [P, S·k], *moves)."""
    keep = torch.sort(torch.where(valid, values, torch.inf), dim=-1, stable=True).indices[:, :k]
    kept = valid.gather(1, keep)
    best = torch.where(kept, values.gather(1, keep), torch.inf)
    packed = torch.stack([best.view(torch.int32).long(), kept.long(), *moves_at(keep)], dim=1)
    bits, kept, *moves = all_gather(packed, axis, dim=2).unbind(1)
    return bits.to(torch.int32).view(torch.float32), kept.bool(), *moves
