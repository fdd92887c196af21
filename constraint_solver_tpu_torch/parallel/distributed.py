"""Multi-process initialisation, the global mesh, and a launcher for rank groups
(port of ``constraint_solver_tpu/parallel/distributed.py``).

The JAX package wires N host processes into one runtime with
``jax.distributed.initialize``; every process then runs the same ``shard_map``
program.  Here every rank is one process running the same Python driver:

    from constraint_solver_tpu_torch.parallel import distributed
    distributed.initialize("tcp://localhost:29500", world_size=4, rank=r,
                           backend="nccl", device=f"cuda:{r}")
    mesh = distributed.global_mesh(n_nbr=1)   # every rank on the 'pop' axis
    solver = PopulationSolver(problem, config, population=P, mesh=mesh, device=...)

``initialize`` takes the rendezvous, the world size, the rank and the backend
explicitly (nothing is read from the environment beyond what
``torch.distributed`` reads itself) and gives the process group a timeout, so a
rank that dies makes the others raise instead of hang.  NCCL wants one card per
rank; ranks that share a card run gloo (``parallel/mesh.py`` says how the
collectives then travel).

``run_ranks`` starts a group of ranks as ``spawn``ed processes (a parent that
has initialised CUDA cannot ``fork``), runs one function in each, and returns
their results.  A rank that raises, dies or outlives the timeout fails the
whole call, and every process it started is stopped before it returns.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from constraint_solver_tpu_torch.parallel.mesh import Mesh, make_mesh


def initialize(
    init_method: str,
    world_size: int,
    rank: int,
    backend: str = "gloo",
    device=None,
    timeout_s: float = 600.0,
) -> None:
    """Join the process group; on a CUDA ``device`` make it this process's
    current device first."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(
        backend=backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def global_mesh(n_nbr: int = 1, names: tuple = ("pop", "nbr")) -> Mesh:
    """A mesh over every rank of the world: (world size // n_nbr, n_nbr)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % n_nbr:
        raise ValueError(f"{world} ranks do not divide over n_nbr={n_nbr}")
    return make_mesh(world // n_nbr, n_nbr, names)


def is_coordinator() -> bool:
    """Rank 0 (or the only process): the rank that reads results and writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(fn, rank, world_size, args, init_method, backend, device, timeout_s, threads, results):
    """One spawned rank: join the group, run ``fn`` and report to the parent."""
    try:
        if threads:
            torch.set_num_threads(threads)
        initialize(init_method, world_size, rank, backend, device, timeout_s)
        value = fn(rank, world_size, *args)
        dist.barrier()
        results.put((rank, True, value))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))  # the parent fails the call
        raise
    finally:
        destroy()


def run_ranks(
    fn,
    world_size: int,
    args: tuple = (),
    backend: str = "gloo",
    device=None,
    init_method: str | None = None,
    timeout_s: float = 600.0,
    threads: int | None = None,
) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned processes,
    each initialised into one process group (``device``: the device every rank
    sets as current), and return the results in rank order.  ``fn`` and
    ``args`` are pickled, so ``fn`` is a module-level function.
    ``init_method`` defaults to a file in a fresh temporary directory;
    ``threads`` sets each rank's CPU thread count.  Raises ``RuntimeError``
    with the rank's traceback if a rank fails, and ``TimeoutError`` after
    ``timeout_s``."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        if init_method is None:
            init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [
            ctx.Process(
                target=_rank_main,
                args=(fn, r, world_size, args, init_method, backend, device, timeout_s, threads, results),
                daemon=True,
            )
            for r in range(world_size)
        ]
        for p in procs:
            p.start()
        out = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(out) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(out))} gave no result in "
                                       f"{timeout_s} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 2.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode is not None]
                    if dead:
                        # A rank that exits reports first; give its report a moment to arrive.
                        try:
                            rank, ok, value = results.get(timeout=5.0)
                        except queue.Empty:
                            raise RuntimeError(f"ranks {dead} exited without a result "
                                               f"(exit codes {[procs[r].exitcode for r in dead]})") from None
                    else:
                        continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} failed:\n{value}")
                out[rank] = value
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
            results.close()
    return [out[r] for r in range(world_size)]
