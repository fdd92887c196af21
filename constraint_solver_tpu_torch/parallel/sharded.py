"""Two-axis sharded solving: the population over ``pop``, each trajectory's
neighborhood over ``nbr`` (port of ``constraint_solver_tpu/parallel/sharded.py``).

One rank per (pop, nbr) coordinate of the mesh (``parallel/mesh.py``):

- the lanes are sharded over ``pop``; the ranks of one ``nbr`` group hold the
  same lanes and draw the same numbers, so their states stay equal;
- within every lane the sampled neighborhood is sharded over ``nbr``: each rank
  scores its slice (through the CUDA kernel on the card, for N-Queens), keeps
  its best candidates and one gather over ``nbr`` rebuilds a small candidate
  list for the engine's selection (the problem, built with ``nbr_axis="nbr"``,
  does this);
- on the ``exchange_every`` round cadence the lanes exchange elites over
  ``pop`` (``parallel/population.py``'s ``exchange_elites``), and
  ``k_exchange=0`` turns the exchange off.

The JAX package builds this as ``shard_map(vmap(ils_round))``; here it is the
``PopulationSolver`` under a (pop, nbr) mesh, whose driver API it keeps
(``run``, ``execute_round`` as a 1-round chunk, ``is_finished``,
``get_iteration_info``, ``get_best_solution``, ``stats``, ``save``/``load``,
``reseed_from_elites``, ``roofline``).
"""

from __future__ import annotations

from constraint_solver_tpu_torch.core.ils import SolverConfig
from constraint_solver_tpu_torch.core.problem import Problem
from constraint_solver_tpu_torch.parallel.mesh import Mesh
from constraint_solver_tpu_torch.parallel.population import PopulationSolver


class ShardedPopulationSolver(PopulationSolver):
    """``PopulationSolver`` over a (pop, nbr) mesh: lanes split over ``pop``,
    each lane's neighborhood split over ``nbr``.  ``problem`` must have been
    built with ``nbr_axis="nbr"`` and ``nbr_shards`` equal to the axis' size."""

    def __init__(
        self,
        problem: Problem,
        config: SolverConfig,
        population: int,
        mesh: Mesh,
        exchange_every: int = 10,
        k_exchange: int = 4,
        portfolio: str = "reference",
        cull_frac: float = 0.0,
        cull_rank: str = "lex",
        device="cuda",
        draws=None,
    ):
        super().__init__(
            problem, config, population, exchange_every=exchange_every, k_exchange=k_exchange,
            portfolio=portfolio, cull_frac=cull_frac, cull_rank=cull_rank, device=device, draws=draws,
            mesh=mesh,
        )
