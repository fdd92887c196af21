"""constraint_solver_tpu_torch — the PyTorch and CUDA port of ``constraint_solver_tpu``.

It mirrors the JAX package module for module (``core``, ``models``, ``ops``,
``parallel``, ``utils``, ``diagram``, and the user surface ``cli`` and
``serve``), so each module's reference is the file of the same name there.
In PyTorch's idiom:

- functions take tensors batched over an explicit leading lane axis P instead
  of being ``vmap``ped, and a lane that is done is masked, not skipped;
- the solvers run on the card (``device="cuda"``) unless the caller passes
  another device, with no check for a card and no fallback: the CPU runs only
  when asked for (``device="cpu"``), as the tests do; every random choice goes
  through a draw source (``utils/draws.py``) instead of a JAX key;
- state is ``NamedTuple``s of tensors;
- the one TPU kernel on the path, the N-Queens neighborhood scores, is a CUDA
  kernel (``csrc/nqueens_scores.cu``) with a plain PyTorch version beside it
  (``ops/nqueens_kernel.py``).

This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"

from constraint_solver_tpu_torch.core.ils import Solver, SolverConfig  # noqa: F401
from constraint_solver_tpu_torch.core.problem import Neighborhood, Problem  # noqa: F401
from constraint_solver_tpu_torch.parallel.population import PopulationSolver  # noqa: F401
