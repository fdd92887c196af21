"""The round-based HTTP solver service (``python -m constraint_solver_tpu_torch.serve.server``)."""

from constraint_solver_tpu_torch.serve.server import SolverService, run_server  # noqa: F401
