"""Command-line entry points, one per domain (``python -m constraint_solver_tpu_torch.cli.<domain>``)."""
