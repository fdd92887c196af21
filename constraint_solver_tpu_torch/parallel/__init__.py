"""Trajectory populations with elite exchange, phase schedules, and multi-device solving
(process meshes, the pop x nbr and pop x seq sharded solvers)."""
