"""Trajectory populations with elite exchange (one device)."""
