"""Trajectory populations with elite exchange and phase schedules (one device)."""
