"""Pretty printers for solutions (a copy of ``constraint_solver_tpu/utils/printing.py``;
numpy only, kept here so that the port imports nothing of the JAX package).

- N-Queens board grid mirrors the reference's Debug formatter
  (reference examples/nqueens/src/lib.rs:26-60).
- Schedule printouts mirror the reference's Debug formatter and the CLI's
  per-employee listing (reference examples/employee-scheduling/src/lib.rs:224-235
  and src/main.rs:56-62).
"""

from __future__ import annotations

import datetime

import numpy as np

_WEEKDAYS = ["Mon", "Tue", "Wed", "Thu", "Fri", "Sat", "Sun"]


def format_board(rows) -> str:
    """Render an N-Queens board as an ASCII grid (Q per queen)."""
    rows = np.asarray(rows)
    n = len(rows)
    sep = "-" * (4 * n + 1)
    lines = [sep]
    for r in range(n):
        cells = "".join("| Q " if rows[c] == r else "|   " for c in range(n))
        lines.append(cells + "|")
        lines.append(sep)
    return "\n".join(lines)


def format_schedule(assign, start_date: datetime.date) -> str:
    """One line per day: 'Mon 2022-05-09 - Employee { id: 3 }'."""
    assign = np.asarray(assign)
    lines = []
    for i, emp in enumerate(assign):
        day = start_date + datetime.timedelta(days=int(i))
        lines.append(f"{_WEEKDAYS[day.weekday()]} {day.isoformat()} - employee {int(emp)}")
    return "\n".join(lines)


def format_schedule_by_employee(assign, start_date: datetime.date) -> str:
    """Per-employee day listing (reference CLI output, main.rs:56-62)."""
    assign = np.asarray(assign)
    by_emp: dict[int, list[datetime.date]] = {}
    for i, emp in enumerate(assign):
        day = start_date + datetime.timedelta(days=int(i))
        by_emp.setdefault(int(emp), []).append(day)
    lines = []
    for emp in sorted(by_emp):
        lines.append(f"employee: {emp}")
        for day in by_emp[emp]:
            lines.append(f"{_WEEKDAYS[day.weekday()]} - {day.isoformat()}")
        lines.append("---")
    return "\n".join(lines)
