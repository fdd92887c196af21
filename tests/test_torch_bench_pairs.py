"""``scripts/bench_pairs.py``'s comparison of parent and change runs: each
metric's values in pair order, medians, quartiles, the change's wins by the
metric's direction (ties count for neither) and the ratio of the medians."""

import importlib.util
import statistics
from pathlib import Path

import pytest

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "bench_pairs.py"


def _load():
    spec = importlib.util.spec_from_file_location("bench_pairs", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _runs(parent, change, metric, cell="c"):
    return [{side: {"cells": {cell: {"metrics": {metric: v, "other": "not measured"}}}}
             for side, v in (("parent", p), ("change", c))} for p, c in zip(parent, change)]


@pytest.mark.parametrize(
    "direction, parent, change, wins",
    [
        ("higher", [1.0, 2.0, 3.0], [2.0, 2.0, 4.0], 2),  # one tie counts for neither side
        ("lower", [1.0, 2.0, 3.0], [2.0, 2.0, 4.0], 0),
        ("lower", [5.0, 6.0, 7.0, 8.0], [4.0, 5.0, 9.0, 1.0], 3),
    ],
)
def test_compare_counts_wins_by_direction(direction, parent, change, wins):
    bp = _load()
    row = bp.compare(_runs(parent, change, "m"), {"m": direction})["c.m"]
    assert row["change_wins"] == wins and row["pairs"] == len(parent)
    assert row["parent"] == parent and row["change"] == change
    assert row["parent_median"] == statistics.median(parent)
    assert row["change_median"] == statistics.median(change)
    assert row["ratio"] == pytest.approx(row["change_median"] / row["parent_median"])
    assert row["parent_quartiles"][1] == row["parent_median"]
    assert "c.other" not in bp.compare(_runs(parent, change, "m"), {"m": direction})  # no number, no row
