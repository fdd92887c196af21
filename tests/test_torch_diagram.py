"""The PyTorch port's ``diagram`` subpackage (geometry, routing, PNG) and
``layout_to_boxes`` against the JAX package's, byte for byte.

Both sides run the repository's ``native/diagram.cc`` (each builds its own
copy of the library); the inputs are ``tests/test_diagram.py``'s and
``tests/test_png.py``'s and solved-shaped layouts of
``DiagramLayoutSpec.random``.  Segments, visibility graphs, routes, crossing
counts, SVG strings and PNG bytes must be equal."""

import dataclasses
import random

import numpy as np
import pytest
import torch

from constraint_solver_tpu.diagram import geometry as jg
from constraint_solver_tpu.diagram import png as jpng
from constraint_solver_tpu.diagram import route as jr
from constraint_solver_tpu.models import diagram_layout as jdl
from constraint_solver_tpu_torch.diagram import geometry as tg
from constraint_solver_tpu_torch.diagram import png as tpng
from constraint_solver_tpu_torch.diagram import route as tr
from constraint_solver_tpu_torch.models import diagram_layout as tdl


def _box(mod, rect, pad, ports=(1, 1, 1, 1)):
    return mod.GeomBox(rect=rect, padding=mod.Padding.uniform(pad), ports=mod.Ports(*ports))


def _property_boxes(seed, count):
    """``tests/test_diagram.py``'s random boxes: arbitrary corners, paddings and port counts."""
    rng = random.Random(seed)
    out = []
    for _ in range(count):
        boxes = []
        for _ in range(rng.randint(1, 6)):
            rect = (rng.uniform(0, 100), rng.uniform(0, 100), rng.uniform(0, 100), rng.uniform(0, 100))
            pad = rng.uniform(0, 10)
            ports = tuple(rng.randint(0, 4) for _ in range(4))
            boxes.append((rect, pad, ports))
        out.append(boxes)
    return out


BOX_SETS = {
    "two-box": [((100.0, 100.0, 200.0, 200.0), 10.0, (1, 1, 0, 0)), ((300.0, 100.0, 400.0, 200.0), 10.0, (0, 0, 0, 1))],
    "port-quirk": [((0.0, 0.0, 100.0, 40.0), 0.0, (1, 1, 0, 0))],
    "demo-3x3": [((100.0 + 150 * i, 100.0 + 150 * j, 200.0 + 150 * i, 200.0 + 150 * j), 10.0, (1, 1, 1, 1))
                 for i in range(3) for j in range(3)],
    "diagonal-36": [((i * 100.0, i * 100.0, (i + 1) * 100.0, (i + 1) * 100.0), 10.0, (1, 1, 1, 1)) for i in range(36)],
    "row-3": [((100.0 * i, 0.0, 100.0 * i + 60.0, 60.0), 5.0, (1, 1, 1, 1)) for i in range(3)],
    **{f"property-{k}": boxes for k, boxes in enumerate(_property_boxes(0, 8))},
}


def _both(spec):
    return [_box(jg, *b) for b in spec], [_box(tg, *b) for b in spec]


def _astuples(boxes):
    return [dataclasses.astuple(b) for b in boxes]


@pytest.mark.parametrize("name", list(BOX_SETS))
def test_geometry_and_svg_equal_jax(name, tmp_path):
    jboxes, tboxes = _both(BOX_SETS[name])
    jd, td = jg.Diagram(jboxes), tg.Diagram(tboxes)
    assert tg.interesting_horizontal_segments(td) == jg.interesting_horizontal_segments(jd)
    assert tg.interesting_vertical_segments(td) == jg.interesting_vertical_segments(jd)
    jgraph, tgraph = jg.OrthogonalVisibilityGraph(jd), tg.OrthogonalVisibilityGraph(td)
    assert tgraph.vertices == jgraph.vertices and tgraph.edges == jgraph.edges
    assert tg.render_svg(td, str(tmp_path / "t.svg")) == jg.render_svg(jd, str(tmp_path / "j.svg"))
    assert (tmp_path / "t.svg").read_bytes() == (tmp_path / "j.svg").read_bytes()
    tpng.render_png(td, str(tmp_path / "t.png"))
    jpng.render_png(jd, str(tmp_path / "j.png"))
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()


def _layout_cases():
    """(spec args, positions): random specs with random in-grid layouts."""
    out = []
    for k, (boxes, edges, grid, max_size) in enumerate(((6, 6, 8, 2), (9, 8, 12, 3), (16, 20, 16, 3))):
        rng = np.random.default_rng(k)
        spec = tdl.DiagramLayoutSpec.random(boxes, edges, grid, seed=k, max_size=max_size)
        sizes, _ = spec.arrays()
        out.append(((boxes, edges, grid), dict(seed=k, max_size=max_size), rng.integers(0, grid - sizes + 1)))
    return out


@pytest.mark.parametrize("args, kw, pos", _layout_cases(), ids=["6b", "9b", "16b"])
def test_layout_routes_svg_and_png_equal_jax(args, kw, pos, tmp_path):
    jspec, tspec = jdl.DiagramLayoutSpec.random(*args, **kw), tdl.DiagramLayoutSpec.random(*args, **kw)
    assert tuple(jspec) == tuple(tspec)
    tboxes = tdl.layout_to_boxes(tspec, pos)
    jboxes = jdl.layout_to_boxes(jspec, pos)
    assert _astuples(tboxes) == _astuples(jboxes)
    assert _astuples(tdl.layout_to_boxes(tspec, torch.as_tensor(pos))) == _astuples(jboxes)
    edges = list(tspec.edges)
    troutes, jroutes = tr.route_connectors(tboxes, edges), jr.route_connectors(jboxes, edges)
    assert troutes == jroutes and all(r is not None for r in troutes)
    assert tr.route_crossings(troutes, tboxes) == jr.route_crossings(jroutes, jboxes)
    assert tr.render_routed(tboxes, edges, str(tmp_path / "t.svg")) == jr.render_routed(jboxes, edges)
    assert tpng.render_routed_png(tboxes, edges, str(tmp_path / "t.png")) == jpng.render_routed_png(
        jboxes, edges, str(tmp_path / "j.png")
    )
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()


def test_canvas_and_write_png_equal_jax(tmp_path):
    rgb = np.random.default_rng(0).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    tpng.write_png(rgb, str(tmp_path / "t.png"))
    jpng.write_png(rgb, str(tmp_path / "j.png"))
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    canvases = []
    for mod in (tpng, jpng):
        cv = mod.Canvas(0, 0, 10, 10, scale=1.0)
        cv.fill_rect(1, 1, 4, 4, (1, 2, 3), border=(9, 9, 9))
        cv.line(0, 8, 10, 8, (5, 5, 5))
        cv.line(0, 0, 6, 6, (7, 7, 7))
        cv.line(-5, 4, 3, 4, (2, 2, 2), width=3)
        cv.dot(-5, -5, (1, 1, 1), r=2)
        cv.dot(9, 9, (4, 4, 4))
        canvases.append(cv.buf)
    np.testing.assert_array_equal(*canvases)


def test_demo_writes_the_grid(tmp_path):
    svg = tg.demo(str(tmp_path / "demo.svg"))
    assert svg == (tmp_path / "demo.svg").read_text()
    assert svg == jg.render_svg(jg.Diagram(_both(BOX_SETS["demo-3x3"])[0]))
