"""Dependency-free PNG rasterizer for diagram renders
(a copy of ``constraint_solver_tpu/diagram/png.py``).

The reference demo rasterizes its diagram to ``/tmp/out.png`` through
usvg/resvg/tiny-skia (reference examples/diagram/src/main.rs:44-156).  No
image library is a dependency, so parity comes from a tiny
renderer: axis-aligned rects, H/V lines, and dots drawn into a numpy RGB
buffer, emitted as one 8-bit truecolor IDAT via stdlib ``zlib``.

Only the primitives the diagram renders are supported — this is a render
surface, not a graphics library.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

WHITE = (255, 255, 255)
BOX_FILL = (232, 240, 254)
BOX_EDGE = (26, 115, 232)
GRAPH_EDGE = (187, 187, 187)
VERTEX = (217, 48, 37)
ROUTE = (24, 128, 56)


def write_png(rgb: np.ndarray, path: str) -> None:
    """Write an uint8[H, W, 3] array as a PNG file."""
    h, w, c = rgb.shape
    assert c == 3 and rgb.dtype == np.uint8

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


class Canvas:
    """Integer-pixel drawing surface with a world→pixel transform."""

    def __init__(self, min_x, min_y, max_x, max_y, scale: float = 1.0):
        self.min_x, self.min_y, self.scale = min_x, min_y, scale
        self.w = max(1, int(round((max_x - min_x) * scale)) + 1)
        self.h = max(1, int(round((max_y - min_y) * scale)) + 1)
        self.buf = np.empty((self.h, self.w, 3), np.uint8)
        self.buf[:] = WHITE

    def _px(self, x, y):
        return (
            int(round((x - self.min_x) * self.scale)),
            int(round((y - self.min_y) * self.scale)),
        )

    def fill_rect(self, x1, y1, x2, y2, color, border=None):
        (px1, py1), (px2, py2) = self._px(x1, y1), self._px(x2, y2)
        px1, px2 = sorted((px1, px2))
        py1, py2 = sorted((py1, py2))
        px1, py1 = max(px1, 0), max(py1, 0)
        px2, py2 = min(px2, self.w - 1), min(py2, self.h - 1)
        if px2 < px1 or py2 < py1:
            return
        self.buf[py1 : py2 + 1, px1 : px2 + 1] = color
        if border is not None:
            self.buf[py1, px1 : px2 + 1] = border
            self.buf[py2, px1 : px2 + 1] = border
            self.buf[py1 : py2 + 1, px1] = border
            self.buf[py1 : py2 + 1, px2] = border

    def _fill_clipped(self, px1, py1, px2, py2, color):
        """Fill an inclusive pixel box, clipped; empty after clipping is a
        no-op (a negative slice stop would wrap around in numpy)."""
        x0, x1 = max(px1, 0), min(px2, self.w - 1)
        y0, y1 = max(py1, 0), min(py2, self.h - 1)
        if x1 < x0 or y1 < y0:
            return
        self.buf[y0 : y1 + 1, x0 : x1 + 1] = color

    def line(self, x1, y1, x2, y2, color, width: int = 1):
        """Axis-aligned (H or V) line; diagonals draw as an elbow."""
        if x1 != x2 and y1 != y2:
            self.line(x1, y1, x2, y1, color, width)
            self.line(x2, y1, x2, y2, color, width)
            return
        (px1, py1), (px2, py2) = self._px(x1, y1), self._px(x2, y2)
        r = width // 2
        px1, px2 = sorted((px1, px2))
        py1, py2 = sorted((py1, py2))
        self._fill_clipped(px1 - r, py1 - r, px2 + r, py2 + r, color)

    def dot(self, x, y, color, r: int = 2):
        px, py = self._px(x, y)
        self._fill_clipped(px - r, py - r, px + r, py + r, color)


def _canvas_for(boxes, extra_points=(), pad: float = 30.0, scale: float = 1.0):
    xs, ys = [], []
    for b in boxes:
        x1, y1, x2, y2 = b.rect
        xs += [x1, x2]
        ys += [y1, y2]
    for (x, y) in extra_points:
        xs.append(x)
        ys.append(y)
    if not xs:
        xs = ys = [0.0]
    return Canvas(
        min(xs) - pad, min(ys) - pad, max(xs) + pad, max(ys) + pad, scale
    )


def render_png(diagram, path: str, scale: float = 1.0) -> tuple:
    """Rasterize boxes + visibility graph to a PNG file (the analog of the
    reference's usvg/resvg demo render, main.rs:44-156).

    Returns the (height, width) of the written image.
    """
    from constraint_solver_tpu_torch.diagram.geometry import (
        OrthogonalVisibilityGraph,
    )

    graph = OrthogonalVisibilityGraph(diagram)
    cv = _canvas_for(diagram.boxes, graph.vertices, scale=scale)
    for (a, b) in sorted(graph.edges):
        cv.line(a[0], a[1], b[0], b[1], GRAPH_EDGE)
    for box in diagram.boxes:
        x1, y1, x2, y2 = box.rect
        cv.fill_rect(x1, y1, x2, y2, BOX_FILL, border=BOX_EDGE)
    for (x, y) in sorted(graph.vertices):
        cv.dot(x, y, VERTEX)
    write_png(cv.buf, path)
    return cv.buf.shape[:2]


def render_routed_png(boxes, edges, path: str, scale: float = 1.0) -> tuple:
    """Rasterize a solved layout with routed connectors to PNG."""
    from constraint_solver_tpu_torch.diagram.route import (
        fallback_elbow,
        route_connectors,
    )

    routes = route_connectors(boxes, edges)
    # Routes can step slightly outside the box bounding rect (padded-edge
    # vertices); include them in the canvas extent.
    pts = [p for r in routes if r for p in r]
    cv = _canvas_for(boxes, pts, scale=scale)
    for route, (i, j) in zip(routes, edges):
        if route is None:
            route = fallback_elbow(boxes, i, j)
        for a, b in zip(route, route[1:]):
            cv.line(a[0], a[1], b[0], b[1], ROUTE, width=2)
    for box in boxes:
        x1, y1, x2, y2 = box.rect
        cv.fill_rect(x1, y1, x2, y2, BOX_FILL, border=BOX_EDGE)
    write_png(cv.buf, path)
    return cv.buf.shape[:2]
