"""Orthogonal connector-routing geometry — Python surface over the C++ core
(a copy of ``constraint_solver_tpu/diagram/geometry.py``).

Parity component for the reference diagram crate (reference
examples/diagram/): sweep-line "interesting segments"
(lib.rs:509-618), H x V intersections (geometry.rs:6-28), and the
orthogonal visibility graph (lib.rs:620-705), per
Dwyer/Marriott/Stuckey 2005 and Wybrow/Marriott/Stuckey 2009.

The hot geometry runs in native C++ (native/diagram.cc, Q32.32 fixed point
matching the reference's I32F32 ``Unit``), compiled on first use and loaded
via ctypes.  An SVG renderer replaces the reference's usvg/resvg demo
(main.rs:11-236).

Divergence from the JAX package: the library is built with ``g++`` into
``build/native/`` at the checkout's root (the JAX module builds it into a
per-user directory under the system's temporary directory).  The source is
the repository's ``native/diagram.cc``, compiled in place and never copied;
the build goes to a unique temporary file renamed into place, again whenever
the source is newer than the library, and one lock covers the build and the
load, so concurrent threads build it once.  ``demo`` takes the path it writes
(the JAX module's default is a fixed file under ``/tmp``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess
import tempfile
import threading

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "diagram.cc")
_BUILD_DIR = os.path.join(_ROOT, "build", "native")
_LIB_CACHE = None
_LIB_LOCK = threading.Lock()


def _build_lib() -> str:
    """Compile native/diagram.cc into build/native/ (cached by mtime).

    The compile goes to a unique temporary file renamed into place, so a
    concurrent builder in another process never loads a half-written
    object."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so_path = os.path.join(_BUILD_DIR, "libcspdiagram.so")
    if (
        not os.path.exists(so_path)
        or os.path.getmtime(so_path) < os.path.getmtime(_SRC)
    ):
        fd, tmp_path = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(
                [
                    "g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-o", tmp_path, _SRC,
                ],
                check=True,
                capture_output=True,
            )
            os.rename(tmp_path, so_path)  # atomic within the same dir
        finally:
            if os.path.exists(tmp_path):
                os.unlink(tmp_path)
    return so_path


def _lib() -> ctypes.CDLL:
    global _LIB_CACHE
    with _LIB_LOCK:
        if _LIB_CACHE is None:
            lib = ctypes.CDLL(_build_lib())
            dpp = ctypes.POINTER(ctypes.c_double)
            lib.csp_interesting_segments.argtypes = [
                dpp, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(dpp), ctypes.POINTER(ctypes.c_int),
            ]
            lib.csp_visibility_graph.argtypes = [
                dpp, ctypes.c_int,
                ctypes.POINTER(dpp), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(dpp), ctypes.POINTER(ctypes.c_int),
            ]
            lib.csp_free.argtypes = [dpp]
            _LIB_CACHE = lib
        return _LIB_CACHE


@dataclasses.dataclass(frozen=True)
class Ports:
    """Connector counts per side; default 1 each (ref primitives.rs:193-224)."""

    top: int = 1
    right: int = 1
    bottom: int = 1
    left: int = 1


@dataclasses.dataclass(frozen=True)
class Padding:
    """Clearance an incoming line travels straight before a port
    (ref primitives.rs:226-243)."""

    top: float = 0.0
    right: float = 0.0
    bottom: float = 0.0
    left: float = 0.0

    @staticmethod
    def uniform(amount: float) -> "Padding":
        return Padding(amount, amount, amount, amount)


@dataclasses.dataclass(frozen=True)
class GeomBox:
    """A rectangle with padding and ports (ref lib.rs:296-304).
    ``rect`` is (x1, y1, x2, y2); corners are normalized."""

    rect: tuple
    padding: Padding = Padding()
    ports: Ports = Ports()


@dataclasses.dataclass(frozen=True)
class Diagram:
    boxes: tuple

    def __init__(self, boxes):
        object.__setattr__(self, "boxes", tuple(boxes))

    def _flat(self):
        out = []
        for b in self.boxes:
            x1, y1, x2, y2 = b.rect
            out += [
                float(x1), float(y1), float(x2), float(y2),
                b.padding.top, b.padding.right, b.padding.bottom, b.padding.left,
                float(b.ports.top), float(b.ports.right),
                float(b.ports.bottom), float(b.ports.left),
            ]
        return (ctypes.c_double * len(out))(*out)


def _segments(diagram: Diagram, horizontal: bool):
    lib = _lib()
    data = diagram._flat()
    out = ctypes.POINTER(ctypes.c_double)()
    n = ctypes.c_int()
    lib.csp_interesting_segments(
        data, len(diagram.boxes), int(horizontal),
        ctypes.byref(out), ctypes.byref(n),
    )
    segs = [
        ((out[4 * i], out[4 * i + 1]), (out[4 * i + 2], out[4 * i + 3]))
        for i in range(n.value)
    ]
    lib.csp_free(out)
    return segs


def interesting_horizontal_segments(diagram: Diagram):
    """Sweep emission order incl. duplicates (ref lib.rs:509-560)."""
    return _segments(diagram, True)


def interesting_vertical_segments(diagram: Diagram):
    """(ref lib.rs:562-618)"""
    return _segments(diagram, False)


class OrthogonalVisibilityGraph:
    """Vertices (ports + segment intersections) and edges (vertex pairs that
    are exact interesting-segment endpoints), ref lib.rs:628-705."""

    def __init__(self, diagram: Diagram):
        lib = _lib()
        data = diagram._flat()
        dpp = ctypes.POINTER(ctypes.c_double)
        verts, edges = dpp(), dpp()
        n_verts, n_edges = ctypes.c_int(), ctypes.c_int()
        lib.csp_visibility_graph(
            data, len(diagram.boxes),
            ctypes.byref(verts), ctypes.byref(n_verts),
            ctypes.byref(edges), ctypes.byref(n_edges),
        )
        self.vertices = {
            (verts[2 * i], verts[2 * i + 1]) for i in range(n_verts.value)
        }
        self.edges = {
            (
                (edges[4 * i], edges[4 * i + 1]),
                (edges[4 * i + 2], edges[4 * i + 3]),
            )
            for i in range(n_edges.value)
        }
        lib.csp_free(verts)
        lib.csp_free(edges)
        self.interesting_horizontal_segments = set(
            interesting_horizontal_segments(diagram)
        )
        self.interesting_vertical_segments = set(
            interesting_vertical_segments(diagram)
        )


def render_svg(diagram: Diagram, path: str | None = None) -> str:
    """Render boxes, visibility vertices, and edges to SVG (the reference
    demo renders via usvg/resvg to PNG, main.rs:11-236)."""
    graph = OrthogonalVisibilityGraph(diagram)
    xs = [v[0] for v in graph.vertices] or [0.0]
    ys = [v[1] for v in graph.vertices] or [0.0]
    pad = 20.0
    min_x, max_x = min(xs) - pad, max(xs) + pad
    min_y, max_y = min(ys) - pad, max(ys) + pad
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" '
        f'viewBox="{min_x} {min_y} {max_x - min_x} {max_y - min_y}">',
        f'<rect x="{min_x}" y="{min_y}" width="{max_x - min_x}" '
        f'height="{max_y - min_y}" fill="white"/>',
    ]
    for (x1, y1), (x2, y2) in sorted(graph.edges):
        parts.append(
            f'<line x1="{x1}" y1="{y1}" x2="{x2}" y2="{y2}" '
            'stroke="#bbbbbb" stroke-width="0.5"/>'
        )
    for b in diagram.boxes:
        x1, y1, x2, y2 = b.rect
        parts.append(
            f'<rect x="{min(x1, x2)}" y="{min(y1, y2)}" '
            f'width="{abs(x2 - x1)}" height="{abs(y2 - y1)}" '
            'fill="#e8f0fe" stroke="#1a73e8"/>'
        )
    for x, y in sorted(graph.vertices):
        parts.append(f'<circle cx="{x}" cy="{y}" r="1.5" fill="#d93025"/>')
    parts.append("</svg>")
    svg = "\n".join(parts)
    if path:
        with open(path, "w") as f:
            f.write(svg)
    return svg


def demo(path: str) -> str:
    """3x3 grid demo mirroring the reference main (main.rs:158-179)."""
    boxes = [
        GeomBox(
            rect=(100.0 + 150.0 * i, 100.0 + 150.0 * j,
                  200.0 + 150.0 * i, 200.0 + 150.0 * j),
            padding=Padding.uniform(10.0),
            ports=Ports(1, 1, 1, 1),
        )
        for i in range(3)
        for j in range(3)
    ]
    return render_svg(Diagram(boxes), path)


if __name__ == "__main__":
    import sys

    target = sys.argv[1] if len(sys.argv) > 1 else "out.svg"
    out = demo(target)
    print(f"wrote {len(out)} bytes of SVG to {target}")
