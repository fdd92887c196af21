"""Orthogonal connector routing on the visibility graph
(a copy of ``constraint_solver_tpu/diagram/route.py``).

The reference builds the orthogonal visibility graph (reference
examples/diagram/src/lib.rs:620-705, after Wybrow/Marriott/Stuckey 2009) but
stops there — no router, and its solver hookup is empty structs
(main.rs:7-9).  This module finishes the pipeline:

    solve (models/diagram_layout.py)      →  grid layout
    C++ sweep (native/diagram.cc)         →  visibility graph
    Dijkstra here                         →  orthogonal connector routes
    render_routed                         →  SVG

Routing is host-side graph search over the irregular sparse graph: the
device owns the dense layout optimization, the host owns the final geometry
pass.

Each connector is routed vertex-nearest-to-center → vertex-nearest-to-center
with edge weight = Manhattan length + a fixed per-bend penalty (prefers
straighter routes, the visual objective of the reference's source papers).
"""

from __future__ import annotations

import heapq
from collections import defaultdict

from constraint_solver_tpu_torch.diagram.geometry import (
    Diagram,
    OrthogonalVisibilityGraph,
)

BEND_PENALTY = 10.0


def _build_adjacency(graph: OrthogonalVisibilityGraph):
    adj = defaultdict(list)
    for (a, b) in graph.edges:
        w = abs(a[0] - b[0]) + abs(a[1] - b[1])
        adj[a].append((b, w))
        adj[b].append((a, w))
    return adj


_EPS = 1e-6


def _densified_adjacency(graph: OrthogonalVisibilityGraph):
    """Adjacency with CONSECUTIVE vertices along every interesting segment
    connected (plus the reference's exact-endpoint edges).

    The reference's edge rule — vertex pairs that are exact segment
    endpoints (ref lib.rs:675-696, a TODO-marked stopgap) — leaves the
    graph fragmented: port vertices sit ON segments but mid-segment, so
    they join nothing.  Connecting each segment's sorted vertex chain is
    the standard orthogonal-visibility-graph construction (Wybrow/
    Marriott/Stuckey 2009) and makes every port reachable, eliminating the
    off-graph elbow fallback."""
    edge_set = set()
    for (a, b) in graph.edges:
        edge_set.add((min(a, b), max(a, b)))
    verts = sorted(graph.vertices)
    for segs, horizontal in (
        (graph.interesting_horizontal_segments, True),
        (graph.interesting_vertical_segments, False),
    ):
        for (p1, p2) in segs:
            if horizontal:
                c = p1[1]
                lo, hi = sorted((p1[0], p2[0]))
                on = [
                    v for v in verts
                    if abs(v[1] - c) < _EPS and lo - _EPS <= v[0] <= hi + _EPS
                ]
            else:
                c = p1[0]
                lo, hi = sorted((p1[1], p2[1]))
                on = [
                    v for v in verts
                    if abs(v[0] - c) < _EPS and lo - _EPS <= v[1] <= hi + _EPS
                ]
                on.sort(key=lambda v: v[1])
            for a, b in zip(on, on[1:]):
                if a != b:
                    edge_set.add((min(a, b), max(a, b)))
    adj = defaultdict(list)
    for (a, b) in edge_set:
        w = abs(a[0] - b[0]) + abs(a[1] - b[1])
        adj[a].append((b, w))
        adj[b].append((a, w))
    return adj


def box_ports(box):
    """Unpadded port coordinates of a GeomBox, mirroring the reference's
    port placement INCLUDING the width/height swap quirk (ref lib.rs:436-462;
    native/diagram.cc:54-73) — these are exactly the port vertices the
    visibility graph contains."""
    x1, y1, x2, y2 = box.rect
    min_x, min_y = min(x1, x2), min(y1, y2)
    max_x, max_y = max(x1, x2), max(y1, y2)
    w, h = max_x - min_x, max_y - min_y
    pts = []
    for i in range(box.ports.top):
        pts.append((min_x + h * (i + 1) / (box.ports.top + 1), min_y))
    for i in range(box.ports.right):
        pts.append((max_x, min_y + w * (i + 1) / (box.ports.right + 1)))
    for i in range(box.ports.bottom):
        pts.append((min_x + h * (i + 1) / (box.ports.bottom + 1), max_y))
    for i in range(box.ports.left):
        pts.append((min_x, min_y + w * (i + 1) / (box.ports.left + 1)))
    return pts


def _snap_to_vertices(points, vertices):
    """Map computed port coordinates to their graph vertices (Q32.32
    round-trips can differ from float math in the last ulps)."""
    out = []
    for p in points:
        best = min(
            vertices,
            key=lambda v: (v[0] - p[0]) ** 2 + (v[1] - p[1]) ** 2,
            default=None,
        )
        if best is not None and abs(best[0] - p[0]) + abs(best[1] - p[1]) < 1e-3:
            out.append(best)
    return out


def route_crossings(routes, boxes):
    """Count route segments crossing any box's OPEN interior (ports lie on
    the boundary, which is legal).  Zero for on-graph routes — the
    interesting segments are clipped outside the padded boxes."""
    crossings = 0
    for route in routes:
        if route is None:
            continue
        for (a, b) in zip(route, route[1:]):
            lo_x, hi_x = sorted((a[0], b[0]))
            lo_y, hi_y = sorted((a[1], b[1]))
            for box in boxes:
                x1, y1, x2, y2 = box.rect
                bx1, bx2 = sorted((x1, x2))
                by1, by2 = sorted((y1, y2))
                if (
                    lo_x < bx2 - _EPS
                    and hi_x > bx1 + _EPS
                    and lo_y < by2 - _EPS
                    and hi_y > by1 + _EPS
                ):
                    crossings += 1
    return crossings


def _nearest_vertex(vertices, point):
    return min(
        vertices,
        key=lambda v: (v[0] - point[0]) ** 2 + (v[1] - point[1]) ** 2,
    )


def _direction(a, b):
    return (
        (b[0] > a[0]) - (b[0] < a[0]),
        (b[1] > a[1]) - (b[1] < a[1]),
    )


def shortest_route(adj, src, dst, bend_penalty: float = BEND_PENALTY):
    """Dijkstra with bend-aware state (vertex, incoming direction).

    Returns the vertex list src..dst, or None if disconnected.
    """
    # state: (vertex, incoming direction); direction None at the source.
    # The heap carries a monotone counter so ties never compare states
    # (direction can be None, which is unorderable against tuples).
    best = {}
    prev = {}
    counter = 0
    heap = [(0.0, counter, src, None)]
    while heap:
        cost, _, v, d = heapq.heappop(heap)
        key = (v, d)
        if key in best and best[key] < cost:
            continue
        if v == dst:
            # Reconstruct.
            path = [v]
            k = key
            while k in prev:
                k = prev[k]
                path.append(k[0])
            return list(reversed(path))
        for (w, length) in adj.get(v, ()):  # noqa: B023
            nd = _direction(v, w)
            ncost = cost + length
            if d is not None and nd != d:
                ncost += bend_penalty
            nkey = (w, nd)
            if nkey not in best or ncost < best[nkey]:
                best[nkey] = ncost
                prev[nkey] = key
                counter += 1
                heapq.heappush(heap, (ncost, counter, w, nd))
    return None


def _components(adj):
    """Connected components of the visibility graph (list of vertex lists)."""
    seen = set()
    comps = []
    for start in adj:
        if start in seen:
            continue
        comp = []
        stack = [start]
        seen.add(start)
        while stack:
            v = stack.pop()
            comp.append(v)
            for (w, _) in adj[v]:
                if w not in seen:
                    seen.add(w)
                    stack.append(w)
        comps.append(comp)
    return comps


def fallback_elbow(boxes, i, j):
    """Center-to-center L-shaped elbow for connectors the graph can't carry
    (shared by the SVG and PNG renderers so the two outputs never diverge)."""
    x1, y1, x2, y2 = boxes[i].rect
    a = ((x1 + x2) / 2.0, (y1 + y2) / 2.0)
    x1, y1, x2, y2 = boxes[j].rect
    b = ((x1 + x2) / 2.0, (y1 + y2) / 2.0)
    return [a, (b[0], a[1]), b]


def route_connectors(boxes, edges, bend_penalty: float = BEND_PENALTY):
    """Route each (i, j) connector PORT to PORT on the visibility graph.

    ``boxes`` is a GeomBox list, ``edges`` index pairs into it.  Returns a
    list of vertex paths (None only if a box exposes no ports or the graph
    is empty — on-graph routing needs no elbow fallback since the
    densified adjacency connects every port, see _densified_adjacency).

    Endpoint choice: the port pair of the two boxes with the smallest
    Manhattan separation (the pair a human router would pick); Dijkstra
    with the bend penalty finds the orthogonal path between them.
    """
    diagram = Diagram(boxes)
    graph = OrthogonalVisibilityGraph(diagram)
    adj = _densified_adjacency(graph)
    if not adj:
        return [None for _ in edges]

    ports = [
        _snap_to_vertices(box_ports(b), graph.vertices) for b in boxes
    ]
    routes = []
    for (i, j) in edges:
        best = None  # (manhattan, src, dst)
        for a in ports[i]:
            for b in ports[j]:
                m = abs(a[0] - b[0]) + abs(a[1] - b[1])
                if best is None or m < best[0]:
                    best = (m, a, b)
        if best is None:
            routes.append(None)
            continue
        routes.append(shortest_route(adj, best[1], best[2], bend_penalty))
    return routes


def render_routed(boxes, edges, path: str | None = None) -> str:
    """SVG of boxes plus routed orthogonal connectors (the finished form of
    the reference's render demo, main.rs:11-236)."""
    routes = route_connectors(boxes, edges)
    xs, ys = [], []
    for b in boxes:
        x1, y1, x2, y2 = b.rect
        xs += [x1, x2]
        ys += [y1, y2]
    pad = 30.0
    min_x, max_x = min(xs) - pad, max(xs) + pad
    min_y, max_y = min(ys) - pad, max(ys) + pad
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" '
        f'viewBox="{min_x} {min_y} {max_x - min_x} {max_y - min_y}">',
        f'<rect x="{min_x}" y="{min_y}" width="{max_x - min_x}" '
        f'height="{max_y - min_y}" fill="white"/>',
    ]
    for route, (i, j) in zip(routes, edges):
        if route is None:
            # No usable component: fall back to an L-shaped center-to-center
            # elbow so the connector stays orthogonal and visible.
            route = fallback_elbow(boxes, i, j)
        pts = " ".join(f"{x},{y}" for x, y in route)
        parts.append(
            f'<polyline points="{pts}" fill="none" '
            'stroke="#188038" stroke-width="2"/>'
        )
    for b in boxes:
        x1, y1, x2, y2 = b.rect
        parts.append(
            f'<rect x="{min(x1, x2)}" y="{min(y1, y2)}" '
            f'width="{abs(x2 - x1)}" height="{abs(y2 - y1)}" '
            'fill="#e8f0fe" stroke="#1a73e8" stroke-width="1.5"/>'
        )
    parts.append("</svg>")
    svg = "\n".join(parts)
    if path:
        with open(path, "w") as f:
            f.write(svg)
    return svg
