"""Connector routing for diagram layouts (a copy of ``constraint_solver_tpu/diagram``).

Host-side geometry over the repository's C++ core (``native/diagram.cc``): the
orthogonal visibility graph, Dijkstra routing of the connectors, SVG and PNG
output.  Copied because importing the JAX package's subpackage first imports
that package, and so JAX; the port imports neither."""

from constraint_solver_tpu_torch.diagram.geometry import (  # noqa: F401
    Diagram,
    GeomBox,
    OrthogonalVisibilityGraph,
    Padding,
    Ports,
    interesting_horizontal_segments,
    interesting_vertical_segments,
    render_svg,
)
from constraint_solver_tpu_torch.diagram.png import (  # noqa: F401
    render_png,
    render_routed_png,
)
from constraint_solver_tpu_torch.diagram.route import (  # noqa: F401
    render_routed,
    route_connectors,
)
