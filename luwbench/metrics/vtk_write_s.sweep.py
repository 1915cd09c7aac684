"""vtk_write_s.sweep: seconds of the traced stretch (one case) inside the
port's `luw.output.vtk` spans: `write_final_outputs`'s VTK files, one span
a file, `io/vtk.py::write_structured_points`."""

from luwbench import spans

LAYER = "output"
MOVES = "case_s"


def read(run):
    return spans.seconds(run.trace, "output.vtk")
