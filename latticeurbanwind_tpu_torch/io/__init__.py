"""VTK I/O and the progress protocol."""

from .vtk import read_structured_points, write_structured_points
from .progress import ProgressEmitter

__all__ = ["read_structured_points", "write_structured_points", "ProgressEmitter"]
