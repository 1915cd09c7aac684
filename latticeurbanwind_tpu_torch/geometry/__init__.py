from .stl import Mesh, read_stl, write_stl
from .voxelize import voxelize_mesh_columns, voxelize_solid_flags

__all__ = ["Mesh", "read_stl", "write_stl", "voxelize_mesh_columns", "voxelize_solid_flags"]
