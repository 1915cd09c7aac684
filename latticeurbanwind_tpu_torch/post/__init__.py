"""Post-processing: the grid <-> geographic transform and vtk2nc."""
