"""Post-processing: the grid <-> geographic transform, vtk2nc and the tools
that read a run's VTKs (visluw, luwutmnc, luwcutvis, luwseason,
luwspectra, luwtkeviz, luwaij, luwvideo, buildingscale)."""
