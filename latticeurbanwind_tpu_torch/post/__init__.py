"""Post-processing helpers the run modes need (the grid <-> geographic transform)."""
