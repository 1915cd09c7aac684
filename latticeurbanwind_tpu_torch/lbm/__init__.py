"""Lattice, state, forcing, fields and the step loop."""
