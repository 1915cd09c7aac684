"""Boundary-condition builders (numpy)."""
