"""Run layer: case assembly, sizing, the driver and the run modes."""
