"""Pre-processing: the makeluw stages (WRF ingest, buildBC, footprint crop,
DEM ingest, terrain and voxelization) and the UTM projection."""
