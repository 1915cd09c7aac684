"""Pre-processing: the makeluw stages (WRF ingest, buildBC, footprint crop,
DEM ingest, terrain and voxelization), the UTM projection and dgprepare
(a raw building STL to the profile / dataset-generation case STL)."""
