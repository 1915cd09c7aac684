"""Pre-processing helpers the run modes need (the UTM projection)."""
