"""Step builders (one device: no mesh, no shardings yet)."""
