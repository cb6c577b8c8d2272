"""Step builders (one device), and the sharding rules and collectives of
tensor-parallel serving."""
