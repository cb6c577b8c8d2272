"""Step builders (one device or a ("data", "model") mesh), the sharding
rules, ZeRO-1, the collectives of tensor-parallel serving and multi-rank
training, and the int8 error-feedback all-reduce."""
