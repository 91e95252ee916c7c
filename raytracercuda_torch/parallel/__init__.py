"""Subpackage of the PyTorch port (see `raytracercuda_torch`): ray sharding
over a process group (`mesh`, `shard`) and the primitive ring (`ring`)."""
