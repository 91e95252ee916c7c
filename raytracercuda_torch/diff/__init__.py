"""Subpackage of the PyTorch port (see `raytracercuda_torch`)."""
