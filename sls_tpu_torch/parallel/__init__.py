"""Processes, meshes and sequence parallelism over ``torch.distributed``."""
