"""Distributed execution (counterpart of ``src/repro/dist/``):

``sharding``        - the logical-axis annotation layer (``ax`` + rule tables)
``params_sharding`` - ``NamedSharding`` trees for params, optimizer state,
                      batches and decode caches (FSDP and batch sharding)
``compat``          - meshes and ``shard_map`` over rank processes
"""
from repro_torch.dist import compat, params_sharding, sharding

__all__ = ["compat", "params_sharding", "sharding"]
