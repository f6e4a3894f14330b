"""Distributed: the data axis on ``torch.distributed`` (one process per
rank), multi-process start-up, and the explicit-collective training step."""

from position_induced_transformer_torch.parallel.sharding import (
    DataMesh,
    data_axis_size,
    make_mesh,
    parse_mesh_spec,
    replicate_tree,
    sequence_gather,
    sequence_shard_geometry,
    sequence_shard_tf_geometry,
    shard_batch,
    shard_rows,
)

__all__ = [
    "DataMesh",
    "make_mesh",
    "parse_mesh_spec",
    "data_axis_size",
    "shard_batch",
    "shard_rows",
    "replicate_tree",
    "sequence_shard_geometry",
    "sequence_shard_tf_geometry",
    "sequence_gather",
]
