"""Distributed on ``torch.distributed`` (one process per rank): device
meshes of the data, dcn and model (head) axes (the model axis for both
families: ``PiT`` and the TF family's ``PiTTF`` / ``PiTTFPointCloud`` and
variants), the GPipe stage axis (the torch family's fixed meshes),
multi-process start-up, and the explicit-collective training step."""

from position_induced_transformer_torch.parallel.pipeline import (
    enable_pipeline,
    make_pipelined_apply,
    make_stage_mesh,
    pipeline_processor,
    pipeline_task,
    stack_processor_params,
)
from position_induced_transformer_torch.parallel.shard_map_step import (
    make_shard_map_train_step,
    shard_batch_arrays,
)
from position_induced_transformer_torch.parallel.sharding import (
    DataMesh,
    StageMesh,
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
from position_induced_transformer_torch.parallel.tensor_parallel import (
    gather_state,
    param_shardings,
    shard_model,
    shard_state,
)

__all__ = [
    "DataMesh",
    "StageMesh",
    "make_mesh",
    "parse_mesh_spec",
    "data_axis_size",
    "shard_batch",
    "shard_rows",
    "param_shardings",
    "shard_model",
    "shard_state",
    "gather_state",
    "replicate_tree",
    "sequence_shard_geometry",
    "sequence_shard_tf_geometry",
    "sequence_gather",
    "make_shard_map_train_step",
    "shard_batch_arrays",
    "make_stage_mesh",
    "stack_processor_params",
    "pipeline_processor",
    "make_pipelined_apply",
    "pipeline_task",
    "enable_pipeline",
]
