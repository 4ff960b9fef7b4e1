"""Scale-out on ``torch.distributed`` (port of ``d3d_tpu.parallel``): the
meshes and sharding rules, dp/tp/sp-sharded training, data-parallel
serving and evaluation, the multi-process job, GPipe pipelines and the
Switch-MoE with its experts split over ranks. One rank a GPU (NCCL), or
CPU ranks over gloo (``device_type="cpu"``)."""

from .mesh import (make_mesh, shard_train_step, batch_sharding,
                   replicate_sharding, bev_sharding, spatial_constrain,
                   reduce_stats_arrays, stats_to_arrays,
                   arrays_to_stats, tp_param_report, param_partition_spec)
from .distributed import (initialize, make_global_mesh, all_hosts_stats,
                          merge_stacked_stats, process_count, process_index)
from .pipeline import (make_pp_mesh, microbatch, pipeline_apply,
                       unmicrobatch)
from .moe import expert_sharding, init_moe_params, moe_mlp
from .mesh import expert_constrain

__all__ = [
    "make_mesh", "shard_train_step", "batch_sharding", "replicate_sharding",
    "bev_sharding", "spatial_constrain",
    "reduce_stats_arrays", "stats_to_arrays", "arrays_to_stats",
    "tp_param_report", "param_partition_spec",
    "initialize", "make_global_mesh", "all_hosts_stats",
    "merge_stacked_stats",
    "process_count", "process_index",
    "make_pp_mesh", "microbatch", "pipeline_apply", "unmicrobatch",
    "expert_sharding", "init_moe_params", "moe_mlp", "expert_constrain",
]
