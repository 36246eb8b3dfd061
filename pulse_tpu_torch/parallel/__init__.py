"""Data-parallel training over torch.distributed (`mesh`)."""

from pulse_tpu_torch.parallel.mesh import (Mesh, all_gather_rows, all_reduce_mean_, all_reduce_sum_, global_mean,
                                           init_process_group, make_mesh, pmoments, rank_seed, replicate,
                                           rollout_generator, shard_env_axis, shard_train_state, use_mesh)

__all__ = [
    "Mesh", "all_gather_rows", "all_reduce_mean_", "all_reduce_sum_", "global_mean", "init_process_group",
    "make_mesh", "pmoments", "rank_seed", "replicate", "rollout_generator", "shard_env_axis", "shard_train_state",
    "use_mesh",
]
