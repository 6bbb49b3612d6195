"""The multi-GPU plane: mesh, partition rules, collectives, checkpoints.

Counterpart of ``synapseml_tpu/parallel``, the gang (elastic training,
:mod:`.gang`) included. The GPipe pipeline module waits for ROADMAP.md
queue A item 9's ``pipe`` axis.
"""

from .backend import (DistributedBackend, DriverRendezvous, initialize_backend, reset_backend,
                      worker_rendezvous)
from .batching import (DoubleBufferedFeeder, PaddedBatch, batches, bucket_size, pad_batch,
                       pad_sequences, round_up_to_multiple, unpad)
from .checkpoint import (AsyncCheckpointer, CheckpointCorrupt, checkpoint_meta,
                         checkpoint_sharding, checkpoint_world, commit_checkpoint,
                         gc_checkpoints, latest_step, latest_verified_step, restore_checkpoint,
                         restore_host_states, save_checkpoint, save_checkpoint_shard,
                         verify_checkpoint)
from .gang import (EXIT_PREEMPTED, EXIT_RESIZE, ElasticResume, GangAborted, GangCoordinator,
                   GangWorker, Preempted, elastic_restore, run_gang_member)
from .mesh import MeshConfig, MeshContext, P, create_mesh, logical_axis_rules, shard_params
from .partition import (PartitionRules, apply_manifest_sharding, checkpoint_sharding_fn,
                        default_llama_rules, default_transformer_rules, emit_shard_metrics,
                        match_partition_rules, opt_state_specs, shard_tree,
                        sharding_manifest_section, split_stage_params, stack_stages)

__all__ = [
    "DistributedBackend", "DriverRendezvous", "initialize_backend", "reset_backend",
    "worker_rendezvous",
    "DoubleBufferedFeeder", "PaddedBatch", "batches", "bucket_size", "pad_batch",
    "pad_sequences", "round_up_to_multiple", "unpad",
    "AsyncCheckpointer", "CheckpointCorrupt", "checkpoint_meta",
    "checkpoint_sharding", "checkpoint_world", "commit_checkpoint",
    "gc_checkpoints", "latest_step", "latest_verified_step",
    "restore_checkpoint", "restore_host_states", "save_checkpoint",
    "save_checkpoint_shard", "verify_checkpoint",
    "EXIT_PREEMPTED", "EXIT_RESIZE", "ElasticResume", "GangAborted", "GangCoordinator",
    "GangWorker", "Preempted", "elastic_restore", "run_gang_member",
    "MeshConfig", "MeshContext", "P", "create_mesh", "logical_axis_rules", "shard_params",
    "PartitionRules", "apply_manifest_sharding", "checkpoint_sharding_fn",
    "default_llama_rules", "default_transformer_rules", "emit_shard_metrics",
    "match_partition_rules", "opt_state_specs", "shard_tree",
    "sharding_manifest_section", "split_stage_params", "stack_stages",
]
