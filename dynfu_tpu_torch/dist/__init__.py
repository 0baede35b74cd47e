"""The multi-GPU layer: the sharded parity and fusion engines over
torch.distributed.

Port of dynfu_tpu/dist/. JAX runs one process over an N-device mesh and
lets GSPMD place the collectives; here each rank is a process on its own
device and the collectives are written out (dist/spmd.py):

* the TSDF volume is block-partitioned along x; integrate is per voxel;
  the edge extraction and marching cubes exchange one halo plane on each
  side and apply their capacities over all blocks;
* the live vertex set is each block's (in rank order the single card's
  scan order); the canonical's warp is split into row ranges;
* the node state is replicated; the GN data Gram is each rank's float64
  partial, added over ranks in rank order and rounded once;
* fusion mode (sharded_fusion_frame) re-extracts its canonical every frame
  from the blocks (a halo of 2 planes) and gathers it in rank order, so it
  is replicated; its vertex stages run on row ranges, and the SE(3)
  solve's monomial Grams and data costs are float64 partials reduced in
  rank order too;
* the per-frame fusion step (spmd.sharded_fusion_step) raycasts the whole
  image over the blocks with the separable slab sweep
  (spmd.sharded_raycast: each rank sweeps every ray over its own samples;
  the records' first events combined by select) and solves over the
  raycast's rows, sharded into row ranges.

The answer is the single card's: selections, counts and the volume exactly,
the Gram but for float64 rounding ties.

Imports are lazy (module __getattr__), so `dynfu_tpu_torch.dist.runtime`
imports without the engine, as the source's rendezvous needed
(dynfu_tpu/dist/__init__.py).
"""

_EXPORTS = {
    "ShardedDynFusion": ("dynfu_tpu_torch.dist.driver", "ShardedDynFusion"),
    "init_distributed": ("dynfu_tpu_torch.dist.runtime", "init_distributed"),
    "is_primary": ("dynfu_tpu_torch.dist.runtime", "is_primary"),
    "spawn": ("dynfu_tpu_torch.dist.runtime", "spawn"),
    "place_engine_state": ("dynfu_tpu_torch.dist.engine_spmd",
                           "place_engine_state"),
    "sharded_engine_frame": ("dynfu_tpu_torch.dist.engine_spmd",
                             "sharded_engine_frame"),
    "sharded_fusion_frame": ("dynfu_tpu_torch.dist.engine_spmd",
                             "sharded_fusion_frame"),
    "sharded_fusion_step": ("dynfu_tpu_torch.dist.spmd",
                            "sharded_fusion_step"),
    "sharding_overhead": ("dynfu_tpu_torch.dist.engine_spmd",
                          "sharding_overhead"),
    "make_mesh": ("dynfu_tpu_torch.dist.spmd", "make_mesh"),
    "shard_volume": ("dynfu_tpu_torch.dist.spmd", "shard_volume"),
    "gather_volume": ("dynfu_tpu_torch.dist.spmd", "gather_volume"),
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    try:
        mod_name, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib

    return getattr(importlib.import_module(mod_name), attr)
