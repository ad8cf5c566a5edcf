"""The parallel runtime on ``torch.distributed`` (port of qtpu/parallel):
meshes of ranks, one device per rank; tensor- and data-parallel serving
rules; spatial halo convs; the GPipe pipeline; the collectives they share;
and the launcher of a world of ranks.  qtpu's ``enable_overlap_flags``
(libtpu's scheduler flags) has no counterpart (ROADMAP.md A13)."""
from qtpu_torch.parallel.distributed import (initialize_from_env,
                                             local_batch_to_global,
                                             process_local_devices)
from qtpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, batch_sharding,
                                      make_mesh, serve_shardings,
                                      serve_variable_specs, shard_variables)
from qtpu_torch.parallel.pipeline import (PIPE_AXIS, make_pipeline_mesh,
                                          pipeline_apply, stage_local,
                                          stage_sharding)
from qtpu_torch.parallel.spatial import (SPATIAL_AXIS, make_spatial_mesh,
                                         spatial_conv2d, spatial_local,
                                         spatial_max_pool, spatial_sharding)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "PIPE_AXIS", "SPATIAL_AXIS",
           "batch_sharding", "make_mesh", "serve_shardings",
           "serve_variable_specs", "shard_variables", "initialize_from_env",
           "local_batch_to_global", "process_local_devices",
           "make_pipeline_mesh", "pipeline_apply", "stage_local",
           "stage_sharding", "make_spatial_mesh", "spatial_conv2d",
           "spatial_local", "spatial_max_pool", "spatial_sharding"]
