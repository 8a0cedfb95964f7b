"""Multi-device on ``torch.distributed`` (counterpart of the JAX
package's ``parallel/``): the mesh of process ranks, data-parallel
cohort inference, window-parallel sliding-window inference, the halo
exchange of D-sharded volumes and the sliding window's apply function on
them."""

from .infer import (make_dp_segmenter, make_dp_whole_predictor,
                    segment_cohort, segment_cohort_whole,
                    sliding_window_inference_mp)
from .mesh import (batch_sharding, create_mesh, initialize_distributed,
                   local_device_count, mesh_from_config, replicated,
                   shard_batch)
from .spatial import make_spatial_apply

__all__ = ["batch_sharding", "create_mesh", "local_device_count",
           "make_dp_segmenter", "make_dp_whole_predictor",
           "make_spatial_apply",
           "mesh_from_config", "replicated", "segment_cohort",
           "segment_cohort_whole", "shard_batch",
           "sliding_window_inference_mp"]
