"""Multi-device scale-out over an explicit mesh of devices.

Port of ``xmaps_tpu.parallel``.  The algorithm has no cross-frame
dependencies, so the natural shardings are
- ``data``: independent frames across devices (the moral equivalent of
  the reference's GNU-parallel eval fan-out, eval/x-map-eval.sh:49,57);
- ``event``: the events of one frame split across devices, with min/max
  of the frame time window and an unsigned max of the packed disparity
  scatter (exactly associative, so results are bit-identical to the
  single-device program).
"""

from xmaps_tpu_torch.parallel.sharding import (  # noqa: F401
    make_group_sharded_pipeline,
    make_mesh,
    make_sharded_pipeline,
    shard_batches,
    shard_staged_group,
)
