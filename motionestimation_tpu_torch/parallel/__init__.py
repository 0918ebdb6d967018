"""Spatial and batch parallelism over a device mesh (the port of
`motionestimation_tpu.parallel`, without its scaling model)."""
from motionestimation_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from motionestimation_tpu_torch.parallel.sharded import (  # noqa: F401
    gather,
    sharded_full_search,
    sharded_gop_pipelined,
    sharded_motion_step,
)
