"""Block-matching motion estimation on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch port of `motionestimation_tpu`: the same full-search MSE, SAD
and SSIM paths (search, compensation, PSNR or residual scores, the 5-frame
stacked output, the GOP pipeline) with the Pallas kernels of those paths
rewritten as CUDA C++ kernels for sm_90a, and the sharded path over a
mesh of devices.
The JAX package stays the reference; this package imports neither it nor
JAX.

Layering (bottom to top), mirroring the JAX package:

    core.geometry    block-grid / search-window math
    core.frames      YUV I/O, PSNR, host compensation (numpy)
    core.device      device resolution (CUDA unless the caller asks for CPU)
    metrics.cost     SSD/SAD cost helpers, the SSIM score
    search           plain-torch golden full search
    kernels          CUDA kernels (csrc/) with their plain versions beside them
    parallel         meshes of devices, halo exchange, the sharded step
                     and ingest (torch.distributed across processes)
    pipeline         the frame-pair runner with CUDA-event timing, the
                     GOP pipeline (pinned buffers, a copy stream, threads)
                     and the sharded GOP
    cli              argv-compatible command-line driver
"""

__version__ = "0.1.0"

from motionestimation_tpu_torch.core.config import SearchConfig  # noqa: F401
