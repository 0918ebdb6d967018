"""Run configuration.

The reference exposes exactly these knobs through positional argv (current
frame, reference frame, output dir, block dim, extra span, width, height)
plus a per-binary metric. They live in one frozen dataclass with the same
fields and validation as `motionestimation_tpu.core.config.SearchConfig`,
so `SearchConfig(**dataclasses.asdict(other))` converts between the two.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Static configuration for one motion-estimation run.

    Attributes:
      blk_dim: macroblock side in pixels (reference default 8 for MSE).
      span: the search window extends ±span pixels beyond the block on
        every side, clamped to the frame.
      metric: "mse" (SSD/N, minimised), "sad" (integer Σ|diff|,
        minimised, same scan and tie rules as MSE) or "ssim" (maximised).
      algorithm: "full" (exhaustive raster scan) or "diamond".
      early_term: diamond-only per-pixel early-termination threshold.
      escape_policy: diamond staged-escalation policy, "canonical" or
        "crossover".
      frame_width / frame_height: luma plane dimensions.
    """

    blk_dim: int = 8
    span: int = 12
    metric: str = "mse"
    algorithm: str = "full"
    early_term: float | None = None
    escape_policy: str = "canonical"
    frame_width: int = 352
    frame_height: int = 288

    def __post_init__(self):
        if self.blk_dim < 1:
            raise ValueError(f"blk_dim must be >= 1, got {self.blk_dim}")
        if self.span < 0:
            raise ValueError(f"span must be >= 0, got {self.span}")
        if self.metric not in ("mse", "sad", "ssim"):
            raise ValueError(
                f"metric must be 'mse', 'sad' or 'ssim', got {self.metric!r}"
            )
        if self.algorithm not in ("full", "diamond"):
            raise ValueError(
                f"algorithm must be 'full' or 'diamond', got {self.algorithm!r}"
            )
        if self.early_term is not None and self.algorithm != "diamond":
            raise ValueError(
                "early_term only applies to algorithm='diamond' "
                "(full search is exhaustive by definition)"
            )
        if self.escape_policy not in ("canonical", "crossover"):
            raise ValueError(
                f"escape_policy must be 'canonical' or 'crossover', "
                f"got {self.escape_policy!r}"
            )
        if self.escape_policy != "canonical" and self.algorithm != "diamond":
            raise ValueError(
                "escape_policy only applies to algorithm='diamond'"
            )
        if self.frame_width < 1 or self.frame_height < 1:
            raise ValueError("frame dimensions must be positive")

    @property
    def num_candidates(self) -> int:
        """Size of the (un-clamped) candidate displacement lattice."""
        k = 2 * self.span + 1
        return k * k
