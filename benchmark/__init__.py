"""The benchmark of `motionestimation_tpu_torch` on NVIDIA cards (README.md)."""
