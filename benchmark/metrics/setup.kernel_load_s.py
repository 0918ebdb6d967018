"""setup.kernel_load_s: the seconds the program spent building and opening
its kernel libraries in the run's process (`kernels._build.load_s`, read
at the end of the run), nvcc included where the run built."""
import sys


def read(run):
    build = sys.modules.get("motionestimation_tpu_torch.kernels._build")
    return getattr(build, "load_s", None) or None
