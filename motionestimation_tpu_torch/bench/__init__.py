from motionestimation_tpu_torch.bench.regression import (  # noqa: F401
    Regression,
    compare_rows,
    compare_versions,
    read_rows,
    write_results,
)
