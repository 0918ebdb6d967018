"""The port of the JAX repo's `tools/`: the speed-of-light tools.

* `vpu_peak`: the elementwise peak of the card's FP32 lanes under the
  fma, mix and roll instruction mixes (P1), and the phase kernel's
  difference chain in isolation (P2).
* `kern_lab`: the full-search lab's two endpoint schemes on 2048x2048
  8x8 +-12 work, the cross term (L2: variants "P0", "P1") and the diff form
  with a packed key (L4: "P4", "P4S").

Their kernels live in kernels/csrc/lab.cu (kernels/lab_cuda.py). Nothing
here imports JAX or the JAX repo's `tools/`: each module keeps its own
copy of the constants it needs.
"""
