"""lmrs_tpu_torch — the PyTorch / CUDA port of lmrs_tpu.

Serves `.lmrs` Q4_0 models on an NVIDIA Hopper GPU through hand-written
CUDA kernels (`lmrs_tpu_torch/csrc`).  Same module layout as the JAX
package `lmrs_tpu`, which stays the reference; this package imports none
of it.
"""
