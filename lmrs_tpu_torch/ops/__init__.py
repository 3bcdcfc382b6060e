"""Tensor ops around the kernels: norms, activations, RoPE, attention,
quantized matmul dispatch and sampling."""
