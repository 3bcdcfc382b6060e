"""Tensor, context and data parallelism over torch.distributed."""
