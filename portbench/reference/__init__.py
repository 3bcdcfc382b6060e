"""Plain PyTorch references, one module per `model_type` of a configuration
file: float32, no kernels, no cache, no batching.  They import nothing of
the port nor of the JAX package, and take the benchmark's inputs (the
quantized weight bytes and scales it made, token ids, pixels) and decode
them themselves."""
