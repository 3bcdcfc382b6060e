"""portbench: the benchmark of lmrs_tpu_torch, the PyTorch and CUDA port.

One command runs one cell of `BENCHMARK.json` once, from the root of a
checkout:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one model configuration, one traffic mix, one
metric or one model architecture is a file of its own, found by the name
`BENCHMARK.json` or the configuration gives it: `configs/<config>.json`,
`traffic/<traffic>.json`, `metrics/<metric>.py`, and for the configuration's
`model_type` `arch/<model_type>.py` (the port's config, weights and params,
and the bytes and operations of a forward) beside its plain reference
`reference/<model_type>.py`.  The harness imports the port
(`lmrs_tpu_torch`) and nothing of the JAX package; `reference/` imports
nothing of either.
"""
