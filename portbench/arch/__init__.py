"""Model architectures, one module per `model_type` of a configuration
file (`arch/<model_type>.py`), found by that name as `reference/` is.

A module provides:
- `port_config(conf)`: the port's `ModelConfig` of a configuration file;
- `make_weights(cfg, conf, seed, device)`: the benchmark's weights, made
  from the seed, which the plain reference reads;
- `port_params(cfg, weights)`: the port's params over them, which its
  scheduler runs;
- `forward_cost(cfg, conf, fwd, counts)` and `attention_cost(cfg, conf,
  fwd, counts)`: the bytes and operations (`bytes`, `ops_bf16`,
  `ops_int8`) of one forward that `record.Recorder` recorded (its raw
  sizes: a decode step's lanes as (pages, rows) and its page size, a
  chunk's start position and rows), and of a decode step's attention;
  `counts` holds the window's change of each counter in `COUNTERS`;
- optionally `COUNTERS`: names of port counters that its costs need,
  read at the window's two ends with the harness's own (`run.counters`);
- optionally `port_vision(weights)`: the port's image encoder over the
  weights, for a model whose turns may begin with an image.

The rules of counting that every architecture shares are `roofline.py`'s.
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Tuple


def load(model_type: str) -> ModuleType:
    """The module of `model_type`; a LookupError that names the missing
    file where there is none."""
    name = f"{__name__}.{model_type}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise LookupError(
            f"no architecture module for model_type {model_type!r}: "
            f"portbench/arch/{model_type}.py is missing") from None


def counters(mod: ModuleType) -> Tuple[str, ...]:
    return tuple(getattr(mod, "COUNTERS", ()))
