"""A tiny Phi-3-shaped configuration and small mixes for CPU runs of the
harness: head_dim 96 (the paged pool's 128 lanes), two layers."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from portbench import spec

ROOT = Path(__file__).resolve().parents[2]


def tiny_conf() -> dict:
    """Phi-3.5-mini's file at two layers of width 192.  Its output check's
    limits are the tiny model's own, set from CPU runs of four seeds: sound
    runs read widest gaps of 0 to 0.06 and mean gaps of 0.0002 to 0.0013
    (400-token samples), the program's int8 pool 0.21 to 0.42 and 0.006 to
    0.010 on the chat mix, the fp8 control 0.27 to 0.38, a planted fault
    1 or more."""
    conf = json.loads((ROOT / "portbench/configs/phi35-mini-q4.json")
                      .read_text())
    conf.update(hidden_size=192, intermediate_size=256, num_hidden_layers=2,
                num_attention_heads=2, num_key_value_heads=2,
                vocab_size=512, max_context=512)
    conf["serve"].update(group_size=32, page_size=64, prefill_chunk=32,
                         pool_tokens=64 * 40)
    conf["check"] = {"max_gap": 0.12, "max_mean_gap": 0.004,
                     "sample_tokens": 20, "sample_turns": 4, "min_tokens": 20}
    return conf


def tiny_docqa() -> dict:
    return {"loop": "closed", "batch": 4, "clients": 4, "rounds": 6,
            "shared_prefix": {"count": 3, "tokens": [70, 140], "zipf_s": 1.0},
            "prompt_tokens": [4, 16], "output_tokens": [6, 20],
            "greedy_share": 0.5, "trace_seconds": 1.0}


def tiny_chat() -> dict:
    return {"loop": "closed", "batch": 3, "clients": 3, "rounds": 8,
            "session": {"lease": True, "history_tokens": [40, 120],
                        "later_history_tokens": [8, 24]},
            "prompt_tokens": [4, 16], "output_tokens": [6, 24],
            "greedy_share": 0.67, "trace_seconds": 1.0}


def cell(workload: str, conf: dict, mix: dict) -> spec.Cell:
    """The BENCHMARK.json cell `workload` with its configuration and mix
    replaced."""
    c = spec.load_cell(workload, ROOT)
    c = copy.copy(c)
    c.config, c.traffic = conf, mix
    return c


def tiny_vision_conf() -> dict:
    """The vision configuration at tiny widths: a 3-layer tower of width
    32 (577 positions a crop, 4 crops), the text model as `tiny_conf`'s
    with room for an image's 764 rows."""
    conf = json.loads((ROOT / "portbench/configs/phi35-vision-q8.json")
                      .read_text())
    t = tiny_conf()
    for k in ("hidden_size", "intermediate_size", "num_hidden_layers",
              "num_attention_heads", "num_key_value_heads"):
        conf[k] = t[k]                  # the vocabulary stays: image ids
    conf["vision"].update(hidden_size=32, intermediate_size=64,
                          num_hidden_layers=3, num_attention_heads=2)
    conf["max_context"] = 1536
    conf["serve"].update(group_size=32, page_size=64, prefill_chunk=32,
                         pool_tokens=64 * 100)
    conf["check"] = {"max_gap": 0.12, "max_mean_gap": 0.004,
                     "sample_tokens": 20, "sample_turns": 4, "min_tokens": 20}
    return conf


def tiny_images() -> dict:
    return {"loop": "closed", "batch": 3, "clients": 3, "rounds": 40,
            "session": {"lease": True, "turns": 3},
            "image": {"long_side": [400, 700],
                      "aspects": [[4, 3], [3, 4], [16, 9], [9, 16]],
                      "rows": 764},
            "prompt_tokens": [4, 12], "output_tokens": [6, 16],
            "greedy_share": 0.5, "trace_seconds": 1.0}


IMAGE_METRICS = {"output_tok_s": "tokens/s", "setup_s": "s"}
IMAGE_PER_LAYER = {"decode_step_ms.image": "ms", "ttft_p90_ms.image": "ms",
                   "tpot_p90_ms.image": "ms", "image_fill_ms": "ms",
                   "step_mfu.image": "%", "encode_roofline.image": "%",
                   "device_idle_share.image": "%"}


def image_cell(conf: dict, mix: dict) -> spec.Cell:
    """The image cell, which BENCHMARK.json does not hold yet (PERF.md's
    first open question): the vision configuration under the
    image-sessions mix, with the readers its metrics would have."""
    def metrics(units):
        return [spec.Metric(n, u, "", "", None, None,
                            spec._load_reader(n, spec.HERE))
                for n, u in units.items()]

    return spec.Cell(name="phi35-vision-q8.image-sessions", chips=1,
                     config_name="phi35-vision-q8", config=conf,
                     traffic_name="image-sessions", traffic=mix,
                     end_to_end=metrics(IMAGE_METRICS),
                     per_layer=metrics(IMAGE_PER_LAYER))
