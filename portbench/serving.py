"""The system under test, built from a configuration file through the
module of its architecture (`arch/<model_type>.py`): the port's
`ModelConfig`, the benchmark's weights from the seed and the port's params
over them, the image encoder where the architecture has one, and the
batched server (`BatchScheduler` on a paged pool, stepped by a
`SchedulerThread`) with the settings `serve/backend.py` passes for
`--batch N --max-ctx C --pool-tokens P`."""

from __future__ import annotations

from portbench import arch as A


def port_config(conf: dict):
    """The port's ModelConfig of a configuration file."""
    return A.load(conf["model_type"]).port_config(conf)


def build_text(conf: dict, seed: int, device):
    """(cfg, the benchmark's weights, the port's decoder params over
    them)."""
    mod = A.load(conf["model_type"])
    cfg = mod.port_config(conf)
    w = mod.make_weights(cfg, conf, seed, device)
    return cfg, w, mod.port_params(cfg, w)


def port_vision(conf: dict, weights):
    """The port's image encoder over the benchmark's weights, or None for
    an architecture without one."""
    fn = getattr(A.load(conf["model_type"]), "port_vision", None)
    return None if fn is None else fn(weights)


def build_scheduler(cfg, params, conf: dict, batch: int, seed: int, device,
                    cache_dtype=None):
    """The backend's batched scheduler (`serve/backend.py`: page 512,
    prefill chunk min(256, page), decode chunk 8, its temperature and
    top-p, W8A8 on) over a paged pool of `pool_tokens`."""
    from lmrs_tpu_torch.serve.scheduler import BatchScheduler

    s = conf["serve"]
    return BatchScheduler(
        cfg, params, max_batch=batch, max_ctx=conf["max_context"],
        cache_dtype=cache_dtype or s["cache_dtype"],
        temperature=s["temperature"], top_p=s["top_p"], seed=seed,
        pool_tokens=s["pool_tokens"], page_size=s["page_size"],
        prefill_chunk=min(s["prefill_chunk"], s["page_size"]),
        decode_chunk=s["decode_chunk"], w8a8=s["w8a8"], device=device)
