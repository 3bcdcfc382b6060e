"""Image turns: the pixels the benchmark sends, and the job that encodes an
image and fills its rows into a leased slot on the scheduler's thread, as
`serve/backend.py`'s `_ingest_image_batched` composes
`models.phi3v.encode_image_to_embeds` and `BatchScheduler.prefill_embeds`
in one `SchedulerThread.call` job."""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np

from portbench import roofline as R
from portbench.reference.phi3_v import image_pixels

CONTEXT_FULL = "the image and a turn after it do not fit the context"


# the (H, W, 3) uint8 pixels of an image (H, W, seed): the raw input that
# the port and the reference both read
pixels = image_pixels


def pixels_for(script, mix: dict, seconds: float) -> Dict[tuple, np.ndarray]:
    """The images of the sessions that arrive before the window can close
    (made in set-up: a client's pixels are not server work)."""
    horizon = float(mix.get("ramp_seconds", 0.0)) + seconds + 5.0
    out = {}
    for c, turns in enumerate(script.clients):
        if script.arrivals is not None and script.arrivals[c] > horizon:
            break
        for t in turns:
            if t.image is not None:
                out[t.image] = pixels(t.image)
    return out


def job_maker(sched, cfg, params, vision, conf: dict, dev,
              spans: List[tuple], images: Dict[tuple, np.ndarray],
              recorder: Callable[[], Optional[object]],
              before: Callable[[], None] = lambda: None):
    """job(lease, image) -> None, or why the rows did not go in; to be run
    on the scheduler's thread.  Each job's host-clock span (synchronised
    at its end) goes to `spans`; in a traced run it is a `record_function`
    span and, while the trace runs, its tower and projector cost is
    recorded.  `before()` runs first (a traced run starts its stretch
    there)."""
    import torch

    from lmrs_tpu_torch.models.phi3v import encode_image_to_embeds
    from lmrs_tpu_torch.serve.scheduler import PoolExhausted

    num_crops = conf["preprocessor"]["num_crops"]
    vc = vision[0]
    dims = dict(dim=vc.dim, hidden_dim=vc.hidden_dim, n_layers=vc.n_layers,
                n_heads=vc.n_heads, patch_size=vc.patch_size,
                image_size=vc.image_size, text_dim=cfg.dim)

    def run(lease, spec) -> Optional[str]:
        img = images.get(spec)
        if img is None:
            img = pixels(spec)
        embeds = encode_image_to_embeds(vision, params, cfg, img, num_crops)
        if sched.slots[lease.slot_idx].pos + embeds.shape[0] + 1 \
                >= sched.S:
            return CONTEXT_FULL
        try:
            sched.prefill_embeds(lease, embeds)
        except PoolExhausted:
            return "kv page pool exhausted by the image"
        rec = recorder()
        if rec is not None and rec.on:
            crops = _crops(img.shape[0], img.shape[1], num_crops)
            rows = embeds.shape[0]
            c = R.image_cost(dims, conf["serve"]["quant"],
                             conf["serve"]["group_size"], 1 + crops,
                             rows - 7)
            rec.extra_costs.append(dict(kind="image", **c))
        return None

    def job(lease, spec) -> Optional[str]:
        before()
        t0 = time.perf_counter()
        rec = recorder()
        if rec is not None:
            from torch.profiler import record_function

            with record_function("image.job"):
                err = run(lease, spec)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        else:
            err = run(lease, spec)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        spans.append(("image.job", t0, time.perf_counter()))
        return err

    return job


def _crops(h: int, w: int, num_crops: int) -> int:
    """Sub-image crops of an (h, w) image under the HD transform."""
    if w < h:
        h, w = w, h
    ratio = w / h
    scale = 1
    while scale * np.ceil(scale / ratio) <= num_crops:
        scale += 1
    scale -= 1
    new_w = int(scale * 336)
    new_h = int(new_w / ratio)
    return (new_w // 336) * int(np.ceil(new_h / 336))
