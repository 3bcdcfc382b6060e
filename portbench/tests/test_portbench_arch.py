"""Architectures as files of their own (`portbench/arch/<model_type>.py`).

1. The goldens (`arch_goldens.json`): the weights, the port's
   `ModelConfig` and the costs of the tiny Phi-3 and Phi-3.5-vision
   configurations (two seeds) and of both published configurations, as
   the harness computed them before architectures had modules of their
   own (the dense arithmetic in `roofline.py`, the sums of each forward
   made in `record.py`), captured with the same recorded forwards as
   below.  The modules reproduce them exactly.
2. An architecture added by new files alone: a Llama-3 module and its
   plain reference, under a `model_type` the harness does not know, put
   beside the packages' own files; a tiny docqa-shaped cell of it runs
   end to end on the CPU and comes out correct, its own cost is what
   `readings.least_time_s` sums, and its counter is read at the window's
   two ends.
"""

import dataclasses
import hashlib
import json
import sys
import textwrap
import types
from pathlib import Path

import pytest
import torch

from portbench import arch as A
from portbench import readings, serving, spec
from portbench import roofline as R
from portbench.arch import phi3
from portbench.record import Recorder
from portbench.run import run_cell
from portbench.tests import tiny

torch.set_num_threads(1)
H100 = "NVIDIA H100 80GB HBM3"
GOLDENS = json.loads((Path(__file__).parent / "arch_goldens.json")
                     .read_text())


def digest(obj, path="", out=None):
    """{path: sha256 of dtype, shape and bytes} of every tensor in a tree
    of dataclasses, dicts and lists; other leaves as they are."""
    out = {} if out is None else out
    if isinstance(obj, torch.Tensor):
        t = obj.detach().contiguous().cpu()
        h = hashlib.sha256()
        h.update(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"")
        out[path] = h.hexdigest()
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            digest(getattr(obj, f.name), f"{path}.{f.name}", out)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            digest(v, f"{path}.{k}", out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            digest(v, f"{path}[{i}]", out)
    elif obj is None or isinstance(obj, (int, float, str)):
        out[path] = obj
    else:
        raise TypeError(f"{path}: {type(obj)}")
    return out


def slot(pages, pos, out=0, max_new=100, req=True):
    r = types.SimpleNamespace(out=[0] * out, max_new_tokens=max_new)
    return types.SimpleNamespace(pages=list(pages), pos=pos,
                                 req=r if req else None)


def recorded(cfg, psz):
    """The fixed forwards, through the Recorder: decode steps with shared
    full pages, a lane whose reply ends inside the chunk, a shared partial
    page; chunks at position 0 (no logits), 64 and 300; image rows."""
    sched = types.SimpleNamespace(B=4, psz=psz, slots=[
        slot([3, 4, 5], 150), slot([3, 4, 6], 170), slot([7], 10),
        slot([], 0, req=False)])
    rec = Recorder(sched)
    rec.on = True
    rec._j = 0
    rec._decode()
    rec._j = 2
    sched.slots[2] = slot([7], 10, out=98)
    rec._decode()
    sched.slots = [slot([8, 9], 2 * psz - 1), slot([8, 10], psz + 1),
                   slot([11], 1), slot([12, 13], psz)]
    rec._j = 0
    rec._decode()
    ids = torch.zeros(32, dtype=torch.long)
    rec._prefill(ids, 0, None, 20)
    rec._prefill(ids, 64, torch.tensor([5]), 6)
    rec._prefill(torch.zeros(8, dtype=torch.long), 300, torch.tensor([2]), 3)
    rec._prefill(torch.zeros(32, cfg.dim), 100, None, 32)
    return rec


def published(name):
    return json.loads((tiny.ROOT / f"portbench/configs/{name}.json")
                      .read_text())


CASES = {"phi3/5": (tiny.tiny_conf, 5),
         "phi3/8589934599": (tiny.tiny_conf, 2**33 + 7),
         "phi3_v/5": (tiny.tiny_vision_conf, 5),
         "phi3_v/8589934599": (tiny.tiny_vision_conf, 2**33 + 7),
         "phi35-mini-q4": (lambda: published("phi35-mini-q4"), None),
         "phi35-vision-q8": (lambda: published("phi35-vision-q8"), None)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_goldens_of_the_dense_harness(case):
    want = GOLDENS[case]
    make, seed = CASES[case]
    conf = make()
    mod = A.load(conf["model_type"])
    if seed is None:
        cfg = serving.port_config(conf)
    else:
        cfg, w, params = serving.build_text(conf, seed, torch.device("cpu"))
        got = digest(w.text if "vision" in conf else w, "text")
        if "vision" in conf:
            got.update(digest(w.vision, "vision"))
        assert got == want["weights"]
        assert digest((params.rope_cos, params.rope_sin), "rope") == \
            want["rope"]
    assert json.loads(json.dumps(dataclasses.asdict(cfg))) == want["config"]
    rec = recorded(cfg, conf["serve"]["page_size"])
    # the dense decoder derives each forward's sums as the recorder did
    assert len(rec.forwards) == len(want["recorded"])
    for f, old in zip(rec.forwards, want["recorded"]):
        assert (f["kind"], f["rows"], f["t_q"], f["logit_rows"]) == \
            (old["kind"], old["rows"], old["t_q"], old["logit_rows"])
        assert phi3.sizes(f) == (old["kv_read"], old["keys"],
                                 old["embed_rows"])
    assert [mod.forward_cost(cfg, conf, f, {}) for f in rec.forwards] == \
        want["forward_cost"]
    peak = R.peaks(H100)
    att = []
    for f in rec.forwards:
        if f["kind"] == "decode" and f["rows"]:
            a = mod.attention_cost(cfg, conf, f, {})
            att.append(dict(a, least_s=R.bound_s(a["bytes"], a["ops_bf16"],
                                                 a["ops_int8"], peak)))
    assert att == want["attention_cost"]
    if "vision" in conf:
        rec.extra_costs.append(dict(kind="image", **R.image_cost(
            mod.vision_dims(conf), conf["serve"]["quant"],
            conf["serve"]["group_size"], 5, 757)))
    ctx = readings.Context(cfg=cfg, conf=conf, mix={}, card=H100, w0=0.0,
                           w1=1.0, setup_s=0.0, recs=[], c0={}, c1={},
                           recorder=rec)
    for kinds, value in want["least_time_s"].items():
        assert readings.least_time_s(ctx, tuple(kinds.split(","))) == value


# -- an architecture added by new files alone -----------------------------
LLAMA_ARCH = '''
    """Llama 3 (`model_type` llama): the dense decoder of `phi3.py` with a
    tied classifier and Llama-3's RoPE rescale, in the port's LLAMA
    family."""

    from portbench.arch import phi3
    from portbench.arch.phi3 import (attention_cost, make_weights,  # noqa
                                     port_params)

    COUNTERS = ("tiny_counter",)
    SEEN = []          # the counts each forward_cost call was given


    def port_config(conf):
        from lmrs_tpu_torch.config import ModelConfig, ModelType, RopeScaling

        rs = conf["rope_scaling"]
        return ModelConfig.make(
            ModelType.LLAMA, **phi3.config_kw(conf),
            rope_scaling=RopeScaling(
                factor=rs["factor"], low_freq_factor=rs["low_freq_factor"],
                high_freq_factor=rs["high_freq_factor"],
                original_context_len=rs["original_max_position_embeddings"]))


    def forward_cost(cfg, conf, fwd, counts):
        SEEN.append(dict(counts))
        return phi3.forward_cost(cfg, conf, fwd, counts)
'''

LLAMA_REFERENCE = '''
    """Llama 3, plain float32 PyTorch: `phi3.py`'s decoder with the
    Llama-3 RoPE rescale (Hugging Face `_compute_llama3_parameters`)."""

    import math

    import torch

    from portbench.reference.phi3 import Phi3, control_gaps, served_gaps  # noqa


    class Llama(Phi3):
        def rope(self, n, device):
            c, rs = self.c, self.c["rope_scaling"]
            j = torch.arange(self.hd // 2, dtype=torch.float64)
            inv = 1.0 / (c["rope_theta"] ** (2.0 * j / self.hd))
            wl = 2.0 * math.pi / inv
            orig = rs["original_max_position_embeddings"]
            lo, hi = rs["low_freq_factor"], rs["high_freq_factor"]
            smooth = (orig / wl - lo) / (hi - lo)
            mid = (1.0 - smooth) * inv / rs["factor"] + smooth * inv
            inv = torch.where(wl > orig / lo, inv / rs["factor"],
                              torch.where(wl < orig / hi, inv, mid))
            ang = torch.arange(n, dtype=torch.float64)[:, None] * inv[None]
            return (torch.cos(ang).float().to(device),
                    torch.sin(ang).float().to(device))


    MODEL = Llama
'''


def llama_conf() -> dict:
    """Llama-3.2-1B's file (rope and tied classifier) at two layers of
    width 256, 2 query heads of 128 over 1 KV head (the paged pool's 128
    lanes); serving and limits as `tiny.tiny_conf`'s.  On four CPU seeds
    (400-token samples) sound runs read widest gaps of 0-0.031 and mean
    gaps of 0-0.0003; the same served tokens against a reference without
    the rescale read 0.054-0.159 and 0.0007-0.0028."""
    t = tiny.tiny_conf()
    return {
        "source": "https://huggingface.co/meta-llama/Llama-3.2-1B/blob/main/"
                  "config.json",
        "model_type": "llama", "hidden_size": 256, "intermediate_size": 384,
        "num_hidden_layers": 2, "num_attention_heads": 2,
        "num_key_value_heads": 1, "head_dim": 128, "vocab_size": 512,
        "rms_norm_eps": 1e-5, "rope_theta": 500000.0,
        "rope_scaling": {"factor": 32.0, "low_freq_factor": 1.0,
                         "high_freq_factor": 4.0,
                         "original_max_position_embeddings": 8192,
                         "rope_type": "llama3"},
        "max_position_embeddings": 131072, "tie_word_embeddings": True,
        "max_context": 512, "serve": t["serve"], "check": t["check"]}


@pytest.fixture
def llama(tmp_path, monkeypatch):
    """`arch/llama.py` and `reference/llama.py` as new files in folders
    of their own that the two packages search first."""
    import portbench.arch
    import portbench.reference

    for pkg, text in ((portbench.arch, LLAMA_ARCH),
                      (portbench.reference, LLAMA_REFERENCE)):
        d = tmp_path / pkg.__name__.split(".")[-1]
        d.mkdir()
        (d / "llama.py").write_text(textwrap.dedent(text))
        monkeypatch.setattr(pkg, "__path__", [str(d), *pkg.__path__])
    yield A.load("llama")
    for name in ("portbench.arch.llama", "portbench.reference.llama"):
        sys.modules.pop(name, None)


def test_unknown_model_type_names_the_missing_module():
    conf = dict(tiny.tiny_conf(), model_type="no_such_model")
    c = tiny.cell("phi35-mini-q4.docqa-shared", conf, tiny.tiny_docqa())
    with pytest.raises(LookupError,
                       match="portbench/arch/no_such_model.py"):
        run_cell(c, 3, 1.0, False, "cpu")


def test_an_architecture_added_by_files_alone(llama):
    seen = {}

    def keep(ctx):
        seen["ctx"] = ctx                 # reads nothing: left out

    def reader(name):
        return spec._load_reader(name, spec.HERE)

    metrics = [spec.Metric(n, u, "", "", None, None, reader(n))
               for n, u in (("output_tok_s", "tokens/s"),
                            ("decode_step_ms", "ms"))]
    metrics.append(spec.Metric("ctx", "", "", "", None, None, keep))
    cell = spec.Cell(name="llama-tiny.docqa-shared", chips=1,
                     config_name="llama-tiny", config=llama_conf(),
                     traffic_name="docqa-shared", traffic=tiny.tiny_docqa(),
                     end_to_end=[], per_layer=metrics)

    def plant(sched):
        # a port counter that the module's cost names: one a forward
        sched.tiny_counter = 0
        orig = sched._fwd_b

        def fwd_b(*a, **kw):
            sched.tiny_counter += 1
            return orig(*a, **kw)

        sched._fwd_b = fwd_b

    r = run_cell(cell, 2**33 + 5, 3.0, True, "cpu", fault=plant)
    assert r["correct"], r["check"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"output_tok_s", "decode_step_ms"}
    ctx = seen["ctx"]
    assert ctx.cfg.model_type.name == "LLAMA" and ctx.cfg.tied_lm_head
    assert ctx.cfg.rope_scaling.factor == 32.0
    # the counter was read at w0 and at w1
    assert 0 < ctx.c0["tiny_counter"] < ctx.c1["tiny_counter"]
    counts = {"tiny_counter": ctx.delta("tiny_counter")}
    assert ctx.arch_counts() == counts
    # the module's own cost is what least_time_s sums (H100 peaks: the
    # CPU has none)
    h100 = dataclasses.replace(ctx, card=H100)
    fwds = [f for f in ctx.recorder.forwards
            if f["kind"] in ("decode", "prefill")]
    assert {f["kind"] for f in fwds} == {"decode", "prefill"}
    llama.SEEN.clear()
    want = 0.0
    for f in fwds:
        c = llama.forward_cost(h100.cfg, h100.conf, f, counts)
        want += R.bound_s(c["bytes"], c["ops_bf16"], c["ops_int8"],
                          R.peaks(H100))
    assert len(llama.SEEN) == len(fwds)
    llama.SEEN.clear()
    assert readings.least_time_s(h100, ("decode", "prefill")) == want
    assert llama.SEEN == [counts] * len(fwds)
