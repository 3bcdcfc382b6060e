"""Whole runs of the harness on the CPU at a tiny size, with the look for a
chip skipped: a sound run comes out correct; with the timed path broken
underneath (each fault a served cell can have), `correct` comes out false;
the lower precision control reads above the sound run; a mix and a metric
added as new files and entries alone are run."""

import json
import shutil

import pytest
import torch

from portbench.run import run_cell
from portbench.tests import tiny

torch.set_num_threads(1)
SEED = 2**33 + 7
DOCQA = "phi35-mini-q4.docqa-shared"
CHAT = "phi35-mini-q4.chat-sessions"
IMAGES = "phi35-vision-q8.image-sessions"


def run(name, mix, fault=None, seconds=3.0, trace=False, conf=None):
    if name == IMAGES:
        c = tiny.image_cell(conf, mix)
    else:
        c = tiny.cell(name, conf or tiny.tiny_conf(), mix)
    return run_cell(c, SEED, seconds, trace, "cpu", fault=fault, keep=True)


@pytest.mark.parametrize("name,mix", [(DOCQA, tiny.tiny_docqa()),
                                      (CHAT, tiny.tiny_chat())])
def test_sound_run_is_correct(name, mix):
    r = run(name, mix)
    assert r["correct"], r["check"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) >= {"tpot_p90_ms", "setup_s", "output_tok_s"}
    # greedy ties may flip on the port's bf16 products: a gap well under
    # the limit
    assert r["check"]["widest_gap"]["value"] <= \
        r["check"]["widest_gap"]["limit"]


def test_traced_run_reads_the_counters():
    r = run(DOCQA, tiny.tiny_docqa(), trace=True, seconds=3.0)
    assert r["correct"]
    assert "decode_step_ms" in r["metrics"]
    assert "prefix_hit_share" in r["metrics"]
    # no device trace on the CPU: the device's readings are left out
    assert "step_mfu.decode" not in r["metrics"]


def test_chat_reads_its_ttft_in_the_traced_run():
    """The chat cell's TTFT tail is a per-layer reading: the untraced run
    leaves it out, the traced run gives the end-to-end arithmetic's value
    under `ttft_p90_ms.chat`."""
    r = run(CHAT, tiny.tiny_chat())
    assert "ttft_p90_ms" not in r["metrics"]
    assert "ttft_p90_ms.chat" not in r["metrics"]
    r = run(CHAT, tiny.tiny_chat(), trace=True)
    assert r["correct"], r["check"]
    v = r["metrics"]["ttft_p90_ms.chat"]
    assert v["unit"] == "ms" and 0 < v["value"] < float("inf")


def fault_stale_state(sched):
    """A decode step that leaves the cache as it was: its K/V rows go to
    the trash page."""
    import lmrs_tpu_torch.models.transformer as tf

    orig = tf._write_index

    def write_index(cache, pos, t_q, table=None):
        i0, i1 = orig(cache, pos, t_q, table)
        if table is not None and t_q == 1:
            i0 = torch.zeros_like(i0)
        return i0, i1

    tf._write_index = write_index
    return lambda: setattr(tf, "_write_index", orig)


def fault_half_batch(sched):
    """Half of the batch left out: the upper half's lanes take the lower
    half's logits."""
    orig = sched._fwd_b

    def fwd_b(x, p, t_q=1, table=None, logit_idx=None, want_logits=True):
        out = orig(x, p, t_q, table, logit_idx, want_logits)
        if t_q == 1 and out is not None and out.shape[0] == sched.B:
            h = sched.B // 2
            out = out.clone()
            out[h:2 * h] = out[:h]
        return out

    sched._fwd_b = fwd_b


def fault_altered_token(sched):
    """A token altered where it is produced: step 3 of every decode chunk
    samples the next id."""
    import lmrs_tpu_torch.serve.scheduler as sm

    orig, n = sm.sample_batched, [0]

    def sample(*a, **kw):
        t = orig(*a, **kw)
        n[0] += 1
        return (t + 1) % sched.cfg.vocab_size if n[0] % 8 == 3 else t

    sm.sample_batched = sample
    return lambda: setattr(sm, "sample_batched", orig)


def image_conf():
    conf = tiny.tiny_vision_conf()
    conf["check"].update(sample_tokens=200, sample_turns=20)
    return conf


@pytest.mark.parametrize("fault", [fault_stale_state, fault_half_batch,
                                   fault_altered_token])
@pytest.mark.parametrize("name,mix,conf,seconds", [
    (DOCQA, tiny.tiny_docqa(), None, 3.0),
    (CHAT, tiny.tiny_chat(), None, 3.0),
    (IMAGES, tiny.tiny_images(), image_conf(), 14.0)])
def test_faults_are_not_correct(fault, name, mix, conf, seconds):
    undo = []
    try:
        r = run(name, mix, fault=lambda s: undo.append(fault(s)),
                conf=conf, seconds=seconds)
    finally:
        for u in undo:
            if u:
                u()
    assert not r["correct"], r["check"]
    # caught by what the served tokens say, not by a short sample
    assert r["check"]["widest_gap"]["value"] > \
        r["check"]["widest_gap"]["limit"]
    assert r["check"]["widest_gap"]["value"] > \
        r["check"]["widest_gap"]["limit"]


def test_lower_precision_control_reads_higher():
    from portbench import check as C

    r = run(DOCQA, tiny.tiny_docqa())
    weights, picked, served = r["_sample"]
    conf = tiny.tiny_conf()
    model, mod = C.reference(conf, weights)
    low, _ = C.reference(conf, weights, act_quant="fp8")
    ctl = []
    for t in picked:
        ctl += mod.control_gaps(model, low, t.context, t.spec.prompt, t.out,
                                "cpu").tolist()
    assert max(ctl) > conf["check"]["max_gap"] >= max(served)


def test_int8_pool_control_is_not_correct():
    """The control: the program with its own int8 KV pool switched on,
    where the configuration states bf16, comes out not correct through the
    run's own verdict (tiny chat cell, a sample of 400 served tokens: sound
    runs read mean gaps of 0.0002-0.0008, the int8 pool 0.006-0.010, and
    widest gaps of 0.02-0.06 and 0.21-0.42, on CPU runs of four seeds)."""
    conf = tiny.tiny_conf()
    conf["check"].update(sample_tokens=400, sample_turns=60)
    sound = run(CHAT, tiny.tiny_chat(), conf=conf)
    assert sound["correct"], sound["check"]
    conf["serve"]["cache_dtype"] = "int8"
    ctl = run(CHAT, tiny.tiny_chat(), conf=conf)
    assert not ctl["correct"], ctl["check"]
    assert ctl["check"]["served_tokens"]["value"] >= 100
    assert ctl["check"]["mean_gap"]["value"] > \
        ctl["check"]["mean_gap"]["limit"]


def test_added_mix_and_metric_run_as_files_alone(tmp_path):
    """A later change adds a traffic mix and a per-layer metric by new files
    and new entries in BENCHMARK.json alone."""
    from portbench.spec import HERE, load_cell

    pkg = tmp_path / "portbench"
    shutil.copytree(HERE / "metrics", pkg / "metrics")
    shutil.copytree(HERE / "traffic", pkg / "traffic")
    shutil.copytree(HERE / "configs", tmp_path / "portbench" / "configs")
    mix = dict(tiny.tiny_docqa(), clients=3, batch=3)
    (pkg / "traffic" / "dummy-mix.json").write_text(json.dumps(mix))
    (pkg / "metrics" / "dummy_turns.py").write_text(
        "def read(ctx):\n    return float(len(ctx.due()))\n")
    bench = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "phi35-mini-q4.dummy",
                               "config": "phi35-mini-q4",
                               "traffic": "dummy-mix", "chips": 1,
                               "why": "a test's dummy mix"})
    bench["per_layer"].append({"name": "dummy_turns", "unit": "turns",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "scheduler",
                               "moves": "tpot_p90_ms",
                               "workloads": ["phi35-mini-q4.dummy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("phi35-mini-q4.dummy", tmp_path, pkg)
    assert cell.traffic == mix
    cell.config = tiny.tiny_conf()
    r = run_cell(cell, SEED, 1.5, True, "cpu")
    assert r["correct"]
    assert r["metrics"]["dummy_turns"]["value"] == r["attempted"] > 0


def test_image_cell_sound():
    r = run(IMAGES, tiny.tiny_images(), conf=image_conf(), seconds=8.0)
    assert r["correct"], r["check"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"output_tok_s", "setup_s"}
    # every conversation starts with its image: the checked turns' cached
    # context begins with it
    picked = r["_sample"][1]
    assert picked and all(t.context[0][0] == "image" for t in picked)
    r = run(IMAGES, tiny.tiny_images(), conf=image_conf(), seconds=8.0,
            trace=True)
    assert r["correct"], r["check"]
    # no device trace on the CPU: the counters' and the host clock's
    assert set(r["metrics"]) == {"decode_step_ms.image", "ttft_p90_ms.image",
                                 "tpot_p90_ms.image", "image_fill_ms"}
