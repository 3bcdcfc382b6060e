"""The plain reference against the port's forward on the CPU, at a tiny
Phi-3-shaped configuration (head_dim 96), Q4_0 and Q8_0 weights."""

import pytest
import torch

from portbench import serving
from portbench.reference.phi3 import Phi3, control_gaps, served_gaps
from portbench.tests import tiny

torch.set_num_threads(1)


def port_logits(cfg, params, toks, chunk=32):
    from lmrs_tpu_torch.models.transformer import forward, init_kv_cache

    cache = init_kv_cache(cfg, "cpu", torch.bfloat16, seq_len=128)
    return torch.cat([forward(params, cfg, cache, toks[p:p + chunk], p,
                              logit_idx="all")
                      for p in range(0, toks.shape[0], chunk)])


def test_reference_matches_the_ports_float_path():
    """The same model: the port with the weights dequantized to float32
    (its plain product) against the reference; the port's attention
    rounds q, K, V and the softmax weights to bf16 (its serving numerics),
    a few thousandths of the logits' spread (~1)."""
    import dataclasses

    from lmrs_tpu_torch.config import QuantType
    from lmrs_tpu_torch.models.transformer import forward, init_kv_cache
    from lmrs_tpu_torch.quant import QTensor, dequantize

    conf = tiny.tiny_conf()
    # without the outlier lanes, whose 8x larger K and V values the port's
    # bf16 attention rounds 8x coarser (the quantized test below has them)
    conf.pop("synthetic_weights")
    cfg, w, params = serving.build_text(conf, 5, torch.device("cpu"))

    def f32(qt):
        return QTensor(dequantize(qt), None, QuantType.NONE, qt.group_size,
                       qt.out_features, qt.in_features)

    p32 = dataclasses.replace(
        params, embed=f32(params.embed), lm_head=f32(params.lm_head),
        layers=[dataclasses.replace(l, wqkv=f32(l.wqkv), wo=f32(l.wo),
                                    w13=f32(l.w13), w2=f32(l.w2))
                for l in params.layers])
    cfg32 = cfg.replace(quant=QuantType.NONE)
    toks = torch.randint(0, cfg.vocab_size, (70,),
                         generator=torch.Generator().manual_seed(1))
    cache = init_kv_cache(cfg32, "cpu", torch.float32, seq_len=128)
    got = torch.cat([forward(p32, cfg32, cache, toks[p:p + 32], p,
                             logit_idx="all") for p in range(0, 70, 32)])
    ref = Phi3(conf, w).logits(toks.tolist(), range(70), "cpu")
    assert (got - ref).abs().max().item() < 0.06


# The port's quantized products take bf16 activations and bf16-rounded
# dequantized weights (kernel B's numerics; a Q8_0 tail of <= 8 rows takes
# int8 activations, W8A8), on top of the bf16 attention above: at two
# layers of width 192 a logit moves by up to a tenth of the logits'
# spread (~1), and the first choice agrees on nearly every row (counted
# over four models' 70 rows each: one model's near-ties swing its share
# between 0.93 and 1).
@pytest.mark.parametrize("quant,tol", [("Q4_0", 0.2), ("Q8_0", 0.2)])
def test_reference_matches_the_port(quant, tol):
    conf = tiny.tiny_conf()
    conf.pop("synthetic_weights")       # as in the test above
    conf["serve"]["quant"] = quant
    agree = []
    for seed in (5, 6, 7, 8):
        cfg, w, params = serving.build_text(conf, seed, torch.device("cpu"))
        toks = torch.randint(0, cfg.vocab_size, (70,),
                             generator=torch.Generator().manual_seed(1))
        got = port_logits(cfg, params, toks)
        ref = Phi3(conf, w).logits(toks.tolist(), range(70), "cpu")
        assert (got - ref).abs().max().item() < tol
        agree.append(got.argmax(1) == ref.argmax(1))
    assert torch.cat(agree).float().mean().item() > 0.95


def test_reference_rows_and_gaps():
    conf = tiny.tiny_conf()
    _, w, _ = serving.build_text(conf, 6, torch.device("cpu"))
    m = Phi3(conf, w)
    seq = list(range(1, 41))
    full = m.logits(seq, range(40), "cpu")
    # a row's logits do not depend on the rows after it (causal)
    assert torch.allclose(m.logits(seq[:20], [19], "cpu"), full[19:20],
                          atol=1e-4)
    # the reference's own greedy tokens are 0 below its best
    ctx, prompt = seq[:10], seq[10:20]
    out = [int(full[19].argmax())]
    for _ in range(5):
        nxt = m.logits(ctx + prompt + out, [len(ctx + prompt + out) - 1],
                       "cpu")
        out.append(int(nxt[0].argmax()))
    assert served_gaps(m, ctx, prompt, out, "cpu").abs().max() == 0
    # another token is below by its gap
    bad = list(out)
    bad[2] = (bad[2] + 1) % conf["vocab_size"]
    assert served_gaps(m, ctx, prompt, bad, "cpu")[2] > 0
    # a control that is the reference itself reads 0
    assert control_gaps(m, m, ctx, prompt, out, "cpu").max() == 0


def test_image_reference_against_the_port():
    """The reference's crops equal the port's preprocessing bit for bit;
    its tower and projector follow the port's within the activation
    quantizer's rounding steps (a float32 sum's last bit flips a rounding,
    which moves a row by a step of its group)."""
    import numpy as np

    from lmrs_tpu_torch.models.phi3v import (encode_image_to_embeds,
                                             preprocess_image)
    from portbench import images
    from portbench.reference.phi3_v import Phi3V, hd_crops

    conf = tiny.tiny_vision_conf()
    dev = torch.device("cpu")
    cfg, w, params = serving.build_text(conf, 3, dev)
    vision = serving.port_vision(conf, w)
    spec = (500, 666, 7)
    img = images.pixels(spec)
    pre = conf["preprocessor"]
    for shape in ((500, 666), (666, 500), (377, 670)):
        im = img[:shape[0], :shape[1]] if shape[0] <= 500 else \
            np.ascontiguousarray(img.transpose(1, 0, 2))[:shape[0],
                                                         :shape[1]]
        p, w_crop, h_crop, n = preprocess_image(im, 4)
        x, wc, hc = hd_crops(im, 4, pre["image_mean"], pre["image_std"])
        assert (wc, hc) == (w_crop, h_crop)
        ours = torch.from_numpy(p).reshape(n, 24, 24, 3, 14, 14)
        ours = ours.permute(0, 3, 1, 4, 2, 5).reshape(n, 3, 336, 336)
        assert torch.equal(ours, torch.from_numpy(x))
    m = Phi3V(conf, w)
    got = encode_image_to_embeds(vision, params, cfg, img, 4)
    want = m.item_rows(("image", spec), "cpu")
    assert got.shape == want.shape == (m.item_length(("image", spec)),
                                       cfg.dim)
    d = (got - want).abs()
    assert d.max().item() < 0.02 * want.abs().max().item()
    assert (d > 1e-3 * want.abs().max().item()).float().mean() < 0.05


def test_kv_outlier_lanes():
    """The K and V rows of each head's lowest-frequency rotary pair (lanes
    47 and 95 of 96) take the configuration's larger scale; no other row
    changes."""
    from portbench.arch.phi3 import kv_outlier_rows

    conf = tiny.tiny_conf()
    cfg, w, _ = serving.build_text(conf, 5, torch.device("cpu"))
    plain = dict(conf)
    plain.pop("synthetic_weights")
    _, w0, _ = serving.build_text(plain, 5, torch.device("cpu"))
    rows = kv_outlier_rows(cfg, 1)
    att = cfg.n_heads * cfg.head_dim
    kv = cfg.n_kv_heads * cfg.head_dim
    assert rows == [att + 47, att + 95, att + 96 + 47, att + 96 + 95,
                    att + kv + 47, att + kv + 95, att + kv + 96 + 47,
                    att + kv + 96 + 95]
    for lw, lw0 in zip(w.layers, w0.layers):
        s, s0 = lw["wqkv"].s, lw0["wqkv"].s
        assert torch.equal(s[rows], 8.0 * s0[rows])
        rest = torch.ones(s.shape[0], dtype=torch.bool)
        rest[rows] = False
        assert torch.equal(s[rest], s0[rest])
        assert torch.equal(lw["wqkv"].q, lw0["wqkv"].q)
