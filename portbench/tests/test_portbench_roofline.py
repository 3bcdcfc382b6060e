"""The yardstick's counts against hand counts."""

import pytest
import torch

from portbench import roofline as R
from portbench.serving import port_config
from portbench.tests import tiny

torch.set_num_threads(1)


def phi():
    import json
    conf = json.loads((tiny.ROOT / "portbench/configs/phi35-mini-q4.json")
                      .read_text())
    return port_config(conf)


def test_kv_row_bytes_at_published_head_dim():
    cfg = phi()
    assert cfg.head_dim == 96 and cfg.cache_head_dim == 128
    # 32 layers x (K, V) x 32 heads x 96 x 2 bytes, not the 128 lanes
    assert R.kv_row_bytes(cfg, "bfloat16") == 32 * 2 * 32 * 96 * 2
    assert R.kv_row_bytes(cfg, "int8") == 32 * 2 * 32 * 96


def test_shared_page_counts_once():
    psz = 512
    doc = [7, 8, 9]                       # a shared prefix's full pages
    lanes = [(doc + [20], 3 * psz + 100), (doc + [21], 3 * psz + 300),
             ([30, 31], psz + 5)]
    # pages 7, 8, 9 once; 20 and 21 each their own rows; 30 whole, 31 five
    assert R.unique_rows(lanes, psz) == 3 * psz + 100 + 300 + psz + 5
    # the same page reached by two lanes at different depths: the deeper
    assert R.unique_rows([([4], 10), ([4], 30)], psz) == 30


def test_weight_bytes_hand_count():
    cfg = phi()
    per_layer = (9216 + 3072 + 16384) * 3072 + 3072 * 8192
    q4 = per_layer * (0.5 + 4 / 128)
    assert R.weight_bytes(cfg, "Q4_0", 128, False, 0) == \
        pytest.approx(32 * q4)
    head = 32064 * 3072 * (0.5 + 4 / 128)
    assert R.weight_bytes(cfg, "Q4_0", 128, True, 2) == \
        pytest.approx(32 * q4 + head + 2 * 3072 * (0.5 + 4 / 128))


def test_forward_cost_and_bound():
    cfg = phi()
    c = R.forward_cost(cfg, "Q4_0", 128, "bfloat16", rows=4, logit_rows=4,
                       kv_read_rows=1000, kv_write_rows=4, attn_keys=1000)
    macs = (9216 + 3072 + 16384) * 3072 + 3072 * 8192
    assert c["ops_bf16"] == pytest.approx(
        2 * 4 * 32 * macs + 2 * 4 * 32064 * 3072 + 4 * 32 * 32 * 96 * 1000)
    assert c["ops_int8"] == 0
    peak = R.PEAKS["NVIDIA H100 80GB HBM3"]
    # a decode step is bound by its bytes
    assert R.bound_s(c["bytes"], c["ops_bf16"], 0, peak) == \
        pytest.approx(c["bytes"] / 3.35e12)
    w8 = R.forward_cost(cfg, "Q8_0", 128, "bfloat16", rows=4, logit_rows=0,
                        kv_read_rows=0, kv_write_rows=4, attn_keys=10,
                        int8_rows=True)
    assert w8["ops_int8"] == pytest.approx(2 * 4 * 32 * macs)
    a = R.attention_cost(cfg, "bfloat16", 1000, 1000, 1)
    assert a["bytes"] == 1000 * 32 * 2 * 32 * 96 * 2 + 2 * 4 * 32 * 32 * 96
