"""The yardstick's counts, and the dense decoder's (`arch/phi3.py`),
against hand counts."""

import copy
import json

import pytest
import torch

from portbench import roofline as R
from portbench.arch import phi3 as A
from portbench.serving import port_config
from portbench.tests import tiny

torch.set_num_threads(1)
CONF = json.loads((tiny.ROOT / "portbench/configs/phi35-mini-q4.json")
                  .read_text())


def phi():
    return port_config(CONF)


def test_kv_row_bytes_at_published_head_dim():
    cfg = phi()
    assert cfg.head_dim == 96 and cfg.cache_head_dim == 128
    # 32 layers x (K, V) x 32 heads x 96 x 2 bytes, not the 128 lanes
    assert A.kv_row_bytes(cfg, "bfloat16") == 32 * 2 * 32 * 96 * 2
    assert A.kv_row_bytes(cfg, "int8") == 32 * 2 * 32 * 96


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
    assert A.weight_bytes(cfg, "Q4_0", 128, False, 0) == \
        pytest.approx(32 * q4)
    head = 32064 * 3072 * (0.5 + 4 / 128)
    assert A.weight_bytes(cfg, "Q4_0", 128, True, 2) == \
        pytest.approx(32 * q4 + head + 2 * 3072 * (0.5 + 4 / 128))


def test_forward_cost_and_bound():
    cfg = phi()
    # four lanes of 250 rows on pages of their own: 1,000 rows, 1,000 keys
    lanes = [((2 * i, 2 * i + 1), 250) for i in range(4)]
    step = dict(kind="decode", rows=4, t_q=64, logit_rows=4, lanes=lanes,
                page_size=512)
    assert A.sizes(step) == (1000, 1000, 4)
    c = A.forward_cost(cfg, CONF, step, {})
    macs = (9216 + 3072 + 16384) * 3072 + 3072 * 8192
    assert c["ops_bf16"] == pytest.approx(
        2 * 4 * 32 * macs + 2 * 4 * 32064 * 3072 + 4 * 32 * 32 * 96 * 1000)
    assert c["ops_int8"] == 0
    assert c["bytes"] == pytest.approx(
        A.weight_bytes(cfg, "Q4_0", 128, True, 4)
        + 1004 * A.kv_row_bytes(cfg, "bfloat16") + 4.0 * 4 * 32064)
    peak = R.PEAKS["NVIDIA H100 80GB HBM3"]
    # a decode step is bound by its bytes
    assert R.bound_s(c["bytes"], c["ops_bf16"], 0, peak) == \
        pytest.approx(c["bytes"] / 3.35e12)
    q8 = copy.deepcopy(CONF)
    q8["serve"]["quant"] = "Q8_0"
    # a 4-row chunk at position 0: 1 + 2 + 3 + 4 keys, W8A8 under 8 rows
    chunk = dict(kind="prefill", start=0, rows=4, t_q=8, logit_rows=0)
    assert A.sizes(chunk) == (4, 10, 4)
    w8 = A.forward_cost(cfg, q8, chunk, {})
    assert w8["ops_int8"] == pytest.approx(2 * 4 * 32 * macs)
    assert w8["ops_bf16"] == pytest.approx(4 * 32 * 32 * 96 * 10)
    a = A.attention_cost(cfg, CONF, step, {})
    assert a["bytes"] == 1000 * 32 * 2 * 32 * 96 * 2 + 2 * 4 * 4 * 32 * 32 * 96


def test_chunk_and_image_row_sizes():
    """A chunk at position p reads p + rows KV rows; its row i attends to
    p + i + 1 keys; image rows gather no embedding rows."""
    chunk = dict(kind="prefill", start=300, rows=3, t_q=8, logit_rows=1)
    assert A.sizes(chunk) == (303, 3 * 300 + 6, 3)
    rows = dict(chunk, kind="embeds", start=100, rows=32, t_q=32)
    assert A.sizes(rows) == (132, 32 * 100 + 32 * 33 // 2, 0)
