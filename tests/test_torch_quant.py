"""lmrs_tpu_torch.quant against lmrs_tpu.quant: activation quantizers, Q4
unpacking in both byte layouts, the file->runtime repack and dequantize.

Tolerance: bit-exact everywhere.  Both sides do the same float32
operations in the same order, and the integer outputs must match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lmrs_tpu.quant as jq
import lmrs_tpu_torch.quant as tq
from lmrs_tpu_torch.config import QuantType

RNG = np.random.default_rng(0)


def _act_input(gs):
    """Random activations plus the rounding traps: exact +-x.5 ties after
    scaling, and an all-zero group."""
    x = RNG.normal(0, 1, (5, 4 * gs)).astype(np.float32)
    # group 1 of row 0: absmax 127 makes the Q8 scale exactly 1, so the
    # values below are exact ties
    x[0, gs:2 * gs] = 0.0
    x[0, gs:gs + 6] = [127.0, 2.5, -2.5, 0.5, -0.5, 63.5]
    # group 1 of row 1: absmax 8 makes the Q4 scale exactly -1
    x[1, gs:2 * gs] = 0.0
    x[1, gs:gs + 5] = [8.0, 0.5, -0.5, 3.5, -3.5]
    x[2, 2 * gs:3 * gs] = 0.0                      # all-zero group
    return x


@pytest.mark.parametrize("gs", [32, 128])
@pytest.mark.parametrize("which", ["q8", "q4"])
def test_activation_quantizers_bit_exact(gs, which):
    x = _act_input(gs)
    jf = jq.quantize_q8_act if which == "q8" else jq.quantize_q4_act
    tf = tq.quantize_q8_act if which == "q8" else tq.quantize_q4_act
    jv, js = jf(jnp.asarray(x), gs)
    tv, ts = tf(torch.from_numpy(x), gs)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the ties really round away from zero (torch.round would give even)
    if which == "q8":
        assert tv[0, gs + 1:gs + 6].tolist() == [3, -3, 1, -1, 64]
    assert np.all(tv.numpy()[2, 2 * gs:3 * gs] == (0 if which == "q8" else -8))


@pytest.mark.parametrize("gs", [16, 32, 128])
def test_unpack_and_repack_bit_exact(gs):
    packed = RNG.integers(0, 256, (6, 3 * gs // 2), dtype=np.uint8)
    np.testing.assert_array_equal(
        tq.unpack_q4_file(torch.from_numpy(packed)).numpy(),
        np.asarray(jq.unpack_q4_file(jnp.asarray(packed))))
    np.testing.assert_array_equal(
        tq.unpack_q4(torch.from_numpy(packed), gs).numpy(),
        np.asarray(jq.unpack_q4(jnp.asarray(packed), gs)))
    want = jq.q4_file_to_runtime_np(packed, gs)
    np.testing.assert_array_equal(tq.q4_file_to_runtime_np(packed, gs), want)
    np.testing.assert_array_equal(
        tq.q4_file_to_runtime(torch.from_numpy(packed), gs).numpy(), want)
    # the repack is a permutation: runtime unpack == file unpack
    np.testing.assert_array_equal(
        tq.unpack_q4(torch.from_numpy(want), gs).numpy(),
        tq.unpack_q4_file(torch.from_numpy(packed)).numpy())


@pytest.mark.parametrize("qtype", [QuantType.Q8_0, QuantType.Q4_0])
def test_export_quantizers_and_dequantize_bit_exact(qtype):
    gs = 32
    w = RNG.normal(0, 0.1, (8, 4 * gs)).astype(np.float32)
    w[3, :gs] = 0.0                                  # all-zero group
    jfn = jq.quantize_q80_np if qtype == QuantType.Q8_0 else jq.quantize_q40_np
    tfn = tq.quantize_q80_np if qtype == QuantType.Q8_0 else tq.quantize_q40_np
    jv, js, je = jfn(w, gs)
    tv, ts, te = tfn(w, gs)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ts, js)
    assert te == je

    jqt = jq.qtensor_from_float_np(w, jq.QuantType(int(qtype)), gs)
    tqt = tq.QTensor(torch.from_numpy(np.array(jqt.q)),
                     torch.from_numpy(np.array(jqt.s)), qtype, gs, 8,
                     4 * gs)
    np.testing.assert_array_equal(tq.dequantize(tqt).numpy(),
                                  np.asarray(jq.dequantize(jqt)))
