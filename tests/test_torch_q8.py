"""The plain versions of the port's Q8_0 kernels D (q8_gemv_i8), E (q8_gemv)
and F (q8_gemm), and the Q8_0 / float dispatch of ops.matmul.qmatmul,
against the JAX functions that reach the TPU kernels they replace, run in
interpret mode on the CPU as the JAX tests run them.  A CPU tensor takes
the plain version; the kernels themselves run only on the card
(chip_smoke.py and the `gpu` tests of tests/test_torch_cuda.py hold each
against its plain version there).

Each test names its JAX reference, because the JAX package's Q8 numerics
depend on the weight layout and the call site:
- row-major stacked weights, T <= 8, LMRS_W8A8=1 (the default): W8A8,
  `qmatmul_pallas_stacked` -> `_q8_xei8_stacked_kernel`.  D's reference.
- the same with LMRS_W8A8=0: W8A16 with bf16-rounded x,
  `_q8_xe_stacked_kernel`; unstacked weights (the classifier),
  `qmatmul_pallas_xe` -> `_q8_xe_kernel`, the same numerics whatever the
  switch says; K-major tiles at T = 1, `qmatmul_kmajor` -> `_vm_q8_kernel`,
  W8A16 with f32 x.  E's references.
- row-major stacked weights, 9 <= T <= 512: `_q8_se_stacked_kernel`.  F's
  reference.

Tolerances, stated at each assert:
- D: both sides quantize x with the same bit-exact quantizer and take exact
  integer dots per group; they differ only in the f32 order of the sum over
  groups: 1e-5 of the output scale.
- E vs the bf16-x kernels: x is made bf16-representable, so both sides
  multiply the same operands exactly and differ in the f32 summation order:
  1e-5.  E vs the K-major kernel: f32 x on both sides, the same 1e-5.
- F: the same bf16 operands and W_deq rounding on both sides: 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.kernels.dequant_matmul import (qmatmul_pallas_stacked,
                                             qmatmul_pallas_xe)
from lmrs_tpu.kernels.vpu_matvec import qmatmul_kmajor, to_kmajor
from lmrs_tpu.ops.matmul import qmatmul as jax_qmatmul
from lmrs_tpu.quant import QTensor as JQTensor
from lmrs_tpu.quant import QuantType as JQuantType
from lmrs_tpu.quant import qtensor_from_float_np

from lmrs_tpu_torch.config import QuantType
from lmrs_tpu_torch.kernels import launches, reset_launches
from lmrs_tpu_torch.kernels.q8_gemm import q8_gemm
from lmrs_tpu_torch.kernels.q8_gemv import q8_gemv, q8_gemv_plain
from lmrs_tpu_torch.kernels.q8_gemv_i8 import (q8_act_quant, q8_gemv_i8,
                                               q8_gemv_i8_plain)
from lmrs_tpu_torch.ops.matmul import qmatmul
from lmrs_tpu_torch.quant import QTensor, quantize_q8_act

RNG = np.random.default_rng(0)
GS = 128


def _weights(o, k, layers=2):
    w = RNG.normal(0, 0.1, (layers, o, k)).astype(np.float32)
    return qtensor_from_float_np(w, JQuantType.Q8_0, GS)


def _layer(qt, layer):
    """Layer `layer` of a stacked JAX QTensor as an unstacked one."""
    return JQTensor(qt.q[layer], qt.s[layer], qt.qtype, qt.group_size,
                    qt.out_features, qt.in_features)


def _bf16_exact(x):
    """x rounded to bf16 and back: operands both sides see exactly."""
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _port(qt, layer):
    return (torch.from_numpy(np.array(qt.q[layer])),
            torch.from_numpy(np.array(qt.s[layer])))


def _assert_close_scaled(got, want, rel):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _act(t, k):
    """Activations with an all-zero group and a group of exact .5 ties."""
    x = RNG.normal(0, 1, (t, k)).astype(np.float32)
    x[0, :GS] = 0.0
    x[-1, GS:2 * GS] = 0.0
    x[-1, GS:GS + 5] = [127.0, 2.5, -2.5, 0.5, -63.5]
    return x


@pytest.mark.parametrize("t", [1, 4, 8])
def test_w8a8_gemv_plain_matches_stacked_xei8_kernel(t, monkeypatch):
    """Reference: qmatmul_pallas_stacked, Q8_0, T <= 8, W8A8 on."""
    monkeypatch.delenv("LMRS_W8A8", raising=False)      # the default: on
    o, k = 384, 512
    qt = _weights(o, k)
    x = _act(t, k)
    want = np.asarray(qmatmul_pallas_stacked(jnp.asarray(x), qt, 1,
                                             interpret=True))
    reset_launches()
    got = q8_gemv_i8(torch.from_numpy(x), *_port(qt, 1), GS).numpy()
    assert launches()["q8_gemv_i8"] == 0    # CPU tensors: the plain version
    _assert_close_scaled(got, want, 1e-5)   # f32 order of the group sum


@pytest.mark.parametrize("t", [1, 5])
def test_w8a8_gemv_plain_matches_exact_path(t):
    """Reference: ops.matmul.qmatmul(impl="exact"), the integer contraction
    with bit-parity to lm.rs."""
    o, k = 256, 640
    qt = _weights(o, k, layers=1)
    x = _act(t, k)
    want = np.asarray(jax_qmatmul(jnp.asarray(x), _layer(qt, 0),
                                  impl="exact"))
    got = q8_gemv_i8(torch.from_numpy(x), *_port(qt, 0), GS).numpy()
    _assert_close_scaled(got, want, 1e-5)   # f32 order of the group sum


def test_w8a8_quantizer_wrapper_is_the_plain_quantizer_on_cpu():
    x = torch.from_numpy(_act(3, 512))
    a, b = q8_act_quant(x, GS), quantize_q8_act(x, GS)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("t", [1, 3])
def test_w8a16_gemv_plain_matches_unstacked_xe_kernel(t):
    """Reference: qmatmul_pallas_xe, Q8_0 (the classifier's kernel)."""
    o, k = 512, 512
    qt = _weights(o, k, layers=1)
    x = _bf16_exact(RNG.normal(0, 1, (t, k)).astype(np.float32))
    want = np.asarray(qmatmul_pallas_xe(jnp.asarray(x), _layer(qt, 0),
                                        interpret=True))
    reset_launches()
    got = q8_gemv(torch.from_numpy(x), *_port(qt, 0), GS).numpy()
    assert launches()["q8_gemv"] == 0       # CPU tensors: the plain version
    _assert_close_scaled(got, want, 1e-5)   # f32 summation order only


def test_w8a16_gemv_plain_matches_stacked_xe_kernel(monkeypatch):
    """Reference: qmatmul_pallas_stacked, Q8_0, T <= 8, W8A8 off."""
    monkeypatch.setenv("LMRS_W8A8", "0")
    o, k = 384, 512
    qt = _weights(o, k)
    x = _bf16_exact(RNG.normal(0, 1, (2, k)).astype(np.float32))
    want = np.asarray(qmatmul_pallas_stacked(jnp.asarray(x), qt, 0,
                                             interpret=True))
    got = q8_gemv(torch.from_numpy(x), *_port(qt, 0), GS).numpy()
    _assert_close_scaled(got, want, 1e-5)   # f32 summation order only


def test_w8a16_gemv_plain_matches_kmajor_vpu_kernel():
    """Reference: qmatmul_kmajor, Q8_0, T = 1 (f32 activations)."""
    o, k = 512, 1024
    qt = _weights(o, k, layers=1)
    x = RNG.normal(0, 1, (1, k)).astype(np.float32)
    want = np.asarray(qmatmul_kmajor(jnp.asarray(x), to_kmajor(qt), 0,
                                     interpret=True))
    got = q8_gemv(torch.from_numpy(x), *_port(qt, 0), GS).numpy()
    _assert_close_scaled(got, want, 1e-5)   # f32 summation order only


@pytest.mark.parametrize("t", [9, 64])
def test_q8_gemm_plain_matches_stacked_se_kernel(t):
    """Reference: qmatmul_pallas_stacked, Q8_0, 9 <= T <= 512."""
    o, k = 256, 512
    qt = _weights(o, k)
    x = RNG.normal(0, 1, (t, k)).astype(np.float32)
    want = np.asarray(qmatmul_pallas_stacked(jnp.asarray(x), qt, 0,
                                             interpret=True))
    reset_launches()
    got = q8_gemm(torch.from_numpy(x), *_port(qt, 0), GS).numpy()
    assert launches()["q8_gemm"] == 0       # CPU tensors: the plain version
    _assert_close_scaled(got, want, 1e-5)   # same bf16 operands


def _port_qtensor(qt, layer, qtype=QuantType.Q8_0):
    q, s = _port(qt, layer)
    return QTensor(q, s, qtype, GS, q.shape[0], q.shape[1])


def test_qmatmul_dispatch_of_q8_weights():
    """Layer weights at T <= 8: D by default, E with w8a8 off; the
    classifier: E whatever w8a8 says; 9 <= T <= 512: F; T > 512: the
    dequantize-then-product branch, as the JAX fast path's (1e-5: the same
    bf16 operands, sums in another order)."""
    o, k = 128, 256
    qt = _weights(o, k, layers=1)
    w = _port_qtensor(qt, 0)
    x = torch.from_numpy(_act(4, k))
    d = q8_gemv_i8_plain(x, w.q, w.s, GS)
    e = q8_gemv_plain(x, w.q, w.s, GS)
    assert not torch.equal(d, e)
    assert torch.equal(qmatmul(x, w), d)
    assert torch.equal(qmatmul(x, w, w8a8=False), e)
    assert torch.equal(qmatmul(x, w, classifier=True), e)
    assert torch.equal(qmatmul(x, w, w8a8=True, classifier=True), e)
    x9 = torch.from_numpy(RNG.normal(0, 1, (2, 6, k)).astype(np.float32))
    got = qmatmul(x9, w)
    assert got.shape == (2, 6, o)
    assert torch.equal(got.reshape(12, o),
                       q8_gemm(x9.reshape(12, k), w.q, w.s, GS))
    big = RNG.normal(0, 1, (520, k)).astype(np.float32)
    want = np.asarray(jax_qmatmul(jnp.asarray(big), _layer(qt, 0),
                                  impl="fast"))
    _assert_close_scaled(qmatmul(torch.from_numpy(big), w).numpy(), want,
                         1e-5)


@pytest.mark.parametrize("t", [1, 12, 600])
def test_qmatmul_of_float_weights_matches_jax(t):
    """QuantType.NONE: one f32 product on both sides, outside any kernel
    (reference: ops.matmul.qmatmul with impl "fast", which falls through to
    the f32 dot).  1e-6 of the output scale: f32 sums in another order."""
    o, k = 96, 160
    wf = RNG.normal(0, 0.1, (o, k)).astype(np.float32)
    x = RNG.normal(0, 1, (t, k)).astype(np.float32)
    jw = JQTensor(jnp.asarray(wf), None, JQuantType.NONE, GS, o, k)
    want = np.asarray(jax_qmatmul(jnp.asarray(x), jw, impl="fast"))
    w = QTensor(torch.from_numpy(wf), None, QuantType.NONE, GS, o, k)
    reset_launches()
    got = qmatmul(torch.from_numpy(x), w).numpy()
    assert not any(launches().values())
    _assert_close_scaled(got, want, 1e-6)
