"""Kernels B (q4_gemm) and F (q8_gemm) cover two more TPU kernels: the
unstacked `_q4_kernel` and `_q8_kernel`
(`lmrs_tpu/kernels/dequant_matmul.py:837` and `:806`), which the JAX
package reaches through `qmatmul_pallas` for unstacked weights at 9 <= T
<= 512 rows: the classifier of a batched step of more than 8 rows
(`forward_batched` at B > 8, or B*(k+1) > 8 under speculation).  They take
bf16 activations, bf16(bf16(w) * bf16(s)) weights and f32 sums, the
function B and F compute.  Their plain versions against `qmatmul_pallas`
in interpret mode at T = 9 and 16, and `ops.matmul.qmatmul` on an
unstacked (classifier) weight at those T picks them.

Tolerance: 1e-5 of the output scale (the same bf16 operands and weight
rounding on both sides, f32 sums in another order).

Kernels E (q8_gemv, T <= 8) and F (T > 8) cover the third: the
experimental group-loop `_q8_kernel_gl` (`dequant_matmul.py:220`, reached
only through `qmatmul_pallas_gl` from `scripts/kbench.py`).  It computes
bf16(q) . bf16(x) summed per group in f32, times the f32 row scale.  The
port's classifier `qmatmul(x, w, classifier=True)` on an unstacked Q8_0
weight against it at T 1 and 5 (E) and 16 (F).  Tolerance 5e-3 of the
output scale: E keeps x in f32 where the group loop rounds it to bf16
(up to 2^-9 of each product); F rounds x as the group loop does but
rounds the weights to bf16(bf16(q) * bf16(s)) where the group loop
scales the f32 sums (up to 2^-9 of each weight).  Measured here: 1.8e-3
to 2.4e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.kernels.dequant_matmul import qmatmul_pallas, qmatmul_pallas_gl
from lmrs_tpu.quant import QuantType as JQuantType
from lmrs_tpu.quant import qtensor_from_float_np

from lmrs_tpu_torch.config import QuantType
from lmrs_tpu_torch.kernels import launches, reset_launches
from lmrs_tpu_torch.kernels.q4_gemm import q4_gemm
from lmrs_tpu_torch.kernels.q8_gemm import q8_gemm
import lmrs_tpu_torch.ops.matmul as matmul_module
from lmrs_tpu_torch.ops.matmul import qmatmul
from lmrs_tpu_torch.quant import QTensor

torch.set_num_threads(1)

GS = 128


@pytest.mark.parametrize("quant", ["q4", "q8"])
@pytest.mark.parametrize("t", [9, 16])
def test_gemm_plain_matches_unstacked_pallas_kernel(quant, t):
    """Reference: qmatmul_pallas (unstacked) -> _q4_kernel / _q8_kernel."""
    rng = np.random.default_rng(t + (quant == "q8"))
    o, k = 512, 1024
    w = rng.normal(0, 0.1, (o, k)).astype(np.float32)
    jq = JQuantType.Q4_0 if quant == "q4" else JQuantType.Q8_0
    qt = qtensor_from_float_np(w, jq, GS)
    x = rng.normal(0, 1, (t, k)).astype(np.float32)
    want = np.asarray(qmatmul_pallas(jnp.asarray(x), qt, interpret=True))
    q = torch.from_numpy(np.array(qt.q))
    s = torch.from_numpy(np.array(qt.s))
    kernel, name = ((q4_gemm, "q4_gemm") if quant == "q4"
                    else (q8_gemm, "q8_gemm"))
    reset_launches()
    got = kernel(torch.from_numpy(x), q, s, GS).numpy()
    assert launches()[name] == 0        # CPU tensors: the plain version
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    # the classifier of a batched step of t rows takes the same function
    qtype = QuantType.Q4_0 if quant == "q4" else QuantType.Q8_0
    cls = QTensor(q, s, qtype, GS, o, k)
    via = qmatmul(torch.from_numpy(x), cls, classifier=True).numpy()
    np.testing.assert_array_equal(via, got)


@pytest.mark.parametrize("t,kernel", [(1, "q8_gemv"), (5, "q8_gemv"),
                                      (16, "q8_gemm")])
def test_classifier_matches_group_loop_kernel(monkeypatch, t, kernel):
    """Reference: qmatmul_pallas_gl -> _q8_kernel_gl (dequant_matmul.py:220)."""
    rng = np.random.default_rng(100 + t)
    o, k = 512, 1024
    w = rng.normal(0, 0.1, (o, k)).astype(np.float32)
    qt = qtensor_from_float_np(w, JQuantType.Q8_0, GS)
    x = rng.normal(0, 1, (t, k)).astype(np.float32)
    want = np.asarray(qmatmul_pallas_gl(jnp.asarray(x), qt, interpret=True))
    cls = QTensor(torch.from_numpy(np.array(qt.q)),
                  torch.from_numpy(np.array(qt.s)), QuantType.Q8_0, GS, o, k)
    calls = []
    orig = getattr(matmul_module, kernel)
    monkeypatch.setattr(matmul_module, kernel,
                        lambda *a: calls.append(kernel) or orig(*a))
    got = qmatmul(torch.from_numpy(x), cls, classifier=True).numpy()
    assert calls == [kernel]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=5e-3 * np.abs(want).max())
