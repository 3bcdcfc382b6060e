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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.kernels.dequant_matmul import qmatmul_pallas
from lmrs_tpu.quant import QuantType as JQuantType
from lmrs_tpu.quant import qtensor_from_float_np

from lmrs_tpu_torch.config import QuantType
from lmrs_tpu_torch.kernels import launches, reset_launches
from lmrs_tpu_torch.kernels.q4_gemm import q4_gemm
from lmrs_tpu_torch.kernels.q8_gemm import q8_gemm
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
