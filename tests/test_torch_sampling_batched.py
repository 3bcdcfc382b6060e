"""Per-slot sampling and the batched prompt-lookup draft of the port's
continuous batching, against the JAX package on the CPU:
`ops.sampling.sample_batched` (lmrs_tpu.ops.sampling.sample_batched) and
`runtime.speculative.lookup_draft_batched` (the JAX `lookup_draft`, which
the JAX scheduler vmaps over its slots).

Tolerances, stated at each assert:
- greedy slots: exactly argmax, whatever the other slots hold.
- sampled slots: JAX PRNG streams cannot be reproduced in torch, so the
  draws are held to the exact distribution (the JAX `processed_probs` of
  the slot's logits, temperature and top-p) by chi-square at alpha = 0.001.
- the draft: bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.ops.sampling import processed_probs as jax_processed_probs
from lmrs_tpu.ops.sampling import sample_batched as jax_sample_batched
from lmrs_tpu.runtime.speculative import lookup_draft as jax_lookup_draft

from lmrs_tpu_torch.ops.sampling import sample_batched
from lmrs_tpu_torch.runtime.speculative import (lookup_draft,
                                                lookup_draft_batched)

torch.set_num_threads(1)

V = 8
# chi-square critical value at alpha = 0.001, 7 degrees of freedom
CHI2_001_7 = 24.32


def _logits(b, seed=0):
    return np.random.default_rng(seed).normal(0, 1.5, (b, V)).astype(
        np.float32)


def test_greedy_slots_are_argmax_whatever_the_others_hold():
    logits = _logits(4)
    temps = torch.tensor([0.0, 0.9, 0.0, 1.3])
    top_ps = torch.tensor([0.9, 0.8, 0.5, 1.0])
    gen = torch.Generator().manual_seed(0)
    want = logits.argmax(-1)
    for _ in range(20):
        got = sample_batched(torch.from_numpy(logits), temps, top_ps, gen,
                             any_sampled=True)
        assert got[0] == want[0] and got[2] == want[2]
    # the same as the JAX function's greedy lanes
    jgot = np.asarray(jax_sample_batched(
        jnp.asarray(logits), jnp.asarray(temps.numpy()),
        jnp.asarray(top_ps.numpy()), __import__("jax").random.PRNGKey(0)))
    assert jgot[0] == want[0] and jgot[2] == want[2]


def test_all_greedy_batch_takes_the_argmax_without_sampling():
    logits = torch.from_numpy(_logits(3, 1))
    zeros = torch.zeros(3)
    got = sample_batched(logits, zeros, torch.full((3,), 0.9), None,
                         any_sampled=False)
    assert torch.equal(got, logits.argmax(-1))
    # the decision is the caller's: with any_sampled the greedy lanes
    # still give the argmax
    gen = torch.Generator().manual_seed(1)
    assert torch.equal(sample_batched(logits, zeros, torch.full((3,), 0.9),
                                      gen, any_sampled=True),
                       logits.argmax(-1))


def _chi2(counts, probs):
    exp = probs * counts.sum()
    keep = exp > 1e-9
    return float(((counts[keep] - exp[keep]) ** 2 / exp[keep]).sum())


@pytest.mark.parametrize("temp,top_p", [(0.7, 0.9), (1.0, 1.0), (1.3, 0.5),
                                        (0.8, 0.0)])
def test_sampled_slot_matches_the_jax_distribution(temp, top_p):
    """Slot 1 samples; slots 0 and 2 are greedy.  4,000 draws of slot 1
    against the JAX processed_probs of its row (top_p outside (0, 1): the
    whole distribution)."""
    logits = _logits(3, 2)
    temps = torch.tensor([0.0, temp, 0.0])
    top_ps = torch.tensor([0.9, top_p, 0.9])
    want = np.asarray(jax_processed_probs(jnp.asarray(logits[1]),
                                          jnp.float32(temp),
                                          jnp.float32(top_p)))
    gen = torch.Generator().manual_seed(3)
    n = 4000
    x = torch.from_numpy(logits)[None].expand(n, 3, V).reshape(n * 3, V)
    draws = sample_batched(x, temps.repeat(n), top_ps.repeat(n), gen,
                           any_sampled=True).reshape(n, 3)
    assert (draws[:, 0] == logits[0].argmax()).all()
    counts = np.bincount(draws[:, 1].numpy(), minlength=V)
    assert counts[want == 0].sum() == 0       # outside the nucleus: never
    assert _chi2(counts, want) < CHI2_001_7


def test_lookup_draft_batched_matches_jax_per_slot():
    rng = np.random.default_rng(4)
    b, s, k, vmax = 5, 48, 4, 30
    h = rng.integers(0, 5, (b, s)).astype(np.int64)
    h[1, 20:30] = -1
    h[3] = np.arange(s)                       # no bigram occurs twice
    pos = np.array([0, 1, 25, 40, s - 1])
    got = lookup_draft_batched(torch.from_numpy(h), torch.from_numpy(pos),
                               k, vmax)
    assert got.shape == (b, k)
    for i in range(b):
        want = np.asarray(jax_lookup_draft(jnp.asarray(h[i], jnp.int32),
                                           jnp.int32(pos[i]), k, vmax))
        np.testing.assert_array_equal(got[i].numpy(), want)
        np.testing.assert_array_equal(
            got[i].numpy(),
            lookup_draft(torch.from_numpy(h[i]), int(pos[i]), k, vmax))
