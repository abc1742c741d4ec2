"""The port's losses (ddp_practice_tpu_torch/ops/losses.py) against the JAX
package's, from the same numpy logits and labels: `cross_entropy` with and
without a weight mask and label smoothing, in fp32 and bf16 logits, its
value and its gradient (the closed-form backward against jax.grad of the
reference's custom VJP), and `accuracy_counts`.

Tolerances: fp32 1e-6 (the same fp32 arithmetic in another summation
order). bf16 logits: the value is fp32 math over the same bf16 inputs
(1e-5); the gradient is rounded to bf16 on both sides, so it may differ
by one bf16 ulp (2^-8 relative) where the fp32 values straddle a rounding
boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_practice_tpu.ops import losses as jl
from ddp_practice_tpu_torch.ops import losses as tl

B, S, V = 3, 7, 29


def _data(seed, weighted):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, S, V)) * 3).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    weight = ((rng.random((B, S)) > 0.3).astype(np.float32)
              if weighted else None)
    return logits, labels, weight


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_and_grad_match_jax(dtype, smoothing, weighted):
    logits, labels, weight = _data(int(weighted) + 10 * int(smoothing * 10),
                                   weighted)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jw = None if weight is None else jnp.asarray(weight)
    tw = None if weight is None else torch.from_numpy(weight)

    def jloss(x):
        return jl.cross_entropy(x, jnp.asarray(labels), weight=jw,
                                label_smoothing=smoothing)

    jlogits = jnp.asarray(logits).astype(jdt)
    jval, jgrad = jax.value_and_grad(jloss)(jlogits)
    x = torch.from_numpy(logits).to(tdt).requires_grad_(True)
    tval = tl.cross_entropy(x, torch.from_numpy(labels), weight=tw,
                            label_smoothing=smoothing)
    tval.backward()
    assert x.grad.dtype == tdt
    vtol = 1e-6 if dtype == "float32" else 1e-5
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=vtol,
                               atol=vtol)
    g_want = np.asarray(jgrad.astype(jnp.float32))
    g_got = x.grad.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(g_got, g_want, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_allclose(g_got, g_want, rtol=2.0 ** -8,
                                   atol=1e-7)


@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_sum_and_accuracy_counts_match_jax(weighted):
    logits, labels, weight = _data(5, weighted)
    logits[0, 0, :] = 1.0       # a tie: both take the first maximum
    labels[0, 0] = 0
    jw = None if weight is None else jnp.asarray(weight)
    tw = None if weight is None else torch.from_numpy(weight)
    js, jn = jl.cross_entropy_sum(jnp.asarray(logits), jnp.asarray(labels),
                                  weight=jw)
    ts, tn = tl.cross_entropy_sum(torch.from_numpy(logits),
                                  torch.from_numpy(labels), weight=tw)
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
    assert float(tn) == float(jn)
    jc, jt = jl.accuracy_counts(jnp.asarray(logits), jnp.asarray(labels),
                                weight=jw)
    tc, tt = tl.accuracy_counts(torch.from_numpy(logits),
                                torch.from_numpy(labels), weight=tw)
    assert (float(tc), float(tt)) == (float(jc), float(jt))
