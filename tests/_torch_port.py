"""Shared fixtures for the PyTorch port's parity tests (tests/test_torch_*):
one decoder built in both packages from one seed, with the flax params
converted into the port, and their biases and LayerNorm parameters moved
off their init values so a layout slip in the converter cannot hide
behind zeros and ones."""

import jax
import jax.numpy as jnp
import numpy as np

from ddp_practice_tpu.models import create_model as jax_create_model
from ddp_practice_tpu_torch.convert import load_flax_params
from ddp_practice_tpu_torch.models import create_model

# a packable head shape (head_dim 64, even head count): the JAX side's
# single-token decode really reaches its Pallas kernel (interpret mode)
SMALL = dict(vocab_size=64, hidden_dim=128, num_heads=2, depth=2,
             mlp_dim=256)


def _perturb(tree, rng):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _perturb(value, rng)
            continue
        arr = np.asarray(value, np.float32)
        if key == "bias":
            arr = arr + rng.normal(0.0, 0.05, arr.shape).astype(np.float32)
        elif key == "scale":
            arr = arr + rng.normal(0.0, 0.2, arr.shape).astype(np.float32)
        out[key] = arr
    return out


def build_pair(seed: int = 0, **kw):
    """(jax_model, jax_params, torch_model) with identical weights."""
    cfg = {**SMALL, **kw}
    jm = jax_create_model("lm_tiny", **cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    params = _perturb(jax.device_get(params), np.random.default_rng(seed))
    tm = create_model("lm_tiny", device="cpu", **cfg)
    load_flax_params(tm, params)
    return jm, jax.tree.map(jnp.asarray, params), tm
