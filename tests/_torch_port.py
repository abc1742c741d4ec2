"""Shared fixtures for the PyTorch port's parity tests (tests/test_torch_*):
one decoder built in both packages from one seed, with the flax params
converted into the port, and their biases and LayerNorm parameters moved
off their init values so a layout slip in the converter cannot hide
behind zeros and ones."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ddp_practice_tpu.models import create_model as jax_create_model
from ddp_practice_tpu_torch.convert import load_flax_params
from ddp_practice_tpu_torch.models import create_model

# The suite runs as several pytest workers on one machine, and torch's
# default intra-op pool puts one spinning thread per core in each of
# them: under that load the small eager ops of these tests ran ~25x
# slower (the shared-prefix bench case: 57 s against 1 s with one
# thread, six busy cores beside it). One thread costs nothing alone.
torch.set_num_threads(1)

# The first torch optimizer built in a process imports torch's compiler
# stack (~2.5 s here, more beside busy workers). Paid once at import, it
# stays out of whichever test happens to build the first optimizer.
torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=0.1)

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


def ranks(fn, world: int, deadline: float = 60.0):
    """[fn(rank) for every rank] with the ranks as threads of this process
    (the port's threaded process group, parallel/threads.py), no new
    process. A rank that raises, or ranks still running after `deadline`
    seconds, fail the case instead of hanging the worker; the process
    leaves the threaded world either way."""
    from ddp_practice_tpu_torch.parallel.threads import run_ranks

    return run_ranks(fn, world, timeout=deadline)
