"""The port's paged pool (ddp_practice_tpu_torch/serve/kv_pages.py)
against the JAX package's.

- `BlockAllocator` and `RadixPrefixCache` driven by one scripted
  sequence in both packages (alloc, ref, free, insert, match, peek,
  ref_prefix, evict, clear, the garbage-block refusals): every return
  value and, after every step, the free list, refcounts, hit/miss
  counters and evictable counts are equal.
- `make_paged_cache`: the same leaf names, shapes and dtypes.
- `scatter_prompt_blocks`, `copy_block` and `rewind_block_tail` on
  numpy-seeded pools give the JAX results exactly (they move data, no
  arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import build_pair
from ddp_practice_tpu.serve import kv_pages as jax_kv
from ddp_practice_tpu_torch.serve import kv_pages as port_kv

BS = 4


def _script(kv):
    """One scripted sequence; returns [(step, result, state), ...]."""
    a = kv.BlockAllocator(10)
    r = kv.RadixPrefixCache(a, BS)
    out = []

    def step(name, fn):
        try:
            res = fn()
        except ValueError as e:
            res = ("ValueError", str(e))
        out.append((name, res, list(a._free), dict(a._refs), a.num_free,
                    a.num_used, a.num_shared, r.hit_tokens, r.miss_tokens,
                    r.evictable(), r._evictable_walk(), len(r),
                    r.edit_seq))
        return res

    sys_a = list(range(10))                 # 2 full blocks + 2 tokens
    sys_b = [0, 1, 2, 3, 9, 9, 9, 9, 5]     # shares the first block
    x = step("alloc3", lambda: a.alloc(3))
    step("insert_a", lambda: r.insert(sys_a, x))
    step("free_x", lambda: a.free(x))
    hit = step("match_a", lambda: r.match(sys_a))
    step("peek_a+", lambda: r.peek(sys_a + [7]))
    step("peek_short", lambda: r.peek(sys_a[:8]))   # clamp: leave one
    y = step("alloc2", lambda: a.alloc(2))
    step("insert_b", lambda: r.insert(sys_b, [x[0], y[0]]))
    step("ref_y", lambda: a.ref(y))
    step("free_y", lambda: a.free(y))
    hb = step("match_b", lambda: r.match(sys_b))
    pins = step("ref_prefix_a", lambda: r.ref_prefix(sys_a))
    step("evict_pinned", lambda: r.evict(3))
    step("unpin", lambda: a.free(pins))
    step("release_a", lambda: a.free(hit[0]))
    step("release_b", lambda: a.free(hb[0]))
    step("evict1", lambda: r.evict(1))
    step("too_many", lambda: a.alloc(20))
    step("free_garbage", lambda: a.free([kv.GARBAGE_BLOCK]))
    step("ref_garbage", lambda: a.ref([kv.GARBAGE_BLOCK]))
    step("insert_garbage",
         lambda: r.insert([5, 5, 5, 5], [kv.GARBAGE_BLOCK]))
    step("free_unallocated", lambda: a.free([9]))
    step("free_y_rest", lambda: a.free(y))
    step("clear", lambda: r.clear())
    return out


def test_allocator_and_radix_script_matches_jax():
    want = _script(jax_kv)
    got = _script(port_kv)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, f"step {w[0]}"
    # the script reached every branch it names
    results = {name: res for name, res, *_ in got}
    assert results["match_a"] == ([1, 2], 8)
    assert results["too_many"] is None
    assert results["free_garbage"][0] == "ValueError"
    assert results["clear"] > 0 and got[-1][5] == 0   # pool drained


def test_block_zero_is_never_allocated():
    a = port_kv.BlockAllocator(4)
    assert a.alloc(3) == [1, 2, 3] and a.alloc(1) is None
    with pytest.raises(ValueError, match="at least 2"):
        port_kv.BlockAllocator(1)


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
def test_make_paged_cache_matches_jax(kv_cache_dtype):
    jm, _, tm = build_pair(0, pos_emb="rope", kv_cache_dtype=kv_cache_dtype)
    want = jax_kv.make_paged_cache(jm, 5, 16)
    got = port_kv.make_paged_cache(tm, 5, 16, "cpu")
    flat_w = {jax.tree_util.keystr(p): leaf for p, leaf in
              jax.tree_util.tree_flatten_with_path(want)[0] if leaf.ndim}
    flat_g = {"".join(f"['{k}']" for k in p): t for p, t in
              port_kv._pool_leaves(got)}
    assert sorted(flat_g) == sorted(flat_w)
    for key, leaf in flat_w.items():
        t = flat_g[key]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).replace("torch.", "") == str(leaf.dtype)


def _trees(seed, nb=6, bs=4, h=2, d=8, width=10):
    """A pool and a batch-1 scratch cache with int8-style scale leaves,
    one layer, as numpy (filled from the seed)."""
    rng = np.random.default_rng(seed)

    def layer(rows, pos):
        return {
            "cached_key": rng.normal(size=(rows, pos, h * d)).astype(
                np.float32),
            "cached_value": rng.normal(size=(rows, pos, h * d)).astype(
                np.float32),
            "cached_key_scale": rng.normal(size=(rows, h, pos)).astype(
                np.float32),
            "cached_value_scale": rng.normal(size=(rows, h, pos)).astype(
                np.float32),
        }

    return {"block0": {"attn": layer(nb, bs)}}, \
        {"block0": {"attn": layer(1, width)}}


def _to_jax(tree):
    out = jax.tree.map(jnp.asarray, tree)
    out["block0"]["attn"]["cache_index"] = jnp.zeros((), jnp.int32)
    return out


def _to_torch(tree):
    out = jax.tree.map(lambda a: torch.from_numpy(a.copy()), tree)
    out["block0"]["attn"]["cache_index"] = 0
    return out


def _assert_same(port_tree, jax_tree):
    for key, leaf in port_tree["block0"]["attn"].items():
        if isinstance(leaf, torch.Tensor):
            np.testing.assert_array_equal(
                leaf.numpy(), np.asarray(jax_tree["block0"]["attn"][key]))


@pytest.mark.parametrize("width", [8, 10])
def test_scatter_prompt_blocks_matches_jax(width):
    """A full and a partial trailing chunk: only real rows are written."""
    pool, scratch = _trees(width, width=width)
    ids = [4, 1, 3][: -(-width // BS)]
    want = jax_kv.scatter_prompt_blocks(
        _to_jax(pool), _to_jax(scratch), jnp.asarray(ids, jnp.int32), width,
        BS)
    got = port_kv.scatter_prompt_blocks(_to_torch(pool), _to_torch(scratch),
                                        ids, width, BS)
    _assert_same(got, want)


def test_copy_block_and_rewind_match_jax():
    pool, _ = _trees(3)
    want = jax_kv.copy_block(_to_jax(pool), 2, 5)
    got = _to_torch(pool)
    assert port_kv.copy_block(got, 2, 5) is got        # in place
    _assert_same(got, want)
    results = []
    for kv in (jax_kv, port_kv):
        a = kv.BlockAllocator(8)
        row = np.zeros((5,), np.int32)
        row[:4] = a.alloc(4)
        n = kv.rewind_block_tail(a, row, 4, 2)
        kept = kv.rewind_block_tail(a, row, n, 3)     # nothing to rewind
        results.append((n, kept, row.tolist(), list(a._free)))
    assert results[0] == results[1]
    assert results[1][2] == [1, 2, 0, 0, 0]
