"""The split schedule of the port's decode kernels A-D
(ddp_practice_tpu_torch/csrc/decode_attention.cu) in plain PyTorch, for
the CPU tests. A plan is (splits, chunk[, span]) (`ops.decode_attention.
_split_plan`; span defaults to chunk): a (batch, head)'s valid keys
[first, last] go to one split when there are at most `span`, else to
splits of `chunk` keys from `first` on. Each split takes its own exact
max, rounds p against it where the kernel does, and writes (m_s, l_s,
acc_s); the splits then merge as the kernel's last arrival does: out =
round(sum e^(m_s - m) acc_s / sum e^(m_s - m) l_s). One active split
writes acc / l directly; an empty range gives zeros."""

import torch

from ddp_practice_tpu_torch.ops.decode_attention import gather_pages
from ddp_practice_tpu_torch.ops.flash_attention import _scales

# one intra-op thread, as tests/_torch_port.py sets for the suite: the
# tier-1 run's workers share the machine's cores
torch.set_num_threads(1)


def _merge(q, k, v, first, last, splits, chunk, span=None, *, round_p,
           k_fold=None, v_fold=None):
    """k, v: (b, n, h, d) fp32 rows of positions [0, n); first, last: (b,)
    valid range; k_fold / v_fold: (b, n, h) scales folded into the score
    and probability rows (kernel D). Returns (b, 1, h*d) in q's dtype."""
    b, n, h, d = k.shape
    span = chunk if span is None else span
    qs = (q.reshape(b, h, d).float() * _scales(d, q.dtype)[0]).to(q.dtype)
    qs = qs.float()
    first, last = first.long()[:, None], last.long()[:, None]
    length = last - first + 1
    active = torch.where(length <= span, 1, -(-length // chunk))
    pos = torch.arange(n, device=k.device)[None, :]
    sc = torch.einsum("bhd,bchd->bhc", qs, k)
    if k_fold is not None:
        sc = sc * k_fold.transpose(1, 2)
    vs = None if v_fold is None else v_fold.transpose(1, 2)
    parts = []
    for s in range(splits):
        lo = first + s * chunk
        hi = torch.where(active == 1, last, torch.minimum(lo + chunk - 1,
                                                          last))
        valid = (pos >= lo) & (pos <= hi) & (s < active) & (length > 0)
        ss = sc.masked_fill(~valid[:, None, :], float("-inf"))
        m = ss.amax(dim=-1)
        p = torch.exp(ss - torch.where(torch.isfinite(m), m, 0.0)[..., None])
        acc = torch.einsum("bhc,bchd->bhd", round_p(p, vs), v)
        parts.append((m, p.sum(dim=-1), acc))
    m = torch.stack([pm for pm, _, _ in parts])          # (S, b, h)
    top = m.amax(dim=0)
    w = torch.exp(m - torch.where(torch.isfinite(top), top, 0.0))
    num = sum(wi[..., None] * acc for wi, (_, _, acc) in zip(w, parts))
    den = sum(wi * l for wi, (_, l, _) in zip(w, parts))
    out = torch.where(den[..., None] > 0,
                      num / den.clamp_min(1e-30)[..., None],
                      torch.zeros_like(num))
    return out.to(q.dtype).reshape(b, 1, h * d)


def flat_split_emulated(q, k_cache, v_cache, cur, attn_start, plan, *,
                        n_heads, k_scale=None, v_scale=None):
    """Kernels A and B at `plan` over positions [0, cur]."""
    b, _, hd = q.shape
    h, n = n_heads, cur + 1
    d = hd // h
    k = k_cache[:, :n].reshape(b, n, h, d).float()
    v = v_cache[:, :n].reshape(b, n, h, d).float()
    if k_scale is not None:   # B: rows dequantized to q's dtype
        k = (k * k_scale[:, :, :n].transpose(1, 2)[..., None]).to(q.dtype)
        v = (v * v_scale[:, :, :n].transpose(1, 2)[..., None]).to(q.dtype)
    first = (torch.zeros(b, dtype=torch.int32, device=q.device)
             if attn_start is None else attn_start.clamp_min(0))
    last = torch.full((b,), cur, dtype=torch.int32, device=q.device)
    return _merge(q, k.float(), v.float(), first, last, *plan,
                  round_p=lambda p, _: p.to(q.dtype).float())


def paged_split_emulated(q, k_pages, v_pages, page_table, lengths,
                         attn_start, plan, *, n_heads, k_scale=None,
                         v_scale=None):
    """Kernels C and D at `plan` over each slot's capacity mb *
    block_size: C rounds p to the pool's dtype; D folds the scales into
    the rows and rounds p * vscale to q's dtype."""
    b, mb = page_table.shape
    n = mb * k_pages.shape[1]
    k = gather_pages(k_pages, page_table, n_heads).float()
    v = gather_pages(v_pages, page_table, n_heads).float()
    first = (torch.zeros(b, dtype=torch.int32, device=q.device)
             if attn_start is None else attn_start.clamp_min(0))
    last = lengths.clamp(max=n - 1)
    if k_scale is None:
        return _merge(q, k, v, first, last, *plan,
                      round_p=lambda p, _: p.to(v_pages.dtype).float())

    def per_position(scale):
        return scale[page_table.long()].transpose(2, 3).reshape(b, n,
                                                                n_heads)

    return _merge(q, k, v, first, last, *plan,
                  round_p=lambda p, vs: (p * vs).to(q.dtype).float(),
                  k_fold=per_position(k_scale),
                  v_fold=per_position(v_scale))
