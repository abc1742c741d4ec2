"""Mixture-of-Experts: the top-k routed MLP (counterpart of
ddp_practice_tpu/ops/moe.py).

Routing keeps the reference's functions and return values: `topk_choices`,
`top_k_routing` (iterative argmax, positions by cumsum, capacity drops,
`gsel` renormalized over each token's kept experts, the Switch aux loss
from the pre-drop first choices, `demand`), `expert_choice_gating`,
`top_k_gating`, `_assignment_permutation` (counting sort; `inv` from one
stable sort) and `_slot_tables`. Ties break as in JAX: `argmax` takes the
first index, `_top_k` the lower index (a stable descending sort), and the
counting sort keeps arrival order within an expert. The reference's
gather-only custom VJPs are `torch.autograd.Function`s with the same
backward formulas.

`MoEMlp` keeps the reference's three expert-compute paths (`impl`: "auto" =
"einsum", "gather", "sorted") and both routers ("topk", "expert_choice"),
with the same `ValueError`s. The router runs in fp32, the experts in the
policy dtype. Parameters keep the reference's names and layouts: `router`
(a bias-free Linear, weight (E, d)), `expert_w_in` (E, d, f),
`expert_b_in` (E, f), `expert_w_out` (E, f, d), `expert_b_out` (E, d); the
(E, k, n) layout is what the grouped matmul consumes. The sorted path runs
its two expert products through `ops/grouped_matmul.py` (kernels J and K
on the card); it ignores routing groups, as the reference's does.

What the reference does through Flax collections, the port does so:

- `train=True` stands for the reference's mutable "intermediates" and
  "batch_stats": the forward leaves `moe_aux_loss`, `moe_load_frac` and
  `moe_drop_rate` in `self.sown` (train/steps.py adds the aux loss to the
  objective and reads the rest as metrics), and the new router bias
  b - rate * sign(demand - 1/E) in `self.pending_bias`. The bias buffer
  itself changes only in `commit_bias()`, which the training step calls
  once after backward: a block that torch.utils.checkpoint replays in
  backward routes again with the bias its forward used and rewrites the
  same values, so the update and the aux loss happen once per step. Eval
  (`train=False`) routes with the current bias and records nothing.
- Data parallelism: the reference's step is one program over the global
  batch, so `demand`, the aux loss's `frac` and `prob`, the load fractions
  and the drop rate are means over every rank's tokens. Under
  torch.distributed the port all-reduces them (`_batch_mean`, `_global_sum`);
  `prob` carries the aux loss's gradient, and its all-reduce passes the
  gradient through unchanged: every rank holds the same global value, and
  DDP's mean over the ranks' grads then gives the grad of the global aux
  loss. Replicas keep identical router biases.
- Expert parallelism (ROADMAP A8c; parallel/mesh.py `shard_state` sets
  `ep`, the ExpertGroup, and cuts the `expert_*` leaves to the rank's
  experts [e0, e1)): the ranks of the expert axis hold the same tokens,
  so routing runs whole and alike on each of them (logits, gating, the
  aux loss, demand, the bias update, the sown statistics) and only the
  expert compute is local, as the reference's GSPMD layout computes it:
  einsum dispatches and combines through the local experts' slice of the
  (G, T, E, C) tensors (combine = dispatch * the (G, T, E) weights),
  gather through the local experts' slots of the slot tables (other
  ranks' slots read the zero spare), sorted sorts the local experts' rows
  first (`_assignment_permutation(first=e0)`) and
  runs kernels J and K over them alone with their group sizes (J writes
  zero past them, K ignores those rows), their biases added to those
  rows only. The boundaries are parallel/tensor.py's: `copy_to_tp`
  (identity forward, sum backward) where x enters the dispatch and on
  the combine weights (einsum: the (G, T, E) gates, gather and sorted:
  each token's k), `reduce_from_tp` (the sum over the group) on the
  output. Nothing is put on the block input before the router: the aux
  loss's grad through the logits is already whole on every rank.
  `_batch_mean` and `_global_sum` stay right: the expert ranks repeat the
  same local statistics, so the world's mean is the data replicas'.
- Sequence parallelism (ROADMAP A8f; `sp`, the SeqGroup): the reference
  routes the global (B, S, D), so the einsum and gather paths gather the
  router logits over the group (`SeqGroup.gather`, fp32 (b, S, E); its
  backward sums every rank's cotangent), route the whole sequence
  alike on every rank, and dispatch and combine only the rank's chunk's
  tokens (`_chunk_places`: the routing groups that hold them and their
  places there): every slot holds one token, which lives on one rank,
  and a rank's tokens read only their own slots, so the chunk of the
  output is exact. Every seq rank computes the same aux
  loss; the gather's backward sums its logits' grads over the group and
  the mean over data x seq then gives the reference's gradient. The
  sorted path routes per token, so it routes the rank's chunk: its
  demand, aux loss and load fractions are global means already.
- Decode (`decode=True`, the KV-cache prefill and single-token steps of
  inference.py and the serving engines) routes with the current bias and
  records nothing, as the reference's decode apply (its "batch_stats" and
  "intermediates" are not mutable there). Token choice routes as in eval:
  capacity max(1, int(cf * k * t / E)) per routing group, so a prefill's
  (left-padding) tokens compete for it, while a single-token step (t = 1,
  capacity 1, k distinct experts) never drops. Expert choice has no
  serving story of its own (at t = 1 every expert would pick the lone
  token), so its decode is the reference's approximation: per-token top-k
  over the gates with capacity t (nothing drops), combined with the raw
  softmax gates at the picked experts, not the renormalised ones. The
  gather and sorted paths decode exactly as they train (the reference
  returns them before it looks at `decode`): gather with the einsum path's
  capacity and drops, sorted dropless.
- The router bias is the `router_bias` buffer (the reference's
  `batch_stats` leaf): a model whose buffers were loaded from a checkpoint
  or from converted `batch_stats` (convert.load_flax_params) routes as
  the reference does when it is given those `batch_stats`; a buffer left
  at its zero init routes as the reference does without them (softmax of
  logits + 0 equals the gates).
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ddp_practice_tpu_torch.ops.grouped_matmul import grouped_matmul
from ddp_practice_tpu_torch.parallel import dist
from ddp_practice_tpu_torch.parallel.tensor import copy_to_tp, reduce_from_tp


# ------------------------------------------------- global batch statistics
class _GlobalMean(torch.autograd.Function):
    """Mean over the ranks; the gradient passes through unchanged (each
    rank's upstream is the same global value, and DDP averages the ranks'
    parameter grads)."""

    @staticmethod
    def forward(ctx, x):
        y = x.detach().clone()
        dist.all_reduce_sum(y)
        return y / dist.process_count()

    @staticmethod
    def backward(ctx, g):
        return g


def _batch_mean(x: torch.Tensor, dims) -> torch.Tensor:
    """Mean over `dims` of the global batch: the local mean, averaged over
    the ranks (equal local batches) when more than one runs."""
    local = x.mean(dim=dims)
    if dist.process_count() > 1:
        return _GlobalMean.apply(local)
    return local


def _global_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the ranks of a statistic that carries no gradient."""
    if dist.process_count() > 1:
        x = x.detach().clone()
        dist.all_reduce_sum(x)
    return x


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, ties to the
    lower index (the reference's top_k order): a stable descending sort."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


# ----------------------------------------------------------------- routing
def topk_choices(router_logits: torch.Tensor, *, k: int,
                 routing_bias: Optional[torch.Tensor] = None):
    """Top-k expert selection without the capacity machinery: (choices
    (..., k) int64, combine gates (..., k) fp32 renormalized over the k
    picks, aux_loss, demand (E,)). `routing_bias` biases selection only
    (the DeepSeek-V3 aux-free scheme), never the combine gates."""
    e = router_logits.shape[-1]
    logits = router_logits.float()
    gates = torch.softmax(logits, dim=-1)
    sel = logits if routing_bias is None else logits + routing_bias.float()
    _, choices = _top_k(sel, k)
    cgates = torch.gather(gates, -1, choices)
    cgates = cgates / torch.clamp(cgates.sum(dim=-1, keepdim=True),
                                  min=1e-9)
    lead = tuple(range(router_logits.dim() - 1))
    onehot = F.one_hot(choices, e).float()                 # (..., k, E)
    demand = _batch_mean(onehot.sum(dim=-2), lead) / k
    frac = _batch_mean(onehot[..., 0, :], lead)
    prob = _batch_mean(gates, lead)
    aux = e * torch.sum(frac * prob)
    return choices, cgates, aux, demand


def top_k_routing(router_logits: torch.Tensor, *, k: int, capacity: int,
                  routing_bias: Optional[torch.Tensor] = None):
    """Capacity-constrained top-k routing as index tensors: (choices
    (G,T,k), positions (G,T,k), keeps (G,T,k) fp32, gsel (G,T,E) fp32,
    aux_loss, demand (E,)), the reference's iterative argmax with cumsum
    positions and capacity drops."""
    g, t, e = router_logits.shape
    logits = router_logits.float()
    gates = torch.softmax(logits, dim=-1)
    if routing_bias is not None:
        sel = torch.softmax(logits + routing_bias.float(), dim=-1)
    else:
        sel = gates
    remaining = sel
    fill = torch.zeros((g, e), device=logits.device)
    first_choice = None
    demand = torch.zeros((e,), device=logits.device)
    kept_expert = torch.zeros((g, t, e), device=logits.device)
    choices, positions, keeps = [], [], []
    for _ in range(k):
        choice = torch.argmax(remaining, dim=-1)            # (G, T)
        onehot = F.one_hot(choice, e).float()               # (G, T, E)
        demand = demand + _batch_mean(onehot, (0, 1)) / k
        if first_choice is None:
            first_choice = onehot
        pos = torch.cumsum(onehot, dim=1) - onehot + fill[:, None, :]
        pos_tok = torch.sum(pos * onehot, dim=-1)           # (G, T)
        keep = (pos_tok < capacity).float()
        choices.append(choice)
        positions.append(torch.clamp(pos_tok, max=capacity - 1).long())
        keeps.append(keep)
        kept_expert = kept_expert + onehot * keep[..., None]
        fill = fill + torch.sum(onehot * keep[..., None], dim=1)
        remaining = remaining * (1.0 - onehot)
    gsel = gates * kept_expert
    gsel = gsel / torch.clamp(gsel.sum(dim=-1, keepdim=True), min=1e-9)
    # Switch eq. 4 from the pre-drop first choices
    frac = _batch_mean(first_choice, (0, 1))
    prob = _batch_mean(gates, (0, 1))
    aux = e * torch.sum(frac * prob)
    return (torch.stack(choices, -1), torch.stack(positions, -1),
            torch.stack(keeps, -1), gsel, aux, demand)


def expert_choice_gating(router_logits: torch.Tensor, *, capacity: int):
    """Experts pick tokens: each expert takes the top-`capacity` tokens of
    its softmax column. Returns (dispatch (G,T,E,C), combine (G,T,E,C),
    uncovered: the fraction of tokens no expert picked)."""
    dispatch, gates, uncovered = _expert_choice(router_logits, capacity)
    return dispatch, dispatch * gates[..., None], uncovered


def _expert_choice(router_logits: torch.Tensor, capacity: int):
    """`expert_choice_gating` with the (G, T, E) gates in place of the
    combine tensor (combine = dispatch * gates)."""
    g, t, e = router_logits.shape
    gates = torch.softmax(router_logits.float(), dim=-1)
    scores = gates.transpose(1, 2)                          # (G, E, T)
    _, idx = _top_k(scores, capacity)                       # (G, E, C)
    onehot = F.one_hot(idx, t).float()                      # (G, E, C, T)
    dispatch = onehot.permute(0, 3, 1, 2)                   # (G, T, E, C)
    covered = torch.clamp(dispatch.sum(dim=(2, 3)), 0.0, 1.0)
    uncovered = 1.0 - _batch_mean(covered.reshape(-1), 0)
    return dispatch, gates, uncovered


def top_k_gating(router_logits: torch.Tensor, *, k: int, capacity: int,
                 routing_bias: Optional[torch.Tensor] = None):
    """(dispatch (G,T,E,C), combine (G,T,E,C), aux_loss, demand): the
    one-hot expansion of `top_k_routing`."""
    choices, positions, keeps, gsel, aux, demand = top_k_routing(
        router_logits, k=k, capacity=capacity, routing_bias=routing_bias)
    dispatch = _dispatch_tensor(choices, positions, keeps,
                                router_logits.shape[-1], capacity)
    return dispatch, dispatch * gsel[..., None], aux, demand


def _dispatch_tensor(choices, positions, keeps, e: int, capacity: int):
    """The (G, T, E, C) one-hot dispatch of `top_k_routing`'s kept
    assignments."""
    dispatch = torch.zeros(choices.shape[:2] + (e, capacity),
                           device=choices.device)
    for j in range(choices.shape[-1]):
        onehot = F.one_hot(choices[..., j], e).float()
        pos_oh = F.one_hot(positions[..., j], capacity).float()
        dispatch = dispatch + torch.einsum(
            "gte,gtc->gtec", onehot * keeps[..., j, None], pos_oh)
    return dispatch


def _assignment_permutation(choices_flat: torch.Tensor, e: int,
                            first: int = 0):
    """Counting sort of the (N*k,) expert assignments: (counts (E,) int32,
    dest (N*k,), inv (N*k,)). Assignment a lands at sorted row dest[a];
    sorted row r holds assignment inv[r]. inv comes from one stable sort by
    expert, which is the counting sort's (expert, arrival) order, and dest
    is its inverse permutation: the same dest as the reference's cumsum
    arithmetic, whose scan over the (N*k, E) one-hot took ~5 ms a layer
    on the card at lm_moe's 32768 rows. With `first` the experts sort
    from `first` on, cyclically (a rank's local experts lead); counts stay
    in expert order. The counts are an index_add_ into E bins (the
    values of `torch.bincount`, which reads its output size on the host
    and so cannot run inside a CUDA graph)."""
    counts = torch.zeros(e, dtype=torch.int64,
                         device=choices_flat.device).index_add_(
        0, choices_flat, torch.ones_like(choices_flat))
    key = choices_flat if first == 0 else (choices_flat - first) % e
    _, inv = torch.sort(key, stable=True)
    dest = torch.empty_like(inv)
    dest[inv] = torch.arange(inv.numel(), device=inv.device)
    return counts.to(torch.int32), dest, inv


def _slot_tables(choices, positions, keeps, e: int, capacity: int):
    """Per-slot lookup tables: (slot_token (G, E*C), slot_round (G, E*C),
    slot_mask (G, E*C) fp32, dest (G, T, k), E*C for a dropped
    assignment). Dropped assignments scatter into a spare trailing column
    that is cut off."""
    g, t, k = choices.shape
    ec = e * capacity
    dest = choices * capacity + positions
    dest = torch.where(keeps > 0, dest, torch.full_like(dest, ec))
    flat = dest.reshape(g, t * k)
    dev = choices.device
    ti = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(1, -1)
    ri = torch.arange(k, device=dev)[None, :].expand(t, k).reshape(1, -1)

    def table(values, dtype):
        out = torch.zeros((g, ec + 1), dtype=dtype, device=dev)
        return out.scatter_(1, flat, values.expand(g, -1).to(dtype))[:, :ec]

    slot_token = table(ti, torch.int64)
    slot_round = table(ri, torch.int64)
    slot_mask = table(torch.ones_like(ti), torch.float32)
    return slot_token, slot_round, slot_mask, dest


def _local_slots(slot_token, slot_round, slot_mask, dest, lo: int, hi: int):
    """`_slot_tables` cut to the slots [lo, hi) (a rank's local experts'):
    dest re-based to them, any other slot (and a dropped assignment) sent
    to the spare column hi - lo."""
    mine = (dest >= lo) & (dest < hi)
    dest = torch.where(mine, dest - lo, torch.full_like(dest, hi - lo))
    return (slot_token[:, lo:hi], slot_round[:, lo:hi], slot_mask[:, lo:hi],
            dest)


def _group_tokens(x: torch.Tensor, group_size: int, stride: bool):
    """The routing-group reshape of a (B, S, D) tensor: (grouped (G, T, D),
    n_sub). Group sizes that are not below S route whole sequences."""
    g0, t0, d = x.shape
    if not 0 < group_size < t0:
        return x, 1
    if t0 % group_size:
        raise ValueError(f"moe group_size {group_size} must divide "
                         f"the sequence length {t0}")
    n_sub = t0 // group_size
    if stride:
        # group j of a sequence = tokens {j, j + n_sub, ...}
        x = x.reshape(g0, group_size, n_sub, d).transpose(1, 2)
    return x.reshape(g0 * n_sub, group_size, d), n_sub


# (b, s, group_size, stride, rank, size, device) -> `_chunk_places`
_PLACES: dict = {}


def _chunk_places(b: int, s: int, group_size: int, stride: bool,
                  rank: int, size: int, device) -> tuple:
    """Where seq rank `rank`'s chunk of a (b, s) batch cut in `size` lies
    in the batch's routing groups: (groups (G_l,), slots (G_l, T_l),
    rows (G_l, T_l), inv (b * s / size,)). `groups` are the groups that
    hold its tokens, `slots` their places in each, `rows` their rows in
    the chunk's flattened (b, s / size) tokens and `inv` the inverse of
    `rows`. Computed once a shape, on the CPU."""
    key = (b, s, group_size, stride, rank, size, torch.device(device))
    if key not in _PLACES:
        _PLACES[key] = _places(b, s, group_size, stride, rank, size,
                               key[-1])
    return _PLACES[key]


def _places(b, s, group_size, stride, rank, size, device) -> tuple:
    pos = _group_tokens(torch.arange(b * s).reshape(b, s, 1), group_size,
                        stride)[0][..., 0]                   # (G, T)
    c = s // size
    mine = (pos % s) // c == rank
    count = mine.sum(1)
    groups = torch.nonzero(count).reshape(-1)
    if (count[groups] != count[groups[0]]).any():
        raise ValueError(
            f"moe routing groups of {group_size} (stride {stride}) hold "
            f"unequal parts of the seq={size} chunks of {s} tokens")
    slots = torch.nonzero(mine[groups])[:, 1].reshape(groups.numel(), -1)
    glob = torch.gather(pos[groups], 1, slots)
    rows = (glob // s) * c + glob % s - rank * c
    inv = torch.argsort(rows.reshape(-1))
    return tuple(a.to(device) for a in (groups, slots, rows, inv))


def _take(x: torch.Tensor, places) -> torch.Tensor:
    """A (G, T, ...) tensor at a seq rank's places (`_chunk_places`):
    (G_l, T_l, ...); the whole tensor when `places` is None."""
    if places is None:
        return x
    groups, slots = places[:2]
    if groups.numel() != x.shape[0]:
        x = x[groups]
    idx = slots.reshape(slots.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(slots.shape + x.shape[2:]))


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[g, idx[g, s]] over the token dim of a (G, T, D) tensor."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _pad_row(x: torch.Tensor) -> torch.Tensor:
    """One zero row appended on dim 1 (the spare slot)."""
    return F.pad(x, (0, 0, 0, 1))


# ------------------------------------------------ gather-only custom VJPs
class _DispatchGather(torch.autograd.Function):
    """xin[g, s] = x[g, slot_token[g, s]] * slot_mask[g, s]; backward k row
    gathers through `dest` (dropped assignments read the zero spare)."""

    @staticmethod
    def forward(ctx, x, slot_token, slot_mask, dest):
        ctx.save_for_backward(dest)
        return _rows(x, slot_token) * slot_mask[..., None].to(x.dtype)

    @staticmethod
    def backward(ctx, g_out):
        (dest,) = ctx.saved_tensors
        gz = _pad_row(g_out)
        dx = _rows(gz, dest[..., 0])
        for j in range(1, dest.shape[-1]):
            dx = dx + _rows(gz, dest[..., j])
        return dx, None, None, None


class _CombineGather(torch.autograd.Function):
    """y[g, t] = sum_j w[g, t, j] * out[g, dest[g, t, j]]; gather-only in
    both directions."""

    @staticmethod
    def forward(ctx, out, w, dest, slot_token, slot_round, slot_mask):
        ctx.save_for_backward(out, w, dest, slot_token, slot_round,
                              slot_mask)
        oz = _pad_row(out)
        y = _rows(oz, dest[..., 0]) * w[..., 0, None].to(out.dtype)
        for j in range(1, dest.shape[-1]):
            y = y + _rows(oz, dest[..., j]) * w[..., j, None].to(out.dtype)
        return y

    @staticmethod
    def backward(ctx, gy):
        out, w, dest, slot_token, slot_round, slot_mask = ctx.saved_tensors
        k = dest.shape[-1]
        w_slot = torch.gather(w.reshape(w.shape[0], -1), 1,
                              slot_token * k + slot_round) * slot_mask
        dout = _rows(gy, slot_token) * w_slot[..., None].to(gy.dtype)
        oz = _pad_row(out)
        dw = torch.stack([torch.sum(gy * _rows(oz, dest[..., j]), dim=-1)
                          for j in range(k)], dim=-1).to(w.dtype)
        return dout, dw, None, None, None, None


class _DispatchRows(torch.autograd.Function):
    """Expert-sort gather xf[tok]; backward sums each token's k sorted rows
    (dest_nk holds their ids): k gathers instead of a scatter-add."""

    @staticmethod
    def forward(ctx, xf, tok, dest_nk):
        ctx.save_for_backward(dest_nk)
        return xf[tok]

    @staticmethod
    def backward(ctx, g):
        (dest_nk,) = ctx.saved_tensors
        dxf = g[dest_nk[:, 0]]
        for j in range(1, dest_nk.shape[1]):
            dxf = dxf + g[dest_nk[:, j]]
        return dxf, None, None


class _CombineRows(torch.autograd.Function):
    """Weighted un-sort y[n] = sum_j cgates[n, j] * out[dest_nk[n, j]];
    backward d out[r] = gy[tok[r]] * cgates.flat[inv[r]] and d cgates[n, j]
    = <gy[n], out[dest_nk[n, j]]>."""

    @staticmethod
    def forward(ctx, out, cgates, tok, dest_nk, inv):
        ctx.save_for_backward(out, cgates, tok, dest_nk, inv)
        y = out[dest_nk[:, 0]] * cgates[:, 0, None]
        for j in range(1, dest_nk.shape[1]):
            y = y + out[dest_nk[:, j]] * cgates[:, j, None]
        return y

    @staticmethod
    def backward(ctx, gy):
        out, cgates, tok, dest_nk, inv = ctx.saved_tensors
        gate_sorted = cgates.reshape(-1)[inv]
        dout = gy[tok] * gate_sorted[:, None].to(gy.dtype)
        dc = torch.stack([torch.sum(gy * out[dest_nk[:, j]], dim=-1)
                          for j in range(dest_nk.shape[1])], dim=-1)
        return dout, dc.to(cgates.dtype), None, None, None


class _BiasRows(torch.autograd.Function):
    """Per-row expert bias b[sorted_expert]; backward db = onehotᵀ @ g in
    fp32 (a dense product, not a scatter-add)."""

    @staticmethod
    def forward(ctx, b, sorted_expert, onehot_sorted):
        ctx.save_for_backward(onehot_sorted)
        ctx.b_dtype = b.dtype
        return b[sorted_expert]

    @staticmethod
    def backward(ctx, g):
        (onehot_sorted,) = ctx.saved_tensors
        db = onehot_sorted.float().T @ g.float()
        return db.to(ctx.b_dtype), None, None


# -------------------------------------------------------------------- MoE
class MoEMlp(nn.Module):
    """Expert-routed MLP: drop-in for a dense transformer MLP block."""

    def __init__(self, d: int, *, num_experts: int = 8, top_k: int = 2,
                 capacity_factor: float = 1.25, mlp_dim: int = 768,
                 aux_loss_weight: float = 0.01,
                 bias_update_rate: float = 0.02, group_size: int = 0,
                 group_stride: bool = True, dtype=torch.float32,
                 impl: str = "auto", router: str = "topk") -> None:
        super().__init__()
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.mlp_dim = mlp_dim
        self.aux_loss_weight = aux_loss_weight
        self.bias_update_rate = bias_update_rate
        self.group_size = group_size
        self.group_stride = group_stride
        self.dtype = dtype
        self.impl = impl
        self.router_kind = router
        e, f = num_experts, mlp_dim
        self.router = nn.Linear(d, e, bias=False)
        self.expert_w_in = nn.Parameter(torch.empty(e, d, f))
        self.expert_b_in = nn.Parameter(torch.zeros(e, f))
        self.expert_w_out = nn.Parameter(torch.empty(e, f, d))
        self.expert_b_out = nn.Parameter(torch.zeros(e, d))
        # the aux-free balancing bias (the reference's batch_stats leaf);
        # expert-choice routers have none
        if router == "topk":
            self.register_buffer("router_bias", torch.zeros(e))
        else:
            self.router_bias = None
        self.sown: Optional[dict] = None
        self.pending_bias: Optional[torch.Tensor] = None
        # the expert group (parallel/mesh.py shard_state: the expert_*
        # leaves then hold the rank's experts) and the seq group
        self.ep = None
        self.sp = None

    def forward(self, x: torch.Tensor, *, train: bool = False,
                decode: bool = False) -> torch.Tensor:       # (G, T, D)
        impl = self.impl
        if impl == "auto":
            impl = "einsum"
        elif impl not in ("einsum", "gather", "sorted"):
            raise ValueError(f"moe impl {impl!r} (want 'auto'|'einsum'|"
                             "'gather'|'sorted')")
        if self.router_kind not in ("topk", "expert_choice"):
            raise ValueError(f"moe router {self.router_kind!r} (want "
                             "'topk'|'expert_choice')")
        if self.router_kind == "expert_choice" and impl != "einsum":
            raise ValueError(
                "expert_choice routing runs on the einsum path (its "
                "dispatch is already dense and padding-free); pass "
                "impl='auto'/'einsum'")
        # decode records nothing and moves no bias
        train = train and not decode
        if impl == "sorted":
            return self._sorted(x, train)
        logits, places, sp = self._logits(x), None, self.sp
        if sp is not None:
            # the whole sequence routed alike on every seq rank, which
            # dispatches and combines its chunk's tokens
            logits = sp.gather(logits)
            places = _chunk_places(x.shape[0], logits.shape[1],
                                   self.group_size, self.group_stride,
                                   sp.rank, sp.size, x.device)
        if impl == "gather":
            return self._gather(x, logits, places, train)
        return self._einsum(x, logits, places, train, decode)

    # -- shared pieces ---------------------------------------------------
    def commit_bias(self) -> None:
        """Apply the router-bias update of the last training forward (the
        training step calls this once, after backward) and drop the sown
        values."""
        if self.pending_bias is not None:
            with torch.no_grad():
                self.router_bias.copy_(self.pending_bias)
        self.pending_bias = None
        self.sown = None

    def _update_bias(self, demand, train: bool) -> None:
        if (train and self.router_bias is not None
                and self.bias_update_rate > 0.0):
            self.pending_bias = (
                self.router_bias - self.bias_update_rate
                * torch.sign(demand.detach() - 1.0 / self.num_experts))

    def _sow(self, aux, load_frac, drop_rate) -> None:
        """What a training forward leaves for the step (the reference's
        "intermediates" sows)."""
        self.sown = {"moe_aux_loss": aux, "moe_load_frac": load_frac,
                     "moe_drop_rate": drop_rate}

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.router.weight.float())

    def _group(self, x):
        """The routing-group reshape: (grouped x, n_sub)."""
        return _group_tokens(x, self.group_size, self.group_stride)

    def _tokens(self, x, places):
        """The tokens the rank dispatches, as (G, T, D) or, under a seq
        group, its chunk's (G_l, T_l, D)."""
        if places is None:
            return self._group(x)[0]
        return x.reshape(-1, x.shape[-1])[places[2]]

    def _ungroup(self, y, x, n_sub, places):
        """`_tokens`' inverse: y back in x's (B, S, D) order."""
        if places is not None:
            return y.reshape(-1, y.shape[-1])[places[3]].reshape(x.shape)
        if n_sub <= 1:
            return y
        g0, t0, d = x.shape
        if self.group_stride:
            y = y.reshape(g0, n_sub, self.group_size, d).transpose(1, 2)
        return y.reshape(g0, t0, d)

    def _warn_oversized_group(self, t0: int, train: bool) -> None:
        if self.group_size > t0 and train:
            warnings.warn(
                f"moe group_size {self.group_size} exceeds the sequence "
                f"length {t0}: routing whole-sequence — pass 0 or a "
                "divisor of the sequence length", stacklevel=3)

    def _capacity(self, t: int) -> int:
        return max(1, int(self.capacity_factor * self.top_k * t
                          / self.num_experts))

    def _local(self) -> tuple:
        """(first, end) of the experts this rank holds."""
        if self.ep is None:
            return 0, self.num_experts
        return self.ep.experts(self.num_experts)

    def _experts(self):
        cd = self.dtype
        return (self.expert_w_in.to(cd), self.expert_b_in.to(cd),
                self.expert_w_out.to(cd), self.expert_b_out.to(cd))

    # -- the three paths -------------------------------------------------
    def _einsum(self, x: torch.Tensor, logits: torch.Tensor, places,
                train: bool, decode: bool) -> torch.Tensor:
        """`logits` are the whole sequence's; under a seq group `x` is the
        rank's chunk and `places` where its tokens lie in the groups."""
        g0, t0, _ = logits.shape
        self._warn_oversized_group(t0, train)
        logits, n_sub = self._group(logits)                  # (G, T, E)
        g, t, _ = logits.shape
        e, k = self.num_experts, self.top_k
        capacity = self._capacity(t)
        # combine = dispatch * weights: (G, T, E) weights, gates or gsel
        if self.router_kind == "expert_choice" and not decode:
            # capacity clamps to the group's token count; no aux loss and
            # no bias, and the coverage stands in for the drop rate
            dispatch, weights, uncovered = _expert_choice(
                logits, min(capacity, t))
            load = dispatch.sum(dim=(0, 1, 3))
            dispatch = _take(dispatch, places)
            aux = torch.zeros((), device=x.device)
        elif self.router_kind == "expert_choice":
            # decode: per-token top-k with capacity t (nothing drops),
            # combined with the raw gates at the picked experts
            dispatch = _take(top_k_gating(logits, k=k, capacity=t)[0],
                             places)
            weights = torch.softmax(logits, dim=-1)
        else:
            choices, positions, keeps, weights, aux, demand = top_k_routing(
                logits, k=k, capacity=capacity,
                routing_bias=self.router_bias)
            load = torch.sum(F.one_hot(choices, e).float()
                             * keeps[..., None], dim=(0, 1, 2))
            dispatch = _dispatch_tensor(
                *(_take(a, places) for a in (choices, positions, keeps)),
                e, capacity)
            self._update_bias(demand, train)
            aux = self.aux_loss_weight * aux
        if train:
            load = _global_sum(load)
            routed = load.sum()
            drop = (uncovered if self.router_kind == "expert_choice" else
                    1.0 - routed / (k * g * t * dist.process_count()))
            self._sow(aux, load / torch.clamp(routed, min=1.0), drop)
        w_in, b_in, w_out, b_out = self._experts()
        cd, ep = self.dtype, self.ep
        e0, e1 = self._local()
        dispatch = dispatch[:, :, e0:e1]
        xin = torch.einsum("gtec,gtd->egcd", dispatch.to(cd),
                           copy_to_tp(self._tokens(x, places), ep).to(cd))
        h = torch.einsum("egcd,edf->egcf", xin, w_in)
        h = F.gelu(h + b_in[:, None, None, :], approximate="tanh")
        out = torch.einsum("egcf,efd->egcd", h, w_out)
        out = out + b_out[:, None, None, :]
        # the local experts' combine: the sum over the group's ranks
        # (backward) runs on the (G, T, E) weights, not (G, T, E, C)
        weights = copy_to_tp(_take(weights, places), ep)[:, :, e0:e1]
        combine = dispatch * weights[..., None]
        y = torch.einsum("gtec,egcd->gtd", combine.to(cd), out)
        y = reduce_from_tp(y, ep)
        return self._ungroup(y, x, n_sub, places).to(x.dtype)

    def _gather(self, x: torch.Tensor, logits: torch.Tensor, places,
                train: bool) -> torch.Tensor:
        """The einsum path's routing with index-gather dispatch and combine
        through per-slot tables; the expert MLP stays a batched einsum.
        `logits` and `places` as `_einsum`'s."""
        d = x.shape[-1]
        self._warn_oversized_group(logits.shape[1], train)
        logits, n_sub = self._group(logits)
        g, t, _ = logits.shape
        e, k = self.num_experts, self.top_k
        capacity = self._capacity(t)
        choices, positions, keeps, gsel, aux, demand = top_k_routing(
            logits, k=k, capacity=capacity, routing_bias=self.router_bias)
        self._update_bias(demand, train)
        if train:
            load = _global_sum(torch.sum(
                F.one_hot(choices, e).float() * keeps[..., None],
                dim=(0, 1, 2)))
            routed = load.sum()
            self._sow(self.aux_loss_weight * aux,
                      load / torch.clamp(routed, min=1.0),
                      1.0 - routed / (k * g * t * dist.process_count()))
        w = torch.gather(gsel, -1, choices) * keeps          # (G, T, k)
        choices, positions, keeps = (_take(a, places)
                                     for a in (choices, positions, keeps))
        e0, e1 = self._local()
        slot_token, slot_round, slot_mask, dest = _local_slots(
            *_slot_tables(choices, positions, keeps, e, capacity),
            e0 * capacity, e1 * capacity)
        w_in, b_in, w_out, b_out = self._experts()
        cd, ep, el = self.dtype, self.ep, e1 - e0
        xin = _DispatchGather.apply(
            copy_to_tp(self._tokens(x, places), ep).to(cd), slot_token,
            slot_mask.to(cd), dest)                          # (G, El*C, D)
        gl = xin.shape[0]
        xin = xin.reshape(gl, el, capacity, d)
        h = torch.einsum("gecd,edf->gecf", xin, w_in)
        h = F.gelu(h + b_in[None, :, None, :], approximate="tanh")
        out = torch.einsum("gecf,efd->gecd", h, w_out)
        out = out + b_out[None, :, None, :]
        y = _CombineGather.apply(out.reshape(gl, el * capacity, d),
                                 copy_to_tp(_take(w, places), ep).to(cd),
                                 dest, slot_token, slot_round, slot_mask)
        y = reduce_from_tp(y, ep)
        return self._ungroup(y, x, n_sub, places).to(x.dtype)

    def _sorted(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """Dropless: counting sort by expert, the expert MLP as two grouped
        matmuls over the ragged (N*k, .) buffer, gathers back with the
        renormalized gates. Routing groups do not apply (no capacity).
        Under the expert axis the local experts' rows lead the sort and
        the grouped matmuls take only their group sizes: the other rows
        come out zero and add nothing to the combine."""
        g0, t0, d = x.shape
        e, k = self.num_experts, self.top_k
        n = g0 * t0
        xf = x.reshape(n, d)
        logits = self._logits(xf)                            # (N, E)
        choices, cgates, aux, demand = topk_choices(
            logits, k=k, routing_bias=self.router_bias)
        self._update_bias(demand, train)
        cf = choices.reshape(n * k)
        e0, e1 = self._local()
        counts, dest, inv = _assignment_permutation(cf, e, first=e0)
        dest_nk = dest.reshape(n, k)
        tok = inv // k
        if train:
            self._sow(self.aux_loss_weight * aux,
                      _global_sum(counts.float())
                      / (k * n * dist.process_count()),
                      torch.zeros((), device=x.device))
        w_in, b_in, w_out, b_out = self._experts()
        cd, ep = self.dtype, self.ep
        local = counts[e0:e1]
        # each sorted row's expert counted from e0 (the local ones first);
        # the biases zero past the local experts
        sorted_expert = (cf[inv] - e0) % e
        onehot_sorted = F.one_hot(sorted_expert, e).to(cd)
        pad = (0, 0, 0, e - (e1 - e0))
        x_sorted = _DispatchRows.apply(copy_to_tp(xf, ep).to(cd), tok,
                                       dest_nk)
        h = grouped_matmul(x_sorted, w_in, local)
        h = F.gelu(h + _BiasRows.apply(F.pad(b_in, pad), sorted_expert,
                                       onehot_sorted), approximate="tanh")
        out = grouped_matmul(h, w_out, local)
        out = out + _BiasRows.apply(F.pad(b_out, pad), sorted_expert,
                                    onehot_sorted)
        y = _CombineRows.apply(out, copy_to_tp(cgates, ep).to(cd), tok,
                               dest_nk, inv)
        y = reduce_from_tp(y, ep)
        return y.reshape(g0, t0, d).to(x.dtype)


def moe_layers(model: nn.Module):
    """The model's MoEMlp modules, in order."""
    return [m for m in model.modules() if isinstance(m, MoEMlp)]
