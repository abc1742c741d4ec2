"""Fused pre-LN transformer encoder layer, forward and backward (counterpart
of ddp_practice_tpu/ops/fused_encoder.py).

One layer is LN1 -> QKV -> per-head softmax attention (bidirectional or
causal) -> projection + residual -> LN2 -> tanh-GELU MLP + residual. On a
CUDA tensor the layer runs CUDA kernels written by hand for sm_90a
(`csrc/fused_encoder.cu`, built by `ops/cuda_build.py`, launched through
ctypes): kernel H forward, one launch (replaces `_fused_kernel`, reached
from `fused_encoder_forward`), and kernel I backward (replaces
`_fused_bwd_kernel`, reached from `fused_encoder_backward`): one
per-sequence launch with its vector-grad reduction, then kernel K
(`ops/grouped_matmul.py`, `csrc/grouped_matmul.cu`) four times for the
weight grads. bf16 products run on the tensor cores (fp32 accumulation),
fp32 ones as FMAs.

Design, where the reference's does not carry over:

- Weights are not resident. A block works on one sequence at a time and
  keeps that sequence's operands (LN outputs, the head's q/k/v, the
  probabilities, the fp32 staging tile) in shared memory. Kernel H reads
  weight fragments from global memory, where the layer's weights stay in
  the L2 cache; kernel I stages hd-row or hd-column blocks of them in two
  shared-memory slots (cp.async, the next block copied while the current
  one multiplies) and runs its products from shared memory with
  mma.sync fed by ldmatrix. Its recompute stashes each head's q|k|v and
  probabilities in a per-block buffer allocated here, and its heads'
  backward reads them back instead of recomputing them; its input grads
  through W_in and Wqkv run once a sequence over the stored operands. The wrapper casts
  the weights once per call to the compute dtype (the reference's `_prep`)
  and keeps PyTorch's (out, in) layout: the kernels read it transposed in
  place.
- What one sequence needs beyond the shared memory of an SM (232448 bytes)
  goes to a per-block scratch in global memory, allocated here with
  `torch.empty`: `_plan` places the buffers in order of use until the budget
  is spent (at the ViT-Tiny shape in bf16 kernel H keeps everything in
  shared memory; kernel I's weight slots push its fp32 dy and the two fp32
  residual streams out). The grid is cut so that the blocks' scratch stays
  within the L2.
- The backward's grads: blocks run in parallel, so the reference's
  accumulation over a sequential grid becomes, for the four weight
  matrices, one kernel K product each over every token of the layer (one
  group, fp32 output): each sequence writes the operands those products
  take (y1, dqkv, o_all, dx2, hg, dh, y2 in the compute dtype, rounded
  where the products round them) into per-layer (tokens, width) buffers
  allocated here. The 8 vector grads are a fixed number of persistent
  blocks' own fp32 partials (block b takes images b, b + grid, ...), summed
  by a second kernel in block order. K sums its work units in a fixed
  order too: the grads are the same bits on every run (atomicAdd's order
  would change from run to run; data-parallel replicas and the tests rely
  on equal grads).
- `seq_merge`, the tile auto-sizing and the VMEM declaration are TPU tuning
  with exact results and are not ported; `img_tile` is accepted and
  ignored. One sequence a block: kernel I's buffers and weight slots fill an
  SM's shared memory at ViT-Tiny, so several sequences a block do not fit.

`fused_shape_supported` is the port's own predicate: head_dim a multiple of
64 (the reference's `_head_dim_ok`, so the same shapes fuse in both
packages), mlp a multiple of 16, the layer's weights in the compute dtype
within 8 MiB (they are streamed from the L2 for every sequence), one
sequence's fp32 staging tile within an SM's shared memory and its scratch
within 4 MiB.

Rounding points (the plain version rounds at the same ones, so fp32 agrees
with the reference to summation order): every leaf, LayerNorm parameters and
biases included, is cast to the compute dtype and the vectors read back as
fp32; every product casts both operands to the compute dtype and
accumulates in fp32; LN (epsilon 1e-6), softmax, GELU and residuals are
fp32; qkv is stored in the compute dtype after the bias add, hg after the
GELU, dqkv after the fp32 bias sums; scores are dot(q, k) in fp32 then times
the fp32 1/sqrt(hd); causal masking adds -1e30; p is cast to the compute
dtype only inside its products; the cotangent is cast to x's dtype first, dx
leaves in x's dtype, weight grads leave fp32 and are cast to each leaf's
dtype.

On a CPU tensor the entries run the plain PyTorch version
(`fused_encoder_plain`, `fused_encoder_backward_plain`). `impl`: "auto" (the
kernels for CUDA tensors, the plain version for CPU tensors; never a
fallback), "kernel" (the kernels or raise) or "plain"; `forced_impl`
overrides it inside a block. `fused_encoder_layer` is a
`torch.autograd.Function` that saves only (x, params): the backward
recomputes the forward (remat semantics). `bwd_impl="reference"` recomputes
`reference_apply(params, x)` under autograd instead (the unfused block's
grads).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
from typing import Callable, Optional, Sequence

import torch

# launches per row of the kernel table, counted where a wrapper launches
# its kernel and nowhere else (a backward launch is kernel I's per-sequence
# kernel and its fixed-order reduction; its four kernel K launches count in
# ops/grouped_matmul.py's LAUNCHES, "tgmm" and "tgmm_reduce")
LAUNCHES = {"fused_encoder_fwd": 0, "fused_encoder_bwd": 0}

# the layer's 12 leaves, in the kernels' order, named as in EncoderBlock
PARAM_NAMES = (
    "ln1.weight", "ln1.bias", "attn.qkv.weight", "attn.qkv.bias",
    "attn.out.weight", "attn.out.bias", "ln2.weight", "ln2.bias",
    "mlp.fc_in.weight", "mlp.fc_in.bias", "mlp.fc_out.weight",
    "mlp.fc_out.bias",
)
_MATS = (2, 4, 8, 10)            # indices of the weight matrices
_VECS = (0, 1, 3, 5, 6, 7, 9, 11)

LN_EPS = 1e-6
_GELU_C = 0.7978845608028654     # sqrt(2/pi)
_GELU_A = 0.044715
_NEG = -1e30

SMEM_LIMIT = 232448              # bytes a block can use on sm_90
WEIGHT_LIMIT = 8 * 1024 * 1024   # weights in the compute dtype
SCRATCH_LIMIT = 4 * 1024 * 1024  # one block's scratch
L2_SCRATCH_BUDGET = 32 * 1024 * 1024   # all blocks' scratch together
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_IMPLS = ("auto", "kernel", "plain")
_forced: Optional[str] = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def block_params(block) -> tuple:
    """The 12 leaves of an EncoderBlock in `PARAM_NAMES` order."""
    return tuple(block.get_parameter(name) for name in PARAM_NAMES)


# ------------------------------------------------------------- predicate
def _head_dim_ok(d: int, num_heads: int) -> bool:
    """The head walk's alignment contract, the reference's: head_dim a
    multiple of 64."""
    return d % num_heads == 0 and (d // num_heads) % 64 == 0


# buffers of one sequence, in the order `_plan` gives them shared memory
# (B_W: kernel I's two weight staging slots)
(B_STATS, B_S, B_W, B_QKV, B_P, B_DS, B_Y, B_O, B_G, B_DY, B_XR, B_DX2,
 N_BUFFERS) = range(13)


@dataclasses.dataclass(frozen=True)
class Plan:
    """Where each buffer of one sequence lives: `offset` bytes into the
    block's shared memory (`in_scratch` 0) or into its global scratch (1),
    `ld` its row pitch in elements (B_W: one staging slot's elements, 0
    in the forward, whose weights are not staged); `ws` the staging tile's
    width,
    `chunk` the MLP columns per pass."""
    offset: tuple
    in_scratch: tuple
    ld: tuple
    smem_bytes: int
    scratch_bytes: int
    ws: int
    chunk: int

    def table(self) -> ctypes.Array:
        vals = list(self.offset) + list(self.in_scratch) + list(self.ld)
        return (ctypes.c_longlong * len(vals))(*vals)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _plan(seq_len: int, d: int, num_heads: int, mlp_dim: int,
          cd_bytes: int, backward: bool) -> Plan:
    """Place one sequence's buffers: shared memory in order of how often
    the kernel touches them, global scratch for what no longer fits. The
    backward (kernel I) stages its weights in two slots of hd x (d + pad)
    or d x (hd + pad) elements and runs its MLP hd columns a chunk."""
    sp = _round_up(seq_len, 16)
    hd = d // num_heads
    ws = max(3 * hd, 2 * sp if backward else sp)
    chunk = min(mlp_dim, hd if backward else 3 * hd)
    pad_t, pad_f = 16 // cd_bytes, 4
    slot = max(hd * (d + pad_t), d * (hd + pad_t)) if backward else 0
    # (buffer, width in elements, element bytes); rows are sp
    spec = {
        B_STATS: (4, 4),                 # mu1, r1, mu2, r2 per row
        B_S: (ws + pad_f, 4),            # fp32 staging: products, scores
        B_QKV: (3 * hd + pad_t, cd_bytes),   # a head's q|k|v; hg, dh chunks
        B_P: (sp + pad_t, cd_bytes),     # probabilities
        B_Y: (d + pad_t, cd_bytes),      # LN output
        B_O: (d + pad_t, cd_bytes),      # head outputs; backward: d(o)
        B_XR: (d + pad_f, 4),            # fp32 residual stream x -> x2 -> out
    }
    if backward:
        spec.update({
            B_W: (0, cd_bytes),              # two weight slots (sized above)
            B_DS: (sp + pad_t, cd_bytes),    # d(scores)
            B_G: (d + pad_t, cd_bytes),      # cotangent, then d(x2)
            B_DY: (d + pad_f, 4),            # d(LN output), accumulated
            B_DX2: (d + pad_f, 4),           # fp32 d(x2)
        })
    offset, where, ld = [0] * N_BUFFERS, [0] * N_BUFFERS, [0] * N_BUFFERS
    smem = scratch = 0
    for buf in range(N_BUFFERS):
        if buf not in spec:
            continue
        width, esz = spec[buf]
        nbytes = _round_up(sp * width * esz, 128)
        ld[buf] = width
        if buf == B_W:
            nbytes, ld[buf] = _round_up(2 * slot * cd_bytes, 128), slot
        if smem + nbytes <= SMEM_LIMIT:
            offset[buf], where[buf] = smem, 0
            smem += nbytes
        else:
            offset[buf], where[buf] = scratch, 1
            scratch += nbytes
    return Plan(tuple(offset), tuple(where), tuple(ld), smem,
                _round_up(scratch, 256), ws, chunk)


def _head_dim_error(d: int, num_heads: int) -> Optional[str]:
    if _head_dim_ok(d, num_heads):
        return None
    return (f"fused encoder layer needs head_dim a multiple of 64 (got "
            f"d={d}, heads={num_heads}): the head walk slices qkv columns "
            f"at head_dim offsets in 64-wide tiles; pick a head count with "
            f"head_dim >= 64 (e.g. --num_heads 4 for d=256)")


def shape_error(seq_len: int, d: int, mlp_dim: int, num_heads: int,
                compute_dtype) -> Optional[str]:
    """None when kernels H and I take this shape, else the limit it
    breaks."""
    if not _head_dim_ok(d, num_heads):
        return _head_dim_error(d, num_heads)
    if compute_dtype not in _DTYPE_CODE:
        return (f"fused encoder layer computes in float32 or bfloat16, not "
                f"{compute_dtype}")
    if mlp_dim % 16:
        return (f"fused encoder layer needs mlp_dim a multiple of 16 (the "
                f"tensor-core tile), got {mlp_dim}")
    cd_bytes = 2 if compute_dtype == torch.bfloat16 else 4
    w_bytes = (4 * d * d + 2 * d * mlp_dim) * cd_bytes
    if w_bytes > WEIGHT_LIMIT:
        return (f"fused encoder layer: weights at d={d}, mlp={mlp_dim} take "
                f"{w_bytes / 2**20:.1f} MiB in {compute_dtype}, over the "
                f"{WEIGHT_LIMIT >> 20} MiB the kernels stream from the L2 "
                f"cache for every sequence; this is the small-d kernel, use "
                f"the per-op path for wide models")
    plan = _plan(seq_len, d, num_heads, mlp_dim, cd_bytes, True)
    if plan.in_scratch[B_S]:
        return (f"fused encoder layer: one sequence of {seq_len} positions "
                f"needs a {_round_up(seq_len, 16)} x {plan.ws} fp32 staging "
                f"tile, over the {SMEM_LIMIT} bytes of shared memory of an "
                f"SM; long sequences keep the streaming flash kernels")
    if plan.scratch_bytes > SCRATCH_LIMIT:
        return (f"fused encoder layer: one sequence (s={seq_len}, d={d}) "
                f"needs {plan.scratch_bytes} bytes of scratch beyond shared "
                f"memory, over the {SCRATCH_LIMIT}-byte limit per block")
    return None


def fused_shape_supported(*, seq_len: int, d: int, mlp_dim: int,
                          num_heads: int, compute_dtype) -> bool:
    """True when kernels H and I can run this encoder shape (the
    auto-selection predicate of EncoderBlock fused="auto")."""
    return shape_error(seq_len, d, mlp_dim, num_heads,
                        compute_dtype) is None


# --------------------------------------------------------- plain versions
def _cast_params(params: Sequence[torch.Tensor], cd):
    """The reference's `_prep` and `_weights_f32`: every leaf cast to the
    compute dtype, then read as fp32 (products of rounded values are exact
    in fp32, so fp32 matmuls of them are the fp32-accumulated products)."""
    return [p.detach().to(cd).float() for p in params]


def _mm(a: torch.Tensor, b: torch.Tensor, cd) -> torch.Tensor:
    """a @ b with both operands rounded to `cd`, fp32 accumulation."""
    return a.to(cd).float() @ b.to(cd).float()


def _layer_norm(xt, scale, bias):
    mu = xt.mean(dim=-1, keepdim=True)
    var = (xt - mu).square().mean(dim=-1, keepdim=True)
    r = torch.rsqrt(var + LN_EPS)
    yhat = (xt - mu) * r
    return yhat * scale + bias, yhat, r


def _layer_norm_bwd(dya, yhat, r, scale):
    dscale = (dya * yhat).sum(dim=0)
    dbias = dya.sum(dim=0)
    dxhat = dya * scale
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * yhat).mean(dim=-1, keepdim=True)
    return r * (dxhat - m1 - yhat * m2), dscale, dbias


def _gelu_grad(x, t):
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * _GELU_C * (
        1.0 + 3.0 * _GELU_A * x * x)


def _fwd_core(xt, imgs, s, ws, *, num_heads, cd, causal):
    """The layer on (imgs*s, d) fp32 tokens with weights `ws` (cast, fp32,
    PyTorch (out, in) layout); every intermediate the backward needs."""
    (l1s, l1b, wqkv, bqkv, wproj, bproj, l2s, l2b, w_in, b_in, w_out,
     b_out) = ws
    t, d = xt.shape
    h, hd = num_heads, d // num_heads
    y1a, y1hat, r1 = _layer_norm(xt, l1s, l1b)
    qkv = (_mm(y1a, wqkv.T, cd) + bqkv).to(cd)
    scale = 1.0 / (hd ** 0.5)
    penalty = None
    if causal:
        pos = torch.arange(s, device=xt.device)
        penalty = torch.where(pos[:, None] >= pos[None, :], 0.0, _NEG)
    heads, outs = [], []
    for hi in range(h):
        q, k, v = (qkv[:, base + hi * hd: base + (hi + 1) * hd]
                   .reshape(imgs, s, hd) for base in (0, d, 2 * d))
        scores = _mm(q, k.transpose(1, 2), cd) * scale
        if penalty is not None:
            scores = scores + penalty
        scores = scores - scores.amax(dim=-1, keepdim=True)
        p = torch.exp(scores)
        p = p / p.sum(dim=-1, keepdim=True)
        outs.append(_mm(p, v, cd).reshape(t, hd))
        heads.append((q, k, v, p))
    o_all = torch.cat(outs, dim=1)
    x2 = xt + _mm(o_all, wproj.T, cd) + bproj
    y2a, y2hat, r2 = _layer_norm(x2, l2s, l2b)
    hpre = _mm(y2a, w_in.T, cd) + b_in
    tanh = torch.tanh(_GELU_C * (hpre + _GELU_A * hpre * hpre * hpre))
    hg = (0.5 * hpre * (1.0 + tanh)).to(cd)
    out = x2 + _mm(hg, w_out.T, cd) + b_out
    return dict(y1a=y1a, y1hat=y1hat, r1=r1, heads=heads, o_all=o_all,
                x2=x2, y2a=y2a, y2hat=y2hat, r2=r2, hpre=hpre, tanh=tanh,
                hg=hg, out=out)


def _check_x(x, params, num_heads):
    if x.dim() != 3:
        raise ValueError(f"x must be (imgs, s, d), got {tuple(x.shape)}")
    if len(params) != len(PARAM_NAMES):
        raise ValueError(f"want {len(PARAM_NAMES)} parameter leaves "
                         f"({', '.join(PARAM_NAMES)}), got {len(params)}")
    d = x.shape[2]
    if d % num_heads:
        raise ValueError(f"d={d} % heads={num_heads}")
    if not _head_dim_ok(d, num_heads):
        raise ValueError(_head_dim_error(d, num_heads))


@torch.no_grad()
def fused_encoder_plain(x, params, *, num_heads: int,
                        compute_dtype=torch.bfloat16, causal: bool = False):
    """Kernel H's arithmetic in plain PyTorch: x (imgs, s, d) -> out in x's
    dtype."""
    _check_x(x, params, num_heads)
    imgs, s, d = x.shape
    core = _fwd_core(x.detach().float().reshape(imgs * s, d), imgs, s,
                     _cast_params(params, compute_dtype),
                     num_heads=num_heads, cd=compute_dtype, causal=causal)
    return core["out"].reshape(imgs, s, d).to(x.dtype)


@torch.no_grad()
def fused_encoder_backward_plain(x, g, params, *, num_heads: int,
                                 compute_dtype=torch.bfloat16,
                                 causal: bool = False):
    """Kernel I's arithmetic in plain PyTorch: (dx in x's dtype, the 12
    parameter grads in PyTorch layout, each in its leaf's dtype)."""
    cd = compute_dtype
    dx, vec, ops, gt = backward_parts(x, g, params, num_heads=num_heads,
                                      compute_dtype=cd, causal=causal)
    ds1, db1, dbqkv, dbproj, ds2, db2, db_in, db_out = vec
    grads = (ds1, db1, _mm(ops["dqkv"].T, ops["y1"], cd), dbqkv,
             _mm(ops["dx2"].T, ops["o"], cd), dbproj, ds2, db2,
             _mm(ops["dh"].T, ops["y2"], cd), db_in,
             _mm(gt.T, ops["hg"], cd), db_out)
    return dx, tuple(gr.reshape(p.shape).to(p.dtype)
                     for gr, p in zip(grads, params))


@torch.no_grad()
def backward_parts(x, g, params, *, num_heads: int,
                   compute_dtype=torch.bfloat16, causal: bool = False):
    """Kernel I's per-sequence pass in plain PyTorch: (dx in x's dtype, the
    8 vector grads in fp32 [ln1_s, ln1_b, bqkv, bproj, ln2_s, ln2_b, b_in,
    b_out], the weight grads' operands {y1, dqkv, o, dx2, hg, dh, y2} as
    fp32 (tokens, width) values before their rounding to the compute dtype,
    the cotangent g as fp32 (tokens, d)). The weight grads are `_mm` of
    them: dWqkv = dqkvᵀ y1, dWproj = dx2ᵀ o, dW_in = dhᵀ y2, dW_out =
    gᵀ hg."""
    _check_x(x, params, num_heads)
    cd = compute_dtype
    imgs, s, d = x.shape
    h, hd = num_heads, d // num_heads
    t = imgs * s
    ws = _cast_params(params, cd)
    (l1s, _, wqkv, _, wproj, _, l2s, _, w_in, _, w_out, _) = ws
    xt = x.detach().float().reshape(t, d)
    gt = g.detach().to(x.dtype).float().reshape(t, d)
    core = _fwd_core(xt, imgs, s, ws, num_heads=num_heads, cd=cd,
                     causal=causal)
    # MLP branch
    db_out = gt.sum(dim=0)
    dhg = _mm(gt, w_out, cd)
    dhpre = dhg * _gelu_grad(core["hpre"], core["tanh"])
    db_in = dhpre.sum(dim=0)
    dy2a = _mm(dhpre, w_in, cd)
    dx2_ln, ds2, db2 = _layer_norm_bwd(dy2a, core["y2hat"], core["r2"], l2s)
    dx2 = gt + dx2_ln
    # attention branch
    dbproj = dx2.sum(dim=0)
    do_all = _mm(dx2, wproj, cd)
    scale = 1.0 / (hd ** 0.5)
    cols = [[], [], []]
    for hi, (q, k, v, p) in enumerate(core["heads"]):
        do = do_all[:, hi * hd:(hi + 1) * hd].reshape(imgs, s, hd)
        dp = _mm(do, v.transpose(1, 2), cd)
        dv = _mm(p.transpose(1, 2), do, cd)
        dsc = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        dsc = dsc * scale
        dq = _mm(dsc, k, cd)
        dk = _mm(dsc.transpose(1, 2), q, cd)
        for group, piece in zip(cols, (dq, dk, dv)):
            group.append(piece.reshape(t, hd))
    dqkv32 = torch.cat(cols[0] + cols[1] + cols[2], dim=1)   # (t, 3d)
    dbqkv = dqkv32.sum(dim=0)
    dqkv = dqkv32.to(cd).float()
    dy1a = _mm(dqkv, wqkv, cd)
    dx1_ln, ds1, db1 = _layer_norm_bwd(dy1a, core["y1hat"], core["r1"], l1s)
    dx = (dx2 + dx1_ln).reshape(imgs, s, d).to(x.dtype)
    ops = dict(y1=core["y1a"], dqkv=dqkv, o=core["o_all"], dx2=dx2,
               hg=core["hg"].float(), dh=dhpre, y2=core["y2a"])
    return dx, (ds1, db1, dbqkv, dbproj, ds2, db2, db_in, db_out), ops, gt


# ------------------------------------------------------------- dispatch
@contextlib.contextmanager
def forced_impl(impl: str):
    """Inside the block every entry runs `impl`, whatever its own `impl`
    argument (a backward follows its forward's choice)."""
    global _forced
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r} (want auto|kernel|plain)")
    previous, _forced = _forced, impl
    try:
        yield
    finally:
        _forced = previous


def _use_kernel(impl: str, x: torch.Tensor) -> bool:
    impl = _forced or impl
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r} (want auto|kernel|plain)")
    if impl == "plain" or (impl == "auto" and x.device.type == "cpu"):
        return False
    if x.device.type != "cuda":
        raise ValueError(
            f"impl={impl!r} launches the CUDA kernels; got a tensor on "
            f"{x.device}")
    return True


def fused_encoder_forward(x, params, *, num_heads: int,
                          compute_dtype=torch.bfloat16, img_tile: int = 0,
                          causal: bool = False, impl: str = "auto"):
    """One encoder layer, forward. x: (imgs, s, d) fp32 or bf16; params: the
    12 leaves in `PARAM_NAMES` order. `img_tile` is the reference's tuning
    argument: accepted, ignored (the kernels size their own work)."""
    del img_tile
    if not _use_kernel(impl, x):
        return fused_encoder_plain(x, params, num_heads=num_heads,
                                   compute_dtype=compute_dtype, causal=causal)
    out = _launch_fwd(x, params, num_heads, compute_dtype, causal)
    LAUNCHES["fused_encoder_fwd"] += 1
    return out


def fused_encoder_backward(x, g, params, *, num_heads: int,
                           compute_dtype=torch.bfloat16, img_tile: int = 0,
                           causal: bool = False, impl: str = "auto"):
    """(dx, the 12 parameter grads): recompute + transpose."""
    del img_tile
    if not _use_kernel(impl, x):
        return fused_encoder_backward_plain(
            x, g, params, num_heads=num_heads, compute_dtype=compute_dtype,
            causal=causal)
    out = _launch_bwd(x, g, params, num_heads, compute_dtype, causal)
    LAUNCHES["fused_encoder_bwd"] += 1
    return out


class _FusedEncoderLayer(torch.autograd.Function):
    """Saves (x, params) only; the backward recomputes the forward."""

    @staticmethod
    def forward(ctx, x, num_heads, compute_dtype, causal, bwd_impl,
                reference_apply, impl, *params):
        use_kernel = _use_kernel(impl, x)
        ctx.meta = (num_heads, compute_dtype, causal, bwd_impl,
                    reference_apply, "kernel" if use_kernel else "plain")
        ctx.save_for_backward(x, *params)
        return fused_encoder_forward(
            x, params, num_heads=num_heads, compute_dtype=compute_dtype,
            causal=causal, impl=ctx.meta[-1])

    @staticmethod
    def backward(ctx, g):
        (num_heads, compute_dtype, causal, bwd_impl, reference_apply,
         impl) = ctx.meta
        x, *params = ctx.saved_tensors
        if bwd_impl == "reference":
            with torch.enable_grad():
                xs = x.detach().requires_grad_(True)
                ps = [p.detach().requires_grad_(True) for p in params]
                out = reference_apply(ps, xs)
                grads = torch.autograd.grad(out, [xs, *ps], g.to(out.dtype))
            return (grads[0],) + (None,) * 6 + tuple(grads[1:])
        dx, dparams = fused_encoder_backward(
            x, g, params, num_heads=num_heads, compute_dtype=compute_dtype,
            causal=causal, impl=impl)
        return (dx,) + (None,) * 6 + tuple(dparams)


def fused_encoder_layer(x, params, *, num_heads: int,
                        reference_apply: Optional[Callable] = None,
                        compute_dtype=torch.bfloat16, img_tile: int = 0,
                        bwd_impl: str = "kernel", causal: bool = False,
                        impl: str = "auto"):
    """Differentiable fused layer: kernel H forward, kernel I backward.

    `bwd_impl="kernel"` (default) runs the fused backward;
    "reference" recomputes `reference_apply(params, x)` under autograd
    instead (the unfused block and its grads)."""
    del img_tile
    if bwd_impl not in ("kernel", "reference"):
        raise ValueError(f"bwd_impl {bwd_impl!r} (kernel|reference)")
    if bwd_impl == "reference" and reference_apply is None:
        raise ValueError("bwd_impl='reference' needs reference_apply")
    return _FusedEncoderLayer.apply(x, num_heads, compute_dtype, causal,
                                    bwd_impl, reference_apply, impl,
                                    *params)


# -------------------------------------------------------------- launches
def _prepare(x, params, num_heads, compute_dtype):
    """Checks, the packed operands and the launch geometry both kernels
    share: (x contiguous, weights in the compute dtype [wqkv | wproj | w_in
    | w_out], vectors fp32 rounded through it [ln1_s, ln1_b, bqkv, bproj,
    ln2_s, ln2_b, b_in, b_out], mlp)."""
    _check_x(x, params, num_heads)
    imgs, s, d = x.shape
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    mlp = params[8].shape[0]
    shapes = ((d,), (d,), (3 * d, d), (3 * d,), (d, d), (d,), (d,), (d,),
              (mlp, d), (mlp,), (d, mlp), (d,))
    for name, p, shape in zip(PARAM_NAMES, params, shapes):
        if tuple(p.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(p.shape)}, want "
                             f"{shape}")
        if p.device != x.device:
            raise ValueError(f"{name} is on {p.device}, x on {x.device}")
    err = shape_error(s, d, mlp, num_heads, compute_dtype)
    if err:
        raise ValueError(err)
    if imgs == 0:
        raise ValueError("x holds no sequence")
    with torch.no_grad():
        mats = torch.cat([params[i].detach().to(compute_dtype).reshape(-1)
                          for i in _MATS])
        vecs = torch.cat([params[i].detach().to(compute_dtype).float()
                          for i in _VECS])
    return x.detach().contiguous(), mats, vecs, mlp


def _grid(imgs: int, plan: Plan, device) -> int:
    """Persistent blocks: one per SM at most, fewer when their scratch
    together would leave the L2."""
    n = min(imgs, torch.cuda.get_device_properties(device)
            .multi_processor_count)
    if plan.scratch_bytes:
        n = min(n, max(1, L2_SCRATCH_BUDGET // plan.scratch_bytes))
    return n


def _launch_fwd(x, params, num_heads, compute_dtype, causal):
    xc, mats, vecs, mlp = _prepare(x, params, num_heads, compute_dtype)
    imgs, s, d = xc.shape
    plan = _plan(s, d, num_heads, mlp, mats.element_size(), False)
    grid = _grid(imgs, plan, x.device)
    out = torch.empty_like(xc)
    scratch = torch.empty(max(grid * plan.scratch_bytes, 256),
                          dtype=torch.uint8, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        rc = lib.fused_encoder_fwd(
            xc.data_ptr(), out.data_ptr(), mats.data_ptr(), vecs.data_ptr(),
            scratch.data_ptr(), plan.table(), imgs, s, d, num_heads, mlp,
            int(causal), _DTYPE_CODE[xc.dtype], _DTYPE_CODE[compute_dtype],
            grid, plan.smem_bytes, plan.scratch_bytes, plan.chunk,
            _stream(x))
    _raise_on(rc, "fused_encoder_fwd", xc, num_heads, mlp, compute_dtype)
    return out


def _launch_bwd(x, g, params, num_heads, compute_dtype, causal):
    """Kernel I: the per-sequence pass (dx, the vector grads, the weight
    grads' operands), then the four weight grads through kernel K."""
    dx, vec, ops, gt = _bwd_sequences(x, g, params, num_heads, compute_dtype,
                                      causal)
    return dx, assemble_grads(vec, _bwd_weight_grads(ops, gt), params)


def assemble_grads(vec, mats, params) -> tuple:
    """The 12 parameter grads in `PARAM_NAMES` order, each in its leaf's
    dtype, from kernel I's flat vector grads (9d + mlp fp32: ln1_s, ln1_b,
    bqkv, bproj, ln2_s, ln2_b, b_in, b_out) and its four weight grads
    (dWqkv, dWproj, dW_in, dW_out)."""
    d, mlp = params[0].shape[0], params[9].shape[0]
    ln1_s, ln1_b, bqkv, bproj, ln2_s, ln2_b, b_in, b_out = vec.split(
        (d, d, 3 * d, d, d, d, mlp, d))
    dwqkv, dwproj, dw_in, dw_out = mats
    flat = (ln1_s, ln1_b, dwqkv, bqkv, dwproj, bproj, ln2_s, ln2_b, dw_in,
            b_in, dw_out, b_out)
    return tuple(piece.reshape(p.shape).to(p.dtype)
                 for piece, p in zip(flat, params))


# kernel I's per-layer operands of the weight grads (csrc enum Op): name,
# width in units of (d, mlp)
BWD_OPERANDS = (("y1", (1, 0)), ("dqkv", (3, 0)), ("o", (1, 0)),
                ("dx2", (1, 0)), ("hg", (0, 1)), ("dh", (0, 1)),
                ("y2", (1, 0)))


def _bwd_sequences(x, g, params, num_heads, compute_dtype, causal):
    """Kernel I's per-sequence launch and its vector-grad reduction: (dx,
    the 9d + mlp vector grads in fp32, {operand: (tokens, width) in the
    compute dtype}, T(g) as (tokens, d))."""
    xc, mats, vecs, mlp = _prepare(x, params, num_heads, compute_dtype)
    imgs, s, d = xc.shape
    if tuple(g.shape) != tuple(x.shape) or g.device != x.device:
        raise ValueError(f"g must match x: {tuple(g.shape)} on {g.device} "
                         f"vs {tuple(x.shape)} on {x.device}")
    gc = g.detach().to(x.dtype).contiguous()
    plan = _plan(s, d, num_heads, mlp, mats.element_size(), True)
    grid = _grid(imgs, plan, x.device)
    vsz = 9 * d + mlp
    dx = torch.empty_like(xc)
    scratch = torch.empty(max(grid * plan.scratch_bytes, 256),
                          dtype=torch.uint8, device=x.device)
    vpart = torch.empty((grid, vsz), dtype=torch.float32, device=x.device)
    vec = torch.empty(vsz, dtype=torch.float32, device=x.device)
    ops = {name: torch.empty((imgs * s, a * d + b * mlp), dtype=compute_dtype,
                             device=x.device)
           for name, (a, b) in BWD_OPERANDS}
    # each block's stash of the recompute's q|k|v, P and fp32 p per head
    sp = _round_up(s, 16)
    stash_bytes = _round_up(num_heads * (sp * (plan.ld[B_QKV] + plan.ld[B_P])
                                         * mats.element_size() + sp * sp * 4),
                            16)
    stash = torch.empty(grid * stash_bytes, dtype=torch.uint8,
                        device=x.device)
    pointers = (ctypes.c_void_p * len(ops))(*(t.data_ptr()
                                              for t in ops.values()))
    lib = _library()
    with torch.cuda.device(x.device):
        rc = lib.fused_encoder_bwd(
            xc.data_ptr(), gc.data_ptr(), dx.data_ptr(), mats.data_ptr(),
            vecs.data_ptr(), scratch.data_ptr(), vpart.data_ptr(),
            vec.data_ptr(), pointers, stash.data_ptr(), stash_bytes,
            plan.table(), imgs, s, d, num_heads,
            mlp, int(causal), _DTYPE_CODE[xc.dtype],
            _DTYPE_CODE[compute_dtype], grid, plan.smem_bytes,
            plan.scratch_bytes, plan.chunk, _stream(x))
    _raise_on(rc, "fused_encoder_bwd", xc, num_heads, mlp, compute_dtype)
    return dx, vec, ops, gc.reshape(imgs * s, d).to(compute_dtype)


def _bwd_weight_grads(ops, gt):
    """Kernel I's four weight grads, each one kernel K product with one
    group over all tokens and fp32 output, in PyTorch's (out, in) layout:
    dWqkv = dqkvᵀ y1, dWproj = T(dx2)ᵀ o_all, dW_in = dhᵀ y2, dW_out =
    T(g)ᵀ hg (4 "tgmm" launches, and a "tgmm_reduce" after each whose
    tokens span more than one work unit)."""
    from ddp_practice_tpu_torch.ops import grouped_matmul as gm

    one = torch.full((1,), gt.shape[0], dtype=torch.int32, device=gt.device)
    return tuple(gm.tgmm(lhs, rhs, one, out_dtype=torch.float32,
                         impl="kernel")[0]
                 for lhs, rhs in ((ops["dqkv"], ops["y1"]),
                                  (ops["dx2"], ops["o"]),
                                  (ops["dh"], ops["y2"]),
                                  (gt, ops["hg"])))


def _raise_on(rc, name, x, num_heads, mlp, compute_dtype):
    if rc != 0:
        imgs, s, d = x.shape
        raise RuntimeError(
            f"{name} launch failed: cudaError_t {rc} (imgs={imgs}, s={s}, "
            f"d={d}, heads={num_heads}, mlp={mlp}, x {x.dtype}, compute "
            f"{compute_dtype})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _library() -> ctypes.CDLL:
    """The fused-encoder library with every pointer and the stream declared
    `c_void_p` (a bare Python int would pass as a 32-bit int)."""
    from ddp_practice_tpu_torch.ops.cuda_build import load_library

    lib = load_library("fused_encoder")
    if not getattr(lib, "_signatures_set", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        T = ctypes.POINTER(ctypes.c_longlong)
        tail = [T] + [I] * 8 + [I, I, ctypes.c_longlong, I, P]
        lib.fused_encoder_fwd.argtypes = [P] * 5 + tail
        lib.fused_encoder_fwd.restype = I
        lib.fused_encoder_bwd.argtypes = [P] * 8 + [
            ctypes.POINTER(ctypes.c_void_p), P, ctypes.c_longlong] + tail
        lib.fused_encoder_bwd.restype = I
        lib._signatures_set = True
    return lib

