"""On-device input augmentation (counterpart of
ddp_practice_tpu/ops/augment.py): pad-crop + horizontal flip (the
CIFAR/MNIST rung) and Inception-style random resized crop + flip (the
ImageNet rung, ResNet-50 at 224).

It runs inside the train step, after the (device-resident) batch gather
and the uint8 -> [0, 1] normalize (train/steps.py `prepare_image`): the
host never touches pixels.

Random draws: the reference keys each step as fold_in(fold_in(
PRNGKey(seed), AUGMENT_TAG), global_step) through threefry, which the port
cannot reproduce. The port derives a 32-bit key from (seed, AUGMENT_TAG,
the global step) with the device hash the dropout keys use
(models/vit.py `mix32` / `fold32`; train/steps.py `step_key`), and each
draw from (key, a stream constant, the draw's index). `step` is the
device step counter on the training paths, so the eager, chunked and
resident steps, and a CUDA-graph replay of any of them, draw the same
crops at the same global step, and a resumed run (whose step counter is
restored) draws the crops it would have drawn: the reference's contract.
The dropout key hashes (step, seed) without the tag, so the two streams
are apart.

Each function takes its draws as tensors too (`offsets` and `mirror`;
`RRCDraws`), so a test can feed in the draws the reference made: given the same
draws, `random_crop_flip` is bit-equal to the reference's and
`random_resized_crop` agrees to float rounding.

`random_resized_crop` is the reference's resample, the library's
`image.scale_and_translate(method="linear", antialias=False)`, as its
`compute_weight_mat` computes it: the sample
position of output i is (i + 0.5)/s - t/s - 0.5, weighted by the
triangle kernel, each output's weights divided by their sum, and zero
where the sample lies outside [-0.5, n - 0.5]. Per image that is an
(H, H) and a (W, W) weight matrix applied as two batched contractions
(`F.interpolate` and `F.grid_sample` treat the edges otherwise). The
flip mirrors the columns of the (W, W) matrix, which is the flipped
output exactly.

Capture-safe: no host read of a device value and no host copy, so an
augmented step captures and replays under utils/graphs.py `StepGraph`.
"""

from __future__ import annotations

import math
import struct
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ddp_practice_tpu_torch.models.vit import fold32, mix32

# the reference's fold_in tag separating augmentation from dropout
AUGMENT_TAG = 0x415547  # "AUG"
# one stream constant a kind of draw
_OFFSETS, _MIRROR, _AREA, _RATIO, _POSITION = 1, 2, 3, 4, 5
_EPS32 = 1.1920928955078125e-07   # np.finfo(np.float32).eps


def augment_rng(seed: int, step):
    """The step's 32-bit augmentation key: a 0-dim int64 tensor on the
    step tensor's device when `step` is one (the device step counter),
    an int when it is an int; both give the same bits. The hash is
    chained (the seed's key under the tag, then the step), as the
    reference's fold_in(fold_in(seed, TAG), step): seed s at step t does
    not draw the crops of seed t at step s."""
    return mix32(fold32(step) ^ mix32(fold32(seed) ^ mix32(AUGMENT_TAG)))


def _bits(key, stream: int, n: int, device) -> torch.Tensor:
    """n 32-bit draws (int64 in [0, 2^32)) of `stream` under `key`."""
    idx = torch.arange(n, device=device, dtype=torch.int64)
    if isinstance(key, torch.Tensor):
        key = key.to(device)
    return mix32(mix32(idx ^ mix32(stream)) ^ key)


def _uniform(key, stream: int, shape, device) -> torch.Tensor:
    """fp32 uniforms in [0, 1): the top 24 bits of each draw."""
    bits = _bits(key, stream, math.prod(shape), device)
    return ((bits >> 8).to(torch.float32) * 2.0 ** -24).view(shape)


def crop_flip_draws(key, batch: int, pad: int, device):
    """(offsets (b, 2) int64 in [0, 2 pad], mirror (b,) bool) under
    `key`."""
    offsets = _bits(key, _OFFSETS, 2 * batch, device) % (2 * pad + 1)
    mirror = _uniform(key, _MIRROR, (batch,), device) < 0.5
    return offsets.view(batch, 2), mirror


class RRCDraws(NamedTuple):
    """A random resized crop's uniforms in [0, 1), one set an image: the
    area fraction's (b,), the log aspect ratio's (b,), the window's
    position (b, 2) (y, x); and the mirror mask (b,) bool."""
    area: torch.Tensor
    ratio: torch.Tensor
    position: torch.Tensor
    mirror: torch.Tensor


def rrc_draws(key, batch: int, device) -> RRCDraws:
    return RRCDraws(_uniform(key, _AREA, (batch,), device),
                    _uniform(key, _RATIO, (batch,), device),
                    _uniform(key, _POSITION, (batch, 2), device),
                    _uniform(key, _MIRROR, (batch,), device) < 0.5)


def random_crop_flip(images: torch.Tensor, key=None, *, pad: int = 4,
                     flip: bool = True,
                     offsets: Optional[torch.Tensor] = None,
                     mirror: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pad-and-crop plus horizontal flip, per image.

    images: (B, H, W, C). Zero-pads H and W by `pad`, takes each image's
    (H, W) window at `offsets` (B, 2) (y, x in [0, 2 pad]), then mirrors
    the images where `mirror` (B,) is true. Draws not given come from
    `key` (`augment_rng`). One gather: the flip is folded into the column
    index."""
    b, h, w, _ = images.shape
    if (pad > 0 and offsets is None) or (flip and mirror is None):
        d_off, d_mir = crop_flip_draws(key, b, pad, images.device)
        offsets = d_off if offsets is None else offsets
        mirror = d_mir if mirror is None else mirror
    rows = torch.arange(h, device=images.device).expand(b, h)
    cols = torch.arange(w, device=images.device).expand(b, w)
    if flip:
        cols = torch.where(mirror.to(images.device).view(b, 1),
                           cols.flip(1), cols)
    if pad > 0:
        images = F.pad(images, (0, 0, pad, pad, pad, pad))
        offsets = offsets.to(images.device).long()
        rows = rows + offsets[:, :1]
        cols = cols + offsets[:, 1:]
    elif not flip:
        return images
    bidx = torch.arange(b, device=images.device).view(b, 1, 1)
    return images[bidx, rows[:, :, None], cols[:, None, :]]


def _weight_mat(n: int, scale: torch.Tensor,
                translation: torch.Tensor) -> torch.Tensor:
    """(b, n_in, n_out) linear-interpolation weights of
    the reference's scale_and_translate (antialias off) for each image's
    `scale` and `translation` (b,), n_in = n_out = n."""
    inv = 1.0 / scale[:, None]
    grid = torch.arange(n, device=scale.device, dtype=scale.dtype)
    sample = (grid + 0.5)[None, :] * inv - translation[:, None] * inv - 0.5
    x = (sample[:, None, :] - grid[None, :, None]).abs()
    weights = torch.clamp_min(1.0 - x, 0.0)
    total = weights.sum(1, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * _EPS32,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= n - 0.5)
    return torch.where(inside[:, None, :], weights, torch.zeros_like(weights))


def _f32(x: float) -> float:
    """x rounded to the nearest fp32 value."""
    return struct.unpack("f", struct.pack("f", x))[0]


def _between(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """The reference library's map of a uniform u in [0, 1) onto [lo,
    hi) in fp32, max(lo, u (hi - lo) + lo), with lo, hi and hi - lo
    rounded to fp32 on the host (Python numbers: no device copy)."""
    lo, hi = _f32(lo), _f32(hi)
    return torch.clamp_min(u * _f32(hi - lo) + lo, lo)


def random_resized_crop(images: torch.Tensor, key=None, *,
                        scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                        flip: bool = True,
                        draws: Optional[RRCDraws] = None) -> torch.Tensor:
    """Inception-style random resized crop + horizontal flip, per image.

    images: (B, H, W, C) float. Each image draws an area fraction in
    `scale` and a log-uniform aspect ratio in `ratio`, clips the window
    to the image (the reference's choice over torchvision's rejection
    sampling), places it uniformly and resamples it back to (H, W) with
    linear interpolation; then mirrors it where the draw says. `draws`
    default to `rrc_draws(key, B)`."""
    b, h, w, _ = images.shape
    dev = images.device
    if draws is None:
        draws = rrc_draws(key, b, dev)
    area_u, ratio_u, pos_u, mirror = (t.to(dev) for t in draws)
    area = _between(area_u, *scale) * (h * w)
    r = torch.exp(_between(ratio_u, *(math.log(_f32(x)) for x in ratio)))
    crop_h = torch.clamp(torch.sqrt(area / r), 1.0, h)
    crop_w = torch.clamp(torch.sqrt(area * r), 1.0, w)
    off_y = pos_u[:, 0] * (h - crop_h)
    off_x = pos_u[:, 1] * (w - crop_w)
    # the window [off, off + crop) onto the whole output: s = H / crop_h,
    # t = -off * s
    s_y, s_x = h / crop_h, w / crop_w
    wy = _weight_mat(h, s_y, -off_y * s_y)
    wx = _weight_mat(w, s_x, -off_x * s_x)
    if flip:
        wx = torch.where(mirror.view(b, 1, 1), wx.flip(2), wx)
    x = images.float()
    x = torch.einsum("bhwc,bhy->bywc", x, wy)
    return torch.einsum("bywc,bwx->byxc", x, wx).to(images.dtype)


def check_kind(kind) -> None:
    """Raise for an augmentation kind `apply_augment` does not know."""
    if kind and kind is not True and kind not in ("crop_flip", "rrc"):
        raise ValueError(
            f"unknown augment kind {kind!r} (want 'crop_flip'|'rrc')")


def apply_augment(images: torch.Tensor, key, kind) -> torch.Tensor:
    """Dispatch an augmentation `kind`: False/"" -> identity,
    True/"crop_flip" -> pad-crop + flip, "rrc" -> random resized crop."""
    check_kind(kind)
    if not kind:
        return images
    if kind == "rrc":
        return random_resized_crop(images, key)
    return random_crop_flip(images, key)
