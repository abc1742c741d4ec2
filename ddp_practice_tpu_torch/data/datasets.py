"""Array-backed image datasets (a copy of the JAX-free parts of
ddp_practice_tpu/data/datasets.py: the port imports nothing of the JAX
package, and the same seed must give the same bytes). Ported: `Dataset`,
the IDX (MNIST) and CIFAR-10 readers, `synthetic_image_classification`
and `load_dataset`'s `mnist`, `cifar10` and `synthetic*` branches. The
array-record corpus behind `imagenet` is ROADMAP A2: that name raises.

The reference consumes `torchvision.datasets.MNIST` with a bare `ToTensor()`
transform — pixel values scaled to [0, 1], NO mean/std normalization
(origin_main.py:88-90, SURVEY §1 L2). We reproduce that contract from raw IDX
files when present, and fall back to a deterministic procedurally generated
dataset of the same shape when the real files are unavailable (this build
environment has no network egress; `download=True` is not an option).
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

# Canonical MNIST IDX file names (either raw or .gz).
_MNIST_FILES = {
    "train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}


@dataclasses.dataclass
class Dataset:
    """An array-backed dataset: NHWC images, integer labels.

    Two storage contracts, distinguished by dtype:

    - ``float32`` in [0, 1] — the reference's post-`ToTensor()` layout
      (origin_main.py:89); fine for MNIST/CIFAR-sized data held in RAM.
    - ``uint8`` in [0, 255] — raw pixels, 4x smaller in RAM *and* over
      H2D; normalization to [0,1] happens on device inside the
      step (train/steps.py `prepare_image`).
      ``images`` may be an ``np.memmap`` so ImageNet-scale corpora
      stream from disk through the OS page cache instead of
      materializing in host memory.
    """

    images: np.ndarray  # (N, H, W, C) float32 in [0,1] or uint8 in [0,255]
    labels: np.ndarray  # (N,) int32
    num_classes: int
    name: str = "dataset"

    def __post_init__(self):
        assert self.images.ndim == 4, self.images.shape
        assert self.images.dtype in (np.float32, np.uint8), self.images.dtype
        assert len(self.images) == len(self.labels)

    def __len__(self) -> int:
        return len(self.images)

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return tuple(self.images.shape[1:])


def read_idx_header(f, path: str = "<stream>"):
    """Parse an IDX header from an open binary stream -> dims tuple.

    The ONE definition of the header format, shared by the loader below
    and the ingest tool's structural verification (data/ingest.py)."""
    magic = struct.unpack(">I", f.read(4))[0]
    dtype_code = (magic >> 8) & 0xFF
    ndim = magic & 0xFF
    if dtype_code != 0x08:  # unsigned byte — the only type MNIST uses
        raise ValueError(f"unsupported IDX dtype 0x{dtype_code:02x} in {path}")
    return struct.unpack(f">{ndim}I", f.read(4 * ndim))


def idx_dims(path: str):
    """Dims tuple of an IDX file (raw or .gz) without reading the data."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return read_idx_header(f, path)


def _read_idx(path: str) -> np.ndarray:
    """Parse an IDX-format file (the MNIST on-disk format)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        dims = read_idx_header(f, path)
        data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(dims)


def _find_idx(data_dir: str, base: str) -> Optional[str]:
    for cand in (base, base + ".gz", base.replace("-idx", ".idx"),
                 base.replace("-idx", ".idx") + ".gz"):
        p = os.path.join(data_dir, cand)
        if os.path.exists(p):
            return p
        # torchvision layout: data/MNIST/raw/<file>
        p = os.path.join(data_dir, "MNIST", "raw", cand)
        if os.path.exists(p):
            return p
    return None


def load_mnist(data_dir: str, split: str) -> Optional[Dataset]:
    """Load real MNIST from IDX files if present, else None."""
    img_base, lbl_base = _MNIST_FILES[split]
    img_path = _find_idx(data_dir, img_base)
    lbl_path = _find_idx(data_dir, lbl_base)
    if img_path is None or lbl_path is None:
        return None
    # keep raw uint8: 4x less RAM and H2D traffic; the /255 happens on
    # device (train/steps.py prepare_image) — bit-identical to host ToTensor
    images = _read_idx(img_path)[..., None]  # NHWC, C=1
    labels = _read_idx(lbl_path).astype(np.int32)
    return Dataset(images=images, labels=labels, num_classes=10, name=f"mnist-{split}")


def synthetic_image_classification(
    *,
    n: int,
    image_shape: Tuple[int, int, int],
    num_classes: int,
    seed: int,
    split_seed: int = 0,
    noise: float = 0.35,
    name: str = "synthetic",
) -> Dataset:
    """Deterministic, learnable synthetic classification dataset.

    Each class c has a fixed random template T_c; a sample is
    clip(T_c + noise * N(0,1), 0, 1). The templates depend only on `seed`
    (shared across train/test so the task is learnable); `split_seed`
    decorrelates the samples between splits. Linearly separable enough that
    the parity models reach high accuracy in a few epochs, so the
    reference's behavioral contract ("accuracy rises past 91% in 3 epochs",
    origin_main.py / README) remains testable without network access.

    Stored as uint8 (like the real datasets it stands in for): 4x less RAM
    and H2D traffic; [0,1] scaling happens on device (prepare_image).
    """
    h, w, c = image_shape
    template_rng = np.random.default_rng(np.random.SeedSequence([seed, 0xDA7A]))
    templates = template_rng.uniform(0.0, 1.0, size=(num_classes, h, w, c)).astype(
        np.float32
    )
    rng = np.random.default_rng(np.random.SeedSequence([seed, split_seed]))
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    images = templates[labels] + noise * rng.standard_normal(
        (n, h, w, c), dtype=np.float32
    )
    images = np.clip(images * 255.0, 0.0, 255.0).astype(np.uint8)
    return Dataset(images=images, labels=labels, num_classes=num_classes, name=name)


def load_dataset(
    name: str,
    data_dir: str,
    split: str,
    *,
    seed: int = 0,
    synthetic_size: Optional[int] = None,
) -> Dataset:
    """Dataset registry.

    ``mnist`` / ``cifar10`` load real files when available and otherwise fall
    back to a shape-compatible synthetic dataset (and say so via the name).
    ``synthetic*`` is always procedural.
    """
    name = name.lower()
    if name == "mnist":
        ds = load_mnist(data_dir, split)
        if ds is not None:
            return ds
        n = synthetic_size or (60000 if split == "train" else 10000)
        return synthetic_image_classification(
            n=n, image_shape=(28, 28, 1), num_classes=10,
            seed=seed, split_seed=(0 if split == "train" else 1),
            name=f"mnist-synthetic-{split}",
        )
    if name == "cifar10":
        ds = _load_cifar10(data_dir, split)
        if ds is not None:
            return ds
        n = synthetic_size or (50000 if split == "train" else 10000)
        return synthetic_image_classification(
            n=n, image_shape=(32, 32, 3), num_classes=10,
            seed=seed, split_seed=(0 if split == "train" else 1),
            name=f"cifar10-synthetic-{split}",
        )
    if name == "imagenet":
        raise NotImplementedError(
            "dataset 'imagenet' (the array-record corpus) is not ported "
            "yet (ROADMAP A2)")
    if name.startswith("synthetic"):
        n = synthetic_size or (4096 if split == "train" else 1024)
        return synthetic_image_classification(
            n=n, image_shape=(28, 28, 1), num_classes=10,
            seed=seed, split_seed=(0 if split == "train" else 1),
            name=f"{name}-{split}",
        )
    raise ValueError(f"unknown dataset {name!r}")


def _load_cifar10(data_dir: str, split: str) -> Optional[Dataset]:
    """Load CIFAR-10 from the standard python-pickle batches if present."""
    import pickle

    base = os.path.join(data_dir, "cifar-10-batches-py")
    if not os.path.isdir(base):
        return None
    files = (
        [f"data_batch_{i}" for i in range(1, 6)] if split == "train" else ["test_batch"]
    )
    imgs, lbls = [], []
    for fn in files:
        p = os.path.join(base, fn)
        if not os.path.exists(p):
            return None
        with open(p, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        imgs.append(d[b"data"])
        lbls.extend(d[b"labels"])
    # raw uint8, normalized on device (prepare_image) — see load_mnist
    images = np.ascontiguousarray(
        np.concatenate(imgs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    )
    labels = np.asarray(lbls, dtype=np.int32)
    return Dataset(images=images, labels=labels, num_classes=10, name=f"cifar10-{split}")
