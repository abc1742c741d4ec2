"""Array-backed image datasets (a copy of the JAX-free parts of
ddp_practice_tpu/data/datasets.py: the port imports nothing of the JAX
package, and the same seed must give the same bytes): `Dataset`, the IDX
(MNIST) and CIFAR-10 readers, `synthetic_image_classification`, the
array-record corpus (`write_array_dataset`, `load_array_dataset`,
`synthetic_imagenet_corpus`: for the same arguments the files on disk
are the reference writer's bytes, so a corpus written by either package
loads in the other) and every branch of `load_dataset`, `imagenet`
included.

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
        real = os.path.join(data_dir, "imagenet-arrays")
        # accept the conventional 'val' name for the held-out split
        candidates = (split, "val") if split == "test" else (split,)
        for cand in candidates:
            if _array_dataset_exists(real, cand):
                return load_array_dataset(real, cand)
        if os.path.isdir(real):
            # a real corpus exists but not this split: refuse rather than
            # silently mixing real training with synthetic-noise eval
            raise FileNotFoundError(
                f"{real} exists but has no complete "
                f"{' or '.join(candidates)!s} split; expected "
                f"<split>-images.npy + <split>-labels.npy + meta.json"
            )
        n = synthetic_size or (16384 if split == "train" else 2048)
        root = os.path.join(data_dir, f"imagenet-synthetic-{n}-s{seed}")
        return synthetic_imagenet_corpus(root, split, n=n, seed=seed)
    if name.startswith("synthetic"):
        n = synthetic_size or (4096 if split == "train" else 1024)
        return synthetic_image_classification(
            n=n, image_shape=(28, 28, 1), num_classes=10,
            seed=seed, split_seed=(0 if split == "train" else 1),
            name=f"{name}-{split}",
        )
    raise ValueError(f"unknown dataset {name!r}")


# --------------------------------------------------------------------- #
# Array-record corpus: the ImageNet-scale storage format.
#
# A corpus directory holds `{split}-images.npy` (uint8, N x H x W x C) and
# `{split}-labels.npy` (int32, N) plus `meta.json`. `.npy` because
# `np.load(mmap_mode="r")` memory-maps it directly: batch gather touches
# only the pages it indexes, so a ~150 GB ImageNet-sized corpus streams
# through the OS page cache — nothing is ever materialized as fp32 in RAM
# (the reference leans on torchvision + DataLoader workers for this role,
# origin_main.py:88-107). Writes are chunked through a writer memmap and
# finished with os.replace, so a crashed writer never leaves a readable
# but torn corpus behind.
# --------------------------------------------------------------------- #


_STALE_TMP_AGE_S = 3600.0


def _sweep_stale_tmps(root: str) -> None:
    """Remove tmp files abandoned by crashed writers (a killed worker's
    finally never runs, and its full-size memmap would otherwise sit on
    the data disk forever). Age-gated so live concurrent writers — which
    use pid-unique names and touch their files continuously — are never
    swept."""
    import time

    now = time.time()
    for name in os.listdir(root):
        if ".tmp." not in name:
            continue
        p = os.path.join(root, name)
        try:
            if now - os.path.getmtime(p) > _STALE_TMP_AGE_S:
                os.remove(p)
        except OSError:
            pass


def _array_dataset_exists(root: str, split: str) -> bool:
    """A split is complete only when its files exist AND meta.json lists
    it: the writer drops the split's meta entry before rewriting the data
    files and restores it after both are in place, so a crash between the
    two file replaces leaves an incomplete-marked corpus, never a readable
    images/labels pair from different generations."""
    import json

    if not all(
        os.path.exists(os.path.join(root, f))
        for f in (f"{split}-images.npy", f"{split}-labels.npy", "meta.json")
    ):
        return False
    try:
        with open(os.path.join(root, "meta.json")) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return False
    return split in meta.get("splits", {})


class _MetaLock:
    """Best-effort advisory lock serializing meta.json read-modify-write
    (concurrent writers of *different* splits would otherwise drop each
    other's entry). flock is per-host-reliable and works on NFSv4; where
    it is a no-op the split-completeness protocol still bounds the damage
    to a spurious regeneration, never corruption."""

    def __init__(self, root: str):
        self._path = os.path.join(root, ".meta.lock")
        self._f = None

    def __enter__(self):
        self._f = open(self._path, "a+")
        try:
            import fcntl

            fcntl.flock(self._f, fcntl.LOCK_EX)
        except (ImportError, OSError):
            pass
        return self

    def __exit__(self, *exc):
        try:
            self._f.close()  # releases the flock
        except OSError:
            pass
        return False


def write_array_dataset(
    root: str,
    split: str,
    chunks,
    *,
    n: int,
    image_shape: Tuple[int, int, int],
    num_classes: int,
    name: str = "array",
    extra_meta: Optional[dict] = None,
) -> None:
    """Stream `chunks` of (uint8 images, labels) into an array-record corpus.

    Peak host memory is one chunk regardless of `n`: chunks are copied
    straight into a writer memmap. Files appear under their final names
    only when complete (tmp + os.replace), `meta.json` last. Tmp names are
    pid-unique, so concurrent writers (e.g. the per-host processes of a
    multi-host run racing to generate the same synthetic corpus) never
    truncate each other's mapping; deterministic generators make the
    last-rename-wins outcome byte-identical.
    """
    import json

    import uuid

    os.makedirs(root, exist_ok=True)
    _sweep_stale_tmps(root)
    # host-unique suffix: PIDs collide across hosts on a shared filesystem
    tag = f"{os.getpid()}.{uuid.uuid4().hex[:8]}"
    img_tmp = os.path.join(root, f".{split}-images.npy.tmp.{tag}")
    lbl_tmp = os.path.join(root, f".{split}-labels.npy.tmp.{tag}")
    done = False
    try:
        images = np.lib.format.open_memmap(
            img_tmp, mode="w+", dtype=np.uint8, shape=(n,) + tuple(image_shape)
        )
        labels = np.lib.format.open_memmap(
            lbl_tmp, mode="w+", dtype=np.int32, shape=(n,)
        )
        written = 0
        for img_chunk, lbl_chunk in chunks:
            img_chunk = np.asarray(img_chunk)
            lbl_chunk = np.asarray(lbl_chunk, dtype=np.int32)
            if img_chunk.dtype != np.uint8:
                raise ValueError(f"chunk dtype {img_chunk.dtype}, expected uint8")
            k = len(img_chunk)
            # exact-shape checks: numpy assignment would happily broadcast a
            # mis-shaped chunk into a silently corrupted corpus
            if img_chunk.shape[1:] != tuple(image_shape):
                raise ValueError(
                    f"chunk image shape {img_chunk.shape[1:]}, "
                    f"expected {tuple(image_shape)}"
                )
            if lbl_chunk.shape != (k,):
                raise ValueError(
                    f"chunk labels shape {lbl_chunk.shape}, expected ({k},)"
                )
            if written + k > n:
                raise ValueError(f"chunks exceed declared n={n}")
            images[written : written + k] = img_chunk
            labels[written : written + k] = lbl_chunk
            written += k
            # mmap writes do not update mtime; touch so a concurrent
            # writer's stale-tmp sweep never reaps a live slow writer
            os.utime(img_tmp)
            os.utime(lbl_tmp)
        if written != n:
            raise ValueError(f"chunks provided {written} samples, declared n={n}")
        images.flush()
        labels.flush()
        del images, labels  # close the writer maps before rename
        # mark the split incomplete across the two-file swap: a crash
        # between the replaces must not leave new images readable against
        # old labels (see _array_dataset_exists)
        _update_meta(root, tag, num_classes, name, split, None)
        os.replace(img_tmp, os.path.join(root, f"{split}-images.npy"))
        os.replace(lbl_tmp, os.path.join(root, f"{split}-labels.npy"))
        _update_meta(root, tag, num_classes, name, split, {
            "n": n, "image_shape": list(image_shape),
            **({"gen": extra_meta} if extra_meta else {}),
        })
        done = True
    finally:
        if not done:  # a failed writer must not strand a full-size tmp
            for p in (img_tmp, lbl_tmp):
                try:
                    os.remove(p)
                except OSError:
                    pass


def _update_meta(root, tag, num_classes, name, split, entry) -> None:
    """Atomically merge one split entry into meta.json under the advisory
    lock (entry=None removes the split, marking it incomplete)."""
    import json

    meta_path = os.path.join(root, "meta.json")
    with _MetaLock(root):
        meta = {"num_classes": num_classes, "name": name, "splits": {}}
        if os.path.exists(meta_path):
            try:
                with open(meta_path) as f:
                    meta = json.load(f)
            except (OSError, ValueError):
                pass  # rebuild a fresh meta over the corrupt one
        meta["num_classes"] = num_classes
        meta["name"] = name
        splits = meta.setdefault("splits", {})
        if entry is None:
            splits.pop(split, None)
        else:
            splits[split] = entry
        tmp = f"{meta_path}.tmp.{tag}"
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(tmp, meta_path)


def load_array_dataset(root: str, split: str, *, mmap: bool = True) -> Dataset:
    """Open an array-record corpus split; `mmap=True` (default) streams
    pixels from disk on access instead of loading them into RAM."""
    import json

    with open(os.path.join(root, "meta.json")) as f:
        meta = json.load(f)
    mode = "r" if mmap else None
    images = np.load(os.path.join(root, f"{split}-images.npy"), mmap_mode=mode)
    labels = np.asarray(
        np.load(os.path.join(root, f"{split}-labels.npy")), dtype=np.int32
    )
    return Dataset(
        images=images,
        labels=labels,
        num_classes=int(meta["num_classes"]),
        name=f"{meta.get('name', 'array')}-{split}",
    )


def synthetic_imagenet_corpus(
    root: str,
    split: str,
    *,
    n: int,
    image_shape: Tuple[int, int, int] = (224, 224, 3),
    num_classes: int = 1000,
    seed: int = 3407,
    noise: float = 0.35,
    chunk_size: int = 256,
) -> Dataset:
    """ImageNet-shaped synthetic corpus, generated to disk once and
    memory-mapped thereafter.

    Same template+noise construction as `synthetic_image_classification`
    (learnable, deterministic in (seed, split)) but streamed: class
    templates live at 1/16 resolution and are upsampled per chunk, so
    generation and loading both run in O(chunk) host memory — the property
    the fp32 in-RAM path fundamentally lacks at this scale.
    """
    gen_params = {
        "seed": seed, "noise": noise, "num_classes": num_classes,
        "split": split,
    }
    if _array_dataset_exists(root, split):
        import json

        with open(os.path.join(root, "meta.json")) as f:
            meta = json.load(f)
        cached = meta.get("splits", {}).get(split, {})
        # cache hit only when every generation parameter matches — a corpus
        # from a different seed/noise/class-count must not be silently reused
        if (
            cached.get("n") == n
            and tuple(cached.get("image_shape", ())) == tuple(image_shape)
            and cached.get("gen") == gen_params
        ):
            return load_array_dataset(root, split)
    h, w, c = image_shape
    th, tw = max(1, h // 16), max(1, w // 16)
    template_rng = np.random.default_rng(np.random.SeedSequence([seed, 0xDA7A]))
    templates = template_rng.uniform(
        0.0, 1.0, size=(num_classes, th, tw, c)
    ).astype(np.float32)
    split_seed = 0 if split == "train" else 1
    rng = np.random.default_rng(np.random.SeedSequence([seed, split_seed, 0x1A6E]))
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    ry, rx = -(-h // th), -(-w // tw)  # repeat factors, then crop

    def chunks():
        for start in range(0, n, chunk_size):
            lbl = labels[start : start + chunk_size]
            t = templates[lbl]
            t = np.repeat(np.repeat(t, ry, axis=1), rx, axis=2)[:, :h, :w, :]
            img = t + noise * rng.standard_normal(t.shape, dtype=np.float32)
            yield (
                np.clip(img * 255.0, 0.0, 255.0).astype(np.uint8),
                lbl,
            )

    write_array_dataset(
        root, split, chunks(), n=n, image_shape=image_shape,
        num_classes=num_classes, name="imagenet-synthetic",
        extra_meta=gen_params,
    )
    return load_array_dataset(root, split)


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
