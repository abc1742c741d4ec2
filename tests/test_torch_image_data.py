"""The port's image data path (ddp_practice_tpu_torch/data/datasets.py and
data/loader.py) against the JAX package's, bit for bit:

- `synthetic_image_classification` and `load_dataset`'s fallbacks for
  mnist, cifar10 and synthetic give the reference's uint8 images and
  labels for the same seed and split;
- the IDX (MNIST) and CIFAR-10 readers parse the files the reference's
  readers parse (written here from a seed), to the same arrays;
- `DataLoader` walks the same batches (image, label, weight) for two epochs
  on two shards, wrap-pads the last eval batch with zero weights, and its
  `epoch_plan`, `steps_per_epoch` and `drop_last` agree;
- the imagenet corpus and the native gather (ROADMAP A2, which raised
  before it was ported) match the reference; an unknown dataset raises.
"""

import gzip
import pickle
import struct

import numpy as np
import pytest

from ddp_practice_tpu.data import datasets as jax_datasets
from ddp_practice_tpu.data.loader import DataLoader as JaxDataLoader
from ddp_practice_tpu.data.sharding import ShardSpec as JaxShardSpec
from ddp_practice_tpu_torch.data import datasets
from ddp_practice_tpu_torch.data.loader import DataLoader
from ddp_practice_tpu_torch.data.sharding import ShardSpec


def _same(a, b):
    assert a.images.dtype == b.images.dtype == np.uint8
    assert a.labels.dtype == b.labels.dtype == np.int32
    assert np.array_equal(a.images, b.images)
    assert np.array_equal(a.labels, b.labels)
    assert (a.num_classes, a.name, a.image_shape, len(a)) == (
        b.num_classes, b.name, b.image_shape, len(b))


def test_synthetic_images_are_bit_equal():
    kw = dict(n=37, image_shape=(8, 6, 3), num_classes=5, seed=11,
              split_seed=1, noise=0.4, name="s")
    _same(datasets.synthetic_image_classification(**kw),
          jax_datasets.synthetic_image_classification(**kw))


@pytest.mark.parametrize("name", ["mnist", "cifar10", "synthetic",
                                  "synthetic_v2"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_load_dataset_fallbacks_are_bit_equal(name, split, tmp_path):
    kw = dict(seed=3407, synthetic_size=48)
    _same(datasets.load_dataset(name, str(tmp_path), split, **kw),
          jax_datasets.load_dataset(name, str(tmp_path), split, **kw))


def test_default_sizes_follow_the_reference():
    ds = datasets.load_dataset("synthetic", "/nonexistent", "test", seed=1)
    assert len(ds) == 1024 and ds.image_shape == (28, 28, 1)


def _write_idx(path, array, compress):
    header = struct.pack(">I", 0x0800 | array.ndim) + struct.pack(
        f">{array.ndim}I", *array.shape)
    opener = gzip.open if compress else open
    with opener(path, "wb") as f:
        f.write(header + array.tobytes())


@pytest.mark.parametrize("compress", [False, True])
def test_idx_reader_matches_the_reference(tmp_path, compress):
    rng = np.random.default_rng(0)
    suffix = ".gz" if compress else ""
    for split, (img, lbl) in datasets._MNIST_FILES.items():
        n = 9 if split == "train" else 4
        _write_idx(tmp_path / (img + suffix),
                   rng.integers(0, 256, (n, 28, 28)).astype(np.uint8),
                   compress)
        _write_idx(tmp_path / (lbl + suffix),
                   rng.integers(0, 10, (n,)).astype(np.uint8), compress)
    for split in ("train", "test"):
        got = datasets.load_dataset("mnist", str(tmp_path), split)
        _same(got, jax_datasets.load_dataset("mnist", str(tmp_path), split))
        assert got.name == f"mnist-{split}" and got.image_shape == (28, 28, 1)
    assert datasets.idx_dims(str(tmp_path / (img + suffix))) == (4, 28, 28)


def test_cifar10_reader_matches_the_reference(tmp_path):
    rng = np.random.default_rng(1)
    base = tmp_path / "cifar-10-batches-py"
    base.mkdir()
    for fn in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(base / fn, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (3, 3072)).astype(
                np.uint8), b"labels": rng.integers(0, 10, 3).tolist()}, f)
    for split, n in (("train", 15), ("test", 3)):
        got = datasets.load_dataset("cifar10", str(tmp_path), split)
        _same(got, jax_datasets.load_dataset("cifar10", str(tmp_path),
                                             split))
        assert len(got) == n and got.image_shape == (32, 32, 3)
        assert got.images.flags["C_CONTIGUOUS"]


def _loaders(ds, jds, rank, world, **kw):
    return (DataLoader(ds, shard=ShardSpec(rank, world), **kw),
            JaxDataLoader(jds, shard=JaxShardSpec(rank, world),
                          backend="python", **kw))


@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_batches_are_bit_equal(shuffle):
    kw = dict(n=22, image_shape=(4, 4, 3), num_classes=10, seed=5)
    ds = datasets.synthetic_image_classification(**kw)
    jds = jax_datasets.synthetic_image_classification(**kw)
    padded = 0
    for rank in range(2):
        mine, ref = _loaders(ds, jds, rank, 2, global_batch_size=8, seed=9,
                             shuffle=shuffle)
        assert len(mine) == len(ref) == mine.steps_per_epoch == 3
        for epoch in range(2):
            mine.set_epoch(epoch)
            ref.set_epoch(epoch)
            for a, b in zip(mine.epoch_plan(), ref.epoch_plan()):
                assert a.dtype == b.dtype and np.array_equal(a, b)
            got, want = list(mine), list(ref)
            assert len(got) == len(want) == 3
            for g, w in zip(got, want):
                assert set(g) == set(w) == {"image", "label", "weight"}
                for key in g:
                    assert g[key].dtype == w[key].dtype, key
                    assert np.array_equal(g[key], w[key]), key
                assert g["image"].shape == (4, 4, 4, 3)
            padded += int(sum((g["weight"] == 0).sum() for g in got))
    assert padded == 2 * 2      # 22 samples in 3 x 8: two wrapped, per epoch


def test_loader_drop_last_and_epochs_differ():
    ds = datasets.synthetic_image_classification(
        n=22, image_shape=(4, 4, 1), num_classes=3, seed=2)
    loader = DataLoader(ds, global_batch_size=8, seed=1, drop_last=True)
    assert loader.steps_per_epoch == 2
    first = np.concatenate([b["label"] for b in loader])
    assert all((b["weight"] == 1).all() for b in loader)
    loader.set_epoch(1)
    order0, _ = DataLoader(ds, global_batch_size=8, seed=1).epoch_plan()
    order1, _ = loader.epoch_plan()
    assert not np.array_equal(order0[:2], order1)
    assert len(first) == 16


def test_unported_data_paths_name_their_roadmap_item(tmp_path):
    """ROADMAP A2's data paths, which raised before it was ported: the
    imagenet corpus loads as the reference's does (the synthetic one,
    generated under data_dir), the native gather gives numpy's batches;
    an unknown dataset still raises."""
    kw = dict(seed=2, synthetic_size=5)
    ds = datasets.load_dataset("imagenet", str(tmp_path / "p"), "test", **kw)
    _same(ds, jax_datasets.load_dataset("imagenet", str(tmp_path / "j"),
                                        "test", **kw))
    ds = datasets.synthetic_image_classification(
        n=4, image_shape=(2, 2, 1), num_classes=2, seed=0)
    native = list(DataLoader(ds, global_batch_size=2, backend="native"))
    plain = list(DataLoader(ds, global_batch_size=2, backend="python"))
    for a, b in zip(native, plain):
        assert all(np.array_equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="unknown dataset"):
        datasets.load_dataset("svhn", "/nonexistent", "train")
