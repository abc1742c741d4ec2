"""The port's array-record corpus (ddp_practice_tpu_torch/data/datasets.py:
`write_array_dataset`, `load_array_dataset`, `synthetic_imagenet_corpus`
and `load_dataset("imagenet")`) against the JAX package's, on the CPU:

- for the same arguments the port's synthetic corpus is the reference
  writer's, byte for byte (images, labels and meta.json), at an
  ImageNet-shaped 224x224x3 and at a small odd shape;
- a corpus written by either package loads in the other, memory-mapped;
- a torn write is refused: too few or too many samples, a mis-shaped
  chunk or a wrong dtype raise and leave no readable split and no tmp
  file behind; a split whose meta entry is gone (a crash between the two
  file replaces) is not complete; stale tmp files are swept and live ones
  kept;
- the cached corpus is reused only when every generation parameter
  matches (seed, noise, class count, size, shape);
- `load_dataset("imagenet")` generates the synthetic corpus under
  `data_dir`, reads a real corpus (with `val` for the test split), and
  refuses a real corpus that lacks the split;
- the Trainer runs ResNet-50 at 32x32 on such a corpus through the
  native loader with `--augment_kind rrc`.
"""

import json
import os
import time

import numpy as np
import pytest

import _torch_port  # noqa: F401  (one intra-op thread for the suite)
from ddp_practice_tpu.data import datasets as jax_datasets
from ddp_practice_tpu_torch.config import TrainConfig
from ddp_practice_tpu_torch.data import datasets
from ddp_practice_tpu_torch.train.loop import Trainer

FILES = ("train-images.npy", "train-labels.npy", "meta.json")


def _bytes(root, name):
    with open(os.path.join(root, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("n,shape,classes", [
    (20, (224, 224, 3), 1000), (37, (17, 33, 1), 7)])
def test_synthetic_corpus_is_the_reference_writers_bytes(tmp_path, n, shape,
                                                         classes):
    kw = dict(n=n, image_shape=shape, num_classes=classes, seed=11,
              chunk_size=8)
    mine, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    ds = datasets.synthetic_imagenet_corpus(mine, "train", **kw)
    jax_datasets.synthetic_imagenet_corpus(ref, "train", **kw)
    for name in FILES:
        assert _bytes(mine, name) == _bytes(ref, name), name
    assert isinstance(ds.images, np.memmap) and ds.images.dtype == np.uint8
    assert ds.images.shape == (n, *shape) and ds.num_classes == classes
    assert ds.name == "imagenet-synthetic-train"


def test_a_corpus_loads_across_packages(tmp_path):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (10, 5, 6, 3)).astype(np.uint8)
    lbls = rng.integers(0, 4, 10).astype(np.int32)
    chunks = [(imgs[:4], lbls[:4]), (imgs[4:], lbls[4:])]
    for writer, reader in ((datasets, jax_datasets),
                           (jax_datasets, datasets)):
        root = str(tmp_path / writer.__name__)
        writer.write_array_dataset(root, "train", chunks, n=10,
                                   image_shape=(5, 6, 3), num_classes=4,
                                   name="mine")
        ds = reader.load_array_dataset(root, "train")
        assert isinstance(ds.images, np.memmap)
        assert np.array_equal(np.asarray(ds.images), imgs)
        assert np.array_equal(ds.labels, lbls) and ds.labels.dtype == np.int32
        assert (ds.num_classes, ds.name) == (4, "mine-train")
        assert reader._array_dataset_exists(root, "train")
        assert not reader._array_dataset_exists(root, "test")
    a, b = (str(tmp_path / m.__name__) for m in (datasets, jax_datasets))
    for name in FILES:
        assert _bytes(a, name) == _bytes(b, name), name


@pytest.mark.parametrize("chunks,match", [
    ([(np.zeros((3, 2, 2, 1), np.uint8), np.zeros(3))], "provided 3"),
    ([(np.zeros((5, 2, 2, 1), np.uint8), np.zeros(5))], "exceed"),
    ([(np.zeros((4, 2, 3, 1), np.uint8), np.zeros(4))], "image shape"),
    ([(np.zeros((4, 2, 2, 1), np.float32), np.zeros(4))], "dtype"),
    ([(np.zeros((4, 2, 2, 1), np.uint8), np.zeros(3))], "labels shape"),
])
def test_a_torn_write_is_refused_and_leaves_nothing(tmp_path, chunks, match):
    root = str(tmp_path)
    with pytest.raises(ValueError, match=match):
        datasets.write_array_dataset(root, "train", chunks, n=4,
                                     image_shape=(2, 2, 1), num_classes=2)
    assert not datasets._array_dataset_exists(root, "train")
    assert not [f for f in os.listdir(root) if ".tmp." in f]


def test_a_split_without_its_meta_entry_is_incomplete(tmp_path):
    root = str(tmp_path)
    chunk = [(np.ones((2, 2, 2, 1), np.uint8), np.ones(2))]
    for split in ("train", "test"):
        datasets.write_array_dataset(root, split, chunk, n=2,
                                     image_shape=(2, 2, 1), num_classes=2)
    # the writer's state between its two file replaces: entry dropped
    datasets._update_meta(root, "t", 2, "array", "train", None)
    assert not datasets._array_dataset_exists(root, "train")
    assert datasets._array_dataset_exists(root, "test")
    with open(os.path.join(root, "meta.json"), "w") as f:
        f.write("{torn")
    assert not datasets._array_dataset_exists(root, "test")


def test_stale_tmps_are_swept_and_live_ones_kept(tmp_path):
    root = str(tmp_path)
    stale = tmp_path / ".train-images.npy.tmp.1.dead"
    live = tmp_path / ".test-images.npy.tmp.2.live"
    stale.write_bytes(b"x")
    live.write_bytes(b"x")
    old = time.time() - 2 * datasets._STALE_TMP_AGE_S
    os.utime(stale, (old, old))
    datasets._sweep_stale_tmps(root)
    assert not stale.exists() and live.exists()


def test_the_cache_is_reused_only_when_every_parameter_matches(tmp_path):
    root = str(tmp_path / "c")
    kw = dict(n=12, image_shape=(8, 8, 3), num_classes=5, seed=1,
              noise=0.35)
    first = datasets.synthetic_imagenet_corpus(root, "train", **kw)
    path = os.path.join(root, "train-images.npy")
    inode = os.stat(path).st_ino
    again = datasets.synthetic_imagenet_corpus(root, "train", **kw)
    assert os.stat(path).st_ino == inode            # read, not rewritten
    assert np.array_equal(np.asarray(first.images), np.asarray(again.images))
    for change in (dict(seed=2), dict(noise=0.1), dict(num_classes=6),
                   dict(n=13), dict(image_shape=(8, 9, 3))):
        other = datasets.synthetic_imagenet_corpus(root, "train",
                                                   **{**kw, **change})
        assert os.stat(path).st_ino != inode, change   # regenerated
        inode = os.stat(path).st_ino
        meta = json.loads(_bytes(root, "meta.json"))
        assert meta["splits"]["train"]["gen"]["seed"] == \
            {**kw, **change}["seed"]
        assert len(other) == {**kw, **change}["n"]


def test_load_dataset_imagenet_branches(tmp_path):
    ds = datasets.load_dataset("imagenet", str(tmp_path), "train", seed=3,
                               synthetic_size=6)
    assert ds.images.shape == (6, 224, 224, 3) and ds.num_classes == 1000
    assert os.path.isdir(tmp_path / "imagenet-synthetic-6-s3")
    real = tmp_path / "real" / "imagenet-arrays"
    chunk = [(np.full((3, 4, 4, 3), 7, np.uint8), np.arange(3))]
    datasets.write_array_dataset(str(real), "train", chunk, n=3,
                                 image_shape=(4, 4, 3), num_classes=3,
                                 name="imagenet")
    base = str(tmp_path / "real")
    assert len(datasets.load_dataset("imagenet", base, "train")) == 3
    with pytest.raises(FileNotFoundError, match="no complete test or val"):
        datasets.load_dataset("imagenet", base, "test")
    datasets.write_array_dataset(str(real), "val", chunk, n=3,
                                 image_shape=(4, 4, 3), num_classes=3,
                                 name="imagenet")
    val = datasets.load_dataset("imagenet", base, "test")
    assert val.name == "imagenet-val" and val.images[0, 0, 0, 0] == 7


def test_trainer_runs_resnet50_on_the_corpus_with_the_native_loader(
        tmp_path, monkeypatch):
    """ResNet-50 at 32x32 (num_filters cut through the registry is not a
    CLI flag, so the corpus is small instead): two rrc-augmented steps and
    the eval pass through the native gather."""
    root = str(tmp_path / "imagenet-arrays")
    rng = np.random.default_rng(1)
    for split, n in (("train", 8), ("test", 4)):
        imgs = rng.integers(0, 256, (n, 32, 32, 3)).astype(np.uint8)
        datasets.write_array_dataset(
            root, split, [(imgs, rng.integers(0, 12, n))], n=n,
            image_shape=(32, 32, 3), num_classes=12, name="imagenet")
    trainer = Trainer(TrainConfig(
        model="resnet50", dataset="imagenet", data_dir=str(tmp_path),
        device="cpu", batch_size=4, epochs=1, augment=True,
        augment_kind="rrc", loader_backend="native", log_every_steps=0))
    assert isinstance(trainer.train_ds.images, np.memmap)
    assert type(trainer.train_loader._gather).__name__ == "NativeGather"
    assert trainer.model.head.out_features == 12     # the corpus's classes
    summary = trainer.fit()
    assert summary["steps"] == 2 and np.isfinite(summary["accuracy"])
