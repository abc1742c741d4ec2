"""The port's native batch gather (ddp_practice_tpu_torch/data/
native_loader.py over csrc/dataloader.cpp, and data/loader.py's backend
choice) on the CPU:

- native batches equal numpy's bit for bit: fp32 arrays in RAM and a
  uint8 memmapped corpus, batches small (one thread) and large (several),
  repeated indices, negative indices wrapping as numpy's do; an index out
  of range raises IndexError, as numpy's fancy indexing does;
- the DataLoader's epochs are the same bytes under "native", "python"
  and "auto", and equal the JAX package's loader;
- "native" raises when the library cannot be built (no compiler), "auto"
  then falls back to numpy and "python" never builds; an unknown backend
  raises;
- the library is built from the port's own source into
  build/ddp_practice_tpu_torch/, named by its source's hash, and exports
  the reference's ABI v3; the CUDA build does not list it.
"""

import pathlib

import numpy as np
import pytest

import _torch_port  # noqa: F401  (one intra-op thread for the suite)
from ddp_practice_tpu.data.loader import DataLoader as JaxDataLoader
from ddp_practice_tpu_torch.data import datasets, native_loader
from ddp_practice_tpu_torch.data.loader import DataLoader
from ddp_practice_tpu_torch.ops import cuda_build

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _fp32(n=300):
    rng = np.random.default_rng(0)
    return datasets.Dataset(
        images=rng.random((n, 6, 5, 3), dtype=np.float32),
        labels=rng.integers(0, 10, n).astype(np.int32), num_classes=10)


def _memmap(tmp_path, n=300):
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (n, 8, 8, 3)).astype(np.uint8)
    datasets.write_array_dataset(str(tmp_path), "train",
                                 [(imgs, rng.integers(0, 5, n))], n=n,
                                 image_shape=(8, 8, 3), num_classes=5)
    ds = datasets.load_array_dataset(str(tmp_path), "train")
    assert isinstance(ds.images, np.memmap)
    return ds


INDEX_SETS = {
    "small": np.array([3, 0, 299, 3]),
    "negative": np.array([-1, -300, 5, -17]),
    "large": np.random.default_rng(2).integers(-300, 300, 257),
}


@pytest.mark.parametrize("store", ["fp32", "uint8 memmap"])
@pytest.mark.parametrize("which", sorted(INDEX_SETS))
def test_native_batches_equal_numpys(tmp_path, store, which):
    ds = _fp32() if store == "fp32" else _memmap(tmp_path)
    gather = native_loader.make_gather(ds)
    assert gather is not None
    idx = INDEX_SETS[which]
    images, labels = gather(idx)
    want_images, want_labels = ds.images[idx], ds.labels[idx]
    assert images.dtype == ds.images.dtype and labels.dtype == np.int32
    assert np.array_equal(images, want_images)
    assert np.array_equal(labels, want_labels)
    for bad in ([300], [0, -301]):
        with pytest.raises(IndexError):
            ds.images[np.array(bad)]
        with pytest.raises(IndexError, match="out of range"):
            gather(np.array(bad))


def test_loader_epochs_are_the_same_bytes_under_every_backend():
    ds = _fp32(45)
    epochs = {}
    for backend in ("native", "python", "auto"):
        loader = DataLoader(ds, global_batch_size=8, seed=4, backend=backend)
        loader.set_epoch(2)
        epochs[backend] = list(loader)
    ref = JaxDataLoader(ds, global_batch_size=8, seed=4, backend="python")
    ref.set_epoch(2)
    epochs["jax package"] = list(ref)
    want = epochs.pop("python")
    for backend, got in epochs.items():
        assert len(got) == len(want) == 6, backend
        for a, b in zip(got, want):
            for key in ("image", "label", "weight"):
                assert np.array_equal(np.asarray(a[key]),
                                      np.asarray(b[key])), (backend, key)


def test_native_raises_without_a_compiler_and_auto_falls_back(monkeypatch):
    monkeypatch.setenv("CXX", "no-such-compiler++")
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_error", None)
    assert not native_loader.library_path().exists()
    ds = _fp32(20)
    with pytest.raises(RuntimeError, match="native loader unavailable.*"
                                           "no-such-compiler"):
        DataLoader(ds, global_batch_size=4, backend="native")
    assert not native_loader.available()
    assert native_loader.make_gather(ds) is None
    for backend in ("auto", "python"):
        loader = DataLoader(ds, global_batch_size=4, backend=backend)
        batch = next(iter(loader))
        assert np.array_equal(batch["image"],
                              ds.images[loader.epoch_plan()[0][0]])
    with pytest.raises(ValueError, match="unknown loader backend"):
        DataLoader(ds, global_batch_size=4, backend="rust")


def test_library_builds_from_the_ports_source_under_build():
    path = native_loader.library_path()
    assert path.parent == ROOT / "build" / "ddp_practice_tpu_torch"
    assert native_loader.SOURCE == (
        ROOT / "ddp_practice_tpu_torch" / "csrc" / "dataloader.cpp")
    lib = native_loader.require()
    assert path.exists() and lib.dl_version() == native_loader.ABI_VERSION
    assert "-march=native" not in native_loader.CXX_FLAGS
    assert "dataloader" not in cuda_build.SOURCES
    # the reference's C interface, function for function
    source = native_loader.SOURCE.read_text()
    reference = (ROOT / "native" / "dataloader.cpp").read_text()
    body = source[source.index("#include <atomic>"):]
    assert body == reference[reference.index("#include <atomic>"):]
