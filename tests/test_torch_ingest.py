"""The port's dataset ingest (ddp_practice_tpu_torch/data/ingest.py) on the
committed real-format fixtures (tests/data/mini_mnist: gzip IDX files;
tests/data/mini_cifar: CIFAR-10 pickle batches), beside the JAX package's
ingest on the same sources:

- `--src` finds the IDX files under a torchvision `MNIST/raw` tree (and
  flat, gz or raw), places them where data/datasets.py looks, and the
  written `--data_dir` loads bit-equal to the fixture, as the reference's
  ingest's output does;
- verification: a canonical name with other bytes fails its MD5; an
  uncompressed IDX source gets the item count only and is still reported
  "(verified)", as in the reference (data/ingest.py:138); a CIFAR tree is
  checked structurally, and a bad batch fails; the CIFAR tar.gz extracts;
- `--no-verify` places the self-made fixtures;
- `--fetch` degrades to the `--src` ingest when every download fails:
  `urllib.request.urlopen` is replaced by a stub that records the URL
  and raises, so nothing leaves the machine.
"""

import gzip
import os
import shutil
import tarfile
import urllib.request

import numpy as np
import pytest

from ddp_practice_tpu.data import ingest as jax_ingest
from ddp_practice_tpu_torch.data import datasets, ingest

FIXTURES = os.path.join(os.path.dirname(__file__), "data")
MINI_MNIST = os.path.join(FIXTURES, "mini_mnist")
MINI_CIFAR = os.path.join(FIXTURES, "mini_cifar")


def _same(a, b):
    assert a.name == b.name
    assert a.images.dtype == b.images.dtype == np.uint8
    assert np.array_equal(a.images, b.images)
    assert np.array_equal(a.labels, b.labels)


@pytest.fixture
def no_network(monkeypatch):
    """Every download attempt raises at once; the URLs are recorded."""
    tried = []

    def refuse(url, *a, **k):
        tried.append(url)
        raise OSError("no network in this test")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    return tried


@pytest.mark.parametrize("layout", ["MNIST/raw", ""])
def test_mnist_src_places_files_that_load_bit_equal(layout, tmp_path,
                                                    capsys):
    src = tmp_path / "torch_data" / layout
    src.parent.mkdir(parents=True, exist_ok=True)
    shutil.copytree(MINI_MNIST, src, dirs_exist_ok=True)
    out, jax_out = tmp_path / "data", tmp_path / "jax_data"
    assert ingest.ingest_mnist(str(tmp_path / "torch_data"), str(out),
                               verify=False) == 0
    assert "(UNVERIFIED)" in capsys.readouterr().out
    assert jax_ingest.ingest_mnist(str(tmp_path / "torch_data"),
                                   str(jax_out), verify=False) == 0
    assert sorted(os.listdir(out)) == sorted(os.listdir(jax_out))
    for split in ("train", "test"):
        got = datasets.load_dataset("mnist", str(out), split)
        _same(got, datasets.load_mnist(MINI_MNIST, split))
        assert got.name == f"mnist-{split}"       # the real loader, not
        assert len(got) == (256 if split == "train" else 64)  # synthetic
    # a second run finds the placed copies
    assert ingest.ingest_mnist(None, str(out), verify=False) == 0
    assert "already present" in capsys.readouterr().out


def test_mnist_verify_rejects_a_wrong_checksum(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    shutil.copy(os.path.join(MINI_MNIST, "train-images-idx3-ubyte.gz"), src)
    with pytest.raises(SystemExit, match="checksum mismatch"):
        ingest.ingest_mnist(str(src), str(tmp_path / "out"), verify=True)
    assert not (tmp_path / "out" / "train-images-idx3-ubyte.gz").exists()


def test_uncompressed_idx_is_verified_by_its_count_only(tmp_path, capsys):
    """The reference's behaviour, kept: an uncompressed IDX file has no
    published MD5, so the item count is all that is checked, and the
    file is still reported "(verified)". A wrong count raises."""
    src = tmp_path / "src"
    src.mkdir()
    labels = np.arange(60000, dtype=np.uint8) % 10
    raw = src / "train-labels-idx1-ubyte"
    raw.write_bytes(b"\x00\x00\x08\x01" + (60000).to_bytes(4, "big")
                    + labels.tobytes())
    out = tmp_path / "out"
    assert ingest.ingest_mnist(str(src), str(out), verify=True) == 1
    text = capsys.readouterr().out
    assert f"placed {out / 'train-labels-idx1-ubyte'} (verified)" in text
    assert "MISSING train-images-idx3-ubyte.gz" in text
    with gzip.open(os.path.join(MINI_MNIST, "t10k-labels-idx1-ubyte.gz")) as f:
        (src / "t10k-labels-idx1-ubyte").write_bytes(f.read())
    with pytest.raises(SystemExit, match="64 items, expected 10000"):
        ingest.ingest_mnist(str(src), str(tmp_path / "out2"), verify=True)


def test_cifar_tree_is_checked_and_loads_bit_equal(tmp_path, capsys):
    import pickle

    out = tmp_path / "data"
    assert ingest.ingest_cifar10(MINI_CIFAR, str(out), verify=True) == 0
    assert "(structurally verified)" in capsys.readouterr().out
    for split in ("train", "test"):
        _same(datasets.load_dataset("cifar10", str(out), split),
              datasets.load_dataset("cifar10", MINI_CIFAR, split))
    bad = tmp_path / "bad" / "cifar-10-batches-py"
    shutil.copytree(os.path.join(MINI_CIFAR, "cifar-10-batches-py"), bad)
    with open(bad / "data_batch_3", "wb") as f:
        pickle.dump({b"data": np.zeros((5, 7), np.uint8),
                     b"labels": [0] * 5}, f)
    with pytest.raises(SystemExit, match="not a CIFAR batch"):
        ingest.ingest_cifar10(str(bad.parent), str(tmp_path / "o2"),
                              verify=True)
    # --no-verify places it anyway (self-made fixtures only)
    assert ingest.ingest_cifar10(str(bad.parent), str(tmp_path / "o3"),
                                 verify=False) == 0


def test_cifar_archive_extracts(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    with tarfile.open(src / "cifar-10-python.tar.gz", "w:gz") as t:
        t.add(os.path.join(MINI_CIFAR, "cifar-10-batches-py"),
              arcname="cifar-10-batches-py")
    with pytest.raises(SystemExit, match="checksum mismatch"):
        ingest.ingest_cifar10(str(src), str(tmp_path / "out"), verify=True)
    out = tmp_path / "out2"
    assert ingest.ingest_cifar10(str(src), str(out), verify=False) == 0
    _same(datasets.load_dataset("cifar10", str(out), "test"),
          datasets.load_dataset("cifar10", MINI_CIFAR, "test"))


def test_fetch_degrades_to_src_without_network(no_network, tmp_path,
                                               capsys):
    """--fetch downloads only what --src lacks; with no network each
    such file fails its mirrors, is reported missing, and what --src
    had is placed all the same."""
    out = tmp_path / "data"
    argv = ["--dataset", "mnist", "--fetch", "--src", MINI_MNIST,
            "--out", str(out), "--no-verify"]
    assert ingest.main(argv) == 0 and no_network == []
    _same(datasets.load_dataset("mnist", str(out), "test"),
          datasets.load_mnist(MINI_MNIST, "test"))
    src = tmp_path / "half"
    src.mkdir()
    for name in ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz"):
        shutil.copy(os.path.join(MINI_MNIST, name), src)
    capsys.readouterr()
    out2 = tmp_path / "data2"
    assert ingest.main(["--dataset", "mnist", "--fetch", "--src", str(src),
                        "--out", str(out2), "--no-verify"]) == 1
    text = capsys.readouterr().out
    assert text.count("fetch failed") == len(no_network) == 4  # 2 x 2
    assert all("train-" in u and u.endswith("-ubyte.gz") for u in no_network)
    assert text.count("MISSING") == 2
    assert sorted(os.listdir(out2)) == sorted(os.listdir(src))
    _same(datasets.load_dataset("mnist", str(out2), "test"),
          datasets.load_mnist(MINI_MNIST, "test"))
    no_network.clear()
    assert ingest.main(["--dataset", "cifar10", "--fetch", "--out",
                        str(tmp_path / "c")]) == 1
    assert len(no_network) == 1 and "MISSING" in capsys.readouterr().out
