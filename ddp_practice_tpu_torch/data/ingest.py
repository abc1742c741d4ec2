"""Dataset provisioning: fetch-or-verify real MNIST/CIFAR into --data_dir
(a copy of ddp_practice_tpu/data/ingest.py: the port imports nothing of
the JAX package; the IDX header reader is data/datasets.py's own copy).

The DDP script this system reproduces gets its data through torchvision's
`download=True`. This is that contract's counterpart: one command that
(optionally) downloads the canonical archives, verifies them against the
published MD5 checksums, and lays them out exactly where
`data/datasets.py`'s loaders look; after that the default training run
(`python -m ddp_practice_tpu_torch.cli --data_dir DATA`) trains the
ConvNet on real pixels.

    python -m ddp_practice_tpu_torch.data.ingest --dataset mnist \
        --src ~/torch_data --out ./data          # ingest existing files
    python -m ddp_practice_tpu_torch.data.ingest --dataset mnist \
        --fetch --out ./data                     # download, then verify
    python -m ddp_practice_tpu_torch.data.ingest --dataset cifar10 \
        --src ~/torch_data --out ./data

--src accepts every common layout: the four IDX files flat or under
MNIST/raw/ (the torchvision tree), raw or .gz; CIFAR as the
cifar-10-batches-py directory or the cifar-10-python.tar.gz archive.
Nothing lands in --out before passing verification (downloads go to a
.part file; a bad mirror or truncated archive is removed and the next
mirror tried: a corrupt file must never be discoverable by the
loaders); pass --no-verify only for self-made fixtures like
tests/data/mini_mnist. Without network, --fetch degrades to the --src
ingest: each failed download is reported and the file is looked for
under --src.

What "verified" means, as in the reference (kept as is, not fixed): a
`.gz` MNIST source is checked against its MD5 and its item count, but an
uncompressed IDX source (torchvision's extracted twin) has no published
MD5, so it gets the item count only, and is still reported "(verified)".
A CIFAR batches directory gets a structural check (every batch unpickles
to 3072-byte rows with as many labels), reported "(structurally
verified)".
"""

from __future__ import annotations

import argparse
import hashlib
import os
import pickle
import shutil
import sys
import tarfile
from typing import Optional

from ddp_practice_tpu_torch.data.datasets import idx_dims

# canonical archives: (filename -> md5, n_items): the MD5s published
# with the original distributions (yann.lecun.com/exdb/mnist mirrors;
# cs.toronto.edu/~kriz/cifar.html)
_MNIST_GZ = {
    "train-images-idx3-ubyte.gz": ("f68b3c2dcbeaaa9fbdd348bbdeb94873", 60000),
    "train-labels-idx1-ubyte.gz": ("d53e105ee54ea40749a09fcbcd1e9432", 60000),
    "t10k-images-idx3-ubyte.gz": ("9fb629c4189551a2d022fa330f9573f3", 10000),
    "t10k-labels-idx1-ubyte.gz": ("ec29112dd5afa0611ce80d1b7f02629c", 10000),
}
_MNIST_URLS = [
    "https://ossci-datasets.s3.amazonaws.com/mnist/",  # torchvision mirror
    "http://yann.lecun.com/exdb/mnist/",
]
_CIFAR_TGZ = ("cifar-10-python.tar.gz", "c58f30108f718f92721af3b95e74349a")
_CIFAR_URL = "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz"


def _md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _find_source(src: str, name: str) -> Optional[str]:
    """Locate `name` under every layout the torchvision ecosystem
    produces. IDX files may also exist as their uncompressed twin
    (torchvision extracts them); archives like the CIFAR tar.gz are
    matched by their exact name only."""
    stems = [name]
    if name.endswith(".gz") and "ubyte" in name:
        stems.append(name[:-3])
    for stem in stems:
        for sub in ("", "MNIST/raw", "raw"):
            p = os.path.join(src, sub, stem)
            if os.path.exists(p):
                return p
    return None


def _fetch_verified(urls, dest: str, md5: Optional[str]) -> bool:
    """Download to dest via a .part file, verifying BEFORE the move —
    a corrupt mirror response (or an HTML error served as 200) is
    deleted and the next mirror tried, and nothing unverified ever
    sits at a loader-discoverable path."""
    import urllib.request

    part = dest + ".part"
    for url in urls:
        try:
            print(f"[ingest] fetching {url}")
            with urllib.request.urlopen(url, timeout=60) as r, open(
                part, "wb"
            ) as f:
                shutil.copyfileobj(r, f)
        except Exception as e:  # noqa: BLE001: any failure: next mirror
            print(f"[ingest] fetch failed ({e})")
            if os.path.exists(part):
                os.remove(part)
            continue
        if md5 is not None:
            got = _md5(part)
            if got != md5:
                print(f"[ingest] {url}: checksum mismatch ({got}), "
                      "discarding and trying the next mirror")
                os.remove(part)
                continue
        os.replace(part, dest)
        return True
    return False


def ingest_mnist(src: Optional[str], out: str, *, verify: bool = True,
                 fetch: bool = False) -> int:
    os.makedirs(out, exist_ok=True)
    placed = 0
    for name, (md5, count) in _MNIST_GZ.items():
        dest = os.path.join(out, name)
        # an already-ingested verified copy short-circuits the fetch
        if os.path.exists(dest) and (not verify or _md5(dest) == md5):
            print(f"[ingest] {dest} already present"
                  + (" (verified)" if verify else ""))
            placed += 1
            continue
        found = _find_source(src, name) if src else None
        if found is None and fetch:
            if _fetch_verified(
                [base + name for base in _MNIST_URLS], dest,
                md5 if verify else None,
            ):
                found = dest
        if found is None:
            print(f"[ingest] MISSING {name} (searched "
                  f"{src or '(no --src)'}; fetch={'on' if fetch else 'off'})")
            continue
        if verify:
            if found != dest and found.endswith(".gz"):
                got = _md5(found)
                if got != md5:
                    raise SystemExit(
                        f"[ingest] checksum mismatch for {found}: got {got}, "
                        f"want {md5}: refusing to place a corrupt/unknown "
                        "file (use --no-verify only for self-made fixtures)"
                    )
            n = idx_dims(found)[0]
            if n != count:
                raise SystemExit(
                    f"[ingest] {found}: {n} items, expected {count}"
                )
        final = os.path.join(out, os.path.basename(found))
        if os.path.abspath(found) != os.path.abspath(final):
            shutil.copyfile(found, final)
        print(f"[ingest] placed {final}"
              + (" (verified)" if verify else " (UNVERIFIED)"))
        placed += 1
    if placed == 4:
        print(f"[ingest] MNIST ready in {out}: run "
              f"python -m ddp_practice_tpu_torch.cli --data_dir {out}")
        return 0
    return 1


def _check_cifar_tree(base: str) -> None:
    """Structural verification of an extracted cifar-10-batches-py tree:
    every batch unpickles to (N, 3072) rows with N matching labels. (The
    per-file MD5s aren't published for the extracted form; structure is
    what we can honestly check: and what keeps miniature fixtures
    ingestable.)"""
    import numpy as np

    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for fn in names:
        p = os.path.join(base, fn)
        if not os.path.exists(p):
            raise SystemExit(f"[ingest] {base}: missing {fn}")
        with open(p, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        data = np.asarray(d[b"data"])
        if data.ndim != 2 or data.shape[1] != 3072 or len(d[b"labels"]) != (
            data.shape[0]
        ):
            raise SystemExit(
                f"[ingest] {p}: not a CIFAR batch "
                f"(shape {data.shape}, {len(d[b'labels'])} labels)"
            )


def ingest_cifar10(src: Optional[str], out: str, *, verify: bool = True,
                   fetch: bool = False) -> int:
    os.makedirs(out, exist_ok=True)
    batches = os.path.join(out, "cifar-10-batches-py")
    # already-extracted tree offered directly
    if src:
        tree = (
            src if os.path.basename(src) == "cifar-10-batches-py"
            else os.path.join(src, "cifar-10-batches-py")
        )
        if os.path.isdir(tree):
            if verify:
                _check_cifar_tree(tree)
            if os.path.abspath(tree) != os.path.abspath(batches):
                shutil.copytree(tree, batches, dirs_exist_ok=True)
            print(f"[ingest] placed {batches}"
                  + (" (structurally verified)" if verify
                     else " (UNVERIFIED)"))
            return 0
    name, md5 = _CIFAR_TGZ
    archive = _find_source(src, name) if src else None
    if archive is None and fetch:
        dest = os.path.join(out, name)
        if _fetch_verified([_CIFAR_URL], dest, md5 if verify else None):
            archive = dest
    if archive is None:
        print(f"[ingest] MISSING {name} (searched {src or '(no --src)'}; "
              f"fetch={'on' if fetch else 'off'})")
        return 1
    if verify and archive != os.path.join(out, name):
        got = _md5(archive)
        if got != md5:
            raise SystemExit(
                f"[ingest] checksum mismatch for {archive}: got {got}, "
                f"want {md5}"
            )
    with tarfile.open(archive, "r:gz") as t:
        t.extractall(out, filter="data")
    print(f"[ingest] extracted {batches}"
          + (" (verified)" if verify else " (UNVERIFIED)"))
    print(f"[ingest] CIFAR-10 ready: run python -m ddp_practice_tpu_torch.cli "
          f"--model vit_tiny --dataset cifar10 --data_dir {out} "
          f"--optimizer adamw --lr 1e-3 --precision bf16")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser("ddp_practice_tpu_torch.data.ingest")
    p.add_argument("--dataset", required=True, choices=["mnist", "cifar10"])
    p.add_argument("--out", default="./data",
                   help="target --data_dir for training runs")
    p.add_argument("--src", default=None,
                   help="directory holding already-downloaded files "
                        "(torchvision MNIST/raw trees, IDX files, CIFAR "
                        "tar.gz or batches directory)")
    p.add_argument("--fetch", action="store_true",
                   help="attempt to download the canonical archives first "
                        "(the reference's download=True; degrades to "
                        "--src ingestion without network egress)")
    p.add_argument("--no-verify", dest="verify", action="store_false",
                   help="skip checksum/count verification (self-made "
                        "fixtures only)")
    a = p.parse_args(argv)
    fn = ingest_mnist if a.dataset == "mnist" else ingest_cifar10
    return fn(a.src, a.out, verify=a.verify, fetch=a.fetch)


if __name__ == "__main__":
    sys.exit(main())
