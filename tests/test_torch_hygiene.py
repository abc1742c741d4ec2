"""Hygiene of the PyTorch port: it stands on its own.

- No file of ddp_practice_tpu_torch/ or chip_smoke.py names the JAX
  modules (`jax`, `flax`) or imports from the JAX package
  (`ddp_practice_tpu.`, with the dot).
- The whole package and chip_smoke import in a fresh interpreter where
  jax, flax and the JAX package cannot be imported.
- The decode-attention CUDA source exists and its builder targets sm_90a.
- Entry points asked for the card raise without one; chip_smoke exits
  non-zero with no result line, both without a card and when it stands
  alone outside the repository.
"""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "ddp_practice_tpu_torch"
FORBIDDEN = re.compile(r"\bjax\b|\bflax\b|ddp_practice_tpu\.")


def _port_files():
    files = sorted(p for p in PORT.rglob("*")
                   if p.is_file() and p.suffix in (".py", ".cu", ".cuh"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_never_names_jax_or_the_jax_package():
    offenders = []
    for path in _port_files():
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if FORBIDDEN.search(line):
                offenders.append(f"{path.relative_to(ROOT)}:{n}: {line}")
    assert not offenders, "\n".join(offenders)


def _blocked_python(code: str, cwd=ROOT):
    prelude = (
        "import sys\n"
        "for name in ('jax', 'flax', 'ddp_practice_tpu'):\n"
        "    sys.modules[name] = None\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", prelude + code], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_package_imports_with_jax_blocked():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PORT.rglob("*.py")
    )
    code = "".join(f"import {m}\n" for m in mods if not m.endswith(
        "__init__")) + "import chip_smoke\nprint('imported', len(sys.modules))"
    res = _blocked_python(code)
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout


def test_kernel_source_and_sm90a_build():
    from ddp_practice_tpu_torch.ops import cuda_build

    assert (PORT / "csrc" / "decode_attention.cu").is_file()
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    lib = cuda_build.library_path("decode_attention")
    assert lib.parent == ROOT / "build" / "ddp_practice_tpu_torch"


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path is not reachable")
    from ddp_practice_tpu_torch.config import resolve_device
    from ddp_practice_tpu_torch.models import create_model
    from ddp_practice_tpu_torch.serve.bench import serve_bench

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("lm_tiny", vocab_size=16, hidden_dim=64, depth=1,
                     num_heads=1, mlp_dim=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_bench(n_requests=1)


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke would run for real")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout
