"""Hygiene of the PyTorch port: it stands on its own.

- No file of ddp_practice_tpu_torch/ (Python, CUDA and the host C++ of
  the native loader) or chip_smoke.py names the JAX modules (`jax`,
  `flax`, `optax`) or imports from the JAX package (`ddp_practice_tpu.`,
  with the dot).
- The whole package and chip_smoke import in a fresh interpreter where
  jax, flax, optax and the JAX package cannot be imported.
- The CUDA sources exist, hold their kernels' C entries (A-D in
  decode_attention.cu, E-G and E's variants in flash_attention.cu, H and I in
  fused_encoder.cu, J and K in grouped_matmul.cu) and name sm_90a, and
  ops/cuda_build.py compiles them for sm_90a; the fused and grouped-matmul
  sources call no library product, and their wrappers' launch paths hold
  no PyTorch product.
- The host-pure modules copied from the JAX package (the paged pool's
  allocator and radix cache, the drafter) import only typing, torch and
  the port; the training slice's data, train, parallel and utils modules
  (and config, cli, losses, flash attention and the flash experiments,
  the ConvNet and its BatchNorm, checkpoint, data/ingest, generate and
  serve/bench, the ResNets, augmentation, the native loader's binding and
  the converter, and the serving plane: health, faults, metrics, SLO,
  fair share, affinity, the router, the trace recorder, logging, the
  POST helper; the front door, admission, SSE, workloads, RPC, the worker
  and its telemetry endpoints, the supervisor) only the standard
  library, numpy, torch and the port. A worker process started the way
  the supervisor starts it serves a request with jax blocked.
- Entry points asked for the card raise without one; chip_smoke exits
  non-zero with no result line, both without a card and when it stands
  alone outside the repository.
"""

import ast
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "ddp_practice_tpu_torch"
FORBIDDEN = re.compile(r"\bjax\b|\bflax\b|\boptax\b|ddp_practice_tpu\.")


def _port_files():
    files = sorted(p for p in PORT.rglob("*") if p.is_file()
                   and p.suffix in (".py", ".cu", ".cuh", ".cpp"))
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
        "for name in ('jax', 'flax', 'optax', 'ddp_practice_tpu'):\n"
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

    source = (PORT / "csrc" / "decode_attention.cu").read_text()
    assert "sm_90a" in source
    for entry in ("decode_attention", "decode_attention_int8",
                  "paged_decode_attention", "paged_decode_attention_int8"):
        assert re.search(rf"^int {entry}\(", source, re.M), entry
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    lib = cuda_build.library_path("decode_attention")
    assert lib.parent == ROOT / "build" / "ddp_practice_tpu_torch"


def test_flash_kernel_source_and_sm90a_build():
    from ddp_practice_tpu_torch.ops import cuda_build

    source = (PORT / "csrc" / "flash_attention.cu").read_text()
    assert "sm_90a" in source
    for entry in ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkdv"):
        assert re.search(rf"^(extern \"C\" )?int {entry}\(", source,
                         re.M), entry
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    lib = cuda_build.library_path("flash_attention")
    assert lib.parent == ROOT / "build" / "ddp_practice_tpu_torch"


def test_flash_kernels_cover_their_rows():
    source = (PORT / "csrc" / "flash_attention.cu").read_text()
    for kernel in ("flash_fwd_kernel", "flash_bwd_dkdv_kernel",
                   "flash_bwd_dq_kernel"):
        assert re.search(rf"\b{kernel}\(const Params p\)", source), kernel
    for reference in ("_fwd_kernel", "_fwd_kernel_packed", "_dkdv_kernel",
                      "_dkdv_kernel_packed", "_dq_kernel",
                      "_dq_kernel_packed"):
        assert reference in source, reference


def test_flash_variants_cover_row_12():
    """E's ablations: one C entry over the compile-time variants of E's
    kernel template, each naming the reference kernel it replaces."""
    source = (PORT / "csrc" / "flash_attention.cu").read_text()
    assert re.search(r'^extern "C" int flash_fwd_variant\(', source, re.M)
    assert "flash_fwd_tc_kernel<64, NH, KIND>" in source
    assert re.search(r"\bflash_fwd_tc_kernel\(const Params p\)", source)
    for reference in ("_fwd_v2", "_fwd_v3", "_fwd_v4", "_fwd_v5",
                      "_fwd_nomax"):
        assert reference in source, reference
    from ddp_practice_tpu_torch.ops import flash_attention as fa

    assert set(fa.VARIANTS) == {"v2", "v3", "v4", "v5", "nomax"}
    assert set(fa.VARIANT_LAUNCHES) == {
        "flash_fwd_v2", "flash_fwd_v3", "flash_fwd_v4", "flash_fwd_v5h2",
        "flash_fwd_v5h4", "flash_fwd_nomax"}


def test_fused_kernel_source_and_sm90a_build():
    from ddp_practice_tpu_torch.ops import cuda_build

    source = (PORT / "csrc" / "fused_encoder.cu").read_text()
    assert "sm_90a" in source
    for entry in ("fused_encoder_fwd", "fused_encoder_bwd"):
        assert re.search(rf"^extern \"C\" int {entry}\(", source, re.M), entry
    for kernel in ("fused_encoder_fwd_kernel", "fused_encoder_bwd_kernel",
                   "fused_encoder_reduce_kernel"):
        assert re.search(rf"\b{kernel}\(const ", source), kernel
    for reference in ("_fused_kernel", "_fused_bwd_kernel", "_fwd_core"):
        assert reference in source, reference
    # every product is in the kernel body: no library GEMM, no atomics
    for banned in ("cublas", "cutlass", "cudnn", "atomicadd"):
        assert banned not in source.lower(), banned
    assert "fused_encoder" in cuda_build.SOURCES
    assert set(cuda_build.SOURCES) == {
        p.stem for p in (PORT / "csrc").glob("*.cu")}
    lib = cuda_build.library_path("fused_encoder")
    assert lib.parent == ROOT / "build" / "ddp_practice_tpu_torch"


def test_fused_wrapper_calls_no_library_product_on_the_card():
    """The launch path of ops/fused_encoder.py (everything from `_prepare`
    down) holds no matmul, SDPA, layer_norm or compile call."""
    text = (PORT / "ops" / "fused_encoder.py").read_text()
    launch = text[text.index("# ------------------------------------------"
                             "-------------------- launches"):]
    for banned in ("matmul(", "_grouped_mm", " @ ", "scaled_dot_product",
                   "layer_norm", "torch.compile", "einsum", "F.linear",
                   "torch.mm"):
        assert banned not in launch, banned


def test_grouped_matmul_source_and_sm90a_build():
    from ddp_practice_tpu_torch.ops import cuda_build

    source = (PORT / "csrc" / "grouped_matmul.cu").read_text()
    assert "sm_90a" in source
    for entry in ("grouped_matmul_gmm", "grouped_matmul_tgmm"):
        assert re.search(rf"^extern \"C\" int {entry}\(", source, re.M), \
            entry
    for kernel in ("gmm_kernel", "tgmm_kernel"):
        assert re.search(rf"\b{kernel}\(const T\* ", source), kernel
    for reference in ("_mb_gmm", "_grouped_matmul", "gmm", "tgmm"):
        assert reference in source, reference
    for banned in ("cublas", "cutlass", "cudnn", "atomicadd"):
        assert banned not in source.lower(), banned
    assert "grouped_matmul" in cuda_build.SOURCES
    lib = cuda_build.library_path("grouped_matmul")
    assert lib.parent == ROOT / "build" / "ddp_practice_tpu_torch"
    text = (PORT / "ops" / "grouped_matmul.py").read_text()
    launch = text[text.index("# ------------------------------------------"
                             "-------------------- launches"):]
    for banned in ("matmul(", " @ ", "torch.mm", "einsum", "_grouped_mm",
                   ".item()", ".tolist()"):
        assert banned not in launch, banned


def _imports(module):
    tree = ast.parse((PORT / module).read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module)
    return imported


@pytest.mark.parametrize("module", ["serve/kv_pages.py", "serve/spec.py"])
def test_host_pure_copies_stand_alone(module):
    imported = _imports(module)
    allowed = ("__future__", "typing", "torch", "ddp_practice_tpu_torch.")
    assert imported and all(m.startswith(allowed) for m in imported), \
        sorted(imported)


TRAIN_SLICE = ["data/sharding.py", "data/lm_corpus.py", "data/datasets.py",
               "data/loader.py", "ops/fused_encoder.py", "train/state.py",
               "train/steps.py", "train/loop.py", "parallel/dist.py",
               "utils/flops.py", "utils/timing.py", "ops/losses.py",
               "ops/moe.py", "ops/grouped_matmul.py", "models/vit_moe.py",
               "config.py", "cli.py", "utils/profiling.py", "utils/xprof.py",
               "ops/flash_attention.py", "experiments/flash_variants.py",
               "experiments/flash_ablate.py", "experiments/flash_4d.py",
               "experiments/flash_profile.py", "experiments/flash_time.py",
               "experiments/flash_bwd_ablate.py",
               "experiments/flash_fwd_ablate.py",
               "experiments/flash_variant_levers.py", "experiments/gmm_tune.py",
               "experiments/tgmm_tune.py", "models/convnet.py",
               "ops/batchnorm.py", "checkpoint/__init__.py",
               "data/ingest.py", "generate.py", "serve/bench.py",
               "experiments/convnet_step.py", "models/resnet.py",
               "ops/augment.py", "data/native_loader.py", "convert.py",
               "benchmarks.py", "parallel/mesh.py",
               "parallel/sharding_rules.py", "parallel/fsdp.py",
               "parallel/tensor.py", "parallel/threads.py",
               "parallel/ring.py", "parallel/ulysses.py",
               "parallel/pipeline.py", "parallel/pipeline_1f1b.py",
               "parallel/interleave.py", "models/pipeline_lm.py",
               "models/pipeline_vit.py", "serve/health.py",
               "serve/faults.py", "serve/metrics.py", "serve/slo.py",
               "serve/fairshare.py", "serve/affinity.py", "serve/router.py",
               "utils/trace.py", "utils/logging.py", "utils/http_post.py",
               "serve/sse.py", "serve/admission.py", "serve/workload.py",
               "serve/frontdoor.py", "serve/rpc.py", "serve/worker.py",
               "serve/supervisor.py", "utils/telemetry.py"]
STDLIB = ("__future__", "typing", "argparse", "asyncio", "atexit",
          "collections", "contextlib", "http.client", "http.server",
          "queue", "select", "signal",
          "ctypes", "dataclasses", "enum", "fcntl", "functools", "gc",
          "gzip", "hashlib", "heapq", "itertools", "json", "logging", "math",
          "os", "pathlib", "pickle", "platform", "re", "shlex", "shutil",
          "zlib",
          "socket", "statistics", "struct", "subprocess", "sys", "tarfile",
          "tempfile", "threading", "time", "traceback", "urllib.request",
          "datetime",
          "uuid", "warnings")


# the offline audit the benches run in-process; it imports only the
# standard library (test_tools_stand_alone)
TOOLS = ("tools.check_stream",)


@pytest.mark.parametrize("module", TRAIN_SLICE)
def test_train_slice_modules_stand_alone(module):
    imported = _imports(module)
    assert imported and all(
        m in STDLIB or m in ("numpy", "torch") or m in TOOLS
        or m.startswith(("torch.", "ddp_practice_tpu_torch."))
        for m in imported), sorted(imported)


@pytest.mark.parametrize("tool", TOOLS)
def test_tools_stand_alone(tool):
    tree = ast.parse((ROOT / (tool.replace(".", "/") + ".py")).read_text())
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
    imported |= {n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom)}
    assert imported and all(m in STDLIB for m in imported), sorted(imported)



def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path is not reachable")
    from ddp_practice_tpu_torch import benchmarks
    from ddp_practice_tpu_torch.config import resolve_device
    from ddp_practice_tpu_torch.models import create_model
    from ddp_practice_tpu_torch.serve import bench

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("lm_tiny", vocab_size=16, hidden_dim=64, depth=1,
                     num_heads=1, mlp_dim=64)
    for entry in (bench.serve_bench, bench.shared_prefix_bench,
                  bench.spec_decode_bench):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(n_requests=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.serve_bench(n_requests=1, paged=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.serve_bench(n_requests=1, replicas=2)
    for entry in (bench.frontdoor_bench, bench.fleet_bench,
                  bench.streaming_bench):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(n_requests=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.qos_bench()
    for flags in (["--paged"], ["--shared-prefix", "--kv-int8"],
                  ["--spec-decode"], ["--replicas", "2"], ["--frontdoor"],
                  ["--qos"], ["--procs", "2"],
                  ["--procs", "2", "--streaming"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.main(["--requests", "1", *flags])
    for entry in (benchmarks.bench_train, benchmarks.bench_lm_train,
                  benchmarks.bench_lm_decode):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry("lm_tiny" if entry is not benchmarks.bench_train
                  else "convnet")


def test_worker_process_serves_with_jax_blocked(tmp_path, monkeypatch):
    """serve/supervisor.py spawn_worker starts `python -m
    ddp_practice_tpu_torch.serve.worker` with jax, flax, optax and the
    JAX package unimportable in the child (a sitecustomize on its
    PYTHONPATH blocks them and leaves its pid): the worker boots, prints
    its READY line and serves one greedy request over the RPC seam."""
    from ddp_practice_tpu_torch.serve.supervisor import reap_all, spawn_worker
    from ddp_practice_tpu_torch.serve.worker import WorkerSpec

    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(
        "import os, sys\n"
        "for name in ('jax', 'flax', 'optax', 'ddp_practice_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"open({str(tmp_path / 'blocked')!r}, 'a').write("
        "f'{os.getpid()}\\n')\n")
    monkeypatch.setenv("PYTHONPATH", str(site))
    spec = WorkerSpec(
        model={"vocab_size": 32, "max_len": 32, "hidden_dim": 32,
               "depth": 1, "num_heads": 2, "mlp_dim": 64,
               "pos_emb": "rope"},
        engine={"max_slots": 1, "max_len": 32, "prompt_buckets": [8],
                "decode_burst": 2}, device="cpu")
    w = spawn_worker(spec, log_dir=str(tmp_path / "logs"),
                     ready_timeout_s=60.0)
    try:
        assert str(w.pid) in (tmp_path / "blocked").read_text().split()
        req = {"rid": 1, "prompt": [3, 1, 4], "max_new_tokens": 4}
        assert w.client.call("submit", request=req)["accepted"]
        deadline = time.monotonic() + 30
        comps = []
        while not comps and time.monotonic() < deadline:
            comps = w.client.call("poll", watermark=0)["completions"]
            time.sleep(0.02)
        assert comps and comps[0]["status"] == "length"
        assert len(comps[0]["tokens"]) == 4
        w.client.call("shutdown")
    finally:
        w.reap()
        assert reap_all() == []


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke would run for real")
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # both runs at once: each spends its time importing torch
    procs = [subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=cwd,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cwd in (ROOT, tmp_path)]
    for proc in procs:
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode != 0 and '"ok"' not in out
