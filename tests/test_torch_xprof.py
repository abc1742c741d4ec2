"""utils/xprof.py: the Kineto trace reader (counterpart of the reference's
XPlane reader, tests/test_xprof.py).

- A trace written here, with kernels named as the port's E and F, a
  cuBLAS GEMM and an elementwise op, a memcpy and a memset carrying
  `bytes`, a `gpu_user_annotation` (to be left out) and host events, gives
  exact `total_ps`, per-category ps / count / bytes, `ops` and planes.
- The newest trace in a directory is read; no matching event raises
  ValueError, as the reference does; `print_summary` prints the
  reference's columns.
- A real CPU `torch.profiler` capture through `utils/profiling`
  round-trips with `device_substr="cpu"`.
Exact integer picoseconds: no tolerance.
"""

import json
import os
import time

import pytest
import torch

from ddp_practice_tpu_torch.utils import profiling, xprof

# one intra-op thread, as tests/_torch_port.py sets for the port's other
# files: the suite runs several workers on one machine
torch.set_num_threads(1)

E = "void (anonymous namespace)::flash_fwd_tc_kernel<64>((anonymous namespace)::Params)"
F = "void (anonymous namespace)::flash_bwd_dkdv_tc_kernel<64>((anonymous namespace)::Params)"
GEMM = "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT"
ELEM = "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>"
VARIANT = "void (anonymous namespace)::flash_fwd_variant_kernel<64, 2, 2>((anonymous namespace)::VarParams)"


def _ev(cat, name, dur, tid=7, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": tid,
            "ts": 0.0, "dur": dur, "args": args}


EVENTS = [
    _ev("kernel", E, 900.5),
    _ev("kernel", E, 901.25),
    _ev("kernel", F, 2000.0),
    _ev("kernel", VARIANT, 850.0),
    _ev("kernel", GEMM, 120.0, tid=8),
    _ev("kernel", ELEM, 3.5),
    _ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 10.0, bytes=4096),
    _ev("gpu_memset", "Memset (Device)", 1.0, bytes=512),
    _ev("gpu_user_annotation", "Optimizer.step#AdamW.step", 5000.0),
    _ev("cpu_op", "aten::add", 12.0, tid=1),
    _ev("cuda_runtime", "cudaLaunchKernel", 4.0, tid=1),
    {"ph": "M", "cat": "kernel", "name": "process_name", "pid": 0},
]


def _write(path, events):
    path.write_text(json.dumps({"schemaVersion": 1, "traceEvents": events}))
    return path


def test_summary_of_a_written_trace_is_exact(tmp_path):
    _write(tmp_path / "host_1.1.pt.trace.json", EVENTS)
    s = xprof.op_summary(str(tmp_path))
    cats = s["categories"]
    assert cats == {
        "flash E": {"ps": 1801750000, "count": 2, "bytes": 0},
        "flash F": {"ps": 2000000000, "count": 1, "bytes": 0},
        "flash variants": {"ps": 850000000, "count": 1, "bytes": 0},
        "matmul": {"ps": 120000000, "count": 1, "bytes": 0},
        "other": {"ps": 3500000, "count": 1, "bytes": 0},
        "copy/memset": {"ps": 11000000, "count": 2, "bytes": 4608},
    }
    # the annotation's 5 ms spans kernels already counted: left out
    assert s["total_ps"] == 4786250000
    assert s["ops"][("flash E", E)] == 1801750000
    assert s["op_counts"][("flash E", E)] == 2
    assert s["ops"][("copy/memset", "Memcpy HtoD (Pinned -> Device)")] \
        == 10000000
    assert s["planes"] == 2          # streams 7 and 8
    assert s == xprof.op_summary_events(EVENTS)


@pytest.mark.parametrize("name,cat,kind", [
    ("flash_bwd_dq_tc_kernel<64>", "kernel", "flash G"),
    ("fused_encoder_fwd_kernel<bf16>", "kernel", "fused H"),
    ("fused_encoder_bwd_kernel<bf16>", "kernel", "fused I"),
    ("fused_encoder_reduce_kernel", "kernel", "fused I reduce"),
    ("gmm_kernel<bf16, 0>", "kernel", "grouped J"),
    ("tgmm_kernel<bf16>", "kernel", "grouped K"),
    ("tgmm_wg_kernel<256, 1>", "kernel", "grouped K"),
    ("tgmm_reduce_kernel<float>", "kernel", "grouped K"),
    ("paged_decode_attention_kernel<1>", "kernel", "decode A-D"),
    ("pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits>", "kernel",
     "library attention"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "kernel", "matmul"),
    ("cutlass::Kernel2<cutlass_80_wmma>", "kernel", "matmul"),
    ("Memcpy DtoD (Device -> Device)", "gpu_memcpy", "copy/memset"),
    ("reduce_kernel<512, 1>", "kernel", "other"),
])
def test_categories_follow_the_kernel_names(name, cat, kind):
    assert xprof.category(name, cat) == kind


def test_newest_trace_wins_and_a_file_path_is_read(tmp_path):
    (tmp_path / "a").mkdir()
    old = _write(tmp_path / "a" / "old.pt.trace.json",
                 [_ev("kernel", E, 1.0)])
    new = _write(tmp_path / "new.pt.trace.json", [_ev("kernel", F, 2.0)])
    past = time.time() - 100
    os.utime(old, (past, past))
    assert xprof.find_trace(str(tmp_path)) == str(new)
    assert set(xprof.op_summary(str(tmp_path))["categories"]) == {"flash F"}
    assert set(xprof.op_summary(str(old))["categories"]) == {"flash E"}


def test_missing_trace_or_device_events_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="no .pt.trace.json"):
        xprof.op_summary(str(tmp_path))
    _write(tmp_path / "cpu_only.pt.trace.json",
           [e for e in EVENTS if e["cat"] in ("cpu_op", "cuda_runtime",
                                              "gpu_user_annotation")])
    with pytest.raises(ValueError, match="no 'cuda' device event"):
        xprof.op_summary(str(tmp_path))
    with pytest.raises(ValueError, match="unknown device"):
        xprof.op_summary(str(tmp_path), device_substr="tpu")


def test_print_summary_has_the_reference_columns(tmp_path, capsys):
    _write(tmp_path / "t.pt.trace.json", EVENTS)
    assert xprof.main([str(tmp_path), "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device op time: 2.39 ms/step (2 step(s))"
    # share, ms/step, count/step, category, GB/s; largest first
    assert [line.split() for line in out[1:3]] == [
        ["41.8%", "1.00", "ms/step", "x", "0", "flash", "F", "0", "GB/s"],
        ["37.6%", "0.90", "ms/step", "x", "1", "flash", "E", "0", "GB/s"]]
    assert len(out) == 1 + 6 + 1 + 7     # 6 categories, 7 distinct ops
    assert out[7] == "top 12 ops:"
    assert out[8].split()[:4] == ["1.000", "ms/step", "[flash", "F]"]
    assert out[9].split()[:4] == ["0.901", "ms/step", "[flash", "E]"]


def test_cpu_capture_round_trips_through_profile_region(tmp_path):
    x = torch.ones(64, 64)
    with profiling.profile_region("probe", str(tmp_path)):
        for _ in range(3):
            x = torch.mm(x, x) * 0.01
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    s = xprof.op_summary(str(tmp_path), device_substr="cpu")
    names = {name for _, name in s["ops"]}
    assert {"aten::mm", "aten::mul"} <= names
    assert s["op_counts"][("cpu_op", "aten::mm")] == 3
    assert s["total_ps"] == sum(s["ops"].values()) > 0
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert s == xprof.op_summary_events(events, device_substr="cpu")
    # the region's own range is an annotation, not an op
    assert [e["cat"] for e in events if e.get("name") == "probe"] == [
        "user_annotation"]
