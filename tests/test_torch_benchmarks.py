"""The port's bench module (ddp_practice_tpu_torch/benchmarks.py) against
the reference's (ddp_practice_tpu/benchmarks.py) on the CPU, at tiny
shapes:

- `bench_train` (convnet, a one-layer vit_tiny), `bench_lm_train` and
  `bench_lm_decode` (one block of lm_tiny and of lm_moe; an int8 cache):
  the port's report
  has the reference's keys, from the same call, and the same values
  where they do not depend on time or on the draws (the configuration,
  the analytic FLOPs, the parameter count, the KV bytes a step). Both
  run with the card's peak rate and memory rate patched in for the CPU,
  so the MFU and MBU keys are compared too. (`decode_window_clamped`
  appears only when the prefill's timing eats most of a call, which
  depends on the machine's load: it is left out of the key comparison.)
- the bench's own contract: two fenced windows give `window_spread_pct`,
  one window none; the decode bench refuses a prefill-dominated
  configuration; `bench_pipeline` runs the reference's sweep; `bench_serve`
  delegates to serve/bench.py, which serves lm_moe.
- the suite entry: one JSON line per entry (an entry that fails gives
  its traceback and does not end the suite), the compact last line, the
  full suite under `--out`, never the repo's BENCHMARKS.json.
"""

import json
import math

import pytest

import _torch_port  # noqa: F401  (one intra-op thread for the suite)
from ddp_practice_tpu import benchmarks as ref
from ddp_practice_tpu.utils import flops as ref_flops
from ddp_practice_tpu_torch import benchmarks as port
from ddp_practice_tpu_torch.utils import flops as port_flops

PEAK, HBM = 989.4e12, 3.35e12
# one block (routed for lm_moe): the reference compiles a whole call (K
# steps, or the whole generation) as one program
ONE_BLOCK = dict(hidden_dim=64, depth=1, num_heads=2, mlp_dim=64)
CASES = {
    "train-convnet": ("bench_train", "convnet", dict(
        image_shape=(28, 28, 1), batch_size=8, steps_per_call=2, calls=2,
        warmup_calls=1, pool_size=16, precision="fp32")),
    "train-vit_tiny": ("bench_train", "vit_tiny", dict(
        image_shape=(8, 8, 3), batch_size=8, steps_per_call=1, calls=3,
        warmup_calls=1, pool_size=16, precision="fp32",
        model_kwargs=dict(depth=1, hidden_dim=64, num_heads=1,
                          mlp_dim=64))),
    "lm_train-lm_tiny": ("bench_lm_train", "lm_tiny", dict(
        seq_len=16, vocab_size=64, batch_size=8, steps_per_call=2,
        calls=2, precision="fp32", attn_impl="xla",
        model_kwargs=ONE_BLOCK)),
    "lm_train-lm_moe": ("bench_lm_train", "lm_moe", dict(
        seq_len=16, vocab_size=64, batch_size=8, steps_per_call=1,
        calls=2, precision="fp32", attn_impl="xla",
        model_kwargs=dict(ONE_BLOCK, num_experts=4, moe_every=1))),
    # greedy: the reference compiles its sampling into the generation
    # program (seconds on the CPU); the int8 case below samples
    "decode-lm_tiny": ("bench_lm_decode", "lm_tiny", dict(
        prompt_len=4, max_new_tokens=8, batch_size=2, vocab_size=64,
        precision="fp32", calls=2, temperature=0.0,
        model_kwargs=ONE_BLOCK)),
    "decode-lm_moe": ("bench_lm_decode", "lm_moe", dict(
        prompt_len=4, max_new_tokens=8, batch_size=2, vocab_size=64,
        precision="fp32", calls=2, temperature=0.0,
        model_kwargs=dict(ONE_BLOCK, num_experts=4, moe_every=1))),
    "decode-lm_tiny-int8-bf16": ("bench_lm_decode", "lm_tiny", dict(
        prompt_len=4, max_new_tokens=8, batch_size=2, vocab_size=64,
        precision="bf16", calls=2, kv_cache="int8",
        model_kwargs=ONE_BLOCK)),
}
# keys whose value is the configuration or an analytic count, not a time
SAME_VALUE = ("model", "image_shape", "batch_size", "steps_per_call",
              "precision", "device_kind", "train_flops_per_image",
              "peak_bf16_tflops", "seq_len", "vocab_size", "attn_impl",
              "train_flops_per_token", "mode", "prompt_len",
              "max_new_tokens", "stream_dtype", "n_params", "kv_cache",
              "kv_bytes_per_step_mb", "hbm_gbps")
_PORT = {}


@pytest.fixture
def card_rates(monkeypatch):
    """The H100's peak and memory rate for the "cpu" device kind, in
    both packages' tables."""
    for mod in (ref_flops, port_flops):
        monkeypatch.setattr(mod, "chip_peak_flops",
                            lambda kind: PEAK if kind == "cpu" else None)
        monkeypatch.setattr(mod, "chip_hbm_bandwidth",
                            lambda kind: HBM if kind == "cpu" else None)


def _port_report(case):
    if case not in _PORT:
        fn, model, kw = CASES[case]
        _PORT[case] = getattr(port, fn)(model, device="cpu", **kw)
    return _PORT[case]


@pytest.mark.parametrize("case", list(CASES))
def test_port_report(card_rates, case):
    fn, model, kw = CASES[case]
    r = _port_report(case)
    assert r["model"] == model and r["device_kind"] == "cpu"
    assert r["n_chips"] == 1
    for key, value in r.items():
        if isinstance(value, float):
            assert math.isfinite(value), key
    if fn == "bench_train":
        assert r["window_spread_pct"] >= 0.0
        assert r["mfu_pct"] == pytest.approx(
            100 * r["images_per_sec_per_chip"]
            * r["train_flops_per_image"] / PEAK, rel=1e-2, abs=0.01)
    elif fn == "bench_lm_train":
        assert r["mfu_pct"] >= 0.0
        if model == "lm_moe":
            assert {"moe_drop_rate", "moe_load_max",
                    "moe_load_min"} <= set(r)
    else:
        assert r["mbu_total_pct"] >= r["mbu_pct"] >= 0.0


@pytest.mark.parametrize("case", list(CASES))
def test_report_keys_and_counts_match_the_reference(card_rates, case):
    fn, model, kw = CASES[case]
    want = getattr(ref, fn)(model, **kw)
    got = _port_report(case)
    skip = {"decode_window_clamped"}
    assert set(got) - skip == set(want) - skip
    for key in SAME_VALUE:
        if key in want:
            assert got[key] == want[key], key


def test_lm_train_on_the_corpus():
    """data="corpus": the Markov corpus's vocabulary replaces vocab_size
    and lm_moe reports its router's health from the last step."""
    r = port.bench_lm_train("lm_moe", device="cpu", data="corpus",
                            **{**CASES["lm_train-lm_moe"][2],
                               "vocab_size": 1000})
    assert r["vocab_size"] == 64
    assert 0.0 <= r["moe_drop_rate"] <= 1.0
    assert 0.0 <= r["moe_load_min"] <= 0.25 <= r["moe_load_max"] <= 1.0
    with pytest.raises(ValueError, match="unknown data source"):
        port.bench_lm_train("lm_tiny", device="cpu", data="text")


def test_decode_hands_the_kernel_contiguous_queries(monkeypatch):
    """The suite's decode entries run lm_base with learned positions at
    batch 8, where q is a strided slice of the fused QKV projection: the
    flat decode kernel reads contiguous rows, so the model must hand it a
    contiguous q (the card refused the slice)."""
    from ddp_practice_tpu_torch.models import vit

    seen = []
    real = vit.decode_attention_packed

    def checked(q, *args, **kwargs):
        seen.append(q.is_contiguous())
        return real(q, *args, **kwargs)

    monkeypatch.setattr(vit, "decode_attention_packed", checked)
    port.bench_lm_decode("lm_tiny", prompt_len=2, max_new_tokens=3,
                         batch_size=4, vocab_size=64, precision="fp32",
                         calls=1, device="cpu",
                         model_kwargs=dict(ONE_BLOCK, hidden_dim=128))
    assert seen and all(seen)


def test_window_spread_needs_two_windows():
    kw = dict(CASES["train-convnet"][2], calls=1)
    r = port.bench_train("convnet", device="cpu", **kw)
    assert "window_spread_pct" not in r


def test_decode_refuses_a_prefill_dominated_configuration():
    with pytest.raises(ValueError, match="prefill-dominated"):
        port.bench_lm_decode("lm_tiny", prompt_len=16, max_new_tokens=8,
                             device="cpu")


# ddp_practice_tpu/benchmarks.py bench_pipeline's record keys
PIPELINE_KEYS = {"schedule", "num_stages", "microbatches", "global_batch",
                 "seq_len", "ms_per_step", "temp_bytes", "loss"}


def test_bench_pipeline_names_its_roadmap_item():
    """ROADMAP A8d's bench runs: the reference's sweep (GPipe, then 1F1B,
    over M) with its record keys, on a small lm_pipe at pipe 2 as
    threads; the two schedules train the same model to the same loss,
    and the memory column is not measured on the CPU."""
    rows = port.bench_pipeline(
        num_stages=2, microbatch_counts=(2, 4), hidden_dim=32, depth=2,
        num_heads=4, mlp_dim=64, vocab_size=32, seq_len=16, mb_rows=2,
        steps=1, warmup=1, precision="fp32", device="cpu")
    assert [(r["schedule"], r["microbatches"]) for r in rows] == [
        ("gpipe", 2), ("gpipe", 4), ("1f1b", 2), ("1f1b", 4)]
    for r in rows:
        assert PIPELINE_KEYS <= set(r) <= PIPELINE_KEYS | {"efficiency_pct"}
        assert r["temp_bytes"] is None
        assert r["global_batch"] == 2 * r["microbatches"]
    for g, f in zip(rows[:2], rows[2:]):
        assert abs(g["loss"] - f["loss"]) <= 1e-3


@pytest.mark.parametrize("bench", ["serve", "shared_prefix", "spec"])
def test_serve_benches_serve_lm_moe(bench):
    """bench_serve is serve/bench.py serve_bench; an lm_moe model (2 heads
    of 64, every second block routed) built by the serving benches serves
    every request of every row: slot, static and paged; the shared-prefix
    arms; plain and speculative paged decoding."""
    from ddp_practice_tpu_torch.serve import bench as sb

    small = dict(model_name="lm_moe", device="cpu", heads=2, seed=0)
    if bench == "serve":
        r = port.bench_serve(n_requests=3, rate_hz=100.0, paged=True,
                             max_new_range=(2, 6), **small)
        rows = ("continuous", "static", "paged")
        n = 3
    elif bench == "shared_prefix":
        r = sb.shared_prefix_bench(n_requests=8, **small)
        rows = ("paged", "paged_prefix")
        n = 8
    else:
        r = sb.spec_decode_bench(n_requests=3, rate_hz=100.0, **small)
        rows = ("paged", "paged_spec")
        n = 3
    for row in rows:
        assert r[row]["completions"] == n, row


def test_suite_entry(monkeypatch, tmp_path, capsys):
    """The suite at tiny entries: a line per entry, the failed entry's
    traceback among them, the compact line last, the suite in --out."""
    tiny = {
        "convnet": dict(CASES["train-convnet"][2]),
        "lm_long": dict(CASES["lm_train-lm_tiny"][2], kind="lm",
                        model="lm_tiny"),
        "lm_decode": dict(CASES["decode-lm_tiny"][2], kind="decode"),
        "resnet50": dict(model="no_such_model"),
        "lm_tiny_fused": dict(kind="lm"),
    }
    monkeypatch.setattr(port, "_SUITE", tiny)
    # the decode entries bench lm_base; at tiny widths here
    real = port.bench_lm_decode
    monkeypatch.setattr(port, "bench_lm_decode",
                        lambda name, **kw: real("lm_tiny", **kw))
    out = tmp_path / "suite.json"
    rc = port.main(["--models",
                    "lm_long,convnet,resnet50,lm_decode,lm_tiny_fused",
                    "--precision", "fp32", "--device", "cpu",
                    "--out", str(out)])
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["model"] for x in lines[:5]] == [
        "lm_long", "convnet", "resnet50", "lm_decode", "lm_tiny_fused"]
    assert "tokens_per_sec" in lines[0] and "images_per_sec" in lines[1]
    assert "no_such_model" in lines[2]["error"]
    assert lines[3]["mode"] == "decode"
    # an entry the port cannot run yet says so, naming its ROADMAP item
    assert lines[4]["error"].startswith("not runnable yet")
    assert "ROADMAP" in lines[4]["error"]
    last = lines[-1]
    assert len(lines) == 6
    assert set(last) == {"metric", "value", "unit", "vs_baseline",
                         "n_errors"}
    assert last["unit"] == "tokens/sec/chip" and last["n_errors"] == 2
    assert last["vs_baseline"] == round(
        lines[1]["images_per_sec_per_chip"]
        / port.REFERENCE_IMAGES_PER_SEC, 3)
    suite = json.loads(out.read_text())
    assert [r["model"] for r in suite["results"]] == ["lm_long", "convnet",
                                                      "lm_decode"]
    assert suite["headline"]["model"] == "lm_long"


def test_steps_per_call_override_skips_decode(monkeypatch, tmp_path,
                                              capsys):
    """--steps_per_call sets the training entries' steps a call and
    leaves the decode entries alone (a decode call has no steps)."""
    tiny = {
        "convnet": dict(CASES["train-convnet"][2]),
        "lm_decode": dict(CASES["decode-lm_tiny"][2], kind="decode"),
    }
    monkeypatch.setattr(port, "_SUITE", tiny)
    real = port.bench_lm_decode
    monkeypatch.setattr(port, "bench_lm_decode",
                        lambda name, **kw: real("lm_tiny", **kw))
    rc = port.main(["--models", "convnet,lm_decode", "--precision", "fp32",
                    "--device", "cpu", "--steps_per_call", "3",
                    "--out", str(tmp_path / "suite.json")])
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0]["steps_per_call"] == 3
    assert lines[1]["mode"] == "decode" and "error" not in lines[1]


TINY_PIPELINE = dict(
    kind="pipeline", num_stages=2, microbatch_counts=(2,), hidden_dim=32,
    depth=2, num_heads=4, mlp_dim=64, vocab_size=32, seq_len=16, mb_rows=2,
    steps=1, warmup=1)


def test_extra_entries_run_when_named(monkeypatch, tmp_path, capsys):
    """The entries beyond the reference's suite run when --models names
    them: the decode on lm_moe benches lm_moe (not lm_base), and the
    pipeline sweep gives its rows without heading the line."""
    monkeypatch.setattr(port, "_SUITE", {
        "convnet": dict(CASES["train-convnet"][2])})
    monkeypatch.setattr(port, "EXTRA", {
        "lm_decode_moe": dict(CASES["decode-lm_moe"][2], kind="decode",
                              model="lm_moe"),
        "pipeline": dict(TINY_PIPELINE)})
    names = []
    real = port.bench_lm_decode
    monkeypatch.setattr(port, "bench_lm_decode",
                        lambda name, **kw: names.append(name)
                        or real(name, **kw))
    rc = port.main(["--models", "pipeline,lm_decode_moe,convnet",
                    "--precision", "fp32", "--device", "cpu",
                    "--calls", "2", "--out", str(tmp_path / "suite.json")])
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x.get("model") for x in lines[:3]] == [
        "pipeline", "lm_decode_moe", "convnet"]
    assert names == ["lm_moe"]
    assert [r["schedule"] for r in lines[0]["rows"]] == ["gpipe", "1f1b"]
    assert lines[1]["mode"] == "decode"
    # the first entry with a rate heads the line
    assert lines[-1]["unit"] == "tokens/sec/chip"
    assert lines[-1]["value"] == lines[1]["tokens_per_sec_per_chip"]


def test_pipeline_sweep_alone(monkeypatch, tmp_path, capsys):
    """A suite of the pipeline sweep alone writes its rows and ends with
    its fastest schedule's step time."""
    monkeypatch.setattr(port, "EXTRA", {"pipeline": dict(TINY_PIPELINE)})
    out = tmp_path / "suite.json"
    rc = port.main(["--models", "pipeline", "--precision", "fp32",
                    "--device", "cpu", "--out", str(out)])
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    rows = lines[0]["rows"]
    assert lines[-1]["unit"] == "ms/step"
    assert lines[-1]["value"] == min(r["ms_per_step"] for r in rows)
    assert json.loads(out.read_text())["results"][0]["rows"] == rows


def test_suite_copies_the_reference_suite():
    """The entries, their names and configurations are the root bench.py's
    (as read from its source: importing it would be harmless, running it
    writes the repo's BENCHMARKS.json)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench.py")
    spec = importlib.util.spec_from_file_location("root_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def norm(suite):
        return {name: {k: (tuple(v) if isinstance(v, list) else v)
                       for k, v in kw.items()}
                for name, kw in suite.items()}

    assert norm(port._SUITE) == norm(mod._SUITE)
