"""The port's training loop (ddp_practice_tpu_torch/train/loop.py and
cli.py) on the CPU:

- the CLI trains lm_tiny (the registry's own size; the reference's parser
  has no depth flag) at seq 32, batch 4, for 3 steps with the flash path's
  plain version, prints the reference's three parity lines, and its JSON
  summary has the reference `_fit_inner`'s keys;
- the CLI trains vit_tiny (the registry's own depth and width) on the
  synthetic CIFAR-10 fallback for 3 steps plus a wrap-padded eval, with the
  image task's summary keys; `--fused on` runs the fused layer's plain
  version, and raises for a model that does not take it, a wide model or
  head_dim 32, naming the limit;
- the CLI trains lm_moe (registry dims, token choice and expert choice)
  and its summary carries the last step's router health (moe_* keys);
- the CLI's defaults (no model flag) train the reference's ConvNet on
  MNIST: the synthetic stand-in when no IDX files are found, and the
  committed real-format fixture through `--data_dir`, where it learns;
  the summary carries `mfu` (None on the CPU, whose peak is unknown);
- model names and flags this slice does not port raise
  NotImplementedError naming their ROADMAP item, and the card is the
  default device; ROADMAP A2's (resnet18, resnet50, `--augment` on a
  ViT, `--loader native`, `--dataset imagenet`) run, `--augment` on an
  LM raises the reference's ValueError, and `num_classes` is not read
  (the dataset sizes the head, as in the reference); the step variants'
  flags (`--steps_per_call`, `--data_placement device`,
  `resident_max_bytes`) run, and
  `--compile_cache` raises: the port has no compile cache;
- data parallelism: two gloo processes at per-rank batch 2 take the same
  step as one process at batch 4 (1e-6) and stay bit-identical replicas,
  for lm_tiny, for lm_moe, whose router statistics and balancing bias
  are global-batch quantities (ops/moe.py all-reduces them): the ranks'
  router biases equal the single process's, and for the ConvNet and
  ResNet-18, whose BatchNorm statistics are all-reduced (SyncBN): the
  ranks' running statistics and parameters equal the single process's
  over the global batch; and chunked (steps_per_call=2), where the ranks
  run each chunk as two eager steps. Under two processes "auto"
  placement streams host batches and "device" is refused.
"""

import json
import logging
import multiprocessing
import pathlib

import pytest
import torch

from ddp_practice_tpu_torch import cli
from ddp_practice_tpu_torch.config import TrainConfig
from ddp_practice_tpu_torch.parallel import dist
from ddp_practice_tpu_torch.train.loop import Trainer, log

SUMMARY_KEYS = {  # ddp_practice_tpu/train/loop.py _fit_inner, LM task
    "accuracy", "elapsed_seconds", "train_seconds", "images_per_sec",
    "images_per_sec_per_chip", "steps", "global_batch", "devices",
    "perplexity", "tokens_per_sec_per_chip",
    "mfu",   # the port's: None where the card's peak is unknown
}


@pytest.fixture
def log_lines():
    lines = []

    class Capture(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Capture()
    log.addHandler(handler)
    yield lines
    log.removeHandler(handler)


def test_cli_trains_lm_tiny_on_the_cpu(log_lines, capsys, tmp_path):
    metrics = tmp_path / "m.jsonl"
    assert cli.main([
        "--model", "lm_tiny", "--device", "cpu", "--seq_len", "32",
        "-b", "4", "--max_steps", "3", "-e", "1", "--log_every", "1",
        "--attn_impl", "flash", "--optimizer", "adamw", "--lr", "1e-3",
        "--synthetic_size", "20000", "--metrics_file", str(metrics),
        "--json"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(summary) == SUMMARY_KEYS | {"wall_seconds"}
    assert summary["steps"] == 3 and summary["global_batch"] == 4
    assert summary["devices"] == 1 and 0.0 <= summary["accuracy"] <= 1.0
    assert any(m.startswith("Accuracy is ") and m.endswith("%")
               for m in log_lines)
    assert any(m.startswith("time elapsed: ") for m in log_lines)
    assert any(m.startswith("throughput: ") for m in log_lines)
    records = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert [r["kind"] for r in records] == ["train"] * 3 + ["eval",
                                                           "summary"]
    assert [r["step"] for r in records[:3]] == [1, 2, 3]


@pytest.mark.parametrize("router", ["topk", "expert_choice"])
def test_cli_trains_lm_moe_on_the_cpu(router, capsys, tmp_path):
    metrics = tmp_path / "m.jsonl"
    assert cli.main([
        "--model", "lm_moe", "--device", "cpu", "--seq_len", "16",
        "-b", "2", "--max_steps", "2", "-e", "1", "--log_every", "1",
        "--optimizer", "adamw", "--lr", "1e-3", "--moe_router", router,
        "--num_experts", "4", "--synthetic_size", "20000",
        "--metrics_file", str(metrics), "--json"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    moe_keys = {"moe_load_max", "moe_load_min", "moe_drop_rate"}
    assert set(summary) == SUMMARY_KEYS | moe_keys | {"wall_seconds"}
    assert 0.0 <= summary["moe_load_min"] <= 0.25 <= summary["moe_load_max"]
    records = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert all(set(r) >= moe_keys for r in records[:2])
    if router == "expert_choice":
        trainer = Trainer(TrainConfig(
            model="lm_moe", device="cpu", seq_len=16, batch_size=2,
            synthetic_size=20000, moe_router=router))
        moe = trainer.model.blocks[1].moe
        assert (moe.capacity_factor, moe.router_bias) == (1.0, None)
        with pytest.raises(ValueError, match="MoE model families"):
            cli.main(["--model", "lm_tiny", "--moe_router", router,
                      "--device", "cpu"])


@pytest.mark.parametrize("argv,item", [
    (["--model", "lm_tiny", "--trace-out", "trace.json"], "A6d"),
    (["--model", "lm_tiny", "--metrics-port", "9100"], "A6d"),
    (["--model", "lm_tiny", "--telemetry-out", "t.jsonl"], "A6d"),
])
def test_unported_paths_name_their_roadmap_item(argv, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        cli.main(argv + ["--device", "cpu", "--seq_len", "16", "-b", "2"])


@pytest.mark.parametrize("argv", [
    ["--tensor", "2"], ["--fsdp"], ["--tensor", "2", "--fsdp"]],
    ids=["tensor", "fsdp", "tensor-fsdp"])
def test_tensor_and_fsdp_flags_run(argv, capsys):
    """ROADMAP A8a's flags through the CLI, the ranks as threads (one
    process: a lone rank refuses --tensor 2 with the reference's
    divisibility error)."""
    from _torch_port import ranks

    common = ["--model", "lm_tiny", "--device", "cpu", "--seq_len", "16",
              "-b", "2", "--max_steps", "2", "-e", "1", "--num_heads", "4",
              "--synthetic_size", "20000", "--log_every", "0", "--json"]
    world = 4 if len(argv) == 3 else 2
    assert ranks(lambda r: cli.main(argv + common), world) == [0] * world
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["steps"] == 2 and summary["devices"] == world
    dp = world // (2 if "--tensor" in argv else 1)
    assert summary["global_batch"] == 2 * dp
    if "--tensor" in argv:
        with pytest.raises(ValueError, match="not divisible by"):
            cli.main(argv + common)


# ROADMAP A2's paths, which raised before it was ported, now run
@pytest.mark.parametrize("argv", [
    ["--model", "resnet18", "--dataset", "cifar10", "--augment"],
    ["--model", "resnet50", "--dataset", "imagenet", "--augment",
     "--augment_kind", "rrc", "--loader", "native"],
    ["--model", "vit_tiny", "--dataset", "cifar10", "--augment"],
    ["--model", "lm_tiny", "--loader", "native", "--seq_len", "16",
     "--synthetic_size", "2000"],
], ids=["resnet18", "resnet50", "vit_tiny-augment", "lm_tiny-native"])
def test_a2_paths_run(argv, capsys, tmp_path):
    assert cli.main(["--synthetic_size", "12"] + argv + [
        "--device", "cpu", "-b", "2", "--max_steps", "1", "-e", "1",
        "--data_dir", str(tmp_path), "--json"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["steps"] == 1


def test_augment_on_the_lm_task_raises_the_references_error():
    with pytest.raises(ValueError, match="does not apply to token streams"):
        cli.main(["--model", "lm_tiny", "--augment", "--device", "cpu",
                  "--seq_len", "16", "-b", "2"])


@pytest.mark.parametrize("argv,resident", [
    (["--steps_per_call", "4"], True),
    (["--steps_per_call", "4", "--data_placement", "host"], False),
    (["--data_placement", "device"], True),
    (["--data_placement", "device", "--steps_per_call", "-1"], True),
])
def test_step_variant_flags_run(argv, resident):
    """The flags that raised before the step variants were ported now
    train: K steps a call on resident or host data, and a whole epoch a
    call."""
    args = cli.build_parser().parse_args([
        "--model", "lm_tiny", "--device", "cpu", "--seq_len", "16", "-b",
        "2", "--max_steps", "6", "-e", "1", "--log_every", "0",
        "--synthetic_size", "20000"] + argv)
    trainer = Trainer(cli.config_from_args(args))
    assert trainer.fit()["steps"] == 6
    assert (trainer.resident_train_step is not None) == resident
    assert (trainer.chunk_step is not None) == ("4" in argv)


def test_resident_max_bytes_decides_auto_placement():
    kw = dict(model="lm_tiny", device="cpu", seq_len=16, batch_size=2,
              synthetic_size=20000)
    assert Trainer(TrainConfig(**kw)).resident_train_step is not None
    small = Trainer(TrainConfig(resident_max_bytes=1 << 10, **kw))
    assert small.resident_train_step is None


def test_compile_cache_has_no_counterpart():
    with pytest.raises(NotImplementedError, match="no compile cache"):
        cli.main(["--model", "lm_tiny", "--compile_cache", "off",
                  "--device", "cpu", "--seq_len", "16", "-b", "2"])


IMAGE_KEYS = SUMMARY_KEYS - {"perplexity", "tokens_per_sec_per_chip"}
MINI_MNIST = str(pathlib.Path(__file__).parent / "data" / "mini_mnist")


@pytest.mark.parametrize("data", ["synthetic", "mini_mnist"])
def test_cli_defaults_train_the_convnet_on_mnist(data, log_lines, capsys,
                                                 tmp_path):
    argv = ["--device", "cpu", "-e", "1", "--log_every", "4", "--json"]
    if data == "synthetic":
        argv += ["--synthetic_size", "256", "--data_dir", str(tmp_path)]
    else:   # 256 real-format images; adam so 8 steps learn something
        argv += ["--data_dir", MINI_MNIST, "-e", "3", "-b", "16",
                 "--optimizer", "adam", "--lr", "3e-3"]
    assert cli.main(argv) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(summary) == IMAGE_KEYS | {"wall_seconds"}
    assert summary["mfu"] is None and summary["devices"] == 1
    assert any(m == "MFU: not measured (no peak rate for this device)"
               for m in log_lines)
    assert any(m.startswith("throughput: ") for m in log_lines)
    assert any(m.startswith("Accuracy is ") for m in log_lines)
    if data == "synthetic":
        assert summary["steps"] == 8 and summary["global_batch"] == 32
    else:
        assert summary["steps"] == 48 and summary["global_batch"] == 16
        assert summary["accuracy"] > 0.5, summary   # chance is 0.1
    trainer = Trainer(TrainConfig(device="cpu", data_dir=MINI_MNIST))
    assert trainer.train_ds.name == "mnist-train"
    assert type(trainer.model).__name__ == "ConvNet"
VIT_ARGS = ["--model", "vit_tiny", "--dataset", "cifar10", "--device", "cpu",
            "-b", "8", "-e", "1", "--synthetic_size", "60"]


@pytest.mark.parametrize("fused", ["auto", "on", "off"])
def test_cli_trains_vit_tiny_on_the_cpu(fused, log_lines, capsys, tmp_path):
    from ddp_practice_tpu_torch.ops import fused_encoder

    metrics = tmp_path / "m.jsonl"
    assert cli.main(VIT_ARGS + [
        "--max_steps", "3", "--log_every", "1", "--fused", fused,
        "--optimizer", "adam", "--lr", "1e-3",
        "--metrics_file", str(metrics), "--json"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(summary) == IMAGE_KEYS | {"wall_seconds"}
    assert summary["steps"] == 3 and summary["global_batch"] == 8
    assert 0.0 <= summary["accuracy"] <= 1.0
    # 60 // 6 = 10 eval images in two batches of 8: six wrapped, weight 0
    assert round(summary["accuracy"] * 10) == pytest.approx(
        summary["accuracy"] * 10)
    assert any(m.startswith("Accuracy is ") for m in log_lines)
    assert any(m.startswith("throughput: ") for m in log_lines)
    records = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert [r["kind"] for r in records] == ["train"] * 3 + ["eval",
                                                           "summary"]
    assert "perplexity" not in records[3]
    assert all(set(r) >= {"loss", "accuracy", "grad_norm"}
               for r in records[:3])
    assert fused_encoder.LAUNCHES == {"fused_encoder_fwd": 0,
                                      "fused_encoder_bwd": 0}


def test_vit_trainer_builds_the_reference_datasets():
    trainer = Trainer(TrainConfig(model="vit_tiny", dataset="cifar10",
                                  device="cpu", batch_size=8,
                                  synthetic_size=60, data_dir="/nonexistent"))
    assert trainer.task == "image"
    assert (len(trainer.train_ds), len(trainer.eval_ds)) == (60, 10)
    assert trainer.train_ds.name == "cifar10-synthetic-train"
    assert trainer.train_ds.image_shape == (32, 32, 3)
    assert (len(trainer.train_loader), len(trainer.eval_loader)) == (8, 2)
    batch = trainer._to_device(next(iter(trainer.eval_loader)))
    assert batch["image"].dtype == torch.uint8
    assert batch["label"].dtype == torch.int64
    assert batch["weight"].dtype == torch.float32
    assert trainer.model.blocks[0].fused == "auto"


@pytest.mark.parametrize("argv,match", [
    (["--model", "vit_base"], "MiB"),
    (["--model", "vit_tiny", "--num_heads", "6"], "head_dim a multiple"),
    (["--model", "vit_tiny", "--dropout", "0.1"], "plain blocks only"),
    (["--model", "lm_tiny", "--seq_len", "16"], "head_dim a multiple"),
    (["--model", "lm_base", "--seq_len", "16"], "MiB"),
    (["--model", "vit_tiny", "--remat"], "LM family"),
])
def test_fused_on_and_lm_flags_raise_where_they_cannot_run(argv, match):
    with pytest.raises(ValueError, match=match):
        cli.main(argv + ["--fused", "on", "--device", "cpu", "-b", "2",
                         "--synthetic_size", "30000", "--max_steps", "1",
                         "-e", "1"])


@pytest.mark.parametrize("field,value,item", [
    ("trace_out", "trace.json", "A6d"),
    ("slo", "slo.json", "A6d"),
])
def test_unported_fields_name_their_roadmap_item(field, value, item):
    with pytest.raises(NotImplementedError, match=f"{field}.*ROADMAP {item}"):
        TrainConfig(model="lm_tiny", device="cpu", **{field: value})


@pytest.mark.parametrize("num_classes", [10, 5, 100])
def test_num_classes_is_not_read_as_in_the_reference(num_classes):
    """The reference's loop sizes the head from the dataset and never
    reads `num_classes`; the port's does the same, whatever its value."""
    t = Trainer(TrainConfig(model="resnet18", dataset="cifar10",
                            device="cpu", synthetic_size=12, batch_size=2,
                            num_classes=num_classes))
    assert t.model.num_classes == t.train_ds.num_classes == 10


def test_each_rank_on_a_host_takes_its_own_card(monkeypatch):
    """An explicit rendezvous (no torchrun environment) spreads a host's
    ranks over its cards; torchrun's LOCAL_RANK wins when present."""
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert [dist.local_rank(r) for r in range(6)] == [0, 1, 2, 3, 0, 1]
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert dist.local_rank(5) == 2


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path is not reachable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(TrainConfig(model="lm_tiny", seq_len=16, batch_size=2))


DP = dict(device="cpu", seq_len=16, synthetic_size=20000,
          optimizer="sgd", learning_rate=0.1, max_steps_per_epoch=1,
          epochs=1, log_every_steps=0)
# run name -> config; the chunked run: 2 steps a call on host batches
DP_MODELS = {"lm_tiny": dict(model="lm_tiny"),
             "lm_moe": dict(model="lm_moe"),
             "convnet": dict(model="convnet"),
             "resnet18": dict(model="resnet18"),
             "lm_tiny_chunked": dict(model="lm_tiny", steps_per_call=2,
                                     max_steps_per_epoch=2,
                                     data_placement="host")}


def _dp_config(run, batch_size):
    return TrainConfig(**{**DP, **DP_MODELS[run], "batch_size": batch_size})


def _dp_worker(rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    dist.initialize(torch.device("cpu"), init_method=f"file://{init_file}",
                    world_size=world, rank=rank)
    try:
        # "auto" streams host batches under several processes, and
        # "device" (the whole corpus on each rank) is refused
        with pytest.raises(ValueError, match="single process"):
            Trainer(_dp_config("lm_tiny", 2).replace(
                data_placement="device"))
        for run in DP_MODELS:
            trainer = Trainer(_dp_config(run, 2))
            assert trainer.resident_train_step is None
            trainer.train_epoch(0)
            assert trainer.state.step == DP_MODELS[run].get(
                "max_steps_per_epoch", 1)
            torch.save(trainer.model.state_dict(),
                       pathlib.Path(out_dir) / f"{run}-rank{rank}.pt")
    finally:
        dist.shutdown()


GLOO_CASE = "test_two_gloo_ranks_take_the_single_process_step"


def _forkserver_context():
    # a fork server (a fresh single-threaded interpreter, so forking from
    # it is safe) imports torch and the port once and forks both ranks;
    # two spawned interpreters would each import them
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["torch._dynamo",
                                "ddp_practice_tpu_torch.train.loop"])
    return ctx


@pytest.fixture(scope="module", autouse=True)
def _warm_forkserver(request):
    """Start the gloo case's fork server at the module's first case when
    that case is collected: its imports (torch and its compiler stack,
    seconds) run in its own process while the cases before it run here,
    and the gloo case forks its ranks from a warm server."""
    if any(item.name == GLOO_CASE for item in request.session.items):
        import multiprocessing.forkserver

        _forkserver_context()
        multiprocessing.forkserver.ensure_running()
    yield


@pytest.mark.net
def test_two_gloo_ranks_take_the_single_process_step(tmp_path):
    # the ranks fork from the (warm) fork server; the single-process
    # steps run here meanwhile
    ctx = _forkserver_context()
    procs = [ctx.Process(target=_dp_worker,
                         args=(r, 2, str(tmp_path / "rdv"), str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    singles = {}
    for run in DP_MODELS:
        single = Trainer(_dp_config(run, 4))
        before = {k: v.clone() for k, v in single.model.state_dict().items()}
        single.train_epoch(0)
        singles[run] = (before, single.model.state_dict())
    for p in procs:
        p.join(timeout=120)
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    for run, (before, after) in singles.items():
        model = DP_MODELS[run]["model"]
        ranks = [torch.load(tmp_path / f"{run}-rank{r}.pt")
                 for r in range(2)]
        assert set(ranks[0]) == set(after)
        moved = 0
        for name, want in after.items():
            assert torch.equal(ranks[0][name], ranks[1][name]), name
            torch.testing.assert_close(ranks[0][name], want, rtol=1e-6,
                                       atol=1e-6, msg=name)
            moved += int(not torch.equal(want, before[name]))
        assert moved > 0
        biases = [n for n in after if n.endswith("router_bias")]
        assert len(biases) == (2 if model == "lm_moe" else 0)
        assert all(after[n].abs().sum() > 0 for n in biases)
        # SyncBN: the ranks' running statistics are the global batch's
        stats = [n for n in after if "running_" in n]
        assert len(stats) == {"convnet": 4, "resnet18": 40}.get(model, 0)
        assert all(not torch.equal(after[n], before[n]) for n in stats)
