"""The port's training loop (ddp_practice_tpu_torch/train/loop.py and
cli.py) on the CPU:

- the CLI trains lm_tiny (the registry's own size; the reference's parser
  has no depth flag) at seq 32, batch 4, for 3 steps with the flash path's
  plain version, prints the reference's three parity lines, and its JSON
  summary has the reference `_fit_inner`'s keys;
- model names and flags this slice does not port raise
  NotImplementedError naming their ROADMAP item, and the card is the
  default device;
- data parallelism: two gloo processes at per-rank batch 2 take the same
  step as one process at batch 4 (1e-6) and stay bit-identical replicas.
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


@pytest.mark.parametrize("argv,item", [
    (["--model", "convnet"], "A1"),
    (["--model", "lm_moe"], "A7"),
    (["--model", "lm_tiny", "--steps_per_call", "4"], "A3"),
    (["--model", "lm_tiny", "--data_placement", "device"], "A3"),
    (["--model", "lm_tiny", "--ckpt_dir", "ck"], "A1"),
    (["--model", "lm_tiny", "--fused", "on"], "B2"),
    (["--model", "lm_tiny", "--tensor", "2"], "A8"),
    (["--model", "lm_tiny", "--compile_cache", "off"], "A3"),
    (["--model", "lm_tiny", "--loader", "native"], "A1"),
    (["--model", "lm_tiny", "--ckpt_sync"], "A1"),
])
def test_unported_paths_name_their_roadmap_item(argv, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        cli.main(argv + ["--device", "cpu", "--seq_len", "16", "-b", "2"])


@pytest.mark.parametrize("field,value,item", [
    ("num_classes", 100, "A1"),
    ("watchdog_probe_every_steps", 10, "A8"),
    ("resident_max_bytes", 1 << 20, "A3"),
])
def test_unported_fields_name_their_roadmap_item(field, value, item):
    with pytest.raises(NotImplementedError, match=f"{field}.*ROADMAP {item}"):
        TrainConfig(model="lm_tiny", device="cpu", **{field: value})


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


DP = dict(model="lm_tiny", device="cpu", seq_len=16, synthetic_size=20000,
          optimizer="sgd", learning_rate=0.1, max_steps_per_epoch=1,
          epochs=1, log_every_steps=0)


def _dp_worker(rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    dist.initialize(torch.device("cpu"), init_method=f"file://{init_file}",
                    world_size=world, rank=rank)
    try:
        trainer = Trainer(TrainConfig(batch_size=2, **DP))
        trainer.train_epoch(0)
        torch.save(trainer.model.state_dict(),
                   pathlib.Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.shutdown()


@pytest.mark.net
def test_two_gloo_ranks_take_the_single_process_step(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_dp_worker,
                         args=(r, 2, str(tmp_path / "rdv"), str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    single = Trainer(TrainConfig(batch_size=4, **DP))
    before = {k: v.clone() for k, v in single.model.state_dict().items()}
    single.train_epoch(0)
    moved = 0
    for name, want in single.model.state_dict().items():
        assert torch.equal(ranks[0][name], ranks[1][name]), name
        torch.testing.assert_close(ranks[0][name], want, rtol=1e-6,
                                   atol=1e-6, msg=name)
        moved += int(not torch.equal(want, before[name]))
    assert moved > 0
