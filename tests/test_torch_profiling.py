"""utils/profiling.py and the training loop's `--profile_dir` on the CPU
(counterparts of tests/test_trace.py's profile_region cases and of the
reference loop's traced step window):

- nested regions that both name a directory start one capture and stop it
  once, and a later region captures again; a region inside a capture that
  someone else started annotates only and does not stop it;
- a raising body propagates its own exception even when the stop fails
  too, and leaves no capture active; with a healthy body a failing stop
  raises;
- `fit` with `profile_dir` writes exactly one Kineto trace holding the
  reference's window of epoch 0 as `train#<step>` annotations: steps 0-3
  at 4 steps an epoch, 10-19 at 25; a step that raises inside the window
  still closes the trace. lm_tiny at seq 16, batch 2 (the loop tests'
  smallest LM).
"""

import json

import pytest
import torch

from ddp_practice_tpu_torch.config import TrainConfig
from ddp_practice_tpu_torch.train.loop import Trainer
from ddp_practice_tpu_torch.utils import profiling

# one intra-op thread, as tests/_torch_port.py sets for the port's other
# files: the suite runs several workers on one machine
torch.set_num_threads(1)


class FakeProfile:
    """Stands in for torch.profiler.profile: records starts and stops."""

    calls = None

    def __init__(self, activities):
        self.activities = activities

    def start(self):
        FakeProfile.calls["start"] += 1

    def stop(self):
        FakeProfile.calls["stop"] += 1
        if FakeProfile.calls["stop_error"] is not None:
            raise FakeProfile.calls["stop_error"]

    def export_chrome_trace(self, path):
        FakeProfile.calls["paths"].append(path)


@pytest.fixture
def fake_profiler(monkeypatch):
    FakeProfile.calls = {"start": 0, "stop": 0, "stop_error": None,
                         "paths": []}
    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(profiling, "_active", None)
    yield FakeProfile.calls
    assert profiling._active is None


def test_nested_regions_capture_once(fake_profiler, tmp_path):
    with profiling.profile_region("outer", str(tmp_path / "a")):
        with profiling.profile_region("inner", str(tmp_path / "b")):
            assert profiling._active is not None
        with profiling.profile_region("inner2", str(tmp_path / "c")):
            pass
    assert (fake_profiler["start"], fake_profiler["stop"]) == (1, 1)
    assert [p.split("/")[-2] for p in fake_profiler["paths"]] == ["a"]
    with profiling.profile_region("next", str(tmp_path / "d")):
        pass
    assert [p.split("/")[-2] for p in fake_profiler["paths"]] == ["a", "d"]


def test_region_inside_an_owned_capture_annotates_only(fake_profiler,
                                                       tmp_path):
    assert profiling.start_capture(str(tmp_path / "loop"))
    with profiling.profile_region("eval", str(tmp_path / "r")):
        pass
    assert fake_profiler["stop"] == 0 and profiling._active is not None
    assert profiling.stop_capture().endswith(".pt.trace.json")
    assert profiling.stop_capture() is None     # nothing active any more


def test_body_exception_is_not_masked(fake_profiler, tmp_path):
    fake_profiler["stop_error"] = RuntimeError("flush failed")
    with pytest.raises(ValueError, match="the real bug"):
        with profiling.profile_region("r", str(tmp_path)):
            raise ValueError("the real bug")
    assert fake_profiler["stop"] == 1 and profiling._active is None
    # the failed stop does not wedge later regions into annotate-only
    fake_profiler["stop_error"] = None
    with profiling.profile_region("again", str(tmp_path)):
        pass
    assert fake_profiler["start"] == 2


def test_stop_failure_alone_raises(fake_profiler, tmp_path):
    fake_profiler["stop_error"] = RuntimeError("flush failed")
    with pytest.raises(RuntimeError, match="flush failed"):
        with profiling.profile_region("r", str(tmp_path)):
            pass
    assert profiling._active is None


def _steps_in(trace_dir):
    traces = list(trace_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1, traces
    events = json.loads(traces[0].read_text())["traceEvents"]
    return sorted(int(e["name"][6:]) for e in events
                  if e.get("name", "").startswith("train#"))


def _trainer(tmp_path, steps, **kw):
    return Trainer(TrainConfig(
        model="lm_tiny", device="cpu", seq_len=16, batch_size=2, epochs=1,
        max_steps_per_epoch=steps, log_every_steps=0, synthetic_size=20000,
        profile_dir=str(tmp_path / "trace"), **kw))


@pytest.mark.parametrize("steps,window", [(4, (0, 4)), (25, (10, 20))])
def test_fit_traces_the_reference_window(tmp_path, steps, window):
    trainer = _trainer(tmp_path, steps)
    assert trainer._profile_window(0) == window
    assert trainer._profile_window(1) is None
    trainer.fit()
    assert _steps_in(tmp_path / "trace") == list(range(*window))
    assert profiling._active is None


def test_a_failing_step_closes_the_trace(tmp_path):
    """A step of the (default, device-resident) epoch fails: the trace
    closes with the steps that began."""
    trainer = _trainer(tmp_path, 4)
    assert trainer.resident_train_step is not None
    step = trainer.resident_train_step
    done = []

    def failing(state, data, grid):
        if len(done) == 2:
            raise RuntimeError("step 2 fails")
        done.append(1)
        return step(state, data, grid)

    trainer.resident_train_step = failing
    with pytest.raises(RuntimeError, match="step 2 fails"):
        trainer.train_epoch(0)
    assert profiling._active is None
    assert _steps_in(tmp_path / "trace") == [0, 1, 2]


@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_a_failing_host_step_closes_the_trace(tmp_path, steps_per_call):
    trainer = _trainer(tmp_path, 4, data_placement="host",
                       steps_per_call=steps_per_call)
    name = "chunk_step" if steps_per_call > 1 else "train_step"
    step = getattr(trainer, name)
    done = []

    def failing(state, batch):
        if len(done) * steps_per_call == 2:
            raise RuntimeError("step 2 fails")
        done.append(1)
        return step(state, batch)

    setattr(trainer, name, failing)
    with pytest.raises(RuntimeError, match="step 2 fails"):
        trainer.train_epoch(0)
    assert profiling._active is None
    # a call is annotated with its first step
    assert _steps_in(tmp_path / "trace") == list(range(0, 3,
                                                       steps_per_call))


def test_decode_profile_runs_the_generate_path_on_the_cpu():
    """experiments/decode_profile at lm_tiny on the CPU: one profiled
    generate call through `make_generate_fn`, summarised from the host's
    ops (the card run summarises device kernels instead)."""
    from ddp_practice_tpu_torch.experiments import decode_profile

    torch.set_num_threads(1)
    out = decode_profile.main(
        1, 2, model_name="lm_tiny", device="cpu", prompt_len=4, top=3,
        vocab_size=64, max_len=16, hidden_dim=128, num_heads=2, depth=1,
        mlp_dim=128)
    assert out["tokens"].shape == (1, 6)
    assert set(out["shares"]) == {"cpu_op"} and out["host_ms"] > 0
