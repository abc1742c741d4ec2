"""The sharded checkpoint (checkpoint/ `_save_sharded`, `_ShardedLeaf`):
lm_tiny trained two steps under tensor=2 x FSDP over data=2 (the ranks
as threads, tests/_torch_port.py `ranks`), then

- the save wrote `shards.<p>.npz` / `shards.<p>.json` for every rank and
  a manifest listing `sharded_leaves`, with the single-rank save's leaf
  names and whole shapes;
- one process restores it (`_assemble_shards`) equal to the sharded
  state gathered whole, and to the same two steps run unsharded;
- a target on the same mesh restores its own regions only (the
  whole-leaf assembly is stubbed to raise, as the reference's
  tests/mp_worker.py checks), and trains on as the saved run does;
- a target on another mesh (FSDP alone) and a single-rank checkpoint
  restored into a sharded target both land on the same values;
- under data 2 x seq 2 with FSDP the seq replicas write empty shard
  files, the checkpoint equals the same steps run on one rank, and a run
  resumed from it takes the unbroken run's next step;
- lm_moe at data 2 x expert 2 with FSDP (its experts cut over expert):
  one process restores the checkpoint whole (router biases included),
  equal to the same steps run on one rank, and a run resumed from it on
  the same mesh takes the unbroken run's next step;
- lm_pipe at data 2 x pipe 2 under 1F1B (its stacked blocks cut over
  pipe): the data-0 rank of each stage writes its stage's shard, one
  process restores the whole state, equal to the same steps run on one
  rank, and a run resumed on the same mesh takes the unbroken run's
  next step.
"""

import json
import os

import numpy as np
import pytest
import torch

import ddp_practice_tpu_torch.checkpoint as ckpt
from _torch_port import ranks
from ddp_practice_tpu_torch.config import MeshConfig, TrainConfig
from ddp_practice_tpu_torch.parallel.mesh import full_parameters
from ddp_practice_tpu_torch.train.loop import Trainer

GRID = dict(fsdp=True, mesh=MeshConfig(tensor=2), batch_size=2)


def _config(ckdir, **kw):
    base = dict(model="lm_tiny", device="cpu", seq_len=16, batch_size=4,
                synthetic_size=20000, optimizer="sgd", learning_rate=0.1,
                momentum=0.9, data_placement="host", log_every_steps=0,
                num_heads=4, checkpoint_dir=str(ckdir))
    return TrainConfig(**{**base, **kw})


def _steps(trainer, n, skip=0):
    """`n` train steps from the epoch's batch `skip`; the losses."""
    trainer.train_loader.set_epoch(0)
    batches = trainer._device_batches(trainer.train_loader)
    for _ in range(skip):
        next(batches)
    losses = []
    for _ in range(n):
        trainer.state, m = trainer.train_step(trainer.state, next(batches))
        losses.append(float(m["loss"]))
    return losses


def _momentum(trainer) -> dict:
    """Every momentum buffer whole, by parameter name (a collective
    under a sharded model)."""
    import torch.distributed as tdist

    from ddp_practice_tpu_torch.parallel.mesh import is_replica0, place

    opt, model = trainer.state.optimizer, trainer.model
    sharding = getattr(model, "sharding", None)
    out = {}
    for (name, p), q in zip(model.named_parameters(), opt.inner_params):
        buf = opt.inner.state[q]["momentum_buffer"]
        if sharding is None:
            out[name] = buf.clone()
            continue
        whole = torch.zeros(sharding.layouts[name].shape)
        if is_replica0(sharding, name):
            place(buf, sharding, name, whole)
        tdist.all_reduce(whole)
        out[name] = whole
    return out


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The 2 x 2 run: its checkpoint directory, its state gathered whole
    and the loss of its third step."""
    ckdir = tmp_path_factory.mktemp("sharded")

    def rank(r):
        t = Trainer(_config(ckdir, **GRID))
        _steps(t, 2)
        t.save()
        state = (full_parameters(t.model), _momentum(t))
        return state, _steps(t, 1, skip=2)

    (params, momentum), third = ranks(rank, 4)[0]
    return ckdir, params, momentum, third


def test_every_rank_writes_its_shards(saved):
    ckdir, params, _, _ = saved
    step_dir = os.path.join(ckdir, "step_2")
    for p in range(4):
        for ext in ("npz", "json"):
            assert os.path.exists(os.path.join(step_dir, f"shards.{p}.{ext}"))
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    meta = manifest["sharded_leaves"]
    names = {manifest["paths"][int(i)] for i in meta}
    assert "model.blocks.0.attn.qkv.weight" in names
    assert "optimizer.state.blocks.0.mlp.fc_in.weight.momentum_buffer" in names
    for i, m in meta.items():
        name = manifest["paths"][int(i)]
        pname = name.split(".", 1)[1] if name.startswith("model.") else \
            name[len("optimizer.state."):].rsplit(".", 1)[0]
        assert tuple(m["shape"]) == tuple(params[pname].shape), name


def test_one_process_restores_the_whole_state(saved, tmp_path):
    ckdir, params, momentum, _ = saved
    target = Trainer(_config(tmp_path))
    ckpt.restore(str(ckdir), target.state)
    assert target.state.step == 2
    for name, p in target.model.named_parameters():
        torch.testing.assert_close(p.detach(), params[name], rtol=0, atol=0)
    got = _momentum(target)
    for name in momentum:
        torch.testing.assert_close(got[name], momentum[name], rtol=0, atol=0)
    # the same two steps unsharded
    ref = Trainer(_config(tmp_path))
    _steps(ref, 2)
    for name, p in ref.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), params[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_a_sharded_target_reads_only_its_regions(saved, tmp_path,
                                                 monkeypatch):
    ckdir, params, momentum, third = saved

    def whole_leaves(*a, **k):
        raise AssertionError("a sharded target must not assemble whole "
                             "leaves")

    monkeypatch.setattr(ckpt, "_assemble_shards", whole_leaves)

    def rank(r):
        t = Trainer(_config(tmp_path, **GRID))
        ckpt.restore(str(ckdir), t.state)
        state = (full_parameters(t.model), _momentum(t))
        return state, _steps(t, 1, skip=2)

    for (got_params, got_momentum), losses in ranks(rank, 4):
        for name in params:
            torch.testing.assert_close(got_params[name], params[name],
                                       rtol=0, atol=0)
            torch.testing.assert_close(got_momentum[name], momentum[name],
                                       rtol=0, atol=0)
        assert losses == third


@pytest.mark.parametrize("source", ["sharded", "single"])
def test_restore_lays_out_onto_the_targets_mesh(saved, tmp_path, source):
    """FSDP over 2 data ranks takes the 2 x 2 checkpoint; the 2 x 2 mesh
    takes a single-rank one: each rank's regions from the same values."""
    ckdir, params, _, _ = saved
    if source == "single":
        single = Trainer(_config(tmp_path / "single"))
        ckpt.restore(str(ckdir), single.state)
        single.save()
        ckdir, grid = tmp_path / "single", GRID
    else:
        grid = dict(fsdp=True, batch_size=2)

    def rank(r):
        t = Trainer(_config(tmp_path / "target", **grid))
        ckpt.restore(str(ckdir), t.state)
        return full_parameters(t.model)

    world = 4 if grid is GRID else 2
    for got in ranks(rank, world):
        for name in params:
            torch.testing.assert_close(got[name], params[name], rtol=0,
                                       atol=0)


SEQ_GRID = dict(fsdp=True, mesh=MeshConfig(seq=2), batch_size=2)


@pytest.fixture(scope="module")
def saved_seq(tmp_path_factory):
    """data 2 x seq 2 with FSDP (ring attention): the checkpoint of two
    steps, the state gathered whole and the third step's loss."""
    ckdir = tmp_path_factory.mktemp("sharded_seq")

    def rank(r):
        t = Trainer(_config(ckdir, **SEQ_GRID))
        _steps(t, 2)
        t.save()
        state = (full_parameters(t.model), _momentum(t))
        return state, _steps(t, 1, skip=2)

    (params, momentum), third = ranks(rank, 4)[0]
    return ckdir, params, momentum, third


def test_seq_replicas_write_nothing_twice(saved_seq, tmp_path):
    """Seq rank 1 of each data replica writes empty shard files; the
    shards of the seq-0 ranks hold the run's state, which is the same
    two steps run on one rank."""
    ckdir, params, momentum, _ = saved_seq
    step_dir = os.path.join(ckdir, "step_2")
    for p in range(4):
        with np.load(os.path.join(step_dir, f"shards.{p}.npz")) as z:
            assert (len(z.files) == 0) == (p % 2 == 1), p
    target = Trainer(_config(tmp_path))
    ckpt.restore(str(ckdir), target.state)
    for name, p in target.model.named_parameters():
        torch.testing.assert_close(p.detach(), params[name], rtol=0, atol=0)
    ref = Trainer(_config(tmp_path / "ref"))
    _steps(ref, 2)
    for name, p in ref.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), params[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_a_seq_sharded_run_resumes_as_unbroken(saved_seq, tmp_path):
    ckdir, params, momentum, third = saved_seq

    def rank(r):
        t = Trainer(_config(tmp_path, **SEQ_GRID))
        ckpt.restore(str(ckdir), t.state)
        state = (full_parameters(t.model), _momentum(t))
        return state, _steps(t, 1, skip=2)

    for (got_params, got_momentum), losses in ranks(rank, 4):
        for name in params:
            torch.testing.assert_close(got_params[name], params[name],
                                       rtol=0, atol=0)
            torch.testing.assert_close(got_momentum[name], momentum[name],
                                       rtol=0, atol=0)
        assert losses == third


EXPERT_GRID = dict(model="lm_moe", num_experts=4, fsdp=True,
                   mesh=MeshConfig(expert=2), batch_size=2)


@pytest.fixture(scope="module")
def saved_expert(tmp_path_factory):
    """lm_moe at data 2 x expert 2 with FSDP (the experts cut over expert,
    FSDP's data cut on a free dim): the checkpoint of two steps, the state
    and router biases gathered whole, and the third step's loss."""
    ckdir = tmp_path_factory.mktemp("sharded_expert")

    def rank(r):
        t = Trainer(_config(ckdir, **EXPERT_GRID))
        _steps(t, 2)
        t.save()
        state = (full_parameters(t.model), _momentum(t),
                 {n: b.clone() for n, b in t.model.named_buffers()})
        return state, _steps(t, 1, skip=2)

    (params, momentum, buffers), third = ranks(rank, 4)[0]
    return ckdir, params, momentum, buffers, third


def test_an_expert_cut_checkpoint_restores_whole(saved_expert, tmp_path):
    """One process restores the expert-cut checkpoint to the sharded
    state gathered whole, router biases included, which is the same two
    steps run on one rank."""
    ckdir, params, momentum, buffers, _ = saved_expert
    one = dict(model="lm_moe", num_experts=4)
    target = Trainer(_config(tmp_path, **one))
    ckpt.restore(str(ckdir), target.state)
    for name, p in target.model.named_parameters():
        torch.testing.assert_close(p.detach(), params[name], rtol=0, atol=0)
    got = _momentum(target)
    for name in momentum:
        torch.testing.assert_close(got[name], momentum[name], rtol=0, atol=0)
    for name, b in target.model.named_buffers():
        torch.testing.assert_close(b, buffers[name], rtol=0, atol=0)
    ref = Trainer(_config(tmp_path / "ref", **one))
    _steps(ref, 2)
    for name, p in ref.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), params[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_an_expert_cut_run_resumes_as_unbroken(saved_expert, tmp_path):
    ckdir, params, momentum, buffers, third = saved_expert

    def rank(r):
        t = Trainer(_config(tmp_path, **EXPERT_GRID))
        ckpt.restore(str(ckdir), t.state)
        assert t.model.blocks[1].moe.ep.size == 2
        state = (full_parameters(t.model), _momentum(t))
        return state, _steps(t, 1, skip=2)

    for (got_params, got_momentum), losses in ranks(rank, 4):
        for name in params:
            torch.testing.assert_close(got_params[name], params[name],
                                       rtol=0, atol=0)
            torch.testing.assert_close(got_momentum[name], momentum[name],
                                       rtol=0, atol=0)
        assert losses == third


PIPE_GRID = dict(model="lm_pipe", mesh=MeshConfig(pipe=2), batch_size=2,
                 pipe_schedule="1f1b", num_microbatches=2)


@pytest.fixture(scope="module")
def saved_pipe(tmp_path_factory):
    """lm_pipe at data 2 x pipe 2 under 1F1B (the stacked blocks cut over
    pipe, each stage writing its own): the checkpoint of two steps, the
    state gathered whole and the third step's loss."""
    ckdir = tmp_path_factory.mktemp("sharded_pipe")

    def rank(r):
        t = Trainer(_config(ckdir, **PIPE_GRID))
        _steps(t, 2)
        t.save()
        state = (full_parameters(t.model), _momentum(t))
        return state, _steps(t, 1, skip=2)

    (params, momentum), third = ranks(rank, 4)[0]
    return ckdir, params, momentum, third


def test_a_pipe_cut_checkpoint_restores_whole(saved_pipe, tmp_path):
    """The data-0 rank of each stage writes its stage's rows of every
    stacked leaf; one process restores the whole state, which is the
    same two steps run on one rank (GPipe, no stages)."""
    ckdir, params, momentum, _ = saved_pipe
    step_dir = os.path.join(ckdir, "step_2")
    for p in range(4):
        with np.load(os.path.join(step_dir, f"shards.{p}.npz")) as z:
            assert (len(z.files) > 0) == (p < 2), p
    target = Trainer(_config(tmp_path, model="lm_pipe"))
    ckpt.restore(str(ckdir), target.state)
    for name, p in target.model.named_parameters():
        torch.testing.assert_close(p.detach(), params[name], rtol=0, atol=0)
    got = _momentum(target)
    for name in momentum:
        torch.testing.assert_close(got[name], momentum[name], rtol=0, atol=0)
    ref = Trainer(_config(tmp_path / "ref", model="lm_pipe"))
    _steps(ref, 2)
    for name, p in ref.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), params[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_a_pipe_cut_run_resumes_as_unbroken(saved_pipe, tmp_path):
    ckdir, params, momentum, third = saved_pipe

    def rank(r):
        t = Trainer(_config(tmp_path, **PIPE_GRID))
        ckpt.restore(str(ckdir), t.state)
        assert t.model.pipe.size == 2
        state = (full_parameters(t.model), _momentum(t))
        return state, _steps(t, 1, skip=2)

    for (got_params, got_momentum), losses in ranks(rank, 4):
        for name in params:
            torch.testing.assert_close(got_params[name], params[name],
                                       rtol=0, atol=0)
            torch.testing.assert_close(got_momentum[name], momentum[name],
                                       rtol=0, atol=0)
        assert losses == third
