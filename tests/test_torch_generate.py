"""The port's generation and serving from a checkpoint
(ddp_practice_tpu_torch/generate.py, serve/bench.py `--ckpt_dir`) on the
CPU, against the JAX package's generate.py:

- a checkpoint the JAX package wrote for lm_tiny (its registry widths:
  d 256, depth 4, 8 heads of 32; RoPE; AdamW after two steps; the
  manifest `extra` the reference's Trainer writes): `load_lm` rebuilds
  the model from the manifest alone, and the port's greedy tokens are
  token-identical to `ddp_practice_tpu.generate`'s, with the policy
  cache and the int8 cache. Head_dim 32 is unpackable, so both sides
  take their plain decode here; kernels A and B are held against the
  plain path on the card by chip_smoke.py at head_dim 64;
- the two CLIs print the same text (EOS truncation included);
- a checkpoint the port's own Trainer wrote (two CPU steps) generates
  what the trained model itself decodes;
- `serve/bench.py --ckpt_dir` completes every prompt with generate.py's
  greedy text; `--trace_out` on it and on the bench writes a trace that
  tools/check_traces.py accepts; both entry points run on the card
  unless asked for the CPU;
- under the bf16 policy the streaming cast (bf16 parameters, LayerNorm
  kept fp32) changes no logit;
- a non-LM checkpoint is refused.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one intra-op thread for the suite)
from _torch_port import jit_quick
from ddp_practice_tpu import checkpoint as jax_ckpt
from ddp_practice_tpu import generate as jax_generate
from ddp_practice_tpu.config import TrainConfig as JaxConfig
from ddp_practice_tpu.inference import make_generate_fn as jax_generate_fn
from ddp_practice_tpu.models import create_model as jax_create_model
from ddp_practice_tpu.train.state import create_state as jax_create_state
from ddp_practice_tpu.train.state import make_optimizer as jax_optimizer
from ddp_practice_tpu.train.steps import make_lm_train_step as jax_lm_step
from ddp_practice_tpu_torch import generate
from ddp_practice_tpu_torch.config import PrecisionPolicy, TrainConfig
from ddp_practice_tpu_torch.inference import (
    cast_params_for_streaming,
    encode_bytes,
    make_generate_fn,
)
from ddp_practice_tpu_torch.models import create_model
from ddp_practice_tpu_torch.serve import bench
from ddp_practice_tpu_torch.train.loop import Trainer
from tools.check_traces import validate

SEQ = 48
EXTRA = {"precision_policy": "fp32", "model": "lm_tiny",
         "optimizer": "adamw", "momentum": 0.0, "clip_norm": 0.0,
         "weight_decay": 0.0, "accum_steps": 1, "seq_len": SEQ,
         "vocab_size": 256, "remat": False, "pos_emb": "rope",
         "tied_embeddings": False}
PROMPTS = ["ab", "hello world"]


@pytest.fixture(scope="module")
def jax_ckpt_dir(tmp_path_factory):
    """lm_tiny written by the JAX package after two AdamW steps on a
    repeated byte motif (so greedy decoding has clear winners)."""
    kw = dict(optimizer="adamw", learning_rate=1e-2)
    jm = jax_create_model("lm_tiny", vocab_size=256, max_len=SEQ,
                          pos_emb="rope")
    tx = jax_optimizer(JaxConfig(**kw), 4)
    key = jax.random.PRNGKey(0)
    jstate = jit_quick(lambda r: jax_create_state(
        jm, tx, rng=r, sample_input=jnp.zeros((1, 8), jnp.int32)), key)(key)
    motif = np.frombuffer(b"hello world, ab ab ", np.uint8).astype(np.int32)
    batch = {"tokens": jnp.asarray(np.tile(motif, 4)[None, :33].repeat(2, 0))}
    step = jit_quick(jax_lm_step(jm, tx, seed=1), jstate, batch)
    for _ in range(2):
        jstate, _ = step(jstate, batch)
    d = str(tmp_path_factory.mktemp("jax_lm") / "ck")
    jax_ckpt.save(d, jstate, extra={**EXTRA, "step": 2})
    return d


def _jax_greedy(d, prompt, n, kv_cache):
    model, params, stats, _ = jax_generate.load_lm(d, kv_cache=kv_cache)
    args = (params, jnp.asarray(encode_bytes(prompt)), jax.random.PRNGKey(0))
    gen = jit_quick(jax_generate_fn(model, max_new_tokens=n, temperature=0.0,
                                    batch_stats=stats), *args)
    return np.asarray(gen(*args))[0].tolist()


def test_serve_ckpt_completes_every_prompt_as_generate(jax_ckpt_dir,
                                                       capsys):
    texts = []
    for prompt in PROMPTS:
        generate.main(["--ckpt_dir", jax_ckpt_dir, "--prompt", prompt,
                       "--max_new_tokens", "8", "--temperature", "0",
                       "--device", "cpu"])
        texts.append(prompt + capsys.readouterr().out[:-1])
    argv = ["--ckpt_dir", jax_ckpt_dir, "--max_new_tokens", "8",
            "--device", "cpu", "--max_slots", "2"]
    for prompt in PROMPTS:
        argv += ["--prompt", prompt]
    assert bench.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    heads = [ln for ln in lines if ln.startswith("--- request")]
    assert [h.split(" ttft")[0] for h in heads] == [
        f"--- request {i} [length]" for i in range(2)]
    for text in texts:
        assert text in lines
    assert lines[-1].startswith("[serve] ckpt step 2: 2 requests, 16 tokens")


@pytest.mark.parametrize("kv_cache", ["policy", "int8"])
def test_greedy_tokens_match_the_reference(jax_ckpt_dir, kv_cache):
    model, step = generate.load_lm(jax_ckpt_dir, device="cpu",
                                   kv_cache=kv_cache)
    assert step == 2 and model.pos_emb == "rope"
    assert (model.hidden_dim, model.depth, model.num_heads) == (256, 4, 8)
    gen = make_generate_fn(model, max_new_tokens=12, temperature=0.0)
    prompt = PROMPTS[kv_cache == "int8"]
    got = gen(torch.from_numpy(encode_bytes(prompt)).long())
    assert got[0].tolist() == _jax_greedy(jax_ckpt_dir, prompt, 12,
                                          kv_cache)


def test_the_two_clis_print_the_same_text(jax_ckpt_dir, capsys):
    argv = ["--ckpt_dir", jax_ckpt_dir, "--prompt", "hello",
            "--max_new_tokens", "10", "--temperature", "0", "--eos_id",
            "39"]
    assert jax_generate.main(argv) == 0
    want = capsys.readouterr().out
    assert generate.main(argv + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want
    assert want.strip()


@pytest.mark.parametrize("argv", [["--ckpt_dir", None], []])
def test_serve_trace_out_names_its_roadmap_item(argv, jax_ckpt_dir,
                                                tmp_path, capsys):
    """Both serve entry points, the checkpoint server and the bench,
    write a request-lifecycle trace that tools/check_traces.py accepts
    (the flag named its ROADMAP item before the recorder was ported)."""
    path = tmp_path / "t.json"
    if argv:
        argv = ["--ckpt_dir", jax_ckpt_dir, "--prompt", "ab",
                "--max_new_tokens", "4"]
    else:
        argv = ["--requests", "3", "--max-new-range", "2,12"]
    assert bench.main(argv + ["--trace_out", str(path),
                              "--device", "cpu"]) == 0
    assert "wrote trace to" in capsys.readouterr().out
    trace = json.loads(path.read_text())
    assert validate(trace) == []
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"prefill", "decode_burst", "request"} <= names


def test_a_port_written_checkpoint_generates(tmp_path, capsys):
    d = str(tmp_path / "ck")
    trainer = Trainer(TrainConfig(
        model="lm_tiny", device="cpu", seq_len=16, batch_size=2, epochs=1,
        max_steps_per_epoch=2, optimizer="adamw", learning_rate=1e-3,
        pos_emb="rope", synthetic_size=20000, log_every_steps=0,
        checkpoint_dir=d))
    trainer.fit()
    model, step = generate.load_lm(d, device="cpu")
    assert step == 2
    for name, t in trainer.model.state_dict().items():
        assert torch.equal(model.state_dict()[name], t), name
    text = "\x05\x09"        # in the synthetic corpus's vocabulary
    prompt = torch.from_numpy(encode_bytes(text)).long()
    want = make_generate_fn(trainer.model, max_new_tokens=6,
                            temperature=0.0)(prompt)
    assert generate.main(["--ckpt_dir", d, "--prompt", text,
                          "--max_new_tokens", "6", "--temperature", "0",
                          "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == bytes(want[0, 2:].tolist()).decode(
        "utf-8", errors="replace") + "\n"
    if not torch.cuda.is_available():   # the entry points default to it
        with pytest.raises(RuntimeError, match="no CUDA device"):
            generate.main(["--ckpt_dir", d, "--prompt", text])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.serve_checkpoint(d, [text])


def test_bf16_streaming_cast_changes_no_logit():
    model = create_model("lm_tiny", device="cpu", vocab_size=64,
                         max_len=16, depth=2,
                         policy=PrecisionPolicy.bf16())
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 64, (2, 12)))
    want = model(tokens)
    cast_params_for_streaming(model)
    assert model.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert model.blocks[0].ln1.weight.dtype == torch.float32
    assert torch.equal(model(tokens), want)


def test_generate_refuses_a_non_lm_checkpoint(tmp_path):
    d = str(tmp_path / "ck")
    Trainer(TrainConfig(device="cpu", synthetic_size=64, batch_size=32,
                        epochs=1, log_every_steps=0,
                        checkpoint_dir=d)).fit()
    with pytest.raises(SystemExit, match="not an LM"):
        generate.main(["--ckpt_dir", d, "--prompt", "x", "--device", "cpu"])
    with pytest.raises(SystemExit, match="no checkpoint"):
        generate.load_lm(str(tmp_path / "none"), device="cpu")
