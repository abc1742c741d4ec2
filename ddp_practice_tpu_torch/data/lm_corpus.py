"""Token corpora and the LM data loader (a copy of
ddp_practice_tpu/data/lm_corpus.py: the same tokens and the same windows
per (seed, epoch, shard); the port imports nothing of the JAX package).

The reference has no text path at all (MNIST CNN, origin_main.py:9-31);
this module gives the decoder LM family (models/lm.py) the same data
contract the image loaders give the CNNs: deterministic (seed, epoch)
epoch plans, per-process shards, and dict batches for the train steps.

Two corpus sources:
- **bytes files** (`load_text_corpus`): any file(s) become a byte-level
  corpus (vocab 256) — no tokenizer, no network, works on whatever text
  the machine has.
- **synthetic Markov** (`synthetic_token_corpus`): a seeded order-1
  Markov chain over a small vocab with sparse transitions — structured
  enough that next-token loss collapses well below the uniform entropy
  within an epoch, so e2e training has a testable contract.

Batches are non-overlapping (seq_len + 1) windows (position t predicts
t + 1, train/steps.py make_lm_train_step); the epoch permutation shuffles
window order, keyed on (seed, epoch) like the image sampler
(data/sharding.py, ≡ sampler.set_epoch ddp_main.py:160).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

from ddp_practice_tpu_torch.data.sharding import ShardSpec, epoch_indices


class TokenCorpus:
    """A flat token stream (1D integer array) plus its vocab size."""

    def __init__(self, tokens: np.ndarray, vocab_size: int, name: str = "tokens"):
        tokens = np.asarray(tokens)
        if tokens.ndim != 1:
            raise ValueError(f"tokens must be 1D, got {tokens.shape}")
        if tokens.dtype not in (np.uint8, np.uint16, np.int32):
            raise ValueError(f"unsupported token dtype {tokens.dtype}")
        self.tokens = tokens
        self.vocab_size = int(vocab_size)
        self.name = name

    def __len__(self) -> int:
        return len(self.tokens)

    def windows(self, seq_len: int) -> np.ndarray:
        """Non-overlapping (n_windows, seq_len + 1) int32 training windows
        (inputs + shifted targets). The device-resident random-draw
        convention shared by the MoE bench, the balance test, and the
        experiments (one source so the windowing can never drift)."""
        window = seq_len + 1
        n_win = len(self.tokens) // window
        return np.asarray(
            self.tokens[: n_win * window], np.int32
        ).reshape(n_win, window)


def load_text_corpus(path: str, name: Optional[str] = None) -> TokenCorpus:
    """Byte-level corpus from one file or every regular file in a
    directory (sorted for determinism)."""
    paths = []
    if os.path.isdir(path):
        for root, _, files in sorted(os.walk(path)):
            paths.extend(os.path.join(root, f) for f in sorted(files))
    else:
        paths = [path]
    chunks = []
    for p in paths:
        try:
            with open(p, "rb") as f:
                chunks.append(np.frombuffer(f.read(), dtype=np.uint8))
        except OSError:
            continue
    if not chunks:
        raise FileNotFoundError(f"no readable files under {path!r}")
    return TokenCorpus(
        np.concatenate(chunks), 256, name=name or f"bytes:{os.path.basename(path)}"
    )


def synthetic_token_corpus(
    n_tokens: int = 262144, *, vocab_size: int = 64, seed: int = 3407,
    branching: int = 4,
) -> TokenCorpus:
    """Order-1 Markov chain: each token has `branching` permitted
    successors with a shared skewed distribution — entropy well below
    log(vocab), so a trained LM's perplexity must drop far under uniform."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x7E47]))
    successors = np.stack([
        rng.choice(vocab_size, size=branching, replace=False)
        for _ in range(vocab_size)
    ])
    probs = rng.dirichlet(np.full(branching, 0.4))
    walk = np.empty(n_tokens, dtype=np.uint16 if vocab_size > 256 else np.uint8)
    state = int(rng.integers(vocab_size))
    choices = rng.choice(branching, size=n_tokens, p=probs)
    for i in range(n_tokens):
        walk[i] = state
        state = int(successors[state, choices[i]])
    return TokenCorpus(walk, vocab_size, name=f"markov{vocab_size}")


class LMDataLoader:
    """Yields {"tokens": (local_batch, seq_len + 1) int32} batches.

    Non-overlapping windows; window order is a (seed, epoch)-keyed global
    permutation; each process takes a contiguous slice of every global
    batch (the image DataLoader's sharding contract, data/loader.py).
    Trailing windows that don't fill a global batch are dropped (standard
    LM practice — the stream has no sample boundary to pad against).
    """

    def __init__(
        self,
        corpus: TokenCorpus,
        *,
        seq_len: int,
        global_batch_size: int,
        shard: Optional[ShardSpec] = None,
        seed: int = 3407,
        shuffle: bool = True,
    ):
        self.corpus = corpus
        self.seq_len = int(seq_len)
        self.global_batch_size = int(global_batch_size)
        self.shard = shard or ShardSpec()
        self.seed = seed
        self.shuffle = shuffle
        self._epoch = 0
        self.window = self.seq_len + 1
        self.num_windows = len(corpus) // self.window
        if self.num_windows < self.global_batch_size:
            raise ValueError(
                f"corpus has {self.num_windows} windows of {self.window} "
                f"tokens — fewer than one global batch "
                f"({self.global_batch_size}); shrink seq_len/batch or grow "
                "the corpus"
            )

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    @property
    def steps_per_epoch(self) -> int:
        return self.num_windows // self.global_batch_size

    def __len__(self) -> int:
        return self.steps_per_epoch

    def epoch_plan(self):
        """(starts, None): a (steps, global_batch) int32 grid of token
        START offsets for the device-resident driver — the same
        (seed, epoch)-keyed window order __iter__ streams, as offsets the
        on-device gather consumes (tokens[start : start + seq_len + 1]).
        The second element keeps the image DataLoader.epoch_plan interface
        (its eval weights); LM drops trailing windows instead of padding,
        so there is nothing to weight."""
        order = epoch_indices(
            self.num_windows, seed=self.seed, epoch=self._epoch,
            shuffle=self.shuffle,
        )
        usable = self.steps_per_epoch * self.global_batch_size
        starts = order[:usable].reshape(
            self.steps_per_epoch, self.global_batch_size
        ) * self.window
        return starts.astype(np.int32), None

    def __iter__(self) -> Iterator[dict]:
        order = epoch_indices(
            self.num_windows, seed=self.seed, epoch=self._epoch,
            shuffle=self.shuffle,
        )
        usable = self.steps_per_epoch * self.global_batch_size
        order = order[:usable]
        sl = self.shard.local_slice(self.global_batch_size)
        w = self.window
        toks = self.corpus.tokens
        for start in range(0, usable, self.global_batch_size):
            widx = order[start : start + self.global_batch_size][sl]
            batch = np.stack([toks[i * w : (i + 1) * w] for i in widx])
            yield {"tokens": batch.astype(np.int32)}
