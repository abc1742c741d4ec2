"""Draft-free speculative decoding: prompt-lookup draft proposals
(counterpart of ddp_practice_tpu/serve/spec.py; host-pure, copied).

A cheap drafter proposes the next k tokens; the model scores the whole
drafted window in one forward and accepts the longest prefix that matches
its own argmaxes, plus one corrected token (`PagedEngine.step_verify`).
Under greedy decoding the emitted stream is identical to plain decode:
speculation is a latency lever, never a quality knob.

`PromptLookupDraft` matches the trailing n-gram of a request's context
(prompt + generated tokens) against earlier occurrences in that same
context and proposes what followed the most recent one. Everything here
is host-pure Python: drafting costs microseconds, not a dispatch, and a
wrong draft costs only verify work, never a wrong token.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


class DraftSource:
    """What the engine needs from a drafter: per-slot context tracking
    plus a `propose` that returns up to k candidate next tokens.

    Lifecycle (driven by PagedEngine): `begin(slot, prompt)` at
    admission (readmission after preemption passes prompt + salvaged
    tokens — the drafter never needs to survive a preempt), `extend`
    with every emitted token run, `end(slot)` at release/preempt.
    Slots are dense small ints, reused after release.
    """

    def begin(self, slot: int, context: Sequence[int]) -> None:
        raise NotImplementedError

    def extend(self, slot: int, tokens: Sequence[int]) -> None:
        raise NotImplementedError

    def propose(self, slot: int, k: int) -> List[int]:
        """Up to k draft tokens for the slot's NEXT positions ([] = no
        proposal this step; the engine then falls back to plain
        decode for the slot — one real token, zero waste)."""
        raise NotImplementedError

    def end(self, slot: int) -> None:
        raise NotImplementedError

    def snapshot(self, slot: int) -> List[int]:
        """The slot's tracked context, for seeding a fork sibling's
        drafter state (`PagedEngine.fork`). Drafters that keep no
        replayable context may return [] — proposals are hints, so a
        cold-started sibling costs acceptance, never correctness."""
        return []


class PromptLookupDraft(DraftSource):
    """N-gram prompt-lookup drafter with an incremental index.

    Per slot it keeps the full context (prompt + generated) and, for
    each n in [ngram_min, ngram_max], a dict mapping every n-gram seen
    so far to the position RIGHT AFTER its most recent occurrence
    (insertion order means later occurrences overwrite earlier ones —
    recency wins, matching the intuition that the latest use of a
    phrase predicts its next continuation best). `propose` looks up the
    context's trailing n-gram, longest n first, and returns the tokens
    that followed the match — then CHAINS: the draft's own tail becomes
    the next lookup gram, so a match near the context's end (where the
    raw continuation would truncate after a token or two) keeps
    extending through the repetition until k tokens are drafted or no
    gram matches. On self-repeating text — quoted spans, cycles, the
    lookup drafter's whole hunting ground — chaining is the difference
    between 2-token and full-k drafts, and verify amortizes its fixed
    two-apply dispatch over k+1 tokens instead of 3.

    The index grows by one dict entry per (token, n) — `extend` is
    O(len(tokens) * n_sizes), `propose` is O(k * n_sizes) — so drafting
    stays far below dispatch cost however long contexts get. A gram
    ending at the context's last token is NOT yet indexed (its
    continuation hasn't happened), which is what keeps `propose` from
    matching the trailing gram against itself.
    """

    def __init__(self, ngram_max: int = 3, ngram_min: int = 1) -> None:
        if ngram_min < 1 or ngram_max < ngram_min:
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max, got "
                f"[{ngram_min}, {ngram_max}]"
            )
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min
        self._ctx: Dict[int, List[int]] = {}
        # slot -> {n -> {gram tuple -> continuation position}}
        self._index: Dict[int, Dict[int, Dict[Tuple[int, ...], int]]] = {}

    # ------------------------------------------------------------ lifecycle
    def begin(self, slot: int, context: Sequence[int]) -> None:
        self._ctx[slot] = []
        self._index[slot] = {
            n: {} for n in range(self.ngram_min, self.ngram_max + 1)
        }
        self.extend(slot, context)

    def extend(self, slot: int, tokens: Sequence[int]) -> None:
        ctx = self._ctx[slot]
        index = self._index[slot]
        for tok in tokens:
            i = len(ctx)  # the new token's position
            # the arrival of token i completes the continuation of
            # every gram ENDING at i-1: register gram -> i
            for n, grams in index.items():
                if i >= n:
                    grams[tuple(ctx[i - n:i])] = i
            ctx.append(int(tok))

    def end(self, slot: int) -> None:
        self._ctx.pop(slot, None)
        self._index.pop(slot, None)

    # -------------------------------------------------------------- drafting
    def propose(self, slot: int, k: int) -> List[int]:
        ctx = self._ctx.get(slot)
        if ctx is None or k <= 0:
            return []
        index = self._index[slot]
        draft: List[int] = []
        while len(draft) < k:
            # the lookup tail spans ctx + draft-so-far; only its last
            # ngram_max tokens can matter, so no full-context copies
            tail = (ctx[max(0, len(ctx) - self.ngram_max):] + draft)[
                -self.ngram_max:]
            total = len(ctx) + len(draft)
            nxt: List[int] = []
            for n in range(self.ngram_max, self.ngram_min - 1, -1):
                if total < n:
                    continue
                pos = index[n].get(tuple(tail[-n:]))
                if pos is None:
                    continue
                # pos <= len(ctx) - 1 always (a gram ending at the last
                # token has no continuation yet), so this is non-empty
                nxt = ctx[pos:pos + (k - len(draft))]
                break
            if not nxt:
                break
            draft.extend(nxt)
        return draft

    # ------------------------------------------------------------- observers
    def snapshot(self, slot: int) -> List[int]:
        return list(self._ctx.get(slot, []))

    def context_len(self, slot: int) -> int:
        """Tracked context length (tests; -1 for an unknown slot)."""
        ctx = self._ctx.get(slot)
        return -1 if ctx is None else len(ctx)
