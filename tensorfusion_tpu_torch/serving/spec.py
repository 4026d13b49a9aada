"""Draft models for speculative decoding: the port of
``tensorfusion_tpu/serving/spec.py``.

The engine's speculative path is draft-agnostic: anything with
``propose(context, k) -> tokens`` can drive it, because greedy-exact
accept/reject (``engine._spec_decode``) makes the OUTPUT independent of
draft quality — a bad draft only costs verify FLOPs, never a changed
token.  Three drafts ship, selected by :func:`make_draft`:

- :class:`NGramDraft` — prompt-lookup decoding: propose the
  continuation that followed the most recent earlier occurrence of the
  current tail n-gram.  Dependency-free, zero weights.
- :class:`ArithmeticDraft` — wraps a :class:`~.runner.FakeRunner`-style
  arithmetic target with a dialable per-token hit rate (``accuracy=1``
  forces 100% accept, ``accuracy=0`` forces 0%).
- :class:`LlamaDraft` — a small llama of ``models/llama.py`` run
  statelessly over a bounded context window per proposal round.

:class:`ReplayDraft` replays known continuations (the forced-100%
regime on a real runner).  The first three are copies of the
reference's; :class:`LlamaDraft` runs the port's ``prefill`` and
``decode_step``.
"""

from __future__ import annotations

import hashlib
import struct
from typing import List, Optional, Sequence

import torch

from ..models import llama


class NGramDraft:
    """Prompt-lookup draft: match the last ``n``-gram of the context
    against its earlier occurrences and propose what followed the most
    recent one.  Falls back to shorter grams down to 1; proposes
    nothing when even the last token never occurred before (the engine
    then takes a plain decode step for that sequence)."""

    def __init__(self, n: int = 3, max_scan: int = 96):
        self.n = max(1, int(n))
        #: only the trailing window is scanned — proposal cost must
        #: stay O(window), not O(context): this python scan runs per
        #: sequence per step, and at tiny-model launch times a wide
        #: window costs more than the verify it feeds
        self.max_scan = max(self.n + 1, int(max_scan))

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        ctx = list(context[-self.max_scan:])
        for n in range(min(self.n, len(ctx) - 1), 0, -1):
            tail = ctx[-n:]
            # most recent earlier occurrence wins; a match at distance
            # p from the tail is treated as a period-p pattern and
            # extrapolated for the full k (a match overlapping the
            # tail — e.g. a constant run — is the common looping case
            # and must not truncate the proposal)
            for start in range(len(ctx) - n - 1, -1, -1):
                if ctx[start:start + n] == tail:
                    period = len(ctx) - n - start
                    ext = list(ctx)
                    out: List[int] = []
                    for _ in range(k):
                        out.append(int(ext[len(ext) - period]))
                        ext.append(out[-1])
                    return out
        return []


class ArithmeticDraft:
    """Deterministic dialable-accuracy draft for the arithmetic
    :class:`~.runner.FakeRunner` target: per proposed token, a seeded
    hash of (position, previous token) decides whether to emit the
    true next token or a guaranteed miss."""

    def __init__(self, runner, accuracy: float = 1.0, seed: int = 0):
        self.runner = runner
        self.accuracy = min(1.0, max(0.0, float(accuracy)))
        self.seed = int(seed)

    def _hit(self, token: int, pos: int) -> bool:
        if self.accuracy >= 1.0:
            return True
        if self.accuracy <= 0.0:
            return False
        h = hashlib.blake2b(struct.pack("<qqq", self.seed, token, pos),
                            digest_size=4)
        return int.from_bytes(h.digest(), "little") / 0xFFFFFFFF \
            < self.accuracy

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        out: List[int] = []
        tok = int(context[-1])
        pos = len(context) - 1
        for _ in range(k):
            true = self.runner._next(tok, pos)
            tok = true if self._hit(tok, pos) else \
                (true + 1) % self.runner.vocab
            out.append(tok)
            pos += 1
        return out


class ReplayDraft:
    """Oracle draft for the forced-100% regime on a REAL runner: it
    replays known greedy continuations (e.g. a baseline run's outputs)
    keyed by prompt, so every proposal is accepted and the verify
    path's mechanical throughput ceiling — (k+1) tokens per launch —
    is measurable without a second model.  A context it does not know
    gets no proposal (plain decode)."""

    def __init__(self, streams: Optional[dict] = None):
        #: prompt tuple -> full greedy continuation
        self.streams = dict(streams or {})

    def record(self, prompt: Sequence[int],
               tokens: Sequence[int]) -> None:
        self.streams[tuple(int(t) for t in prompt)] = \
            [int(t) for t in tokens]

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        ctx = [int(t) for t in context]
        for plen in range(len(ctx), 0, -1):
            stream = self.streams.get(tuple(ctx[:plen]))
            if stream is None:
                continue
            done = len(ctx) - plen
            if ctx[plen:] == stream[:done]:
                return stream[done:done + k]
        return []


class LlamaDraft:
    """Small-model draft: greedy-decode ``k`` tokens with a (smaller)
    llama over the trailing ``window`` of the context, on the device of
    its parameters.  Stateless — every round prefills its window from
    scratch into a private contiguous cache, so preemption/CoW on the
    target never desyncs it."""

    def __init__(self, params, config, window: int = 64):
        self.params = params
        self.config = config
        self.window = max(8, int(window))

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        if len(context) < self.window:
            # one fixed window keeps every round the same shape; short
            # contexts take plain decode steps instead
            return []
        dev = self.params["tok_emb"].device
        ctx = [int(t) for t in context[-self.window:]]
        logits, cache = llama.prefill(
            self.params, torch.tensor([ctx], dtype=torch.int32, device=dev),
            self.config, cache_len=self.window + 32)
        out: List[int] = []
        tok = int(torch.argmax(logits[0]))
        out.append(tok)
        pos = len(ctx)
        for _ in range(k - 1):
            logits, cache = llama.decode_step(
                self.params, torch.tensor([tok], dtype=torch.int32, device=dev),
                cache, pos, self.config)
            tok = int(torch.argmax(logits[0]))
            out.append(tok)
            pos += 1
        return out


def make_draft(kind: str, target_runner=None, params=None, config=None,
               accuracy: float = 1.0, seed: int = 0,
               ngram: int = 3) -> Optional[object]:
    """The draft-selection knob: ``"none"`` |
    ``"ngram"`` | ``"arith"`` | ``"model"``."""
    kind = (kind or "none").lower()
    if kind == "none":
        return None
    if kind == "ngram":
        return NGramDraft(n=ngram)
    if kind == "arith":
        if target_runner is None:
            raise ValueError("arith draft needs the FakeRunner target")
        return ArithmeticDraft(target_runner, accuracy=accuracy,
                               seed=seed)
    if kind == "model":
        if params is None or config is None:
            raise ValueError("model draft needs params + config")
        return LlamaDraft(params, config)
    raise ValueError(f"unknown draft kind {kind!r}")
