"""Model runners: the engine's device-side contract (the port of
``tensorfusion_tpu/serving/runner.py``).

The engine (``serving/engine.py``) schedules *tokens*; a runner turns
scheduled work into next tokens against the paged pool it owns:

- ``block_size`` / ``num_blocks`` — the pool geometry the engine's
  :class:`~.kvpool.BlockAccount` mirrors; ``nbytes`` — its footprint;
- ``prefill(tokens, table, start_pos, last)`` — one prompt chunk of
  ONE sequence into its pages; returns the first generated token when
  ``last`` (greedy argmax over the final position's logits);
- ``decode(tokens, positions, tables)`` — one fused decode step for
  the whole batch; returns each sequence's next token;
- ``verify(tokens, positions, tables)`` — one fused speculative-verify
  step: ``S`` tokens per sequence, returns the ``[B][S]`` greedy
  targets the engine accepts draft proposals against;
- ``copy_blocks(pairs)`` — page copies for the account's copy-on-write
  prefix sharing (``(src, dst)`` per pair);
- ``read_blocks(ids)`` / ``write_blocks(ids, k, v)`` — extract / inject
  whole pages, the disaggregated-prefill path (``serving/disagg.py``;
  storage-free runners return ``(None, None)``).

:class:`LlamaRunner` is the real thing (torch, ``kvpool`` paged
attention, one CUDA graph per decode and verify bucket on the card);
:class:`FakeRunner` is a dependency-free deterministic stepper that the
engine's tests drive.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DEVICE_GATE, DeviceLike, resolve_device
from . import kvpool


@dataclasses.dataclass
class StepGraph:
    """One captured bucket: the static int32 inputs the graph reads, the
    int32 greedy tokens it writes, and the graph."""

    inputs: List[torch.Tensor]
    out: torch.Tensor
    graph: "torch.cuda.CUDAGraph"


class LlamaRunner:
    """Paged-cache serving runner for the llama flagship.

    Owns the pool (``kvpool.init_paged_cache`` on ``device``, where the
    parameters must live) and, on the card, one captured CUDA graph per
    step bucket — the counterpart of the reference's compile cache:
    decode per ``(batch bucket, table-width bucket)``, verify per
    ``(batch bucket, S, table-width bucket)``, both powers of two (pad
    rows scatter into the reserved scratch block and their outputs are
    dropped).  Each graph runs the greedy argmax inside, so only int32
    tokens cross to the host per step.  Prefill chunks vary in length
    with every prompt and run eagerly.  On the CPU every step runs
    eagerly.

    Graphs are captured lazily on the calling thread, or up front by
    :meth:`warmup`.  A capture must not overlap work that another thread
    launches on the card: every runner's eager calls (``prefill`` and the
    page moves), the remote worker's device work (``remoting/worker.py``)
    and every capture pass one process-wide gate (:data:`~..device.DEVICE_GATE`), so a
    capture waits for the eager calls in flight, and holds new ones off
    until it is done (a threaded ``PrefillPool`` prefills on its own
    runners while the engine's stepper captures a verify bucket or a
    wider decode bucket lazily).  A failed capture raises; nothing falls
    back to eager steps.
    All of a runner's graphs share one memory pool: their inputs and
    outputs live outside it, and a step reads its tokens right after its
    replay, so one graph's scratch may reuse another's.  The pool and the
    parameters are written and read in place and never rebound, since a
    graph holds their storage.
    """

    def __init__(self, params: Dict, config, num_blocks: int = 64,
                 block_size: int = 8, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        emb = params["tok_emb"].device
        if emb.type != self.device.type:
            raise ValueError(f"parameters are on {emb}, the runner was "
                             f"asked to run on {self.device}")
        self.params = params
        self.config = config
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.cache = kvpool.init_paged_cache(config, num_blocks, block_size,
                                             device=emb)
        self.nbytes = kvpool.paged_cache_nbytes(config, num_blocks,
                                                block_size)
        #: captured buckets: ("decode", b, m) / ("verify", b, s, m)
        self.graphs: Dict[Tuple, StepGraph] = {}
        self.capture_s = 0.0
        self._pool = None

    # -- steps ------------------------------------------------------------

    def _decode_greedy(self, tok, tab, pos):
        logits, _ = kvpool.paged_decode_step(self.params, tok, self.cache,
                                             tab, pos, self.config)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def _verify_greedy(self, tok, tab, pos):
        logits, _ = kvpool.paged_verify_step(self.params, tok, self.cache,
                                             tab, pos, self.config)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def _run(self, key: Tuple, fn, arrays: List[np.ndarray]) -> np.ndarray:
        """``fn`` on ``arrays`` (int32, the step's padded inputs): eagerly
        on the CPU, else through the bucket's graph."""
        if self.device.type != "cuda":
            return fn(*(torch.from_numpy(a) for a in arrays)).numpy()
        g = self.graphs.get(key) or self._capture(key, fn, arrays)
        for buf, a in zip(g.inputs, arrays):
            buf.copy_(torch.from_numpy(a))
        g.graph.replay()
        return g.out.cpu().numpy()

    def _capture(self, key: Tuple, fn, arrays: List[np.ndarray]) -> StepGraph:
        """Capture ``fn`` for the bucket of ``arrays``' shapes.  Its static
        inputs are zeros while it warms up (one eager run on a side
        stream, as capture needs), so that run writes only into scratch
        block 0."""
        t0 = time.perf_counter()
        with DEVICE_GATE.exclusive():
            inputs = [torch.zeros(a.shape, dtype=torch.int32,
                                  device=self.device) for a in arrays]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                out = torch.zeros_like(fn(*inputs))
            torch.cuda.current_stream().wait_stream(side)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool):
                out.copy_(fn(*inputs))
        g = StepGraph(inputs=inputs, out=out, graph=graph)
        self.graphs[key] = g
        self.capture_s += time.perf_counter() - t0
        return g

    @staticmethod
    def _pad_tables(tables: List[List[int]], b: int) -> np.ndarray:
        m = kvpool.pow2_bucket(max(len(t) for t in tables), lo=4)
        tab = np.zeros((b, m), np.int32)
        for i, t in enumerate(tables):
            tab[i, :len(t)] = t
        return tab

    # -- engine contract --------------------------------------------------

    def prefill(self, tokens: List[int], table: List[int],
                start_pos: int, last: bool = True) -> Optional[int]:
        dev = self.params["tok_emb"].device
        m = kvpool.pow2_bucket(len(table), lo=4)
        tab = torch.zeros((m,), dtype=torch.int32)
        tab[:len(table)] = torch.tensor(table, dtype=torch.int32)
        with DEVICE_GATE.shared():
            logits, _ = kvpool.paged_prefill_chunk(
                self.params, torch.tensor(tokens, dtype=torch.int32, device=dev),
                self.cache, tab.to(dev), start_pos, self.config)
            return int(torch.argmax(logits)) if last else None

    def decode(self, tokens: List[int], positions: List[int],
               tables: List[List[int]]) -> List[int]:
        b = len(tokens)
        bp = kvpool.pow2_bucket(b)
        tab = self._pad_tables(tables, bp)
        tok = np.zeros((bp,), np.int32)
        tok[:b] = tokens
        pos = np.zeros((bp,), np.int32)
        pos[:b] = positions
        nxt = self._run(("decode", bp, tab.shape[1]), self._decode_greedy,
                        [tok, tab, pos])
        return [int(x) for x in nxt[:b]]

    def verify(self, tokens: List[List[int]], positions: List[int],
               tables: List[List[int]]) -> List[List[int]]:
        """One fused verify step: ``tokens[i]`` is sequence i's latest
        real token followed by its draft proposals (all rows the same
        length S); returns the ``[B][S]`` greedy target tokens."""
        b = len(tokens)
        s = len(tokens[0])
        bp = kvpool.pow2_bucket(b)
        tab = self._pad_tables(tables, bp)
        tok = np.zeros((bp, s), np.int32)
        tok[:b] = tokens
        pos = np.zeros((bp,), np.int32)
        pos[:b] = positions
        nxt = self._run(("verify", bp, s, tab.shape[1]), self._verify_greedy,
                        [tok, tab, pos])
        return [[int(x) for x in row] for row in nxt[:b]]

    def copy_blocks(self, pairs: List[Tuple[int, int]]) -> None:
        """Copy whole K/V pages ``src -> dst`` across every layer (the
        copy-on-write path), in place."""
        if not pairs:
            return
        dev = self.params["tok_emb"].device
        with DEVICE_GATE.shared():
            src = torch.tensor([p[0] for p in pairs], device=dev)
            dst = torch.tensor([p[1] for p in pairs], device=dev)
            for layers in self.cache.values():
                for layer in layers:
                    layer[dst] = layer[src]

    def read_blocks(self, ids: List[int]):
        """Extract pages as CPU tensors ``(k, v)``, each
        ``[L, n, n_kv, bs, D]``."""
        with DEVICE_GATE.shared():
            idx = torch.tensor(ids, device=self.params["tok_emb"].device)
            return tuple(torch.stack([layer[idx] for layer in self.cache[kind]]).cpu()
                         for kind in ("k", "v"))

    def write_blocks(self, ids: List[int], k, v) -> None:
        """Inject pages into this pool's blocks, in place.  ``k``/``v``:
        ``[L, n, n_kv, bs, D]`` tensors or arrays."""
        with DEVICE_GATE.shared():
            idx = torch.tensor(ids, device=self.params["tok_emb"].device)
            for kind, pages in (("k", k), ("v", v)):
                for layer, page in zip(self.cache[kind], pages):
                    layer[idx] = torch.as_tensor(page).to(layer.device, layer.dtype)

    def warmup(self, max_batch: int, prompt_len: int, chunk: int) -> None:
        """Capture the decode graphs a serving shape will hit — every
        batch bucket up to ``max_batch`` at every table-width bucket up
        to the one of ``prompt_len + chunk`` tokens — so the first
        requests' TTFT holds no capture.  Nothing to do on the CPU."""
        if self.device.type != "cuda":
            return
        blocks = self.num_blocks - kvpool.RESERVED_BLOCKS
        top = kvpool.pow2_bucket(min(blocks, kvpool.pow2_bucket(
            (prompt_len + chunk) // self.block_size + 1)), lo=4)
        bp = 1
        while bp <= kvpool.pow2_bucket(max_batch):
            m = 4
            while m <= top:
                if ("decode", bp, m) not in self.graphs:
                    zeros = [np.zeros((bp,), np.int32),
                             np.zeros((bp, m), np.int32),
                             np.zeros((bp,), np.int32)]
                    self._capture(("decode", bp, m), self._decode_greedy, zeros)
                m <<= 1
            bp <<= 1


class FakeRunner:
    """Deterministic arithmetic stepper (no device): the next token is a
    pure function of (previous token, position), so a preempted and
    re-prefilled sequence reproduces its exact suffix — the property
    the engine's no-lost-sequences invariant leans on."""

    def __init__(self, num_blocks: int = 64, block_size: int = 4,
                 vocab: int = 251):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.vocab = vocab
        self.nbytes = 0
        self.prefill_calls = 0
        self.decode_calls = 0
        self.verify_calls = 0
        self.copied_blocks = 0

    def _next(self, token: int, pos: int) -> int:
        return (token * 31 + pos * 7 + 3) % self.vocab

    def prefill(self, tokens: List[int], table: List[int],
                start_pos: int, last: bool = True) -> Optional[int]:
        self.prefill_calls += 1
        if not last:
            return None
        return self._next(tokens[-1], start_pos + len(tokens) - 1)

    def decode(self, tokens: List[int], positions: List[int],
               tables: List[List[int]]) -> List[int]:
        self.decode_calls += 1
        return [self._next(t, p) for t, p in zip(tokens, positions)]

    def verify(self, tokens: List[List[int]], positions: List[int],
               tables: List[List[int]]) -> List[List[int]]:
        """Spec-verify against the arithmetic stepper: row ``s``'s
        target is a pure function of (row token ``s``, position) — the
        same function decode applies, so greedy-exactness of the
        accept/reject loop is provable in unit tests."""
        self.verify_calls += 1
        out = []
        for row, pos in zip(tokens, positions):
            out.append([self._next(t, pos + i)
                        for i, t in enumerate(row)])
        return out

    def copy_blocks(self, pairs: List[Tuple[int, int]]) -> None:
        self.copied_blocks += len(pairs)

    def read_blocks(self, ids: List[int]):
        # storage-free: the ship path degrades to metadata-only
        return None, None

    def write_blocks(self, ids: List[int], k, v) -> None:
        return None
