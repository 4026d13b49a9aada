"""Federated multi-worker meshes: one logical device across N workers.

The port's copy of ``tensorfusion_tpu/remoting/federation.py``, for
single-device members.  :class:`FederatedDevice` composes N
:class:`~.client.RemoteDevice` connections:

- **data parallelism** (:meth:`FederatedDevice.federated_jit`): arguments
  split along an axis into near-equal per-worker slices (or replicate
  whole), each worker runs its slice of the torch function through the
  ordinary COMPILE / EXECUTE path, and outputs gather by concatenation,
  cross-worker sum or first replica.
- **collectives** over the protocol-v7 opcodes (ALLREDUCE_SHIP /
  ALLGATHER_SHIP): each worker reduces its own partials so one slice
  leaves it; replies come back q8 where negotiated.  Flat by default
  (every worker's leg in flight at once, the client sums in mesh order).
- **the zero-relay fabric ring** (protocol v9): with ``ring=True`` and
  every member at v9 the client only orchestrates (FABRIC_OPEN on every
  member, then one FABRIC_ALLREDUCE leg each, receipts back) while the
  reduce and install hops run worker to worker with q8 per hop; no
  collective payload crosses the client (``client_relay_bytes`` stays 0)
  and the total lands resident on every member.  Members at v7 or v8
  keep the client-relayed ring, bit-compatible with the reference.
- **model parallelism** (:meth:`FederatedDevice.model_parallel_jit`):
  ``stage2(psum(stage1(args)))`` with the psum over the fabric ring, so
  no single worker holds the whole contraction.
- **overlap** bookkeeping: a collective that runs while a
  :class:`FedStep`'s compute is in flight counts as hidden transfer.

``TPF_FED_QUANT=1`` / ``0`` forces collective quantization on or off for
the connections a federation owns (``quantize=`` wins).  Integers, bools
and f64 ship exact whatever the policy.  Every federated path falls back
to plain execution on worker 0, with no v7+ frame on the wire, when any
member negotiated below v7.  Values come back as CPU torch tensors;
arguments are torch tensors, numpy arrays or per-worker handle lists.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import constants
from . import protocol
from .client import RemoteBuffer, RemoteDevice

log = logging.getLogger("tpf_torch.remoting.federation")

#: with ``ring=True`` and no fabric, a federation of at least this many
#: workers reduces through the client-relayed ring (the client holds one
#: partial at a time) instead of flat concurrent collects
RING_MIN_WORKERS = 3


def _split_points(n: int, parts: int) -> List[int]:
    """Near-equal split boundaries of ``n`` rows over ``parts`` workers
    (the first ``n % parts`` take one extra row, ``np.array_split``'s
    convention)."""
    base, extra = divmod(n, parts)
    points = [0]
    for i in range(parts):
        points.append(points[-1] + base + (1 if i < extra else 0))
    return points


def _slice(arr, axis: int, lo: int, hi: int):
    """Rows ``[lo, hi)`` of ``arr`` along ``axis``, contiguous."""
    if isinstance(arr, torch.Tensor):
        return arr.narrow(axis, lo, hi - lo).contiguous()
    host = np.asarray(arr)
    index: List[slice] = [slice(None)] * host.ndim
    index[axis] = slice(lo, hi)
    return np.ascontiguousarray(host[tuple(index)])


def _nbytes(arr) -> int:
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return int(np.asarray(arr).nbytes)


class FedStep:
    """One federated resident step: per-worker result-handle pytrees and
    the completion futures the overlap ledger judges hiding against."""

    __slots__ = ("handles", "futures", "done_at")

    def __init__(self, handles: List[Any], futures: List):
        self.handles = handles
        self.futures = [f for f in futures if f is not None]
        self.done_at: List[float] = []
        for fut in self.futures:
            fut.add_done_callback(
                lambda _f: self.done_at.append(time.monotonic()))

    def compute_done_at(self) -> Optional[float]:
        """When the last worker finished this step, or None while any
        ack is outstanding."""
        if len(self.done_at) < len(self.futures):
            return None
        return max(self.done_at) if self.done_at else None

    def wait(self, timeout_s: float = 300.0) -> None:
        for fut in self.futures:
            fut.result(timeout=timeout_s)


class FederatedDevice:
    """N remote workers composed into one logical mesh.  ``workers``:
    ``tcp://`` URLs (connections made and owned: closed by
    :meth:`close`) or :class:`RemoteDevice` instances (borrowed)."""

    def __init__(self, workers: Sequence, token: Optional[str] = None,
                 quantize: Optional[bool] = None,
                 tracer=None, profiler=None, tenant: str = "fed0",
                 timeout_s: float = 300.0,
                 ring: bool = False,
                 ring_min_workers: int = RING_MIN_WORKERS):
        if not workers:
            raise ValueError("a federation needs at least one worker")
        if quantize is None:
            env = os.environ.get(constants.ENV_FED_QUANT, "")
            if env in ("1", "0"):
                quantize = env == "1"
        self.quantize = quantize
        self._owned: List[RemoteDevice] = []
        self.workers: List[RemoteDevice] = []
        for w in workers:
            if isinstance(w, RemoteDevice):
                self.workers.append(w)
            else:
                dev = RemoteDevice(str(w), token=token, timeout_s=timeout_s,
                                   quantize=quantize, tracer=tracer)
                self._owned.append(dev)
                self.workers.append(dev)
        self.tracer = tracer
        #: client-side attribution ledger: collective transfer seconds,
        #: hidden and exposed, under ``tenant``
        self.profiler = profiler
        self.tenant = tenant
        self.ring = bool(ring)
        self.ring_min_workers = max(2, int(ring_min_workers))
        self._fed_ok: Optional[bool] = None
        self._fab_ok: Optional[bool] = None
        self._fab_mint = itertools.count()
        self._lock = threading.Lock()
        #: collective ledger (``fed_snapshot``); ``client_relay_bytes``
        #: counts every collective payload byte through this client
        # guarded by: _lock
        self._stats: Dict[str, float] = {
            "allreduce_total": 0, "allgather_total": 0,
            "fabric_rings_total": 0,
            "fallback_calls_total": 0, "shard_execs_total": 0,
            "collective_raw_bytes": 0, "collective_wire_bytes": 0,
            "client_relay_bytes": 0,
            "hidden_s": 0.0, "exposed_s": 0.0}

    # -- mesh composition ------------------------------------------------

    @property
    def n_workers(self) -> int:
        return len(self.workers)

    def fed_supported(self) -> bool:
        """More than one worker, and every member negotiated >= v7;
        probed once.  Otherwise every call runs on worker 0 alone."""
        if self._fed_ok is None:
            ok = len(self.workers) > 1
            for dev in self.workers:
                if dev._sock is None:
                    dev.info()          # dials and negotiates
                if dev._wire_version < protocol.FED_MIN_VERSION:
                    ok = False
            self._fed_ok = ok
            if not ok and len(self.workers) > 1:
                log.warning("federation degraded to single-worker "
                            "execution: a member negotiated < v%d",
                            protocol.FED_MIN_VERSION)
        return self._fed_ok

    def fabric_supported(self) -> bool:
        """Federated, and every member negotiated >= v9; probed once.
        Otherwise ``ring=True`` stays on the client-relayed ring."""
        if self._fab_ok is None:
            ok = self.fed_supported() and len(self.workers) > 1 and all(
                dev._wire_version >= protocol.FABRIC_MIN_VERSION
                for dev in self.workers)
            self._fab_ok = ok
            if not ok and self.ring and len(self.workers) > 1:
                log.warning("fabric ring unavailable (a member negotiated "
                            "< v%d): ring=True stays on the deprecated "
                            "client-relayed ring",
                            protocol.FABRIC_MIN_VERSION)
        return self._fab_ok

    def info(self) -> Dict[str, Any]:
        """Per-worker INFO and the logical composition."""
        infos = [dev.info() for dev in self.workers]
        return {"workers": len(infos), "federated": self.fed_supported(),
                "n_devices_total": sum(i.get("n_devices", 1) for i in infos),
                "per_worker": infos}

    def close(self) -> None:
        for dev in self._owned:
            dev.close()

    # -- ledger ------------------------------------------------------------

    def _note(self, **deltas: float) -> None:
        with self._lock:
            for k, v in deltas.items():
                self._stats[k] = self._stats.get(k, 0) + v

    def fed_snapshot(self) -> Dict[str, float]:
        """The ledger ``hypervisor.metrics.federation_lines`` encodes."""
        with self._lock:
            snap = dict(self._stats)
        total = snap["hidden_s"] + snap["exposed_s"]
        snap["overlap_efficiency_pct"] = round(
            100.0 * snap["hidden_s"] / total, 2) if total > 0 else 0.0
        snap["workers"] = len(self.workers)
        return snap

    def _attr_collective(self, dur_s: float, hidden_s: float,
                         raw_bytes: int, wire_bytes: int, op: str) -> None:
        hidden_s = min(max(hidden_s, 0.0), dur_s)
        self._note(**{f"{op}_total": 1,
                      "collective_raw_bytes": raw_bytes,
                      "collective_wire_bytes": wire_bytes,
                      "hidden_s": hidden_s,
                      "exposed_s": max(dur_s - hidden_s, 0.0)})
        if self.profiler is not None:
            self.profiler.attribute(self.tenant, "transfer", dur_s,
                                    hidden_s=hidden_s)

    @staticmethod
    def _leg_bytes(rmeta: Dict[str, Any],
                   stats: Optional[Dict[str, int]]) -> tuple:
        """(raw, wire) bytes one leg moved: its reply plus what the
        request staged."""
        rx = rmeta.get("_rx_wire") or {}
        raw = int(rx.get("raw_bytes", 0))
        wire = int(rx.get("wire_bytes", 0))
        if stats:
            raw += int(stats.get("raw_bytes", 0))
            wire += int(stats.get("wire_bytes", 0))
        return raw, wire

    @staticmethod
    def _hidden_until(t0: float, t1: float, overlap_with) -> float:
        """Collective wall time in [t0, t1] while ``overlap_with``'s
        compute was still in flight."""
        if overlap_with is None:
            return 0.0
        done = overlap_with.compute_done_at()
        if done is None:
            return t1 - t0
        return min(max(done - t0, 0.0), t1 - t0)

    def _span(self, name: str, **attrs):
        if self.tracer is None:
            return None
        return self.tracer.start_span(name, attrs=attrs)

    @staticmethod
    def _fail_span(span, e: BaseException) -> None:
        if span is not None and span.end_s is None:
            span.finish(error=f"{type(e).__name__}: {e}"[:200])

    # -- collectives -------------------------------------------------------

    @staticmethod
    def _handle_ids(h) -> List[str]:
        """Buffer ids behind one per-worker handle: a RemoteBuffer, an id
        string, or a collection of those."""
        if isinstance(h, str):
            return [h]
        buf = getattr(h, "buf_id", None)
        if buf is not None:
            return [buf]
        out: List[str] = []
        for e in h:
            out.extend(FederatedDevice._handle_ids(e))
        return out

    def all_reduce(self, handles: Sequence, op: str = "sum",
                   install: bool = False, free_src: bool = False,
                   overlap_with: Optional[FedStep] = None,
                   fetch_value: bool = True,
                   prefer_fabric: Optional[bool] = None) -> Dict[str, Any]:
        """Cross-worker AllReduce of per-worker resident partials
        (``handles``: one per worker, mesh order).  Flat concurrent legs
        by default; the fabric ring when ``ring`` (or ``prefer_fabric``)
        and every member speaks v9; the client-relayed ring for v7/v8
        members at ``ring`` with ``ring_min_workers`` or more.
        ``install`` leaves the total resident on every worker (returned
        as ``handles``); ``free_src`` retires the partials;
        ``fetch_value=False`` skips pulling the fabric ring's total back.
        Returns ``{"value", "handles", "raw_bytes", "wire_bytes",
        "hidden_s", "dur_s"}``."""
        if not self.fed_supported():
            return self._fallback_reduce(handles, free_src=free_src)
        fabric = (self.ring if prefer_fabric is None
                  else bool(prefer_fabric)) and self.fabric_supported()
        ring = (not fabric) and self.ring and \
            len(self.workers) >= self.ring_min_workers
        span = self._span("fed.collective", op=op,
                          workers=len(self.workers))
        t0 = time.monotonic()
        raw = wire = 0
        try:
            if fabric:
                total, out_handles, raw, wire = self._fabric_ring_reduce(
                    handles, op=op, install=install, free_src=free_src,
                    fetch_value=fetch_value)
            else:
                if ring:
                    # client-relayed ring (v7/v8 members): the running
                    # accumulator visits each worker, summed there
                    total = None
                    for dev, h in zip(self.workers, handles):
                        stats: Dict[str, int] = {}
                        rmeta, total = dev.allreduce_ship(
                            self._handle_ids(h), acc=total,
                            free_src=free_src, stats=stats, op=op)
                        r, w = self._leg_bytes(rmeta, stats)
                        raw, wire = raw + r, wire + w
                else:
                    futs = []
                    for dev, h in zip(self.workers, handles):
                        stats = {}
                        futs.append((dev, stats, dev.allreduce_ship(
                            self._handle_ids(h), free_src=free_src,
                            wait=False, stats=stats, op=op)))
                    total = None
                    for dev, stats, fut in futs:
                        rmeta, part = dev.finish_collective(fut)
                        r, w = self._leg_bytes(rmeta, stats)
                        raw, wire = raw + r, wire + w
                        total = part if total is None else total + part
                out_handles = None
                if install:
                    out_handles, install_wire = self._install(total)
                    raw += _nbytes(total) * len(self.workers)
                    wire += install_wire
                # every client-coordinated collective byte is relay
                self._note(client_relay_bytes=raw)
            t1 = time.monotonic()
            hidden = self._hidden_until(t0, t1, overlap_with)
            self._attr_collective(t1 - t0, hidden, raw, wire, "allreduce")
            if span is not None:
                span.finish(raw_bytes=raw, wire_bytes=wire, ring=int(ring),
                            fabric=int(fabric),
                            hidden_ms=round(hidden * 1e3, 3))
            return {"value": total, "handles": out_handles,
                    "raw_bytes": raw, "wire_bytes": wire,
                    "hidden_s": hidden, "dur_s": t1 - t0}
        except BaseException as e:
            self._fail_span(span, e)
            raise

    def _fabric_ring_reduce(self, handles: Sequence, op: str = "sum",
                            install: bool = False, free_src: bool = False,
                            fetch_value: bool = True) -> tuple:
        """One zero-relay ring: FABRIC_OPEN on every member first (so no
        hop races its session), then every member's leg in flight at once
        (sequential legs would deadlock: member j waits for j-1's hop).
        Returns ``(value | None, handles | None, raw, wire)`` with the
        worker-to-worker hop bytes."""
        cid = f"fab{next(self._fab_mint)}"
        roster = [{"url": dev.peer_url} for dev in self.workers]
        for dev in self.workers:
            dev.fabric_open(cid)
        rids = [dev.mint_buf_id("fab") for dev in self.workers]
        futs = []
        for i, (dev, h) in enumerate(zip(self.workers, handles)):
            futs.append((dev, dev.fabric_allreduce(
                cid, self._handle_ids(h), roster, i, rids[i], op=op,
                free_src=free_src, quant=bool(self.quantize))))
        raw = wire = 0
        shape: tuple = ()
        dtype = "float32"
        for dev, fut in futs:
            rmeta, _ = dev.finish_collective(fut)
            raw += int(rmeta.get("peer_raw_bytes", 0))
            wire += int(rmeta.get("peer_wire_bytes", 0))
            shape = tuple(rmeta.get("shape") or shape)
            dtype = rmeta.get("dtype") or dtype
        self._note(fabric_rings_total=1)
        out = [RemoteBuffer(dev, rid, shape, dtype)
               for dev, rid in zip(self.workers, rids)]
        value = out[0].fetch() if fetch_value else None
        if install:
            return value, out, raw, wire
        for h in out:
            h.free()
        return value, None, raw, wire

    def _install(self, total) -> tuple:
        """Re-scatter: the total to every worker as a fresh resident
        buffer, by fire-and-forget ALLREDUCE_SHIP installs ordered before
        later EXECUTEs by each connection's FIFO.  Returns the handles and
        the wire bytes the installs sent."""
        out = []
        wire = 0
        dtype = protocol.WIRE_NAMES[total.dtype] \
            if isinstance(total, torch.Tensor) else total.dtype.name
        for dev in self.workers:
            rid = dev.mint_buf_id("red")
            st: Dict[str, int] = {}
            dev.allreduce_ship([], acc=total, result_id=rid,
                               receipt_only=True, quiet=True, stats=st)
            wire += int(st.get("wire_bytes", 0))
            out.append(RemoteBuffer(dev, rid, tuple(total.shape), dtype))
        return out, wire

    def _fallback_reduce(self, handles: Sequence,
                         free_src: bool = False) -> Dict[str, Any]:
        """Single-worker degradation: the lone partial is the total,
        fetched over the pre-v7 wire."""
        self._note(fallback_calls_total=1)
        h = handles[0]
        total = h.fetch()
        if free_src:
            h.free()
        return {"value": total, "handles": None, "raw_bytes": 0,
                "wire_bytes": 0, "hidden_s": 0.0, "dur_s": 0.0}

    def all_gather(self, handles: Sequence, axis: int = 0,
                   free_src: bool = False,
                   overlap_with: Optional[FedStep] = None) -> torch.Tensor:
        """Cross-worker AllGather: each worker concatenates its pieces
        along ``axis``; the client concatenates the slices in mesh
        order."""
        if not self.fed_supported():
            self._note(fallback_calls_total=1)
            h = handles[0]
            piece = h.fetch()
            if free_src:
                h.free()
            return piece
        span = self._span("fed.collective", op="gather",
                          workers=len(self.workers))
        t0 = time.monotonic()
        try:
            futs = []
            for dev, h in zip(self.workers, handles):
                stats: Dict[str, int] = {}
                futs.append((dev, stats, dev.allgather_ship(
                    self._handle_ids(h), axis=axis, free_src=free_src,
                    wait=False, stats=stats)))
            pieces = []
            raw = wire = 0
            for dev, stats, fut in futs:
                rmeta, piece = dev.finish_collective(fut)
                r, w = self._leg_bytes(rmeta, stats)
                raw, wire = raw + r, wire + w
                pieces.append(piece)
            out = pieces[0] if len(pieces) == 1 \
                else torch.cat(pieces, dim=axis)
            self._note(client_relay_bytes=raw)
            t1 = time.monotonic()
            hidden = self._hidden_until(t0, t1, overlap_with)
            self._attr_collective(t1 - t0, hidden, raw, wire, "allgather")
            if span is not None:
                span.finish(raw_bytes=raw, wire_bytes=wire, ring=0,
                            hidden_ms=round(hidden * 1e3, 3))
            return out
        except BaseException as e:
            self._fail_span(span, e)
            raise

    # -- federated functions -----------------------------------------------

    def federated_jit(self, fn: Callable, in_axes=0,
                      out_modes="concat") -> "FederatedFunction":
        """Run ``fn`` (a torch function or module) split across the
        federation.  ``in_axes``: per argument the axis its tensor splits
        along, or None to replicate it (one value broadcasts).
        ``out_modes``: per output leaf ``"concat"`` (gather along the
        split axis), ``"sum"`` (reduce per-worker partials) or
        ``"first"`` (replicated: member 0's); one string broadcasts."""
        return FederatedFunction(self, fn, in_axes, out_modes)

    def model_parallel_jit(self, stage1: Callable, stage2: Callable,
                           stage1_in_axes=0) -> "ModelParallelFunction":
        """Cross-worker model parallelism, ``stage2(psum(stage1(args)))``:
        ``stage1`` makes each worker's partial from its shard of the
        arguments (``stage1_in_axes`` names the contraction axis each
        splits along), the partials AllReduce over the fabric ring, and
        ``stage2`` continues from the total every member holds."""
        return ModelParallelFunction(self, stage1, stage2, stage1_in_axes)


class FederatedFunction:
    """The callable :meth:`FederatedDevice.federated_jit` returns."""

    def __init__(self, fed: FederatedDevice, fn: Callable, in_axes,
                 out_modes):
        self.fed = fed
        self.fn = fn
        self.in_axes = in_axes
        self.out_modes = out_modes
        #: one wrapper per member, all derived from the first with
        #: ``.on``: one export per signature, COMPILEd on every member
        self._wrappers: Optional[List[Callable]] = None
        self._fn_name = getattr(fn, "__name__", "") or type(fn).__name__

    def _axes_for(self, n_args: int) -> List[Optional[int]]:
        ax = self.in_axes
        if ax is None or isinstance(ax, int):
            return [ax] * n_args
        ax = list(ax)
        if len(ax) != n_args:
            raise ValueError(f"in_axes has {len(ax)} entries for {n_args} "
                             f"args")
        return ax

    def _modes_for(self, n_out: int) -> List[str]:
        m = self.out_modes
        modes = [m] * n_out if isinstance(m, str) else list(m)
        if len(modes) != n_out:
            raise ValueError(f"out_modes has {len(modes)} entries for "
                             f"{n_out} outputs")
        for mode in modes:
            if mode not in ("concat", "sum", "first"):
                raise ValueError(f"unknown out_mode {mode!r}")
        return modes

    @staticmethod
    def _resident(e) -> bool:
        """``e`` is a resident handle, or a pytree of them (a parameter
        tree PUT on one worker)."""
        leaves = pytree.tree_leaves(e)
        return bool(leaves) and all(isinstance(x, RemoteBuffer)
                                    for x in leaves)

    def _shard_args(self, args) -> List[tuple]:
        """Per-worker argument tuples: split-axis arguments sliced at the
        near-equal split points, replicated ones passed whole, and a list
        of one resident handle (or handle pytree) per worker passed
        through."""
        w = self.fed.n_workers
        per_worker: List[list] = [[] for _ in range(w)]
        for arg, axis in zip(args, self._axes_for(len(args))):
            if isinstance(arg, (list, tuple)) and len(arg) == w and \
                    all(self._resident(e) for e in arg):
                for i in range(w):
                    per_worker[i].append(arg[i])
            elif axis is None:
                for i in range(w):
                    per_worker[i].append(arg)
            else:
                points = _split_points(arg.shape[axis], w)
                for i in range(w):
                    per_worker[i].append(
                        _slice(arg, axis, points[i], points[i + 1]))
        return [tuple(a) for a in per_worker]

    def _gather(self, results: List, axes: List[Optional[int]]):
        """Combine per-worker result pytrees leaf by leaf."""
        leaves0, treedef = pytree.tree_flatten(results[0])
        all_leaves = [pytree.tree_flatten(r)[0] for r in results]
        concat_axis = next((a for a in axes if a is not None), 0)
        out = []
        for j, mode in enumerate(self._modes_for(len(leaves0))):
            col = [leaves[j] for leaves in all_leaves]
            if mode == "concat":
                out.append(torch.cat(col, dim=concat_axis))
            elif mode == "sum":
                total = col[0]
                for c in col[1:]:
                    total = total + c
                out.append(total)
            else:
                out.append(col[0])
        return pytree.tree_unflatten(out, treedef)

    def _worker_fns(self) -> List[Callable]:
        if self._wrappers is None:
            first = self.fed.workers[0].remote_jit(self.fn)
            self._wrappers = [first] + [first.on(dev)
                                        for dev in self.fed.workers[1:]]
        return self._wrappers

    def _fallback_fn(self) -> Callable:
        return self._worker_fns()[0]

    def on(self, device) -> Callable:
        """``fn`` on one RemoteDevice, sharing the members' exports."""
        return self._worker_fns()[0].on(device)

    def _shard_span(self, worker: int, mode: str):
        return self.fed._span("fed.shard_exec", worker=worker,
                              fn=self._fn_name, mode=mode)

    def __call__(self, *args):
        """Split, run every worker's slice at once (pipelined submits),
        gather per ``out_modes``; on a degraded federation, worker 0 runs
        the whole call."""
        if not self.fed.fed_supported():
            self.fed._note(fallback_calls_total=1)
            return self._fallback_fn()(*args)
        futs = []
        for i, (f, sh) in enumerate(zip(self._worker_fns(),
                                        self._shard_args(args))):
            span = self._shard_span(i, "call")
            try:
                futs.append((span, f.submit(*sh)))
            except BaseException as e:
                self.fed._fail_span(span, e)
                raise
            self.fed._note(shard_execs_total=1)
        results = []
        for span, fut in futs:
            try:
                results.append(fut.result(
                    timeout=self.fed.workers[0].timeout_s))
            except BaseException as e:
                self.fed._fail_span(span, e)
                raise
            if span is not None:
                span.finish()
        return self._gather(results, self._axes_for(len(args)))

    def upload_arg(self, index: int, array, *example_args):
        """Park argument ``index`` resident on every worker ahead of
        calls (its slice, or all of it when replicated); returns the
        per-worker handle list to pass in the argument's place."""
        if not self.fed.fed_supported():
            return self._fallback_fn().upload_arg(index, array,
                                                  *example_args)
        axes = self._axes_for(len(example_args) if example_args
                              else max(index + 1, 1))
        axis = axes[index] if index < len(axes) else None
        fns = self._worker_fns()
        examples = self._shard_args(example_args) if example_args \
            else [() for _ in fns]
        if axis is None:
            return [f.upload_arg(index, array, *ex)
                    for f, ex in zip(fns, examples)]
        points = _split_points(array.shape[axis], self.fed.n_workers)
        return [f.upload_arg(index, _slice(array, axis, points[i],
                                           points[i + 1]), *ex)
                for i, (f, ex) in enumerate(zip(fns, examples))]

    def step_resident(self, *args, free=()) -> FedStep:
        """One fire-and-forget federated step: every worker's slice runs
        with its results kept resident (client-minted ids, no round
        trip); ``free`` retires earlier per-worker handle lists.  Reduce
        the returned step's ``handles`` with
        :meth:`FederatedDevice.all_reduce`."""
        if not self.fed.fed_supported():
            self.fed._note(fallback_calls_total=1)
            frees = [f[0] if isinstance(f, (list, tuple)) else f
                     for f in free]
            out, fut = self._fallback_fn().step_resident(
                *args, free=tuple(frees), acked=True)
            return FedStep([out], [fut])
        handles, futs = [], []
        for i, (f, sh) in enumerate(zip(self._worker_fns(),
                                        self._shard_args(args))):
            span = self._shard_span(i, "step")
            worker_free = tuple(fr[i] for fr in free
                                if isinstance(fr, (list, tuple)))
            try:
                out, fut = f.step_resident(*sh, free=worker_free,
                                           acked=True)
            except BaseException as e:
                self.fed._fail_span(span, e)
                raise
            if span is not None:
                span.finish()
            self.fed._note(shard_execs_total=1)
            handles.append(out)
            futs.append(fut)
        return FedStep(handles, futs)


class ModelParallelFunction:
    """``stage2(psum(stage1(args)))`` with the psum across workers: every
    worker's stage-1 slice launches resident, the partials AllReduce over
    the fabric ring into a total installed on every member (nothing rides
    back here), and stage 2 runs from it, its replicated output taken
    from member 0.  A degraded federation runs both stages on worker 0
    (a psum over one member is the identity)."""

    def __init__(self, fed: FederatedDevice, stage1: Callable,
                 stage2: Callable, stage1_in_axes=0):
        self.fed = fed
        self.stage1 = stage1
        self.stage2 = stage2
        self._s1 = fed.federated_jit(stage1, in_axes=stage1_in_axes,
                                     out_modes="sum")
        self._s2 = fed.federated_jit(stage2, in_axes=None,
                                     out_modes="first")
        self._fb: Optional[tuple] = None

    def _fallback(self) -> tuple:
        if self._fb is None:
            dev = self.fed.workers[0]
            self._fb = (dev.remote_jit(self.stage1),
                        dev.remote_jit(self.stage2))
        return self._fb

    def __call__(self, *args):
        fed = self.fed
        if not fed.fed_supported():
            fed._note(fallback_calls_total=1)
            s1, s2 = self._fallback()
            return s2(s1(*args))
        step = self._s1.step_resident(*args)
        red = fed.all_reduce(step.handles, install=True, free_src=True,
                             overlap_with=step, fetch_value=False,
                             prefer_fabric=True)
        out = self._s2(red["handles"])
        for h in red["handles"]:
            h.free()
        return out
