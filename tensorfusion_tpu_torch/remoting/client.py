"""Client of the port's remote execution: run torch functions on a remote
worker (``remoting/worker.py``).

The single-device half of ``tensorfusion_tpu/remoting/client.py``.
``RemoteDevice(url).remote_jit(fn)`` exports ``fn`` locally over fake
CPU tensors of the call's signature (no card and no data needed; see
``remoting/program.py``), ships the ``torch.export`` archive to the
worker once per signature (COMPILE, with the FLOP estimate of the
port's ``client.runtime.estimate_flops`` as ``mflops_hint``), and
thereafter sends only argument tensors per call.  ``fn`` is an
``nn.Module`` or a function of tensor pytrees; arguments are torch
tensors, numpy arrays, or :class:`RemoteBuffer` handles to tensors made
resident with :meth:`RemoteDevice.put`.  Results come back as CPU torch
tensors in ``fn``'s output structure (bf16 has no numpy type without
``ml_dtypes``).

Transport, as in the reference: a HELLO token handshake
(``TPF_REMOTING_TOKEN``) that negotiates the wire version, the QoS
class (``qos=`` or ``TPF_REMOTING_QOS``) and q8 replies (``quantize=``
or ``TPF_REMOTING_QUANT``); a reader thread that matches replies to
requests by ``seq``, so ``wrapped.submit(...)`` pipelines many calls on
one connection; structured BUSY / DEADLINE_EXCEEDED errors (the
synchronous wrapper retries BUSY with jittered backoff); one reconnect
attempt on a dropped connection; optional client-side tracing
(``tracer=``) whose wire span's context rides the EXECUTE and adopts
the worker's span tree.

Serving over the wire: :meth:`RemoteDevice.generate` streams a GENERATE
through the worker's continuous-batching engine (``_submit(...,
stream=queue)``: the reader routes every frame of that request to the
queue until the final frame or an ERROR, and hands a lost connection to
every open stream), and :meth:`RemoteDevice.ship_kv` ships a prefilled
prompt's KV pages (KV_SHIP, protocol v6): pages of ``SHARD_PUT_MIN_BYTES``
or more go ahead as quiet ephemeral PUTs, smaller ones inline.

State and peers: the federated collectives (``allreduce_ship`` /
``allgather_ship``, protocol v7), the peer fabric's rendezvous and ring
legs (``fabric_open`` / ``fabric_allreduce``, v9), SNAPSHOT / RESTORE
into the worker's state root, and the orchestrator's half of a
streaming live migration (``snapshot_delta`` / ``migrate_freeze`` /
``migrate_commit``, v8).  Each version-gated call raises before anything
is sent when the connection negotiated less (the client half of the
double gate; the worker refuses the kind as well).  Large accumulators
go ahead as quiet ephemeral PUTs sent directly on the connection.

Left out until the multi-device slice: ``ShardedRemoteBuffer``, the
sharded layouts and the reference's background upload stream; until the
control-plane part: ``from_connection``.
"""

from __future__ import annotations

import functools
import itertools
import logging
import os
import random
import socket
import threading
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import constants
from ..client.runtime import estimate_flops
from ..clock import default_clock
from . import program, protocol
from .protocol import recv_message, send_message

log = logging.getLogger("tpf_torch.remoting.client")

#: buffers at or above this size are uploaded as separate pipelined PUT
#: frames (their transfer overlaps the worker's copy of earlier ones);
#: smaller ones ride inline in the request frame
SHARD_PUT_MIN_BYTES = 256 << 10

#: how many BUSY rejections the synchronous wrapper absorbs (with
#: jittered backoff) before giving up — a saturated-but-moving worker
#: drains well inside this; a wedged one should fail loudly
MAX_BUSY_RETRIES = 32

class RemoteExecutionError(RuntimeError):
    pass


class RemoteBusyError(RemoteExecutionError):
    """The worker's dispatch queue rejected the request (bounded
    backpressure).  ``retry_after_ms`` is the worker's drain estimate —
    retry after sleeping about that long, with jitter, so a thundering
    herd doesn't re-arrive in lockstep."""

    def __init__(self, msg: str, retry_after_ms: int = 50):
        super().__init__(msg)
        self.retry_after_ms = max(int(retry_after_ms), 1)

    def backoff_s(self, attempt: int = 1) -> float:
        """Jittered, gently exponential sleep for retry ``attempt``."""
        base = self.retry_after_ms / 1e3 * min(2 ** (attempt - 1), 8)
        return min(base, 2.0) * (0.5 + random.random())


class RemoteDeadlineError(RemoteExecutionError):
    """The request's ``deadline_ms`` elapsed in the worker's queue; it
    was never executed."""

    def __init__(self, msg: str, queue_wait_ms: int = 0):
        super().__init__(msg)
        self.queue_wait_ms = int(queue_wait_ms)


def _raise_reply_error(rmeta: Dict[str, Any]) -> None:
    """Map a structured ERROR reply onto the typed exceptions."""
    code = rmeta.get("code")
    msg = rmeta.get("error", "remote error")
    if code == "BUSY":
        raise RemoteBusyError(msg, rmeta.get("retry_after_ms", 50))
    if code == "DEADLINE_EXCEEDED":
        raise RemoteDeadlineError(msg, rmeta.get("queue_wait_ms", 0))
    raise RemoteExecutionError(msg)


class RemoteBuffer:
    """Handle to a device-resident tensor on the worker (upload once with
    RemoteDevice.put, reference in remote_jit calls).  ``dtype`` is the
    wire name ("bfloat16", "float32", ...)."""

    def __init__(self, device: "RemoteDevice", buf_id: str, shape, dtype,
                 device_id: int = 0):
        self.device = device
        self.buf_id = buf_id
        self.shape = tuple(shape)
        self.dtype = str(dtype)
        self.device_id = device_id

    def fetch(self) -> torch.Tensor:
        _, _, bufs = self.device._rpc("FETCH", {"buf_id": self.buf_id}, [])
        return bufs[0]

    def free(self) -> None:
        self.device._rpc("FREE", {"buf_ids": [self.buf_id]}, [])


def _nbytes(arr) -> int:
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return int(np.asarray(arr).nbytes)


def _wire_dtype(leaf) -> str:
    if isinstance(leaf, RemoteBuffer):
        return leaf.dtype
    if isinstance(leaf, torch.Tensor):
        return protocol.WIRE_NAMES[leaf.dtype]
    return np.asarray(leaf).dtype.name


class RemoteDevice:
    def __init__(self, url: str, token: Optional[str] = None,
                 timeout_s: float = 300.0,
                 protocol_version: int = protocol.VERSION,
                 qos: Optional[str] = None,
                 tracer=None,
                 quantize: Optional[bool] = None,
                 peer_url: Optional[str] = None):
        # url: "tcp://host:port"
        if url.startswith("tcp://"):
            url = url[len("tcp://"):]
        host, _, port = url.rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)
        self.url = f"tcp://{self.host}:{self.port}"
        #: the address other workers dial for peer-fabric hops: ``url``
        #: unless the client reaches the worker another way than its
        #: peers do (a proxy, a thinner uplink)
        self.peer_url = str(peer_url) if peer_url else self.url
        self.token = token if token is not None else \
            os.environ.get("TPF_REMOTING_TOKEN", "")
        self.timeout_s = timeout_s
        #: QoS class this tenant claims at HELLO — its weight in the
        #: worker's fair dispatch queue (v4 workers; older ones ignore)
        self.qos = qos or os.environ.get(constants.ENV_REMOTING_QOS,
                                         "") or None
        #: lossy q8 wire encoding — STRICTLY opt-in (ctor arg wins, else
        #: TPF_REMOTING_QUANT=1/0); live only once the connection
        #: negotiates v6
        if quantize is None:
            quantize = os.environ.get(constants.ENV_REMOTING_QUANT,
                                      "") == "1"
        self.quantize = bool(quantize)
        #: whether requests try the adaptive zlib encoding (the worker's
        #: per-connection rule, applied from this end)
        self.compress = protocol.default_compress(self.host)
        #: per-connection q8 scratch (reset per message; the send
        #: serializer below is the lifetime guard)
        # guarded by: _send_lock
        self._pool = protocol.BufferPool()
        #: cumulative outbound wire accounting (raw/wire bytes, per-enc
        #: buffer counts)
        # guarded by: _state_lock
        self.wire_stats: Dict[str, int] = {}
        #: cumulative inbound wire accounting — written only by the
        #: reader thread; snapshot with dict()
        self.rx_stats: Dict[str, int] = {}
        #: the worker-resolved dispatch weight (HELLO_OK, v4 workers)
        self.qos_weight: Optional[float] = None
        #: optional span recorder (tracing.Tracer); None disables
        #: client-side tracing
        self.tracer = tracer
        #: highest wire version this client will speak; pinning to 2
        #: makes it frame-faithful to a v2 build (mixed-version tests)
        self.protocol_version = protocol_version
        #: negotiated per connection by the HELLO exchange
        self._wire_version = 2
        #: target's process-unique id, learned at HELLO (v9+, else None)
        self.worker_uid: Optional[str] = None
        self._sock: Optional[socket.socket] = None
        self._send_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._pending: Dict[int, Future] = {}
        #: seq -> (Queue, frames still owed) of a streaming request
        #: (GENERATE, KV_SHIP): every frame echoing the seq lands on the
        #: queue; the entry goes once the final frame (``done``) and a
        #: KV_SHIP's receipt have both come (the receipt may come last),
        #: at an ERROR, or with the connection
        # guarded by: _state_lock
        self._streams: Dict[int, Tuple[Any, set]] = {}
        self._seq = 0
        self._mint = itertools.count(1)   # client-minted buffer ids
        #: frame versions this client build decodes
        self._accept = tuple(v for v in protocol.SUPPORTED_VERSIONS
                             if v <= self.protocol_version)

    # -- connection + pipelined transport ------------------------------

    def _connect_locked(self) -> None:
        """Dial + HELLO handshake + start the response reader (caller
        holds _send_lock)."""
        sock = socket.create_connection((self.host, self.port), timeout=60)
        # pipelined small headers must not Nagle-stall behind buffers
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # HELLO is always framed at v2 so any worker can read it; the
        # version the connection actually runs at comes back in HELLO_OK
        hello = {"token": self.token}
        if self.protocol_version > 2:
            hello["max_version"] = self.protocol_version
        if self.qos is not None and self.protocol_version >= 4:
            hello["qos"] = self.qos
        if self.quantize and self.protocol_version >= 6:
            hello["quant"] = True
        send_message(sock, "HELLO", hello, [],
                     version=protocol.HELLO_VERSION)
        kind, meta, _ = recv_message(sock, accept=self._accept)
        if kind != "HELLO_OK":
            sock.close()
            raise RemoteExecutionError(
                meta.get("error", "remoting handshake failed"))
        self._wire_version = max(2, min(self.protocol_version,
                                        int(meta.get("version", 2))))
        self.worker_uid = meta.get("worker_uid")
        if meta.get("qos_weight") is not None:
            self.qos_weight = float(meta["qos_weight"])
        # per-request deadlines are enforced via Future.result(timeout_s);
        # a socket timeout here would kill every pipelined request the
        # moment one response gap exceeds it
        sock.settimeout(None)
        self._sock = sock
        threading.Thread(target=self._read_loop, args=(sock,),
                         name="tpf-remote-reader", daemon=True).start()

    def _read_loop(self, sock: socket.socket) -> None:
        try:
            while True:
                rx: Dict[str, int] = {}
                kind, meta, bufs = recv_message(sock, accept=self._accept,
                                                stats=rx)
                meta["_rx_wire"] = rx
                for k, v in rx.items():
                    self.rx_stats[k] = self.rx_stats.get(k, 0) + v
                seq = meta.get("seq")
                with self._state_lock:
                    entry = self._streams.get(seq)
                    stream = None if entry is None else entry[0]
                    if entry is not None:
                        # streaming request: an ERROR retires it, else
                        # the last of the frames it owes
                        owed = entry[1]
                        owed.discard("done" if meta.get("done") else kind)
                        if kind == "ERROR" or not owed:
                            self._streams.pop(seq, None)
                        fut = None
                    else:
                        fut = self._pending.pop(seq, None)
                if stream is not None:
                    stream.put((kind, meta, bufs))
                elif fut is not None:
                    fut.set_result((kind, meta, bufs))
        except Exception as e:  # noqa: BLE001 - fail this socket's calls
            with self._state_lock:
                if self._sock is not sock:
                    # a reconnect already replaced this socket; the new
                    # connection's pending map is not ours to fail
                    return
                pending, self._pending = self._pending, {}
                streams, self._streams = self._streams, {}
            self._fail(pending, streams, str(e))

    @staticmethod
    def _fail(pending: Dict[int, Future], streams: Dict[int, Any],
              error: str) -> None:
        """Hand a lost connection to its in-flight requests and streams."""
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(ConnectionError(error))
        for q, _ in streams.values():
            q.put(("ERROR", {"error": error, "_connection_lost": True}, []))

    def close(self) -> None:
        with self._send_lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
            # the reader's reconnect guard makes it exit without touching
            # _pending once the socket is swapped out, so close() fails
            # in-flight requests itself — promptly, not after timeout_s
            with self._state_lock:
                pending, self._pending = self._pending, {}
                streams, self._streams = self._streams, {}
            self._fail(pending, streams, "device closed")

    def _quant_on(self) -> bool:
        """q8 is live for this connection: opted in AND negotiated v6."""
        return self.quantize and self._wire_version >= 6

    def _merge_stats(self, st: Dict[str, int],
                     extra: Optional[Dict[str, int]]) -> None:
        with self._state_lock:
            for k, v in st.items():
                self.wire_stats[k] = self.wire_stats.get(k, 0) + v
        if extra is not None:
            for k, v in st.items():
                extra[k] = extra.get(k, 0) + v

    def _submit(self, kind: str, meta: Dict[str, Any], buffers,
                compress: bool = True,
                want_reply: bool = True,
                stream=None,
                stats: Optional[Dict[str, int]] = None
                ) -> Optional[Future]:
        """Send one request without waiting; the returned Future resolves
        to (kind, meta, buffers) when its response arrives.  With
        ``want_reply=False`` the request carries no seq and returns None
        (fire-and-forget: quiet requests whose failures surface later).
        With ``stream=`` (a Queue) the request is streaming: every reply
        frame of its seq is put on the queue, and it returns None.
        ``stats`` additionally receives this send's wire accounting."""
        st: Dict[str, int] = {}
        with self._send_lock:
            if self._sock is None:
                # connect is serialized under the send lock: a racing
                # sender must wait for the socket, not dial a second one
                self._connect_locked()
            fut: Optional[Future] = None
            if stream is not None:
                self._seq += 1
                seq = self._seq
                wire_meta = dict(meta, seq=seq)
                owed = {"done", "KV_SHIP_OK"} if kind == "KV_SHIP" \
                    else {"done"}
                with self._state_lock:
                    self._streams[seq] = (stream, owed)
            elif want_reply:
                self._seq += 1
                seq = self._seq
                wire_meta = dict(meta, seq=seq)
                fut = Future()
                with self._state_lock:
                    self._pending[seq] = fut
            else:
                wire_meta = dict(meta)
            try:
                send_message(self._sock, kind, wire_meta, buffers,
                             compress=compress and self.compress,
                             version=self._wire_version,
                             quantize=self._quant_on(),
                             pool=self._pool, stats=st)
            except (ConnectionError, OSError):
                # one reconnect attempt (worker restarts, idle timeouts);
                # every other in-flight request died with the old socket
                with self._state_lock:
                    if stream is not None:
                        self._streams.pop(seq, None)
                    elif want_reply:
                        self._pending.pop(seq, None)
                    dead, self._pending = self._pending, {}
                    dead_streams, self._streams = self._streams, {}
                self._fail(dead, dead_streams, "connection lost")
                if self._sock is not None:
                    self._sock.close()
                    self._sock = None
                self._connect_locked()
                if stream is not None:
                    with self._state_lock:
                        self._streams[seq] = (stream, owed)
                elif want_reply:
                    with self._state_lock:
                        self._pending[seq] = fut
                send_message(self._sock, kind, wire_meta, buffers,
                             compress=compress and self.compress,
                             version=self._wire_version,
                             quantize=self._quant_on(),
                             pool=self._pool, stats=st)
        self._merge_stats(st, stats)
        return fut

    def _result(self, fut: Future) -> Tuple:
        rkind, rmeta, rbufs = fut.result(timeout=self.timeout_s)
        if rkind == "ERROR":
            _raise_reply_error(rmeta)
        return rkind, rmeta, rbufs

    def _rpc(self, kind: str, meta: Dict[str, Any], buffers) -> Tuple:
        for attempt in (0, 1):
            fut = self._submit(kind, meta, buffers)
            try:
                return self._result(fut)
            except ConnectionError:
                if attempt:
                    raise
                self.close()
        raise RemoteExecutionError("unreachable")

    def info(self) -> Dict[str, Any]:
        _, meta, _ = self._rpc("INFO", {}, [])
        return meta

    def put(self, array, device_id: int = 0) -> RemoteBuffer:
        """Upload one tensor (or numpy array) resident on the worker."""
        arr = array if isinstance(array, torch.Tensor) else np.asarray(array)
        meta: Dict[str, Any] = {}
        if device_id and self._ensure_v3(f"PUT to device {device_id}"):
            meta["device_id"] = device_id
        _, rmeta, _ = self._rpc("PUT", meta, [arr])
        return RemoteBuffer(self, rmeta["buf_id"], arr.shape,
                            _wire_dtype(arr),
                            device_id=rmeta.get("device_id", 0))

    def _ensure_version(self, need: int, what: str) -> bool:
        """True when the (established) connection speaks at least
        ``need``; raises with a useful message otherwise."""
        if self._sock is None:
            self.info()     # dials + negotiates
        if self._wire_version < need:
            raise RemoteExecutionError(
                f"{what} needs protocol v{need} but the worker only "
                f"speaks v{self._wire_version}")
        return True

    def _ensure_v3(self, what: str) -> bool:
        return self._ensure_version(3, what)

    def _consume_stream(self, q, gspan, busy: int,
                        on_token: Optional[Callable[[int], None]],
                        receipt_owed: bool) -> Dict[str, Any]:
        """Read one GENERATE / KV_SHIP stream to its final frame (and a
        KV_SHIP's receipt, which may come after it): tokens to
        ``on_token`` as they land, ERROR frames raised as the typed
        exceptions (a lost connection as ``ConnectionError``)."""
        tokens: List[int] = []
        receipt: Dict[str, Any] = {}
        out: Optional[Dict[str, Any]] = None
        while out is None or (receipt_owed and not receipt):
            kind, rmeta, _ = q.get(timeout=self.timeout_s)
            if kind == "ERROR":
                if rmeta.get("_connection_lost"):
                    raise ConnectionError(rmeta.get("error", "connection lost"))
                if self.tracer is not None:
                    self.tracer.adopt(rmeta.get("trace_spans") or ())
                _raise_reply_error(rmeta)
            if kind == "KV_SHIP_OK":
                receipt = {"blocks": rmeta.get("blocks"),
                           "n_tokens": rmeta.get("n_tokens")}
                continue
            for t in rmeta.get("tokens") or ():
                tokens.append(int(t))
                if on_token is not None:
                    on_token(int(t))
            if rmeta.get("done"):
                if self.tracer is not None:
                    self.tracer.adopt(rmeta.get("trace_spans") or ())
                if gspan is not None:
                    gspan.finish(ttft_ms=rmeta.get("ttft_ms") or 0,
                                 busy_retries=busy)
                out = {"tokens": tokens,
                       "n_tokens": rmeta.get("n_tokens", len(tokens)),
                       "ttft_ms": rmeta.get("ttft_ms"),
                       "finish_reason": rmeta.get("finish_reason", ""),
                       "busy_retries": busy}
        if receipt_owed:
            out["ship"] = receipt
        return out

    def _stream_request(self, base_meta: Dict[str, Any], max_tokens: int,
                        send,
                        on_token: Optional[Callable[[int], None]],
                        receipt_owed: bool = False) -> Dict[str, Any]:
        """Send a streaming request with ``send(meta, queue)`` and consume
        its stream (``receipt_owed``: a KV_SHIP's), retrying BUSY with
        jittered backoff (bounded) and tracing it as ``client.generate``
        when a tracer is set."""
        import queue as _queue

        gspan = None
        if self.tracer is not None:
            gspan = self.tracer.start_span(
                "client.generate", attrs={"tokens": int(max_tokens)})
            if gspan.sampled:
                base_meta = dict(base_meta, trace=gspan.ctx())
        busy = 0
        try:
            while True:
                q: "_queue.Queue" = _queue.Queue()
                send(dict(base_meta), q)
                try:
                    return self._consume_stream(q, gspan, busy, on_token,
                                                receipt_owed)
                except RemoteBusyError as e:
                    busy += 1
                    if busy > MAX_BUSY_RETRIES:
                        raise
                    default_clock().sleep(e.backoff_s(busy))
        except BaseException as e:
            if gspan is not None and gspan.end_s is None:
                gspan.finish(error=f"{type(e).__name__}: {e}"[:200])
            raise

    def generate(self, prompt, max_tokens: int,
                 eos_id: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 stream: bool = True,
                 on_token: Optional[Callable[[int], None]] = None
                 ) -> Dict[str, Any]:
        """Generate through the worker's continuous-batching engine: one
        GENERATE, its GENERATE_OK frames consumed until the final one.
        ``on_token`` is called per token as frames arrive; the result
        holds every ``tokens`` plus the engine's ``ttft_ms``,
        ``finish_reason`` and ``n_tokens``.  A saturated engine's BUSY
        is retried with jittered backoff (bounded); a missed admission
        deadline raises :class:`RemoteDeadlineError`.  Needs a v5
        worker with an engine."""
        self._ensure_version(5, "GENERATE (serving engine)")
        meta: Dict[str, Any] = {"prompt": [int(t) for t in prompt],
                                "max_tokens": int(max_tokens),
                                "stream": bool(stream)}
        if eos_id is not None:
            meta["eos_id"] = int(eos_id)
        if deadline_ms is not None:
            meta["deadline_ms"] = float(deadline_ms)
        return self._stream_request(
            meta, max_tokens,
            lambda m, q: self._submit("GENERATE", m, [], stream=q), on_token)

    def ship_kv(self, prompt, max_tokens: int, keys, k, v,
                first_token: Optional[int], n_tokens: int,
                eos_id: Optional[int] = None,
                deadline_ms: Optional[float] = None,
                stream: bool = True,
                on_token: Optional[Callable[[int], None]] = None
                ) -> Dict[str, Any]:
        """Ship a prompt's prefilled KV pages to the worker's engine
        (KV_SHIP, protocol v6) and consume the generation that follows.
        ``keys``: per-block content chain keys
        (``serving.kvpool.prompt_block_keys``); ``k`` / ``v``: ``[L,
        n_blocks, n_kv, bs, D]`` tensors or arrays (None ships metadata
        alone, for storage-free runners).  Pages of
        ``SHARD_PUT_MIN_BYTES`` or more go ahead as quiet ephemeral PUTs
        on this connection (q8 per block where it negotiated q8), the
        KV_SHIP frame after them.  Returns what :meth:`generate`
        returns, plus the receipt as ``ship``; the stream is read until
        both the final frame and the receipt have come.  A pre-v6
        connection raises before anything is sent."""
        self._ensure_version(protocol.KV_SHIP_MIN_VERSION,
                             "KV_SHIP (disaggregated prefill)")
        meta: Dict[str, Any] = {"prompt": [int(t) for t in prompt],
                                "max_tokens": int(max_tokens),
                                "keys": [int(x) for x in keys],
                                "n_tokens": int(n_tokens),
                                "stream": bool(stream)}
        if first_token is not None:
            meta["first_token"] = int(first_token)
        if eos_id is not None:
            meta["eos_id"] = int(eos_id)
        if deadline_ms is not None:
            meta["deadline_ms"] = float(deadline_ms)
        pages = None if k is None else tuple(
            t.contiguous() if isinstance(t, torch.Tensor)
            else np.ascontiguousarray(np.asarray(t)) for t in (k, v))

        def send(m, q):
            buffers = []
            if pages is not None and _nbytes(pages[0]) >= SHARD_PUT_MIN_BYTES:
                # big pages: quiet ephemeral PUTs ahead of the frame; a
                # BUSY retry ships them again (the worker consumed them
                # with the rejection)
                ctr = next(self._mint)
                ids = [f"c-kv{ctr}-k", f"c-kv{ctr}-v"]
                for sid, arr in zip(ids, pages):
                    self._submit("PUT", {"buf_id": sid, "ephemeral": True,
                                         "quiet": True}, [arr],
                                 want_reply=False)
                m["kv_bufs"] = ids
            elif pages is not None:
                buffers = list(pages)
            self._submit("KV_SHIP", m, buffers, stream=q)

        return self._stream_request(meta, max_tokens, send, on_token,
                                    receipt_owed=True)

    # -- federated collectives (protocol v7) -----------------------------

    def _stage_upload(self, buf_id: str, arr,
                      stats: Optional[Dict[str, int]] = None) -> None:
        """One quiet ephemeral PUT (q8-eligible), sent before the frame
        that names ``buf_id``; the worker consumes it at first use."""
        self._submit("PUT", {"buf_id": buf_id, "ephemeral": True,
                             "quiet": True}, [arr], want_reply=False,
                     stats=stats)

    def allreduce_ship(self, buf_ids, acc=None,
                       result_id: Optional[str] = None,
                       receipt_only: bool = False,
                       free_src: bool = False,
                       quiet: bool = False,
                       wait: bool = True,
                       stats: Optional[Dict[str, int]] = None,
                       op: str = "sum"):
        """One worker's leg of a federated AllReduce (ALLREDUCE_SHIP,
        v7): the worker sums the resident partials ``buf_ids`` and the
        shipped accumulator ``acc`` (half floats in f32, cast back once),
        then ships the total back (q8 where negotiated) and/or installs
        it resident under ``result_id``.  An ``acc`` of
        ``SHARD_PUT_MIN_BYTES`` or more goes ahead as a quiet ephemeral
        PUT.  ``free_src`` retires the partials with the reduce.
        ``wait=False`` returns the transport Future (resolve it with
        :meth:`finish_collective`); ``quiet`` with ``receipt_only`` makes
        an install fire-and-forget, ordered before later EXECUTEs by the
        worker's per-connection FIFO."""
        self._ensure_version(protocol.FED_MIN_VERSION,
                             "ALLREDUCE_SHIP (federated collectives)")
        meta: Dict[str, Any] = {"op": op,
                                "buf_ids": [str(b) for b in buf_ids]}
        if result_id is not None:
            meta["result_id"] = str(result_id)
        if receipt_only:
            meta["receipt_only"] = True
        if free_src:
            meta["free_src"] = True
        buffers: List = []
        if acc is not None:
            acc = acc.contiguous() if isinstance(acc, torch.Tensor) \
                else np.ascontiguousarray(np.asarray(acc))
            if _nbytes(acc) >= SHARD_PUT_MIN_BYTES:
                aid = f"c-ar{next(self._mint)}"
                self._stage_upload(aid, acc, stats=stats)
                meta["acc_bufs"] = [aid]
            else:
                buffers = [acc]
        if quiet and receipt_only:
            meta["quiet"] = True
            self._submit("ALLREDUCE_SHIP", meta, buffers,
                         want_reply=False, stats=stats)
            return None
        fut = self._submit("ALLREDUCE_SHIP", meta, buffers, stats=stats)
        return fut if not wait else self.finish_collective(fut)

    def allgather_ship(self, buf_ids, axis: int = 0,
                       free_src: bool = False,
                       wait: bool = True,
                       stats: Optional[Dict[str, int]] = None):
        """One worker's leg of a federated AllGather (ALLGATHER_SHIP,
        v7): the worker concatenates its pieces along ``axis`` and ships
        the slice.  Same ``wait`` / ``free_src`` contract as
        :meth:`allreduce_ship`."""
        self._ensure_version(protocol.FED_MIN_VERSION,
                             "ALLGATHER_SHIP (federated collectives)")
        meta: Dict[str, Any] = {"buf_ids": [str(b) for b in buf_ids],
                                "axis": int(axis)}
        if free_src:
            meta["free_src"] = True
        fut = self._submit("ALLGATHER_SHIP", meta, [], stats=stats)
        return fut if not wait else self.finish_collective(fut)

    def finish_collective(self, fut: Future
                          ) -> Tuple[Dict[str, Any], Optional[torch.Tensor]]:
        """Resolve one collective leg: ``(receipt meta, payload tensor or
        None)``.  The receipt's ``_rx_wire`` holds the reply's inbound
        wire accounting."""
        _, rmeta, rbufs = self._result(fut)
        return rmeta, (rbufs[0] if rbufs else None)

    def mint_buf_id(self, tag: str = "r") -> str:
        """A fresh client-minted ``c-`` buffer id (an install target)."""
        return f"c-f{next(self._mint)}-{tag}"

    # -- peer fabric (protocol v9) ----------------------------------------

    def fabric_open(self, cid: str) -> Dict[str, Any]:
        """Rendezvous the worker into fabric collective ``cid``: it parks
        a session so its ring neighbours' PEER_REDUCE / PEER_INSTALL hops
        never race the leg that consumes them.  Open every member before
        launching any leg."""
        self._ensure_version(protocol.FABRIC_MIN_VERSION,
                             "FABRIC_OPEN (peer fabric)")
        _, meta, _ = self._rpc("FABRIC_OPEN", {"cid": str(cid)}, [])
        return meta

    def fabric_allreduce(self, cid: str, buf_ids, ring, index: int,
                         result_id: str, op: str = "sum",
                         free_src: bool = False, quant: bool = False,
                         wait: bool = False,
                         stats: Optional[Dict[str, int]] = None):
        """Launch this worker's leg of a zero-relay ring AllReduce
        (FABRIC_ALLREDUCE, v9): the worker pre-reduces ``buf_ids``, takes
        its slot ``index`` in ``ring`` (``[{"url": ...}, ...]``), relays
        the running sum up-ring and the total down-ring worker to worker
        (q8 per hop with ``quant``) and installs it under ``result_id``.
        The reply is a receipt: no collective payload crosses this
        client.  ``wait=False`` by default, since every member's leg must
        be in flight at once."""
        self._ensure_version(protocol.FABRIC_MIN_VERSION,
                             "FABRIC_ALLREDUCE (peer fabric)")
        meta: Dict[str, Any] = {
            "cid": str(cid),
            "buf_ids": [str(b) for b in buf_ids],
            "ring": [{"url": str(m.get("url", ""))} for m in ring],
            "index": int(index),
            "result_id": str(result_id),
            "op": str(op)}
        if free_src:
            meta["free_src"] = True
        if quant:
            meta["quant"] = True
        fut = self._submit("FABRIC_ALLREDUCE", meta, [], stats=stats)
        return fut if not wait else self.finish_collective(fut)

    # -- state: snapshot / restore and streaming migration -----------------

    def snapshot(self, state_dir: str) -> Dict[str, Any]:
        """Persist the worker's resident buffers and executables under
        ``state_dir``, a path inside the worker's state root."""
        _, meta, _ = self._rpc("SNAPSHOT", {"state_dir": state_dir}, [])
        return meta

    def restore(self, state_dir: str) -> Dict[str, Any]:
        """Re-materialize a snapshot from ``state_dir`` (inside the
        worker's state root); every archive passes the program check."""
        _, meta, _ = self._rpc("RESTORE", {"state_dir": state_dir}, [])
        return meta

    def snapshot_delta(self, target_url: str,
                       target_token: Optional[str] = None,
                       final: bool = False,
                       quant: bool = False) -> Dict[str, Any]:
        """One pre-copy round of a streaming live migration: the worker
        ships every resident buffer dirtied since its previous round (and
        any executable not yet shipped) straight to ``target_url`` as
        staged quiet PUTs, worker to worker, and answers with the round's
        receipt (``buffers``, ``raw_bytes``, ``wire_bytes``,
        ``elapsed_ms``, ``dirty_left``, ``bandwidth_bps``).  The round
        runs as the worker's lowest-weight ``migration`` tenant.  Exact
        by default; ``quant=True`` opts the session into lossy q8."""
        self._ensure_version(protocol.MIGRATE_MIN_VERSION,
                             "SNAPSHOT_DELTA (streaming migration)")
        meta: Dict[str, Any] = {"target_url": str(target_url)}
        if target_token is not None:
            meta["target_token"] = str(target_token)
        if final:
            meta["final"] = True
        if quant:
            meta["quant"] = True
        _, rmeta, _ = self._rpc("SNAPSHOT_DELTA", meta, [])
        return rmeta

    def migrate_freeze(self) -> Dict[str, Any]:
        """Freeze the worker for the final round: mutating requests wait
        at its connection handlers, its dispatcher drains and a hosted
        engine pauses between steps.  The reply reports the
        ``dirty_buffers`` / ``dirty_bytes`` still to ship."""
        self._ensure_version(protocol.MIGRATE_MIN_VERSION,
                             "MIGRATE_FREEZE (streaming migration)")
        _, rmeta, _ = self._rpc("MIGRATE_FREEZE", {}, [])
        return rmeta

    def migrate_commit(self, abort: bool = False) -> Dict[str, Any]:
        """End the migration: ship the final frozen delta, publish the
        staged state on the target, drop it here and thaw, returning
        ``pause_ms``, ``rounds`` and the byte totals.  ``abort=True``
        frees the staged state on the target and thaws with the state
        kept here."""
        self._ensure_version(protocol.MIGRATE_MIN_VERSION,
                             "MIGRATE_COMMIT (streaming migration)")
        meta: Dict[str, Any] = {"abort": True} if abort else {}
        _, rmeta, _ = self._rpc("MIGRATE_COMMIT", meta, [])
        return rmeta

    # ------------------------------------------------------------------

    def remote_jit(self, fn: Callable, microbatch: bool = False) -> Callable:
        """Wrap ``fn`` so calls execute on the remote worker.  ``fn``
        takes and returns tensor pytrees; it is exported here, once per
        argument signature.  The wrapper also exposes ``.submit(*args)
        -> Future`` for pipelined calls, ``.compile_for(*args)``,
        ``.step_resident(*args)`` (results stay on the worker, handles
        come back at once), ``.upload_arg(i, array)`` and ``.on(device)``
        (the same function on another RemoteDevice, sharing this
        wrapper's exports: a federation's members, or a tenant rebinding
        to another worker after a migration, export each signature once
        and only COMPILE it on each worker).

        ``microbatch=True`` declares the executable fusable: the worker
        may run compatible concurrent requests (same executable, from
        this or other connections) in one dispatch, each with its own
        inputs and outputs."""
        return self._remote_jit(fn, microbatch, {})

    def _remote_jit(self, fn: Callable, microbatch: bool,
                    exports: Dict[Any, tuple]) -> Callable:
        """:meth:`remote_jit` with ``exports`` (signature -> exported
        program) shared by every wrapper that ``.on`` derives."""
        #: sig -> (exe_id, out_tree, out_sigs)
        exe_ids: Dict[Any, Tuple[str, Any, list]] = {}
        device = self

        def leaf_sig(l):
            if isinstance(l, (RemoteBuffer, torch.Tensor)):
                return (tuple(l.shape), _wire_dtype(l))
            arr = np.asarray(l)
            return (arr.shape, arr.dtype.name)

        def export(sig, treedef) -> tuple:
            specs = [(shape, protocol.TORCH_DTYPES[dt])
                     for shape, dt in sig[0]]
            blob, out_tree, out_sigs = program.export_program(
                fn, specs, treedef)
            try:
                metas = [torch.empty(shape, dtype=dt, device="meta")
                         for shape, dt in specs]
                flops = estimate_flops(
                    fn, pytree.tree_unflatten(metas, treedef), {})
                mflops = max(int(flops / 1e6), 1)
            except Exception:  # noqa: BLE001
                log.debug("FLOP estimate failed; flat-rate QoS "
                          "charge for this executable", exc_info=True)
                mflops = 1
            return blob, out_tree, out_sigs, mflops

        def prepare(args):
            leaves, treedef = pytree.tree_flatten(args)
            sig = (tuple(leaf_sig(l) for l in leaves), treedef)
            entry = exe_ids.get(sig)
            if entry is None:
                exported = exports.get(sig)
                if exported is None:
                    exported = exports[sig] = export(sig, treedef)
                blob, out_tree, out_sigs, mflops = exported
                cmeta: Dict[str, Any] = {"mflops_hint": mflops}
                if microbatch:
                    cmeta["microbatch"] = True
                _, meta, _ = device._rpc(
                    "COMPILE", cmeta, [np.frombuffer(blob, dtype=np.uint8)])
                entry = (meta["exe_id"], out_tree,
                         [(shape, protocol.WIRE_NAMES[dt])
                          for shape, dt in out_sigs])
                exe_ids[sig] = entry
            return entry, leaves

        def send_execute(entry, leaves, extra_meta=None,
                         want_reply=True, stats=None) -> Optional[Future]:
            """Fire the EXECUTE; returns the raw transport future (None
            for fire-and-forget)."""
            arg_refs: list = []
            buffers: list = []
            for leaf in leaves:
                if isinstance(leaf, RemoteBuffer):
                    arg_refs.append(leaf.buf_id)
                else:
                    arg_refs.append(None)
                    buffers.append(leaf)
            return device._submit(
                "EXECUTE", dict(extra_meta or {}, exe_id=entry[0],
                                arg_refs=arg_refs),
                buffers, want_reply=want_reply, stats=stats)

        def _deadline_meta(deadline_ms):
            """deadline_ms rides the EXECUTE only on a v4 connection —
            an older worker would ignore it silently."""
            if deadline_ms is None:
                return None
            if device._wire_version < 4:
                raise RemoteExecutionError(
                    f"deadline_ms needs protocol v4 but the worker "
                    f"only speaks v{device._wire_version}")
            return {"deadline_ms": int(deadline_ms)}

        fn_name = getattr(fn, "__name__", "") or type(fn).__name__

        def _root_span():
            """client.remote_jit root span, or None (tracing off)."""
            if device.tracer is None:
                return None
            return device.tracer.start_span("client.remote_jit",
                                            attrs={"fn": fn_name})

        def _wire_span(root, exe_id):
            """client.wire child span + the v5 ``trace`` meta carrying
            its context, or (None, None)."""
            if root is None or not root.sampled:
                return None, None
            wire = device.tracer.start_span("client.wire", parent=root,
                                            attrs={"exe_id": exe_id})
            if device._wire_version >= 5:
                return wire, wire.ctx()
            return wire, None

        def _stats_enc(stats):
            if not stats:
                return "raw"
            for enc in ("q8", "zlib"):
                if stats.get(f"buffers_{enc}"):
                    return enc
            return "raw"

        def _wire_done(wire, rmeta, stats=None):
            """Adopt the server-side span tree and close the wire span."""
            if wire is None:
                return
            device.tracer.adopt(rmeta.get("trace_spans") or ())
            wire.finish(n_results=rmeta.get("n_results", 0),
                        microbatched=rmeta.get("microbatched", 0),
                        enc=_stats_enc(stats),
                        wire_bytes=(stats or {}).get("wire_bytes", 0))

        def _extra(root, entry, deadline_ms):
            wire, trace_meta = _wire_span(root, entry[0])
            extra = _deadline_meta(deadline_ms)
            if trace_meta is not None:
                extra = dict(extra or {}, trace=trace_meta)
            return wire, extra, ({} if wire is not None else None)

        @functools.wraps(fn)
        def remote(*args, deadline_ms: Optional[int] = None):
            root = _root_span()
            try:
                ser = device.tracer.start_span(
                    "client.serialize", parent=root,
                    attrs={"cached": bool(exe_ids)}) \
                    if root is not None else None
                entry, leaves = prepare(args)
                if ser is not None:
                    ser.finish(exe_id=entry[0])
                reconnects = busy = 0
                while True:
                    wire, extra, stats = _extra(root, entry, deadline_ms)
                    fut = send_execute(entry, leaves, extra_meta=extra,
                                       stats=stats)
                    try:
                        _, rmeta, results = device._result(fut)
                        _wire_done(wire, rmeta, stats)
                        if root is not None:
                            root.finish(busy_retries=busy,
                                        reconnects=reconnects)
                        return pytree.tree_unflatten(results, entry[1])
                    except RemoteBusyError as e:
                        if wire is not None:
                            wire.finish(error="BUSY")
                        busy += 1
                        if busy > MAX_BUSY_RETRIES:
                            raise
                        default_clock().sleep(e.backoff_s(busy))
                    except ConnectionError:
                        if wire is not None:
                            wire.finish(error="ConnectionError")
                        reconnects += 1
                        if reconnects > 1:
                            raise
                        device.close()
            except BaseException as e:
                if root is not None and root.end_s is None:
                    root.finish(error=f"{type(e).__name__}: {e}"[:200])
                raise

        def submit(*args, deadline_ms: Optional[int] = None) -> Future:
            """Pipelined call: a Future of the result pytree.  BUSY is
            NOT retried here — a pipelined caller is exactly the load the
            worker is pushing back on, so the Future fails with
            RemoteBusyError and the caller applies its own flow
            control."""
            root = _root_span()
            entry, leaves = prepare(args)
            wire, extra, stats = _extra(root, entry, deadline_ms)
            raw = send_execute(entry, leaves, extra_meta=extra,
                               stats=stats)
            out: Future = Future()

            def _chain(f: Future):
                try:
                    rkind, rmeta, results = f.result()
                    if rkind == "ERROR":
                        if wire is not None:
                            device.tracer.adopt(
                                rmeta.get("trace_spans") or ())
                            wire.finish(error=rmeta.get("code")
                                        or "error")
                        _raise_reply_error(rmeta)
                    _wire_done(wire, rmeta, stats)
                    if root is not None:
                        root.finish()
                    out.set_result(pytree.tree_unflatten(results,
                                                         entry[1]))
                except BaseException as e:  # noqa: BLE001
                    if root is not None and root.end_s is None:
                        root.finish(error=f"{type(e).__name__}")
                    out.set_exception(e)

            raw.add_done_callback(_chain)
            return out

        def compile_for(*args):
            """Compile for this argument signature without executing
            (tensors, arrays or RemoteBuffers work as examples)."""
            return prepare(args)[0]

        def step_resident(*args, free: Tuple = (), wait: bool = False,
                          acked: bool = False):
            """Execute with results kept resident on the worker and
            return their handles WITHOUT waiting for any round trip:
            result ids are client-minted and the request is fire-and-
            forget, so a chain ``state = remote.step_resident(state)``
            streams at the worker's service rate.  ``free=``
            fire-and-forgets FREEs of no-longer-needed handles.  Errors
            surface at the next synchronous boundary (a fetch).
            ``wait=True`` makes the step one round trip; ``acked=True``
            returns ``(handles, Future)`` of the completion ack."""
            device._ensure_v3("step_resident (client-minted result ids)")
            entry, leaves = prepare(args)
            _, out_tree, out_sigs = entry
            ctr = next(device._mint)
            ids = [f"c-r{ctr}-{j}" for j in range(len(out_sigs))]
            want_ack = wait or acked
            fut = send_execute(
                entry, leaves,
                extra_meta={"keep_results": True, "result_ids": ids,
                            **({} if want_ack else {"quiet": True})},
                want_reply=want_ack)
            if free:
                dead = [h.buf_id for h in (free if isinstance(
                    free, (tuple, list)) else (free,))]
                device._submit("FREE", {"buf_ids": dead, "quiet": True},
                               [], want_reply=False)
            if wait:
                device._result(fut)
            handles = [RemoteBuffer(device, i, shape, dtype)
                       for i, (shape, dtype) in zip(ids, out_sigs)]
            out = pytree.tree_unflatten(handles, out_tree)
            if acked and not wait:
                return out, fut
            return out

        def upload_arg(index: int, array, *example_args) -> RemoteBuffer:
            """Park argument ``index`` resident ahead of calls (on one
            device: a plain resident buffer).  Needs the call signature:
            example args, or an earlier call."""
            if example_args:
                prepare(example_args)
            elif not exe_ids:
                raise RemoteExecutionError(
                    "upload_arg needs the call signature: pass example "
                    "args (upload_arg(i, array, *example_args)) or call "
                    "the function once first")
            return device.put(array)

        remote._tpf_remote = True  # noqa: SLF001
        remote.submit = submit
        remote.compile_for = compile_for
        remote.upload_arg = upload_arg
        remote.step_resident = step_resident
        remote.on = lambda other: other._remote_jit(fn, microbatch, exports)
        return remote
