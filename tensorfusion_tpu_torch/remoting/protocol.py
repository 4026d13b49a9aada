"""Remote-execution wire protocol (TPFR): the port's copy of
``tensorfusion_tpu/remoting/protocol.py``, framing torch tensors.

One frame is ``MAGIC | u32 version | u32 header length | JSON header |
buffers``.  The header is ``{"kind", "meta", "buffers": [desc, ...]}``,
one desc per buffer: ``shape``, ``dtype`` (a wire name), ``nbytes`` on
the wire, ``raw_nbytes`` decoded, and ``enc``:

- ``raw``: the little-endian bytes of the tensor;
- ``zlib``: those bytes deflated, chosen per buffer only when a prefix
  probe and then the whole buffer shrink below ``COMPRESS_GAIN``;
- ``q8`` (protocol >= 6, opt-in, lossy): ``[f32 per-block scales][int8
  values]`` for f32 / f16 / bf16 buffers of at least ``Q8_MIN_BYTES``,
  ``s = max|block| / 127``, ``q = rint(x / s)``, chosen when it ships
  fewer bytes than the other candidate.

Requests carry a ``seq`` the responder echoes, so a client pipelines
many requests on one connection.  HELLO is always framed at version 2
and negotiates the connection's version (``max_version``), QoS class
(``qos``, v4) and q8 replies (``quant``, v6).  Version 3 adds the mesh
fields (:data:`SHARD_MIN_VERSION`), client-minted ids and ephemeral
buffers; v4 deadlines and structured
``BUSY`` / ``DEADLINE_EXCEEDED`` errors; v5 ``trace`` contexts and
server ``trace_spans``; v6 q8; v7-v9 the federated, migration and
peer-fabric kinds.  The registries below list every kind of the
reference; the port's worker serves all of them but COMPILE_MLIR (the
raw-StableHLO path of the reference's PJRT plugin), which it answers
with ``unknown kind``.  No pickle rides the wire.

bf16 needs no ``ml_dtypes``: the port frames bf16 torch tensors as their
2-byte payload under ``dtype: "bfloat16"``, exactly as the reference
frames an ``ml_dtypes.bfloat16`` array; q8 widens bf16 to f32 exactly
(torch's ``.float()``, the ``u16 << 16`` of the bits) and narrows back
rounding to nearest even, as ``astype(ml_dtypes.bfloat16)`` does, so
the frames are byte-equal to the reference's.  Decoded buffers are CPU
torch tensors (``recv_message``); ``encode_message`` takes torch tensors
or numpy arrays.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

MAGIC = b"TPFR"
VERSION = 9
#: frame versions this build can decode (v3-v9 are additive over v2)
SUPPORTED_VERSIONS = (2, 3, 4, 5, 6, 7, 8, 9)
#: version every HELLO is framed at, so any peer can read it
HELLO_VERSION = 2
#: lowest wire version that may carry the mesh fields (reference v3):
#: COMPILE_OK ``nr_devices`` / ``arg_layouts`` / ``out_layouts`` (a list
#: of ``{"device": id, "slices": [[lo, hi], ...]}`` an argument or result,
#: null when replicated), EXECUTE ``arg_shards`` (per argument, null or
#: its shards in layout order: a resident id, or null for the next inline
#: buffer), PUT and FETCH ``device_id``; a sharded program compiles only
#: on such a connection.  The client refuses to send them below it, the
#: worker to honor them.  INFO's ``n_devices``, ``devices`` (``id``,
#: ``coords``) and ``resident_bytes_per_device`` go to every version, as
#: the reference's do.
SHARD_MIN_VERSION = 3
#: lowest wire version whose frames may carry ``enc="q8"`` buffers
Q8_MIN_VERSION = 6
#: lowest wire version that may carry KV_SHIP (the client refuses to
#: send it below, the worker to honor it below)
KV_SHIP_MIN_VERSION = 6
#: lowest wire version that may carry the federated collectives
#: (ALLREDUCE_SHIP / ALLGATHER_SHIP); gated at both ends like KV_SHIP
FED_MIN_VERSION = 7
#: lowest wire version that may carry streaming live migration
#: (SNAPSHOT_DELTA / MIGRATE_FREEZE / MIGRATE_COMMIT)
MIGRATE_MIN_VERSION = 8
#: lowest wire version that may carry the peer fabric (FABRIC_OPEN /
#: FABRIC_ALLREDUCE and the worker-to-worker PEER_REDUCE / PEER_INSTALL
#: hops): the client refuses to send the FABRIC kinds below it and the
#: worker refuses every v9 kind from a connection below it
FABRIC_MIN_VERSION = 9
#: ceiling on a FABRIC_ALLREDUCE ``ring`` member list: the ring and its
#: ``index`` arrive off the wire, so both are bounded before use
MAX_FABRIC_RING = 64

# -- opcode / reply / error-code registry ---------------------------------

#: client -> worker request kinds
REQUEST_KINDS = ("HELLO", "INFO", "COMPILE", "COMPILE_MLIR", "PUT",
                 "FREE", "FETCH", "EXECUTE", "GENERATE", "KV_SHIP",
                 "ALLREDUCE_SHIP", "ALLGATHER_SHIP",
                 "SNAPSHOT", "RESTORE",
                 "SNAPSHOT_DELTA", "MIGRATE_FREEZE", "MIGRATE_COMMIT",
                 "FABRIC_OPEN", "FABRIC_ALLREDUCE",
                 "PEER_REDUCE", "PEER_INSTALL")
#: request kinds the python client never sends
CLIENT_OPTIONAL_KINDS = ("COMPILE_MLIR", "PEER_REDUCE", "PEER_INSTALL")
#: worker -> client reply kinds
REPLY_KINDS = ("HELLO_OK", "INFO_OK", "COMPILE_OK", "PUT_OK", "FREE_OK",
               "FETCH_OK", "EXECUTE_OK", "GENERATE_OK", "KV_SHIP_OK",
               "ALLREDUCE_SHIP_OK", "ALLGATHER_SHIP_OK",
               "SNAPSHOT_OK", "RESTORE_OK",
               "SNAPSHOT_DELTA_OK", "MIGRATE_FREEZE_OK",
               "MIGRATE_COMMIT_OK",
               "FABRIC_OPEN_OK", "FABRIC_ALLREDUCE_OK",
               "PEER_REDUCE_OK", "PEER_INSTALL_OK", "ERROR")
#: structured ERROR ``code`` values (v4; older clients see plain ERROR)
ERROR_CODES = ("BUSY", "DEADLINE_EXCEEDED", "needs_compile")
#: per-buffer wire encodings, in the order they were introduced; the
#: first entry is the wire default (a buffer desc without ``enc`` is raw)
WIRE_ENCODINGS = ("raw", "zlib", "q8")

#: elements per q8 scale block — small enough that one outlier only
#: poisons its own block's precision, big enough that the f32 scale
#: overhead stays under 1% of the int8 payload
Q8_BLOCK = 512
#: buffers below this size ship exact — the quantize pass plus the
#: per-buffer desc overhead beats the saved bytes on small payloads
Q8_MIN_BYTES = 16 << 10
#: dtypes eligible for q8 (lossy) encoding; ints/bools/f64 are the
#: exact-path opt-out — they never quantize, whatever the policy says
Q8_DTYPES = frozenset(("float32", "float16", "bfloat16"))

#: buffers at or above this size are candidates for compression
COMPRESS_MIN_BYTES = 16 << 10
#: compression must shrink the buffer to below this fraction to be used
COMPRESS_GAIN = 0.9
#: cheap compressibility probe: compress only this prefix first
COMPRESS_PROBE_BYTES = 4 << 10
#: peers on this host: no adaptive zlib to them unless forced
LOOPBACK_HOSTS = frozenset(("127.0.0.1", "::1", "localhost"))


def default_compress(peer_host: str, forced: Optional[bool] = None) -> bool:
    """Whether a connection to ``peer_host`` tries the adaptive zlib
    encoding, the one rule of both ends: ``forced`` when given, else
    ``TPF_REMOTING_COMPRESS=1`` / ``0``, else never to a loopback peer
    (deflating bf16 weights runs at tens of MB/s, far below a same-host
    socket) and adaptively to a remote one."""
    if forced is None:
        forced = {"1": True, "0": False}.get(
            os.environ.get("TPF_REMOTING_COMPRESS", ""))
    if forced is not None:
        return forced
    return peer_host not in LOOPBACK_HOSTS

#: wire dtype name <-> torch dtype (bool is one byte, as numpy's)
TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "uint16": torch.uint16,
    "uint32": torch.uint32, "uint64": torch.uint64, "bool": torch.bool}
WIRE_NAMES = {v: k for k, v in TORCH_DTYPES.items()}
_DTYPES = frozenset(TORCH_DTYPES)

#: hard ceilings a peer's header cannot exceed — the framing layer must be
#: safe *before* the worker's HELLO auth gate runs, so sizes are bounded
#: here rather than trusted from the wire (a huge ``nbytes``/``hlen`` or a
#: zlib bomb would otherwise allocate arbitrary memory pre-auth)
MAX_HEADER_BYTES = 4 << 20
MAX_BUFFER_BYTES = 8 << 30
#: ceiling on a q8 desc's ``q8_block``: the decoder materializes one
#: f32 scale per block *and* ``np.repeat`` expands scales by ``block``
#: elements, so an unbounded block is an allocation bomb even when the
#: dequantized output itself passes the MAX_BUFFER_BYTES check
Q8_MAX_BLOCK = 1 << 20


def itemsize(name: str) -> int:
    return torch.empty((), dtype=TORCH_DTYPES[name]).element_size()


class _Wire:
    """One outgoing buffer: its wire dtype name, shape, element count,
    byte size and a zero-copy uint8 view of its bytes."""

    __slots__ = ("dtype", "shape", "size", "nbytes", "u8", "src")

    def __init__(self, buf):
        if isinstance(buf, torch.Tensor):
            t = buf.detach()
            if t.device.type != "cpu":
                t = t.cpu()
            t = t.contiguous()
            if t.dtype not in WIRE_NAMES:
                raise ValueError(f"unsupported dtype {t.dtype}")
            self.dtype = WIRE_NAMES[t.dtype]
            self.shape = list(t.shape)
            self.size = t.numel()
            self.u8 = t.reshape(-1).view(torch.uint8).numpy()
        else:
            arr = np.ascontiguousarray(buf)
            if arr.dtype.name not in _DTYPES:
                raise ValueError(f"unsupported dtype {arr.dtype.name}")
            self.dtype = arr.dtype.name
            self.shape = list(arr.shape)
            self.size = arr.size
            self.u8 = arr.reshape(-1).view(np.uint8)
            t = arr
        self.src = t
        self.nbytes = self.u8.nbytes

    def as_f32(self) -> np.ndarray:
        """The values as a flat f32 array (exact for f16 and bf16)."""
        if isinstance(self.src, torch.Tensor):
            return self.src.reshape(-1).float().numpy()
        if self.dtype == "bfloat16":
            # a foreign bf16 numpy array: widen its bits, u16 << 16
            bits = self.src.reshape(-1).view(np.uint16).astype(np.uint32)
            return (bits << 16).view(np.float32)
        return np.asarray(self.src, dtype=np.float32).reshape(-1)


class BufferPool:
    """Reusable per-connection scratch for q8 wire payloads.

    Lifetime rule: views carved by :meth:`take` stay valid until
    :meth:`reset` is next called, and ``reset`` is called once per
    *message* by the encoder — callers must hold their connection's send
    serializer (the client's ``_send_lock``, the worker's per-connection
    write lock) across encode+send, which every send path already does.
    The pool never shrinks; a connection's scratch converges to its
    largest message."""

    def __init__(self):
        self._buf = bytearray()
        self._cursor = 0
        #: accounting surfaced in wire stats: takes / regrows
        self.takes = 0
        self.grown = 0

    def reset(self) -> None:
        self._cursor = 0

    def take(self, nbytes: int) -> memoryview:
        if self._cursor + nbytes > len(self._buf):
            # replace, never resize: earlier views from this message
            # keep the old bytearray alive and stay valid
            grow = max(nbytes, 2 * len(self._buf), 64 << 10)
            self._buf = bytearray(grow)
            self._cursor = 0
            self.grown += 1
        view = memoryview(self._buf)[self._cursor:self._cursor + nbytes]
        self._cursor += nbytes
        self.takes += 1
        return view


def _from_f32(out: np.ndarray, dtype: str, shape) -> torch.Tensor:
    """Dequantized f32 values into the wire dtype: f32 and f16 cast
    as numpy casts them; bf16 rounds to nearest even (torch's cast,
    ``astype(ml_dtypes.bfloat16)``'s rounding)."""
    t = torch.from_numpy(out)
    return t.to(TORCH_DTYPES[dtype]).reshape(shape)


class Q8Array:
    """A received q8 buffer kept in its quantized form (``dequant_q8=
    False`` consumers — a quant-aware kernel that wants the int8 payload
    and block scales directly instead of paying the dequant)."""

    __slots__ = ("q", "scales", "block", "dtype", "shape")

    def __init__(self, q: np.ndarray, scales: np.ndarray, block: int,
                 dtype: str, shape):
        self.q = q                  # int8 [n]
        self.scales = scales        # f32 [ceil(n/block)]
        self.block = block
        self.dtype = dtype          # wire dtype name to dequantize to
        self.shape = tuple(shape)

    def dequantize(self) -> torch.Tensor:
        out = self.q.astype(np.float32) * \
            np.repeat(self.scales, self.block)[:self.q.size]
        return _from_f32(out, self.dtype, self.shape)


def _q8_wire_nbytes(n: int, block: int = Q8_BLOCK) -> int:
    nb = -(-n // block)     # ceil
    return nb * 4 + n


def q8_encode(arr, pool: Optional[BufferPool] = None
              ) -> Optional[memoryview]:
    """Quantize one float tensor (or array) into the q8 wire layout
    ``[f32 scales][int8 values]``, written straight into the pool's
    scratch.  Returns None when the values hold inf/nan (they poison
    the block scale — the buffer must ship exact instead)."""
    wire = arr if isinstance(arr, _Wire) else _Wire(arr)
    flat = wire.as_f32()
    n = flat.size
    nb = -(-n // Q8_BLOCK)
    pad = nb * Q8_BLOCK - n
    absf = np.abs(flat)
    if pad:
        bm = np.empty(nb, np.float32)
        if nb > 1:
            bm[:-1] = absf[:(nb - 1) * Q8_BLOCK] \
                .reshape(nb - 1, Q8_BLOCK).max(axis=1)
        bm[-1] = absf[(nb - 1) * Q8_BLOCK:].max()
    else:
        bm = absf.reshape(nb, Q8_BLOCK).max(axis=1)
    if not np.isfinite(bm).all():
        return None
    wire_len = _q8_wire_nbytes(n)
    out = pool.take(wire_len) if pool is not None else \
        memoryview(bytearray(wire_len))
    scales = np.frombuffer(out, dtype="<f4", count=nb)
    np.divide(np.maximum(bm, 1e-12), 127.0, out=scales)
    q = np.frombuffer(out, dtype=np.int8, count=n, offset=nb * 4)
    per_elem = np.repeat(scales, Q8_BLOCK)[:n]
    tmp = flat / per_elem
    np.rint(tmp, out=tmp)
    np.clip(tmp, -127, 127, out=tmp)
    q[:] = tmp.astype(np.int8)
    return out


def q8_decode(raw, desc: Dict[str, Any], dequant: bool = True):
    """Decode one q8 wire payload against its (untrusted) buffer desc.

    Every allocation here is bounded by the DECLARED shape/dtype before
    any decode work happens — the q8 analog of the zlib-bomb defence:
    the dequantized output can never exceed ``MAX_BUFFER_BYTES`` nor
    disagree with ``raw_nbytes``, and the payload length must be
    exactly what the shape implies (a malformed frame fails loudly
    instead of desyncing the connection)."""
    dtype = desc["dtype"]
    if dtype not in Q8_DTYPES:
        raise ValueError(f"q8 buffer with non-quantizable dtype {dtype}")
    block = int(desc.get("q8_block") or 0)
    if block <= 0 or block > Q8_MAX_BLOCK:
        raise ValueError("q8 buffer q8_block outside (0, Q8_MAX_BLOCK]")
    shape = desc["shape"]
    n = 1
    for dim in shape:
        if int(dim) < 0:
            raise ValueError("q8 buffer with negative dimension")
        n *= int(dim)
    out_nbytes = n * itemsize(dtype)
    if out_nbytes > MAX_BUFFER_BYTES:
        raise ValueError("q8 dequantized size exceeds cap")
    if desc.get("raw_nbytes") != out_nbytes:
        raise ValueError("q8 raw_nbytes disagrees with declared shape")
    nb = -(-n // block)
    if len(raw) != nb * 4 + n:
        raise ValueError("q8 payload length disagrees with declared "
                         "shape")
    scales = np.frombuffer(raw, dtype="<f4", count=nb)
    q = np.frombuffer(raw, dtype=np.int8, count=n, offset=nb * 4)
    if not dequant:
        return Q8Array(q, scales, block, dtype, shape)
    out = q.astype(np.float32) * np.repeat(scales, block)[:n]
    return _from_f32(out, dtype, shape)


def encode_message_parts(kind: str, meta: Dict[str, Any],
                         buffers: List,
                         compress: bool = False,
                         version: int = VERSION,
                         stats: Optional[Dict[str, int]] = None,
                         quantize: bool = False,
                         pool: Optional[BufferPool] = None) -> List:
    """Wire pieces for one message: [head_bytes, buf_view, ...].

    Buffer payloads stay as zero-copy views over the (contiguous)
    tensors.  ``compress=True`` is *adaptive per buffer*: a cheap prefix
    probe decides whether deflating is worth it, and the buffer ships
    raw whenever compression would not actually shrink it.
    ``quantize=True`` (v6 connections whose peer opted in) additionally
    offers the lossy q8 encoding to eligible float buffers — per buffer,
    whichever candidate ships the fewest bytes wins.  q8 payloads are
    quantized straight into ``pool``.  ``stats``, when given,
    accumulates ``raw_bytes`` / ``wire_bytes`` / ``buffers_<enc>``."""
    descs = []
    views: List = []
    if pool is not None:
        pool.reset()
    quantize = quantize and version >= Q8_MIN_VERSION
    for buf in buffers:
        arr = _Wire(buf)
        raw_nbytes = arr.nbytes
        if raw_nbytes > MAX_BUFFER_BYTES:
            # fail fast sender-side: past this point the receiver would
            # abort mid-stream and desync the whole pipelined connection
            raise ValueError(
                f"buffer of {raw_nbytes} bytes exceeds the "
                f"{MAX_BUFFER_BYTES}-byte wire cap")
        dtype = arr.dtype
        enc = "raw"
        wire = arr.u8.data   # zero-copy view
        zbytes = None
        if compress and raw_nbytes >= COMPRESS_MIN_BYTES:
            # the probe reads the prefix alone; the whole buffer is
            # copied and deflated only when the probe shows gain
            probe = zlib.compress(arr.u8[:COMPRESS_PROBE_BYTES].tobytes(), 1)
            if len(probe) < COMPRESS_PROBE_BYTES * COMPRESS_GAIN:
                z = zlib.compress(arr.u8, 1)
                if len(z) < raw_nbytes * COMPRESS_GAIN:
                    enc, wire, zbytes = "zlib", z, len(z)
        if quantize and dtype in Q8_DTYPES and \
                raw_nbytes >= Q8_MIN_BYTES:
            # adaptive vs the zlib candidate: q8's size is known up
            # front, so only quantize when it would actually win
            q8_len = _q8_wire_nbytes(arr.size)
            if q8_len < (zbytes if zbytes is not None else raw_nbytes):
                qwire = q8_encode(arr, pool)
                if qwire is not None:       # non-finite values ship exact
                    enc, wire = "q8", qwire
        desc = {"shape": arr.shape, "dtype": dtype,
                "nbytes": len(wire), "raw_nbytes": raw_nbytes,
                "enc": enc}
        if enc == "q8":
            desc["q8_block"] = Q8_BLOCK
        descs.append(desc)
        views.append(wire)
        if stats is not None:
            stats["raw_bytes"] = stats.get("raw_bytes", 0) + raw_nbytes
            stats["wire_bytes"] = stats.get("wire_bytes", 0) + len(wire)
            key = f"buffers_{enc}"
            stats[key] = stats.get(key, 0) + 1
    header = json.dumps({"kind": kind, "meta": meta,
                         "buffers": descs}).encode()
    head = MAGIC + struct.pack("<II", version, len(header)) + header
    if stats is not None:
        # whole frames, header included (the buffer counters above count
        # payloads only)
        stats["frames"] = stats.get("frames", 0) + 1
        stats["frame_bytes"] = stats.get("frame_bytes", 0) + len(head) + \
            sum(d["nbytes"] for d in descs)
    return [head] + views


def encode_message(kind: str, meta: Dict[str, Any], buffers: List,
                   compress: bool = False,
                   version: int = VERSION,
                   quantize: bool = False) -> bytes:
    return b"".join(bytes(p) if not isinstance(p, (bytes, bytearray))
                    else p
                    for p in encode_message_parts(kind, meta, buffers,
                                                  compress=compress,
                                                  version=version,
                                                  quantize=quantize))


def _read_exact(sock: socket.socket, n: int) -> bytearray:
    """Read exactly n bytes into one preallocated buffer (recv_into, no
    chunk-list join copy)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed")
        got += r
    return buf


#: sendmsg iovec ceiling per call — POSIX IOV_MAX is >= 1024 everywhere
#: this runs; frames are [header + one view per buffer]
_IOV_MAX = 512
_HAS_SENDMSG = hasattr(socket.socket, "sendmsg")


def _send_parts(sock: socket.socket, parts: List) -> None:
    """One vectored ``sendmsg`` scatter-gather per frame, straight from
    the part views — no per-part syscall train, no payload joins.
    Partial sends advance the iovec and retry; platforms without
    ``sendmsg`` fall back to per-part ``sendall``.  Empty parts (a
    zero-size tensor) are dropped: ``sendmsg`` of only empty views
    sends 0 bytes and would spin."""
    views = [memoryview(p).cast("B") if not isinstance(p, memoryview)
             else p.cast("B") for p in parts]
    views = [v for v in views if len(v)]
    if not _HAS_SENDMSG:
        for v in views:
            sock.sendall(v)
        return
    while views:
        sent = sock.sendmsg(views[:_IOV_MAX])
        while sent > 0 and views:
            if sent >= len(views[0]):
                sent -= len(views[0])
                views.pop(0)
            else:
                views[0] = views[0][sent:]
                sent = 0


def send_message(sock: socket.socket, kind: str, meta: Dict[str, Any],
                 buffers: List, compress: bool = False,
                 version: int = VERSION,
                 stats: Optional[Dict[str, int]] = None,
                 quantize: bool = False,
                 pool: Optional[BufferPool] = None) -> None:
    _send_parts(sock, encode_message_parts(kind, meta, buffers,
                                           compress=compress,
                                           version=version,
                                           stats=stats,
                                           quantize=quantize,
                                           pool=pool))


def _tensor_of(raw, desc: Dict[str, Any]) -> torch.Tensor:
    """A raw payload as a CPU tensor of its desc's dtype and shape
    (zero-copy over the receive buffer)."""
    dtype = desc["dtype"]
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype}")
    shape = [int(d) for d in desc["shape"]]
    if any(d < 0 for d in shape):
        raise ValueError("buffer with negative dimension")
    n = 1
    for d in shape:
        n *= d
    if n * itemsize(dtype) != len(raw):
        raise ValueError("buffer length disagrees with declared shape")
    if n == 0:
        return torch.empty(shape, dtype=TORCH_DTYPES[dtype])
    if not isinstance(raw, bytearray):
        raw = bytearray(raw)
    return torch.frombuffer(raw, dtype=TORCH_DTYPES[dtype]).reshape(shape)


def recv_message(sock: socket.socket,
                 accept: Tuple[int, ...] = SUPPORTED_VERSIONS,
                 stats: Optional[Dict[str, int]] = None,
                 dequant_q8: bool = True
                 ) -> Tuple[str, Dict[str, Any], List]:
    """Read one frame; buffers come back as CPU torch tensors.
    ``stats``, when given, accumulates the same ``raw_bytes`` /
    ``wire_bytes`` / per-enc buffer counters the send side keeps.
    ``dequant_q8=False`` hands q8 buffers back as :class:`Q8Array`
    instead of paying the dequantize; every bounds check still runs."""
    head = _read_exact(sock, len(MAGIC) + 8)
    if head[:4] != MAGIC:
        raise ValueError("bad magic")
    version, hlen = struct.unpack("<II", head[4:])
    if version not in accept:
        raise ValueError(f"protocol version {version} not in {accept}")
    if hlen > MAX_HEADER_BYTES:
        raise ValueError(f"header of {hlen} bytes exceeds cap")
    header = json.loads(_read_exact(sock, hlen))
    if stats is not None:
        # whole frames, header included (the buffer counters below count
        # payloads only)
        stats["frames"] = stats.get("frames", 0) + 1
        stats["frame_bytes"] = stats.get("frame_bytes", 0) + len(head) + hlen
    buffers = []
    for desc in header["buffers"]:
        nbytes, raw_nbytes = desc["nbytes"], desc.get("raw_nbytes")
        if nbytes > MAX_BUFFER_BYTES or (raw_nbytes or 0) > MAX_BUFFER_BYTES:
            raise ValueError("buffer exceeds size cap")
        raw = _read_exact(sock, nbytes)
        enc = desc.get("enc", "raw")
        if stats is not None:
            stats["raw_bytes"] = stats.get("raw_bytes", 0) + \
                int(raw_nbytes or nbytes)
            stats["wire_bytes"] = stats.get("wire_bytes", 0) + nbytes
            stats["frame_bytes"] += nbytes
            key = f"buffers_{enc}"
            stats[key] = stats.get(key, 0) + 1
        if enc == "q8":
            # like the frame-version gate above, enforced below the
            # feature gate: a pre-v6 frame must never smuggle a q8
            # buffer past a peer that did not negotiate it
            if version < Q8_MIN_VERSION:
                raise ValueError(
                    f"q8 buffer in a v{version} frame (q8 needs "
                    f"protocol >= {Q8_MIN_VERSION})")
            buffers.append(q8_decode(raw, desc, dequant=dequant_q8))
            continue
        if enc == "zlib":
            # raw_nbytes must be a positive bound: zlib's max_length=0
            # means *unlimited*, so 0 (or a missing/negative value) would
            # turn the bounded decompression below into a bomb vector
            if not raw_nbytes or raw_nbytes < 0:
                raise ValueError("compressed buffer without a positive "
                                 "raw_nbytes")
            # bounded decompression: never inflate past the declared size,
            # and reject trailing compressed data (zlib-bomb defence)
            d = zlib.decompressobj()
            raw = d.decompress(raw, raw_nbytes)
            if len(raw) != raw_nbytes or d.decompress(b"", 1) or \
                    d.unconsumed_tail:
                raise ValueError("decompressed size mismatch")
        buffers.append(_tensor_of(raw, desc))
    return header["kind"], header["meta"], buffers
