"""The port's TPFR wire protocol against the JAX package's, on the CPU.

The same kind, meta and buffers (numpy for the reference, torch for the
port; bf16 through ``ml_dtypes`` on one side and torch on the other)
must give byte-equal frames for every encoding and version, each
package must decode the other's frames over a socketpair, and the
framing caps must refuse what the reference's refuse
(tests/test_remoting.py ``test_preauth_framing_is_bounded`` and
``test_q8_malformed_frames_rejected``).
"""

import json
import socket
import struct
import threading
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

from tensorfusion_tpu.remoting import protocol as R  # noqa: E402
from tensorfusion_tpu_torch.remoting import protocol as P  # noqa: E402

DTYPES = ["float32", "float16", "bfloat16", "int8", "int32", "bool",
          "float64"]
ENCS = ["raw", "zlib", "q8"]


def _numpy(dtype, n=20000, seed=0, enc="raw"):
    """A reference-side buffer: ``n`` values of ``dtype`` (half of them
    zero for zlib, so deflate wins)."""
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        a = rng.integers(0, 2, n).astype(bool)
    elif dtype.startswith("int"):
        a = rng.integers(-100, 100, n).astype(dtype)
    else:
        np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype
        a = (rng.standard_normal(n) * 3).astype(np_dtype)
    if enc == "zlib":
        a[: n // 2] = 0
    return a


def _torch(a):
    """The port-side twin of a reference buffer (bf16 via its bits)."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x):
    """Comparable raw bytes of a tensor or array."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _kw(enc, version):
    return dict(compress=enc != "raw", quantize=enc == "q8", version=version)


@pytest.mark.parametrize("version", [2, 6, 9])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("enc", ENCS)
def test_frames_byte_equal_to_reference(enc, dtype, version):
    a = _numpy(dtype, enc=enc)
    meta = {"seq": 7, "exe_id": "e", "arg_refs": [None, None]}
    want = R.encode_message("EXECUTE", meta, [a, a[:5]], **_kw(enc, version))
    got = P.encode_message("EXECUTE", meta, [_torch(a), _torch(a[:5])],
                           **_kw(enc, version))
    assert got == want
    # the port frames numpy buffers the same way
    assert P.encode_message("EXECUTE", meta, [a, a[:5]],
                            **_kw(enc, version)) == want
    # the encoding the frame really carries
    stats = {}
    P.encode_message_parts("EXECUTE", meta, [_torch(a)], stats=stats,
                           **_kw(enc, version))
    expect_q8 = enc == "q8" and version >= 6 and dtype in P.Q8_DTYPES
    assert ("buffers_q8" in stats) == expect_q8


def _over_socketpair(frame: bytes, recv):
    """``recv`` of one frame sent from another thread (a frame larger
    than the socket buffer would block a same-thread send)."""
    a, b = socket.socketpair()
    b.settimeout(30)

    def send():
        try:
            a.sendall(frame)
        except OSError:
            pass        # the receiver refused the frame and closed

    th = threading.Thread(target=send, daemon=True)
    th.start()
    try:
        return recv(b)
    finally:
        b.close()
        th.join(timeout=30)
        a.close()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("enc", ENCS)
def test_each_package_decodes_the_others_frames(enc, dtype):
    a = _numpy(dtype, seed=1, enc=enc)
    kw = _kw(enc, P.VERSION)
    ref_frame = R.encode_message("FETCH_OK", {"seq": 1}, [a], **kw)
    port_frame = P.encode_message("FETCH_OK", {"seq": 1}, [_torch(a)], **kw)
    # port decodes the reference's frame, and the reference the port's
    pk, pm, pb = _over_socketpair(ref_frame, P.recv_message)
    rk, rm, rb = _over_socketpair(port_frame, R.recv_message)
    assert (pk, pm) == (rk, rm) == ("FETCH_OK", {"seq": 1})
    assert isinstance(pb[0], torch.Tensor) and pb[0].dtype == P.TORCH_DTYPES[dtype]
    assert tuple(pb[0].shape) == rb[0].shape == a.shape
    # both sides hold the same values, bit for bit (q8 is lossy, but the
    # two dequantizations agree)
    assert _bits(pb[0]) == _bits(rb[0])
    if enc != "q8" or dtype not in P.Q8_DTYPES:
        assert _bits(pb[0]) == _bits(a)


def test_q8_to_bf16_decode_is_bit_equal():
    """Dequantized values land on bf16 by round-to-nearest-even on both
    sides, ties included (values built to sit halfway between two bf16
    numbers after the scale multiply are common in this range)."""
    rng = np.random.default_rng(3)
    for scale in (1e-3, 1.0, 7.5, 3e4):
        a = (rng.standard_normal(100_000) * scale).astype(ml_dtypes.bfloat16)
        wire = bytes(R.q8_encode(a))
        assert bytes(P.q8_encode(_torch(a))) == wire
        desc = {"shape": [a.size], "dtype": "bfloat16", "nbytes": len(wire),
                "raw_nbytes": a.size * 2, "enc": "q8", "q8_block": P.Q8_BLOCK}
        want = R.q8_decode(wire, desc)
        got = P.q8_decode(wire, desc)
        assert got.dtype == torch.bfloat16
        assert _bits(got) == _bits(want)
        assert _bits(P.q8_decode(wire, desc, dequant=False).dequantize()) == \
            _bits(want)


def test_registries_match_the_reference():
    for name in ("MAGIC", "VERSION", "SUPPORTED_VERSIONS", "HELLO_VERSION",
                 "Q8_MIN_VERSION", "REQUEST_KINDS", "CLIENT_OPTIONAL_KINDS",
                 "REPLY_KINDS", "ERROR_CODES", "WIRE_ENCODINGS", "Q8_BLOCK",
                 "Q8_MIN_BYTES", "Q8_DTYPES", "COMPRESS_MIN_BYTES",
                 "COMPRESS_GAIN", "COMPRESS_PROBE_BYTES", "MAX_HEADER_BYTES",
                 "MAX_BUFFER_BYTES", "Q8_MAX_BLOCK"):
        assert getattr(P, name) == getattr(R, name), name
    assert set(P.TORCH_DTYPES) == R._DTYPES


def _q8_frame(desc_overrides=None, payload=None, version=None,
              shape=(100_000,)):
    """Hand-craft one q8-encoded PUT frame (possibly malformed), as
    tests/test_remoting.py:_q8_frame does."""
    x = np.zeros(shape, np.float32)
    wire = bytes(P.q8_encode(torch.from_numpy(x)))
    desc = {"shape": list(shape), "dtype": "float32",
            "nbytes": len(wire), "raw_nbytes": x.nbytes,
            "enc": "q8", "q8_block": P.Q8_BLOCK}
    desc.update(desc_overrides or {})
    if payload is not None:
        wire = payload
        desc["nbytes"] = len(wire)
    header = json.dumps({"kind": "PUT", "meta": {},
                         "buffers": [desc]}).encode()
    return (P.MAGIC + struct.pack("<II", version or P.VERSION, len(header))
            + header + wire)


@pytest.mark.parametrize("recv", [P.recv_message, R.recv_message],
                         ids=["port", "reference"])
def test_q8_malformed_frames_rejected(recv):
    """The caps refuse the same malformed q8 frames in both packages."""
    kind, _, bufs = _over_socketpair(_q8_frame(), recv)
    assert kind == "PUT" and tuple(bufs[0].shape) == (100_000,)
    with pytest.raises(ValueError, match="cap|exceeds"):
        _over_socketpair(_q8_frame(
            {"shape": [1 << 20, 1 << 12], "raw_nbytes": 1 << 34}), recv)
    with pytest.raises(ValueError, match="raw_nbytes"):
        _over_socketpair(_q8_frame({"raw_nbytes": 4 * 100_000 + 4}), recv)
    with pytest.raises(ValueError, match="length"):
        _over_socketpair(_q8_frame(payload=b"\x00" * 1000), recv)
    with pytest.raises(ValueError, match="q8_block"):
        _over_socketpair(_q8_frame({"q8_block": 0}), recv)
    with pytest.raises(ValueError, match="q8_block"):
        _over_socketpair(_q8_frame({"q8_block": P.Q8_MAX_BLOCK + 1}), recv)
    with pytest.raises(ValueError, match="q8.*v5|protocol"):
        _over_socketpair(_q8_frame(version=5), recv)
    with pytest.raises(ValueError, match="dtype"):
        _over_socketpair(_q8_frame({"dtype": "int32"}), recv)


def _raw_frame(header: dict, payload: bytes = b"", version=None,
               hlen=None) -> bytes:
    blob = json.dumps(header).encode()
    return (P.MAGIC + struct.pack("<II", version or P.VERSION,
                                  len(blob) if hlen is None else hlen)
            + blob + payload)


@pytest.mark.parametrize("recv", [P.recv_message, R.recv_message],
                         ids=["port", "reference"])
def test_framing_caps_reject_what_the_reference_rejects(recv):
    """Oversized header, oversized declared buffer, zlib bombs (a lying
    small raw_nbytes, and raw_nbytes=0, which zlib reads as unlimited),
    a bad magic and an unaccepted version."""
    with pytest.raises(ValueError, match="header"):
        _over_socketpair(_raw_frame({}, hlen=P.MAX_HEADER_BYTES + 1), recv)
    big = {"kind": "PUT", "meta": {}, "buffers": [
        {"shape": [1], "dtype": "uint8", "nbytes": P.MAX_BUFFER_BYTES + 1,
         "raw_nbytes": 1, "enc": "raw"}]}
    with pytest.raises(ValueError, match="cap"):
        _over_socketpair(_raw_frame(big), recv)
    bomb = zlib.compress(b"\0" * (1 << 20), 9)
    for raw_nbytes in (4, 0):
        hdr = {"kind": "PUT", "meta": {}, "buffers": [
            {"shape": [1 << 20], "dtype": "uint8", "nbytes": len(bomb),
             "raw_nbytes": raw_nbytes, "enc": "zlib"}]}
        with pytest.raises(ValueError, match="raw_nbytes|mismatch"):
            _over_socketpair(_raw_frame(hdr, bomb), recv)
    with pytest.raises(ValueError, match="magic"):
        _over_socketpair(b"XXXX" + _raw_frame({})[4:], recv)
    with pytest.raises(ValueError, match="version"):
        _over_socketpair(_raw_frame({}, version=1), recv)


def test_sender_side_cap_fails_fast(monkeypatch):
    monkeypatch.setattr(P, "MAX_BUFFER_BYTES", 1024)
    with pytest.raises(ValueError, match="wire cap"):
        P.encode_message("PUT", {}, [torch.zeros(2048, dtype=torch.uint8)])


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_q8_roundtrip_error_bounded_per_block(dtype):
    """tests/test_remoting.py:773-807 for the port: a q8 round trip never
    moves an element by more than half its block's scale (plus one ulp
    of the wire dtype)."""
    rng = np.random.default_rng(42)
    x = torch.from_numpy(rng.standard_normal((257, 129)).astype(np.float32)
                         * 11.0).to(P.TORCH_DTYPES[dtype])
    stats = {}
    frame = b"".join(bytes(p) for p in P.encode_message_parts(
        "PUT", {}, [x], quantize=True, stats=stats))
    assert stats["buffers_q8"] == 1 and stats["wire_bytes"] < stats["raw_bytes"]
    _, _, (y,) = _over_socketpair(frame, P.recv_message)
    assert y.shape == x.shape and y.dtype == x.dtype
    xf, yf = x.float().reshape(-1).numpy(), y.float().reshape(-1).numpy()
    ulp = {"float32": 2.0 ** -20, "float16": 2.0 ** -10,
           "bfloat16": 2.0 ** -7}[dtype]
    for blk in range(-(-xf.size // P.Q8_BLOCK)):
        seg = slice(blk * P.Q8_BLOCK, min((blk + 1) * P.Q8_BLOCK, xf.size))
        top = float(np.abs(xf[seg]).max())
        bound = max(top, 1e-12) / 127.0 / 2 * 1.001 + top * ulp
        assert float(np.abs(xf[seg] - yf[seg]).max()) <= bound


def test_exact_path_for_integer_bool_f64_small_and_nonfinite():
    """Integer, bool and f64 buffers never quantize, nor do small ones or
    ones holding inf/nan: they round-trip bit-exact."""
    bad = torch.ones(100_000)
    bad[12345], bad[54321] = float("inf"), float("nan")
    for t in (torch.arange(100_000, dtype=torch.int32),
              torch.arange(50_000).to(torch.int8),
              torch.arange(100_000) % 3 == 0,
              torch.linspace(0, 1, 50_000, dtype=torch.float64),
              torch.ones(16), bad):
        stats = {}
        frame = b"".join(bytes(p) for p in P.encode_message_parts(
            "PUT", {}, [t], quantize=True, stats=stats))
        assert "buffers_q8" not in stats, (t.dtype, stats)
        _, _, (got,) = _over_socketpair(frame, P.recv_message)
        assert _bits(got) == _bits(t)


def test_vectored_send_multibuffer_roundtrip():
    """One vectored sendmsg per frame survives partial sends: a frame far
    larger than a socket buffer, over several buffers, arrives exact."""
    g = torch.Generator().manual_seed(0)
    bufs = [torch.randint(0, 255, (2_000_003,), dtype=torch.uint8, generator=g),
            torch.randn(1_000_001, dtype=torch.float64, generator=g),
            torch.arange(7, dtype=torch.int16),
            torch.randn((513, 1027), generator=g).to(torch.bfloat16),
            torch.zeros((0, 3))]
    a, b = socket.socketpair()
    out = {}

    def rx():
        out["msg"] = P.recv_message(b)

    th = threading.Thread(target=rx)
    th.start()
    try:
        P.send_message(a, "PUT", {"seq": 1}, bufs)
        th.join(timeout=60)
    finally:
        a.close()
        b.close()
    for want, have in zip(bufs, out["msg"][2]):
        assert have.dtype == want.dtype and have.shape == want.shape
        assert _bits(have) == _bits(want)


@pytest.mark.parametrize("host,env,forced,want", [
    ("127.0.0.1", "", None, False), ("::1", "", None, False),
    ("localhost", "", None, False), ("10.0.0.2", "", None, True),
    ("10.0.0.2", "0", None, False), ("127.0.0.1", "1", None, True),
    ("127.0.0.1", "0", True, True), ("10.0.0.2", "1", False, False)])
def test_one_compression_rule_for_both_ends(monkeypatch, host, env, forced,
                                            want):
    """No zlib to a loopback peer, adaptive zlib to a remote one,
    ``TPF_REMOTING_COMPRESS`` forcing either way and the worker's
    argument over that; the client applies the same rule."""
    from tensorfusion_tpu_torch.remoting import RemoteDevice

    monkeypatch.setenv("TPF_REMOTING_COMPRESS", env)
    assert P.default_compress(host, forced) is want
    if forced is None:
        assert RemoteDevice(f"tcp://{host}:1").compress is want
