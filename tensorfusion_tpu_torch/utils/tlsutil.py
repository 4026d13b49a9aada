"""TLS plumbing for the control-plane HTTP surfaces.

The port's copy of ``tensorfusion_tpu/utils/tlsutil.py``.

The reference inherits transport security from Kubernetes (apiserver TLS
+ cert-manager issued webhook certs, ``config/certmanager/``); tpu-fusion
owns its own wire, so this module provides the equivalent:

- :func:`generate_self_signed` — a one-call CA-less self-signed cert for
  dev / single-cluster deployments (the role cert-manager's self-signed
  issuer plays for the reference's webhook);
- :func:`server_context` — an ``ssl.SSLContext`` for the stdlib HTTP
  servers (statestore, operator API, hypervisor API);
- :func:`client_context` — the verifying client side.  Trust anchors come
  from ``TPF_TLS_CA`` (path to the server cert / CA bundle);
  ``TPF_TLS_INSECURE=1`` disables verification (encrypted but
  unauthenticated — better than plaintext, still logged as a warning).

Everything is stdlib ``ssl`` + the ``cryptography`` package for key/cert
generation only.
"""

from __future__ import annotations

import datetime
import ipaddress
import logging
import os
import ssl
from typing import Optional, Sequence

log = logging.getLogger("tpf.tls")


def generate_self_signed(cert_path: str, key_path: str,
                         hosts: Sequence[str] = ("localhost", "127.0.0.1"),
                         days: int = 365) -> None:
    """Write a fresh self-signed certificate + key PEM pair covering
    ``hosts`` (DNS names and/or IP literals)."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME,
                                         "tpu-fusion")])
    alt_names = []
    for h in hosts:
        try:
            alt_names.append(x509.IPAddress(ipaddress.ip_address(h)))
        except ValueError:
            alt_names.append(x509.DNSName(h))
    # certificate validity must embed REAL wall time — a peer's TLS
    # stack checks it against its own clock, so simulated time would
    # mint certs that are invalid outside the twin
    # tpflint: disable=wall-clock-direct -- X.509 notBefore/notAfter
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=days))
            .add_extension(x509.SubjectAlternativeName(alt_names),
                           critical=False)
            .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                           critical=True)
            .sign(key, hashes.SHA256()))
    os.makedirs(os.path.dirname(cert_path) or ".", exist_ok=True)
    with open(key_path, "wb") as f:
        f.write(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption()))
    os.chmod(key_path, 0o600)
    with open(cert_path, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))


def server_context(cert_path: str, key_path: str) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_cert_chain(cert_path, key_path)
    return ctx


def wrap_http_server(httpd, cert_path: str, key_path: str) -> None:
    """Serve TLS on a stdlib (Threading)HTTPServer.

    The listening socket is wrapped with ``do_handshake_on_connect=
    False`` so ``accept()`` returns immediately — the handshake runs in
    the per-connection handler thread (see :class:`TlsHandshakeMixin`).
    Wrapping with the default (handshake-on-accept) would let ONE silent
    peer stall the accept loop and freeze the whole server."""
    ctx = server_context(cert_path, key_path)
    httpd.socket = ctx.wrap_socket(httpd.socket, server_side=True,
                                   do_handshake_on_connect=False)


class KeepAliveHandlerMixin:
    """Shared HTTP/1.1 policy for the control-plane servers: responses
    always carry Content-Length so clients keep connections alive
    (RemoteStore holds one per thread instead of a TCP+TLS handshake per
    call), and idle connections time out so an abandoned client cannot
    pin a handler thread forever (300s comfortably exceeds every
    long-poll cap, which request handlers must enforce themselves —
    sleep loops never touch the socket)."""

    protocol_version = "HTTP/1.1"
    timeout = 300


class TlsHandshakeMixin:
    """Handler mixin completing the TLS handshake per connection, with a
    deadline, in the handler's own thread.  List it BEFORE the HTTP
    handler base class.

    A failed handshake (plaintext probe, port scan, slowloris) is a
    routine event on an exposed port: it logs ONE debug line and closes
    the connection instead of dumping a traceback per probe."""

    #: a peer must complete the handshake within this budget
    handshake_timeout_s = 10.0
    _tls_ok = True

    def setup(self):  # noqa: D102 - socketserver hook
        if isinstance(self.request, ssl.SSLSocket):
            timeout = self.request.gettimeout()
            self.request.settimeout(self.handshake_timeout_s)
            try:
                self.request.do_handshake()
            except (ssl.SSLError, OSError) as e:
                log.debug("TLS handshake from %s failed: %s",
                          self.client_address, e)
                self._tls_ok = False
            finally:
                try:
                    self.request.settimeout(timeout)
                except OSError:
                    pass
        super().setup()

    def handle(self):  # noqa: D102
        if self._tls_ok:
            super().handle()

    def finish(self):  # noqa: D102
        if self._tls_ok:
            super().finish()
        else:
            try:
                self.request.close()
            except OSError:
                pass


def default_san_hosts(bind_host: str = "") -> tuple:
    """SAN entries for a self-signed server cert: loopback plus this
    machine's reachable names/IPs, so TPF_TLS_CA verification works for
    REMOTE clients of a 0.0.0.0 bind (a cert naming only localhost
    would force them to TPF_TLS_INSECURE=1)."""
    import socket

    hosts = ["localhost", "127.0.0.1"]
    if bind_host and bind_host not in ("0.0.0.0", "::", ""):
        hosts.append(bind_host)
    try:
        hosts.append(socket.gethostname())
    except OSError:
        pass
    try:
        # the UDP-connect trick: no packets sent, just routing lookup
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("10.255.255.255", 1))
            hosts.append(s.getsockname()[0])
        finally:
            s.close()
    except OSError:
        pass
    seen, out = set(), []
    for h in hosts:
        if h and h not in seen:
            seen.add(h)
            out.append(h)
    return tuple(out)


def hypervisor_urlopen(url: str, method: str = "GET",
                       data: Optional[bytes] = None,
                       timeout_s: float = 10.0):
    """urlopen for hypervisor-API calls from any in-cluster client
    (migration controller, TUI, workload bootstrap): attaches the
    ``TPF_HYPERVISOR_TOKEN`` header when set and a verifying TLS context
    for https URLs — so enabling --api-token/--tls-cert on hypervisors
    doesn't silently break their callers."""
    import urllib.request

    req = urllib.request.Request(url, method=method, data=data)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    token = os.environ.get("TPF_HYPERVISOR_TOKEN", "")
    if token:
        req.add_header("X-TPF-Token", token)
    ctx = client_context() if url.startswith("https://") else None
    return urllib.request.urlopen(req, timeout=timeout_s, context=ctx)


def client_context(ca_path: Optional[str] = None,
                   insecure: Optional[bool] = None) -> ssl.SSLContext:
    """Verifying TLS client context.  Defaults come from the env:
    ``TPF_TLS_CA`` (trust anchor path) and ``TPF_TLS_INSECURE=1``."""
    if ca_path is None:
        ca_path = os.environ.get("TPF_TLS_CA", "") or None
    if insecure is None:
        insecure = os.environ.get("TPF_TLS_INSECURE", "") == "1"
    if insecure:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        log.warning("TLS verification DISABLED (TPF_TLS_INSECURE)")
        return ctx
    if ca_path:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.load_verify_locations(ca_path)
        return ctx
    return ssl.create_default_context()
