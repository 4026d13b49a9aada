"""Always-on flight recorder: bounded event rings + postmortem bundles
(the port's copy of ``tensorfusion_tpu/profiling/recorder.py``).

The black box: every component appends small event dicts into a
bounded per-component ring (store events, dispatcher decisions, engine
step summaries, alert transitions — whatever the wiring site deems the
"last seconds of state").  When an invariant trips, an alert fires or a
worker path crashes, :meth:`FlightRecorder.dump_bundle` freezes the
rings plus the TSDB tail, the active traces and the config/knob
snapshot into a *deterministic, digestable* postmortem directory — the
artifact a human (or the next sim run) opens instead of trying to
reproduce a vanished state.

Determinism contract:

- event timestamps come from the injectable Clock (virtual in the
  twin), sequence numbers from a counter — never the wall clock;
- ring overflow conflates OLDEST-first (bounded deque) and counts what
  it dropped, so a bundle is explicit about truncation;
- bundle files are canonical JSON (sorted keys, fixed separators) and
  the bundle digest is computed over ``sorted((name, sha256(bytes)))``
  — two same-seed sim runs produce byte-identical bundles.

Auto-capture sites pass through :meth:`auto_bundle`, which is a no-op
unless a bundle directory is configured (``bundle_dir=`` /
``TPF_PROF_BUNDLE_DIR``) and budgets the number of bundles per process
so a crash loop cannot fill a disk.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import threading
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

from .. import constants
from ..clock import Clock, default_clock

log = logging.getLogger("tpf.profiling.recorder")

#: default per-component ring capacity — "the last seconds", not a log
DEFAULT_RING_LEN = 256

#: auto-bundle budget per FlightRecorder (alert storms / crash loops
#: must not write unbounded postmortems)
DEFAULT_MAX_AUTO_BUNDLES = 4

ENV_BUNDLE_DIR = constants.ENV_PROF_BUNDLE_DIR

_SLUG_RE = re.compile(r"[^A-Za-z0-9_.-]+")


def _canon(obj) -> bytes:
    return (json.dumps(obj, sort_keys=True, separators=(",", ":"))
            + "\n").encode()


def bundle_digest(files: Dict[str, bytes]) -> str:
    """Digest of a bundle's file set: sha256 over the sorted
    (name, per-file sha256) pairs — stable against directory order and
    recomputable from a dumped directory (``tpfprof`` does)."""
    h = hashlib.sha256()
    for name in sorted(files):
        h.update(name.encode())
        h.update(hashlib.sha256(files[name]).hexdigest().encode())
    return h.hexdigest()


class _Ring:
    __slots__ = ("events", "dropped", "appended")

    def __init__(self, maxlen: int):
        self.events: deque = deque(maxlen=maxlen)
        self.dropped = 0
        self.appended = 0


class FlightRecorder:
    def __init__(self, clock: Optional[Clock] = None,
                 ring_len: int = DEFAULT_RING_LEN,
                 config: Optional[dict] = None,
                 bundle_dir: Optional[str] = None,
                 max_auto_bundles: int = DEFAULT_MAX_AUTO_BUNDLES):
        self.clock = clock or default_clock()
        self.ring_len = max(int(ring_len), 1)
        #: knob/config snapshot frozen into every bundle (the "what was
        #: this process configured as" page of the postmortem)
        self.config = dict(config or {})
        self.bundle_dir = bundle_dir if bundle_dir is not None \
            else os.environ.get(ENV_BUNDLE_DIR, "")
        self.max_auto_bundles = max_auto_bundles
        self._lock = threading.Lock()
        # guarded by: _lock
        self._rings: Dict[str, _Ring] = {}
        # guarded by: _lock
        self._seq = 0
        # guarded by: _lock
        self._bundle_seq = 0
        # guarded by: _lock
        self._auto_bundles = 0

    # -- recording --------------------------------------------------------

    def note(self, component: str, kind: str, **fields) -> None:
        """Append one event to a component ring.  Cheap: one lock, one
        dict, one deque append; overflow conflates oldest-first."""
        with self._lock:
            ring = self._rings.get(component)
            if ring is None:
                ring = self._rings[component] = _Ring(self.ring_len)
            self._seq += 1
            if len(ring.events) == ring.events.maxlen:
                ring.dropped += 1
            ring.appended += 1
            ev = {"seq": self._seq,
                  "t": round(self.clock.monotonic(), 9),
                  "kind": kind}
            if fields:
                ev.update(fields)
            ring.events.append(ev)

    def ring(self, component: str) -> List[dict]:
        with self._lock:
            ring = self._rings.get(component)
            return [dict(ev) for ev in ring.events] if ring else []

    def snapshot(self) -> dict:
        """All rings, oldest-first, with drop accounting."""
        with self._lock:
            return {
                name: {"events": [dict(ev) for ev in ring.events],
                       "dropped": ring.dropped,
                       "appended": ring.appended,
                       "capacity": ring.events.maxlen}
                for name, ring in sorted(self._rings.items())}

    # -- bundles ----------------------------------------------------------

    def build_bundle(self, reason: str, tsdb=None, tracers: Iterable = (),
                     extra: Optional[dict] = None
                     ) -> Tuple[Dict[str, bytes], str]:
        """The in-memory bundle: {filename: canonical bytes} + digest.
        Writing is separate (:meth:`dump_bundle`) so the sim can digest
        bundles without touching the filesystem."""
        with self._lock:
            self._bundle_seq += 1
            seq = self._bundle_seq
        files: Dict[str, bytes] = {
            "rings.json": _canon(self.snapshot()),
            "config.json": _canon(self.config),
        }
        if tsdb is not None:
            files["tsdb.json"] = _canon(tsdb.dump_tail())
        spans: List[dict] = []
        for tracer in tracers or ():
            spans.extend(tracer.finished())
        if spans:
            files["traces.json"] = _canon(spans)
        if extra:
            files["extra.json"] = _canon(extra)
        manifest = {
            "format": "tpfprof-bundle-v1",
            "reason": reason,
            "bundle_seq": seq,
            "t": round(self.clock.monotonic(), 9),
            "files": {name: hashlib.sha256(data).hexdigest()
                      for name, data in sorted(files.items())},
        }
        digest = bundle_digest(files)
        manifest["bundle_digest"] = digest
        files["MANIFEST.json"] = _canon(manifest)
        return files, digest

    def dump_bundle(self, out_dir: str, reason: str, tsdb=None,
                    tracers: Iterable = (),
                    extra: Optional[dict] = None) -> Tuple[str, str]:
        """Write a postmortem directory ``<out_dir>/bundle-<seq>-<slug>``
        and return (path, bundle_digest)."""
        files, digest = self.build_bundle(reason, tsdb=tsdb,
                                          tracers=tracers, extra=extra)
        manifest = json.loads(files["MANIFEST.json"])
        slug = _SLUG_RE.sub("-", reason).strip("-") or "bundle"
        path = os.path.join(
            out_dir, f"bundle-{manifest['bundle_seq']:04d}-{slug[:48]}")
        os.makedirs(path, exist_ok=True)
        for name, data in files.items():
            with open(os.path.join(path, name), "wb") as f:
                f.write(data)
        log.warning("flight recorder: postmortem bundle %s (%s)",
                    path, reason)
        return path, digest

    def auto_bundle(self, reason: str, tsdb=None, tracers: Iterable = (),
                    extra: Optional[dict] = None) -> Optional[str]:
        """Budgeted auto-capture for invariant/alert/crash hooks: a
        no-op without a configured bundle_dir, bounded per process, and
        never allowed to take its caller down (the failing path is
        already having a bad day)."""
        if not self.bundle_dir:
            return None
        with self._lock:
            if self._auto_bundles >= self.max_auto_bundles:
                return None
            self._auto_bundles += 1
        try:
            path, _ = self.dump_bundle(self.bundle_dir, reason,
                                       tsdb=tsdb, tracers=tracers,
                                       extra=extra)
            return path
        except Exception:  # noqa: BLE001 - diagnostics must not crash
            # the crashing path further
            log.exception("auto bundle capture failed (%s)", reason)
            return None


def load_bundle(path: str) -> Tuple[Dict[str, bytes], dict]:
    """Read a dumped bundle directory back as {name: bytes} + manifest
    (``tpfprof`` recomputes the digest from this)."""
    files: Dict[str, bytes] = {}
    for name in os.listdir(path):
        full = os.path.join(path, name)
        if os.path.isfile(full):
            with open(full, "rb") as f:
                files[name] = f.read()
    manifest = json.loads(files.get("MANIFEST.json", b"{}"))
    return files, manifest


def verify_bundle(path: str) -> List[str]:
    """Errors for a dumped bundle: per-file digest mismatches and a
    bundle-digest mismatch.  Empty list = intact."""
    files, manifest = load_bundle(path)
    errors = []
    declared = manifest.get("files", {})
    content = {n: d for n, d in files.items() if n != "MANIFEST.json"}
    for name, want in sorted(declared.items()):
        if name not in content:
            errors.append(f"bundle file {name} missing")
        elif hashlib.sha256(content[name]).hexdigest() != want:
            errors.append(f"bundle file {name} digest mismatch")
    for name in sorted(set(content) - set(declared)):
        errors.append(f"bundle file {name} not in manifest")
    if manifest.get("bundle_digest") != bundle_digest(content):
        errors.append("bundle digest mismatch")
    return errors
