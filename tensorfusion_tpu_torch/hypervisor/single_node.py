"""Single-node backend: VM/bare-metal worker process spawner.

The port's copy of tensorfusion_tpu/hypervisor/single_node.py: worker specs
are persisted as JSON files in a state dir; the backend spawns each
worker's command as a child process with the allocation env injected,
reconciles dead processes with restarts, and re-adopts state after a
hypervisor restart.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import subprocess
import threading
import typing
from dataclasses import asdict
from typing import Callable, Dict, List, Optional

from .. import constants
from .framework import Backend, ProcessMapping, WorkerSpec

log = logging.getLogger("tpf.hypervisor.single_node")


def _from_value(tp, value):
    """Recursively build a value of (possibly generic) type ``tp``."""
    if value is None:
        return None
    origin = typing.get_origin(tp)
    if origin is typing.Union:  # Optional[X]
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        return _from_value(args[0], value) if args else value
    if origin in (list, tuple):
        (item_tp,) = typing.get_args(tp) or (typing.Any,)
        seq = [_from_value(item_tp, v) for v in value]
        return tuple(seq) if origin is tuple else seq
    if origin is dict:
        args = typing.get_args(tp)
        val_tp = args[1] if len(args) == 2 else typing.Any
        return {k: _from_value(val_tp, v) for k, v in value.items()}
    if dataclasses.is_dataclass(tp) and isinstance(value, dict):
        return from_dict(tp, value)
    return value


def from_dict(cls, data: dict):
    """Construct dataclass ``cls`` from a plain dict, ignoring unknown
    keys: the port's copy of the reference's ``api.meta.from_dict``."""
    if data is None:
        return None
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in data:
            kwargs[f.name] = _from_value(hints.get(f.name, typing.Any),
                                         data[f.name])
    return cls(**kwargs)


class SingleNodeBackend(Backend):
    def __init__(self, state_dir: str, reconcile_interval_s: float = 2.0,
                 max_restarts: int = 3, spawn: bool = True):
        self.state_dir = state_dir
        self.reconcile_interval_s = reconcile_interval_s
        self.max_restarts = max_restarts
        self.spawn = spawn                  # False = track-only (tests)
        os.makedirs(state_dir, exist_ok=True)
        self._lock = threading.RLock()
        #: serializes the spawn check-fork-store sequence so concurrent
        #: submit/reconcile paths cannot double-spawn one worker, while
        #: _lock (which readers like resolve_process contend on) stays
        #: free during the fork itself
        self._spawn_lock = threading.Lock()
        # guarded by: _lock
        self._procs: Dict[str, subprocess.Popen] = {}
        # guarded by: _lock
        self._restarts: Dict[str, int] = {}
        # guarded by: _lock
        self._env: Dict[str, Dict[str, str]] = {}
        self._on_added: Optional[Callable[[WorkerSpec], None]] = None
        self._on_removed: Optional[Callable[[str], None]] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- Backend ----------------------------------------------------------

    def start(self, on_worker_added, on_worker_removed) -> None:
        self._on_added = on_worker_added
        self._on_removed = on_worker_removed
        # Restart recovery: re-adopt persisted workers.
        for spec in self._load_all():
            log.info("recovered worker %s from file state", spec.key)
            self._on_added(spec)
        self._thread = threading.Thread(target=self._loop,
                                        name="tpf-single-node", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        with self._lock:
            for key, proc in self._procs.items():
                if proc.poll() is None:
                    proc.terminate()

    def publish_device_status(self, devices: List[dict]) -> None:
        path = os.path.join(self.state_dir, "devices.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(devices, f, indent=2)
        os.replace(tmp, path)

    def resolve_process(self, pid: int) -> Optional[ProcessMapping]:
        with self._lock:
            for key, proc in self._procs.items():
                if proc.pid == pid:
                    ns, name = key.split("/", 1)
                    return ProcessMapping(host_pid=pid, namespace=ns,
                                          pod_name=name)
        return None

    # -- public API (used by the hypervisor server / CLI) -----------------

    def submit_worker(self, spec: WorkerSpec,
                      env: Optional[Dict[str, str]] = None) -> None:
        self._persist(spec)
        if env:
            self.set_worker_env(spec.key, env)
        if self._on_added:
            self._on_added(spec)
        self._maybe_spawn(spec)

    def delete_worker(self, worker_key: str) -> None:
        path = self._spec_path(worker_key)
        if os.path.exists(path):
            os.unlink(path)
        with self._lock:
            proc = self._procs.pop(worker_key, None)
            self._restarts.pop(worker_key, None)
            self._env.pop(worker_key, None)
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
        if self._on_removed:
            self._on_removed(worker_key)

    def set_worker_env(self, worker_key: str, env: Dict[str, str]) -> None:
        """Injected-allocation env for spawn (set by the hypervisor after
        the allocation controller binds devices)."""
        with self._lock:
            self._env[worker_key] = dict(env)

    def worker_pid(self, worker_key: str) -> Optional[int]:
        with self._lock:
            proc = self._procs.get(worker_key)
            return proc.pid if proc is not None else None

    # -- internals --------------------------------------------------------

    def _spec_path(self, worker_key: str) -> str:
        return os.path.join(self.state_dir,
                            worker_key.replace("/", "__") + ".worker.json")

    def _persist(self, spec: WorkerSpec) -> None:
        path = self._spec_path(spec.key)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(asdict(spec), f, indent=2)
        os.replace(tmp, path)

    def _load_all(self) -> List[WorkerSpec]:
        out = []
        for fn in sorted(os.listdir(self.state_dir)):
            if not fn.endswith(".worker.json"):
                continue
            try:
                with open(os.path.join(self.state_dir, fn)) as f:
                    out.append(from_dict(WorkerSpec, json.load(f)))
            except (json.JSONDecodeError, TypeError):
                log.warning("corrupt worker state file %s", fn)
        return out

    def _maybe_spawn(self, spec: WorkerSpec) -> None:
        if not self.spawn or not spec.command:
            return
        with self._spawn_lock:
            with self._lock:
                existing = self._procs.get(spec.key)
                if existing is not None and existing.poll() is None:
                    return
                env = dict(os.environ)
                env.update(spec.env)
                env.update(self._env.get(spec.key, {}))
            env[constants.ENV_POD_NAMESPACE] = spec.namespace
            env[constants.ENV_POD_NAME] = spec.name
            # the fork happens under _spawn_lock only: its sole job is
            # serializing this check-fork-store sequence, and nothing
            # latency-sensitive ever contends on it
            # tpflint: disable=blocking-under-lock
            proc = subprocess.Popen(spec.command, env=env,
                                    stdout=subprocess.DEVNULL,
                                    stderr=subprocess.DEVNULL)
            with self._lock:
                self._procs[spec.key] = proc
            log.info("spawned worker %s pid=%d", spec.key, proc.pid)

    def _loop(self) -> None:
        """Reconcile loop: restart dead worker processes
        (single_node_backend.go:677-737 analog)."""
        while not self._stop.wait(self.reconcile_interval_s):
            specs = self._load_all()
            for spec in specs:
                if not spec.command or not self.spawn:
                    continue
                with self._lock:
                    proc = self._procs.get(spec.key)
                    dead = proc is None or proc.poll() is not None
                    restarts = self._restarts.get(spec.key, 0)
                if dead:
                    if restarts >= self.max_restarts:
                        continue
                    log.warning("worker %s process dead; restarting (%d/%d)",
                                spec.key, restarts + 1, self.max_restarts)
                    with self._lock:
                        self._restarts[spec.key] = restarts + 1
                        self._procs.pop(spec.key, None)
                    self._maybe_spawn(spec)
