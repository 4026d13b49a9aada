"""Hypervisor daemon entry point: the port's copy of
tensorfusion_tpu/hypervisor/__main__.py.  It loads the provider, starts
the device and worker controllers, the HTTP server and a backend, and
serves until killed.  Two backends, as in the reference:

- default: the file-state ``SingleNodeBackend`` (the worker spawner);
- with ``--operator-url``: the ``ControlPlaneBackend`` over a
  :class:`~tensorfusion_tpu_torch.remote_store.RemoteStore`: the node
  agent joins a state store (``python -m tensorfusion_tpu_torch.
  statestore``, or the reference's) over HTTP, publishes its node and
  chips there, turns pods bound to this node into workers, and pushes
  its metrics lines into the store.

    python -m tensorfusion_tpu_torch.hypervisor \\
        [--provider build/hypervisor/libtpf_provider_nvml-<hash>.so] \\
        --limiter native/build/libtpf_limiter.so \\
        --shm-base /tmp/tpf-shm --state-dir /tmp/tpf-state --port 8000 \\
        [--operator-url http://store:2379 --node-name gpu-host-0 \\
         --pool pool-h100 [--store-token SECRET] [--advertise-url URL]]

Without ``--provider`` (or ``TPF_PROVIDER_LIB``) it builds and loads the
NVML provider (``hypervisor/csrc/provider_nvml.c``); any other provider
library of the same ABI, such as the reference's mock, loads the same way.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys

from .. import constants
from ..clock import WALL
from . import _build
from .allocation import AllocationController
from .device import DeviceController
from .limiter_binding import Limiter
from .provider_binding import Provider
from .server import HypervisorServer
from .single_node import SingleNodeBackend
from .worker import WorkerController


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="tpf-hypervisor")
    ap.add_argument("--provider",
                    default=os.environ.get(constants.ENV_PROVIDER_LIB, ""),
                    help="provider library (default: the NVML provider, "
                         "built on first use)")
    ap.add_argument("--limiter",
                    default=os.environ.get(constants.ENV_LIMITER_LIB,
                                           "native/build/libtpf_limiter.so"))
    ap.add_argument("--shm-base",
                    default=os.environ.get(constants.ENV_SHM_BASE,
                                           "/tmp/tpu-fusion/shm"))
    ap.add_argument("--state-dir", default="/tmp/tpu-fusion/state")
    ap.add_argument("--snapshot-dir", default="/tmp/tpu-fusion/snapshots")
    ap.add_argument("--port", type=int,
                    default=constants.DEFAULT_HYPERVISOR_PORT)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--tick-ms", type=int, default=100)
    ap.add_argument("--operator-url",
                    default=os.environ.get(constants.ENV_OPERATOR_URL, ""),
                    help="join a remote operator's store gateway instead "
                         "of running standalone")
    ap.add_argument("--node-name",
                    default=os.environ.get(constants.ENV_NODE_NAME, "")
                    or os.uname().nodename)
    ap.add_argument("--pool",
                    default=os.environ.get(constants.ENV_POOL_NAME, ""))
    ap.add_argument("--store-token",
                    default=os.environ.get(constants.ENV_STORE_TOKEN, ""))
    ap.add_argument("--api-token",
                    default=os.environ.get(constants.ENV_HYPERVISOR_TOKEN, ""),
                    help="require this X-TPF-Token on the hypervisor's "
                         "HTTP API except /healthz and the workload-pod "
                         "bootstrap routes (/limiter, /process) — "
                         "freeze/resume/snapshot and inventory need it")
    ap.add_argument("--tls-cert",
                    default=os.environ.get("TPF_TLS_CERT", ""))
    ap.add_argument("--tls-key",
                    default=os.environ.get("TPF_TLS_KEY", ""))
    ap.add_argument("--port-file", default="",
                    help="write the bound API port here (for --port 0)")
    ap.add_argument("--advertise-url", default="",
                    help="externally reachable URL registered on the "
                         "TPUNode (default: the local bind URL — set "
                         "this in cross-host/container deployments)")
    ap.add_argument("--metrics-path", default="",
                    help="append influx-line metrics to this file "
                         "(networked deployments additionally push them "
                         "to the store gateway)")
    ap.add_argument("--metrics-interval-s", type=float, default=5.0)
    ap.add_argument("-v", "--verbose", action="store_true")
    return ap


class HypervisorDaemon:
    """The daemon's component graph, separated from the process loop so
    the wiring is testable in-process."""

    def __init__(self, args):
        self.args = args
        self.log = logging.getLogger("tpf.hypervisor")
        os.makedirs(args.snapshot_dir, exist_ok=True)
        self.provider = Provider(
            args.provider or str(_build.provider_path()),
            log_fn=lambda lvl, msg: self.log.info("[provider] %s", msg))
        self.devices = DeviceController(self.provider)
        self.limiter = Limiter(args.limiter)
        self.allocator = AllocationController(self.devices)
        self.workers = WorkerController(
            self.devices, self.allocator, self.limiter, args.shm_base,
            tick_interval_s=args.tick_ms / 1000.0)
        self.server = HypervisorServer(self.devices, self.workers,
                                       snapshot_dir=args.snapshot_dir,
                                       host=args.host, port=args.port,
                                       token=args.api_token,
                                       tls_cert=args.tls_cert,
                                       tls_key=args.tls_key)
        self.store = None
        push = None
        if args.operator_url:
            from ..remote_store import RemoteStore
            from .control_plane import ControlPlaneBackend

            self.store = RemoteStore(args.operator_url, token=args.store_token)
            self.backend = ControlPlaneBackend(
                self.store, self.devices, node_name=args.node_name,
                pool=args.pool, known_pids=self.workers.all_pids)
            # metrics go into the store over the same connection, where
            # the operator drains them
            push = self.store.push_metrics
        else:
            self.backend = SingleNodeBackend(args.state_dir)
        self.metrics = None
        if args.metrics_path or push is not None:
            from .metrics import HypervisorMetricsRecorder

            self.metrics = HypervisorMetricsRecorder(
                self.devices, self.workers, path=args.metrics_path,
                interval_s=args.metrics_interval_s,
                node_name=args.node_name, push=push)

    def _on_added(self, spec) -> None:
        tracked = self.workers.add_worker(spec)
        if self.store is None:
            self.backend.set_worker_env(spec.key, tracked.status.env)

    def start(self) -> None:
        args = self.args
        self.devices.start()
        self.server.start()
        if args.port_file:
            with open(args.port_file, "w") as f:
                f.write(str(self.server.port))
        if self.store is not None:
            from .control_plane import provider_vendor

            self.backend.hypervisor_url = args.advertise_url or self.server.url
            self.backend.vendor = provider_vendor(self.devices)
        self.server.backend = self.backend
        self.backend.start(self._on_added, self.workers.remove_worker)
        self.workers.start()
        if self.metrics is not None:
            self.metrics.start()
        self.log.info(
            "hypervisor serving on %s (%d chips)%s", self.server.url,
            len(self.devices.devices()),
            f", joined operator {args.operator_url}" if self.store else "")

    def stop(self) -> None:
        if self.metrics is not None:
            self.metrics.stop()
        self.server.stop()
        self.workers.stop()
        self.backend.stop()
        if self.store is not None:
            self.store.close()
        self.devices.stop()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s %(message)s")

    daemon = HypervisorDaemon(args)
    daemon.start()

    stop = False

    def _sig(*_):
        nonlocal stop
        stop = True

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    try:
        while not stop:
            WALL.sleep(0.5)
    finally:
        daemon.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
