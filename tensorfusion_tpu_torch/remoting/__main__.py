"""Standalone remote worker of the port: serves one device (the card by
default) over TCP for ``RemoteDevice`` clients.

    python -m tensorfusion_tpu_torch.remoting --port 7707 [--token SECRET] \
        [--device cuda] [--max-resident-gb 40] [--state-root DIR]
"""

from __future__ import annotations

import argparse
import logging
import threading


def main() -> None:
    parser = argparse.ArgumentParser(
        description="tpu-fusion remote worker (PyTorch port)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=7707)
    parser.add_argument("--token", default=None,
                        help="auth token (default: $TPF_REMOTING_TOKEN)")
    parser.add_argument("--max-resident-gb", type=float, default=0.0,
                        help="resident-buffer budget (0 = unlimited)")
    parser.add_argument("--device", default="cuda",
                        help="the device served (default cuda; cpu runs "
                             "the kernels' plain versions)")
    parser.add_argument("--state-root", default=None,
                        help="the only directory SNAPSHOT / RESTORE may "
                             "use (unset refuses both)")
    parser.add_argument("--insecure", action="store_true",
                        help="serve without a token on a non-loopback "
                             "bind (the worker runs caller-supplied "
                             "programs — do not do this on open "
                             "networks)")
    args = parser.parse_args()

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    from .worker import RemoteVTPUWorker

    worker = RemoteVTPUWorker(
        host=args.host, port=args.port, token=args.token,
        max_resident_bytes=int(args.max_resident_gb * (1 << 30)),
        insecure=args.insecure or None, device=args.device,
        state_root=args.state_root)
    worker.start()
    print(f"tpf remote worker ready on {worker.url} ({worker.device})",
          flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        worker.stop()


if __name__ == "__main__":
    main()
