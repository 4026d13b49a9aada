"""Hot-reloaded global config.

The port's copy of ``tensorfusion_tpu/config/global_config.py``.

Analog of the reference's fsnotify-watched ``GlobalConfig`` YAML
(``cmd/main.go:614-712``): a JSON config file polled for mtime changes;
registered callbacks fire on every reload so live components (metrics
interval, alert rules, ERL knobs) pick up changes without a restart.
JSON instead of YAML keeps the operator dependency-free.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..api.meta import from_dict

log = logging.getLogger("tpf.config")


@dataclass
class GlobalConfig:
    metrics_interval_s: float = 5.0
    metrics_path: str = ""
    alert_rules: List[Dict] = field(default_factory=list)
    default_pool: str = ""
    scheduler_placement_mode: str = "CompactFirst"
    erl: Dict[str, float] = field(default_factory=dict)
    #: native-pod auto-migration rules (webhook/auto_migration.py)
    auto_migration: Dict = field(default_factory=dict)
    extra: Dict[str, str] = field(default_factory=dict)


def mock_global_config() -> GlobalConfig:
    """Test fixture (MockGlobalConfig analog)."""
    return GlobalConfig(metrics_interval_s=0.1)


class GlobalConfigWatcher:
    def __init__(self, path: str, poll_interval_s: float = 1.0):
        self.path = path
        self.poll_interval_s = poll_interval_s
        self.config = GlobalConfig()
        self._mtime = 0.0
        self._callbacks: List[Callable[[GlobalConfig], None]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.reload()

    def on_change(self, cb: Callable[[GlobalConfig], None]) -> None:
        self._callbacks.append(cb)

    def reload(self) -> bool:
        try:
            mtime = os.stat(self.path).st_mtime
        except FileNotFoundError:
            return False
        if mtime == self._mtime:
            return False
        self._mtime = mtime
        try:
            with open(self.path) as f:
                data = json.load(f)
            self.config = from_dict(GlobalConfig, data)
        except (json.JSONDecodeError, TypeError) as e:
            log.error("bad global config %s: %s (keeping previous)",
                      self.path, e)
            return False
        log.info("global config reloaded from %s", self.path)
        for cb in self._callbacks:
            try:
                cb(self.config)
            except Exception:
                log.exception("config change callback failed")
        return True

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="tpf-config-watch", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.reload()
            except Exception:
                log.exception("config reload failed")
