"""Layered configuration system.

The port's copy of ``tensorfusion_tpu/config/__init__.py``."""

from .chip_info import CHIP_INFO_DB, chip_info, mock_chip_info
from .global_config import GlobalConfig, GlobalConfigWatcher
