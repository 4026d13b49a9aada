"""Shared utilities (quantities, serde, line protocol) re-exported for
workloads: the port's copy of tensorfusion_tpu/utils/__init__.py, without
the autoscaler's cron matcher (the autoscaler is not ported).

The heavy lifting lives with its owners (``api.resources`` for quantities,
``api.meta`` for dataclass serde, ``metrics.encoder`` for line protocol);
this package is the stable import surface for hosted-workload code.
"""

from ..api.meta import from_dict, to_dict
from ..api.resources import format_bytes, parse_quantity
from ..metrics.encoder import encode_line, parse_line
