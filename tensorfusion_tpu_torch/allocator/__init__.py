"""Allocator: in-memory chip store + allocation state machine (the port's
copy of ``tensorfusion_tpu/allocator``)."""

from .core import (AllocationConflictError, AllocRecord, ChipState,
                   InsufficientResourcesError, TPUAllocator)
from .filters import (Filter, FilterResult, default_chain, run_filters)
from .indexalloc import IndexAllocator, IndexExhaustedError
from .portalloc import PortAllocator, PortExhaustedError
from .quota import QuotaExceededError, QuotaStore
from .strategy import (COMPACT_FIRST, LOW_LOAD_FIRST,
                       NODE_COMPACT_CHIP_LOW_LOAD, Strategy, new_strategy)
