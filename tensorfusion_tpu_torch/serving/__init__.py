"""tpfserve for the port: continuous-batching serving over a paged KV
pool, on the card (the port of ``tensorfusion_tpu/serving/``).

- :mod:`.kvpool` — refcounted block accounting with copy-on-write
  prefix sharing, and paged attention in torch (decode, chunked
  prefill, the fused speculative-verify step), writing the pool in
  place.
- :mod:`.engine` — decode-step-granularity continuous batching with
  QoS admission, deadline shedding, pool preemption, prefix-shared KV
  and speculative decoding.
- :mod:`.runner` — the device contract: :class:`~.runner.LlamaRunner`
  (one CUDA graph per decode and verify bucket on the card) and
  :class:`~.runner.FakeRunner` (deterministic, for the tests).
- :mod:`.spec` — draft models for speculative decoding (prompt-lookup
  n-gram, dialable arithmetic, small llama).
- :mod:`.disagg` — the disaggregated prefill pool, and the
  :class:`~.disagg.RemoteKVShipper` that ships its pages to a remote
  worker's engine (KV_SHIP).
"""

from .disagg import PrefillPool, RemoteKVShipper  # noqa: F401
from .engine import (DEFAULT_MAX_BATCH, DEFAULT_MAX_WAITING,  # noqa: F401
                     DEFAULT_PREFILL_CHUNK, Sequence, ServingEngine)
from .kvpool import (BlockAccount, chain_key,  # noqa: F401
                     contiguous_to_paged, init_paged_cache,
                     paged_cache_nbytes, paged_decode_step,
                     paged_prefill_chunk, paged_verify_step,
                     pow2_bucket, prompt_block_keys)
from .runner import FakeRunner, LlamaRunner  # noqa: F401
from .spec import (ArithmeticDraft, LlamaDraft,  # noqa: F401
                   NGramDraft, ReplayDraft, make_draft)

__all__ = ["ServingEngine", "Sequence", "BlockAccount", "LlamaRunner",
           "FakeRunner", "PrefillPool", "RemoteKVShipper", "NGramDraft",
           "ArithmeticDraft", "LlamaDraft", "ReplayDraft", "make_draft",
           "init_paged_cache", "paged_decode_step",
           "paged_prefill_chunk", "paged_verify_step",
           "contiguous_to_paged", "paged_cache_nbytes", "pow2_bucket",
           "chain_key", "prompt_block_keys",
           "DEFAULT_MAX_BATCH", "DEFAULT_MAX_WAITING",
           "DEFAULT_PREFILL_CHUNK"]
