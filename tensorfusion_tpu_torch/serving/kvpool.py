"""Paged KV-cache block pool for the continuous-batching engine: the
port of ``tensorfusion_tpu/serving/kvpool.py``.

The contiguous cache (``models/llama.py:init_kv_cache``) preallocates
``[B, n_kv, max_len, D]`` per request.  This module carves ONE physical
cache into fixed-size blocks shared by every sequence on the card (the
vLLM PagedAttention layout):

- :class:`BlockAccount` — the host-side allocator, a copy of the
  reference's: a free list of block ids, refcounted per-owner block
  tables with copy-on-write prefix sharing, occupancy counters.  It
  holds no storage.
- :func:`init_paged_cache` — the device storage: per layer,
  ``[num_blocks, n_kv, block_size, D]`` for K and V, zeroed.  Block 0 is
  RESERVED as scratch: padded batch rows (decode batches are bucketed)
  write their garbage there, and a real sequence's block table never
  contains it.
- :func:`paged_decode_step`, :func:`paged_verify_step`,
  :func:`paged_prefill_chunk` — the paged variants of
  ``llama._attention_decode``: per-sequence (ragged) positions, K/V
  gathered through each sequence's block table, grouped GQA, softmax in
  f32, in the reference's order of casts.

Where the reference rebuilds the pool as a new value on every call, the
port writes it IN PLACE (indexed assignment) and returns the same dict:
the runner's CUDA graphs hold the pool's storage, so nothing may rebind
``cache["k"][i]`` to a new tensor.  Block-table lookups past a table's
width raise (a caller's bug) where JAX would clamp.

Accounting: :meth:`BlockAccount.nbytes` / :func:`paged_cache_nbytes` is
the pool's fixed footprint, charged once on the client's device-memory
meter when serving starts.
"""

from __future__ import annotations

import hashlib
import math
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..models import llama
from ..models.quantize import matmul as _mm

#: block ids below this are scratch (padded batch rows scatter here);
#: never handed to a sequence
RESERVED_BLOCKS = 1

#: chain-hash root: the content key of "no blocks yet"
ROOT_KEY = 0


def chain_key(parent: int, tokens: Sequence[int]) -> int:
    """Content identity of one KV block: the chain hash of its parent
    block's key and the token ids cached in it.  Two sequences produce
    the same key for block ``i`` iff their token prefixes agree through
    that block — and greedy KV is a pure function of (params, token
    prefix, positions), so equal keys mean byte-equal pages.  Stable
    across processes/runs (blake2b, not ``hash()``): the sim digest and
    the KV_SHIP wire both carry these keys."""
    h = hashlib.blake2b(digest_size=8)
    h.update(struct.pack("<Q", parent))
    h.update(b"".join(struct.pack("<i", int(t)) for t in tokens))
    return int.from_bytes(h.digest(), "little") or 1


def prompt_block_keys(prompt: Sequence[int], block_size: int
                      ) -> List[Tuple[int, int]]:
    """The shareable content keys of a prompt: one per FULL block plus,
    when the prompt does not end on a block boundary, one for the
    partial tail (its key covers exactly the prompt tokens in it).
    Returns ``[(key, n_tokens_covered_through_this_block), ...]``."""
    keys: List[Tuple[int, int]] = []
    parent = ROOT_KEY
    n = len(prompt)
    for lo in range(0, n, block_size):
        hi = min(lo + block_size, n)
        parent = chain_key(parent, prompt[lo:hi])
        keys.append((parent, hi))
    return keys


class BlockAccount:
    """Refcounted free-list allocator + per-owner block tables for the
    paged pool, with copy-on-write prefix sharing.

    Storage-free bookkeeping: the engine asks *admission* questions
    (``can_fit``), grows tables token-by-token (``ensure``), and
    releases whole owners at retirement (``release``).  All-or-nothing
    grants — a partially grown table is never left behind by an
    exhausted pool.  Single-stepper discipline: only the engine thread
    mutates an account (the engine snapshots counters under its own
    lock), so there is no lock here.

    Prefix sharing (docs/serving.md): a block's *content key* is the
    chain hash of the token ids cached in it (:func:`chain_key`).  The
    engine ``publish``\\ es prompt blocks as it prefills them and
    ``adopt``\\ s registered blocks for later arrivals whose prompt
    prefix matches (``peek_match`` answers the can-fit question first),
    so N tenants sharing a system prompt hold ONE physical copy with
    refcount N.  Every write goes through :meth:`writable`: a write
    into a block with refcount > 1 triggers copy-on-write to a fresh
    block (the caller copies the device page), and a write into a
    refcount-1 block that is still registered unregisters it first —
    registered content is immutable.  Registry entries hold no
    reference of their own: a block lives exactly as long as sequences
    reference it, so eviction/preemption only ever reclaims blocks
    whose refcount hits zero and quiescence reclaims the whole pool.

    **Persistent prefix cache** (``persistent_prefix=True``,
    ROADMAP 4a, docs/serving.md): the registry takes a reference of
    its OWN on every block it registers, so a shared system prompt
    survives quiescent gaps — sharing no longer requires the prefix's
    sequences to be concurrently live.  The cache yields under
    pressure: whenever an allocation would fail, cache-only blocks
    (refcount 1, held by the registry alone) are evicted lowest-id
    first until the allocation fits (``prefix_cache_evictions_total``;
    ``kv_prefix_cache_evictions_total`` on the metrics line), and
    ``can_fit`` counts those evictable blocks as available so
    admission never stalls on cache-held capacity.  Default OFF: the
    historical reclaim-at-quiescence contract (and the sim invariant
    built on it) is unchanged unless the engine opts in.
    """

    def __init__(self, num_blocks: int, block_size: int,
                 reserved: int = RESERVED_BLOCKS,
                 persistent_prefix: bool = False):
        if num_blocks <= reserved:
            raise ValueError(
                f"pool of {num_blocks} blocks leaves nothing usable "
                f"past the {reserved} reserved scratch block(s)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.reserved = reserved
        #: lowest-id-first free list: allocation order is deterministic,
        #: which the sim digest and block-reuse tests rely on
        self._free: List[int] = sorted(range(reserved, num_blocks),
                                       reverse=True)
        self._owned: Dict[object, List[int]] = {}
        #: refcount per allocated block == how many owner tables hold
        #: it (the registry holds no reference; content entries die
        #: with their last referencing sequence)
        self._refs: Dict[int, int] = {}
        #: content-key registry: chain key -> physical block
        self._by_key: Dict[int, int] = {}
        #: reverse map for unregistering on write/reclaim
        self._key_of: Dict[int, int] = {}
        self.peak_used = 0
        self.total_allocated = 0
        self.total_released = 0
        #: blocks reclaimed by engine preemption (a victim sequence
        #: evicted back to the waiting queue to unblock a higher-QoS
        #: one) — the ``kv_evictions_total`` metric
        self.evicted = 0
        #: prefix-sharing counters (tpf_serving_engine fields)
        self.prefix_hits = 0            # blocks adopted via the registry
        self.prefix_hit_tokens = 0      # prompt tokens served from it
        self.cow_copies = 0             # copy-on-write block copies
        #: persistent prefix cache (ROADMAP 4a): when on, publish()
        #: takes a cache-owned reference so registered content
        #: outlives its sequences; pressure evicts lowest-id first
        self.persistent_prefix = bool(persistent_prefix)
        #: blocks the registry itself holds a reference on
        self._cache_held: set = set()
        #: cache blocks evicted under allocation pressure —
        #: kv_prefix_cache_evictions_total
        self.prefix_cache_evictions = 0
        #: streaming-migration dirty tracking (docs/migration.md): a
        #: write generation per live physical block, bumped whenever
        #: page content can change (allocation, CoW target, in-place
        #: write, shipped-KV ingest) — ``dirty_since`` answers "which
        #: pages changed since pre-copy round N" for the migration
        #: convergence predictor, exactly the worker's per-buffer
        #: ``_buf_gen`` discipline applied to the paged pool
        self.write_gen = 0
        self._block_gen: Dict[int, int] = {}

    # -- capacity ---------------------------------------------------------

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - self.reserved

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.usable_blocks - len(self._free)

    def blocks_for(self, n_tokens: int) -> int:
        return max(0, math.ceil(n_tokens / self.block_size))

    def seq_capacity_tokens(self) -> int:
        """Most tokens a single sequence could ever hold."""
        return self.usable_blocks * self.block_size

    @property
    def evictable_blocks(self) -> int:
        """Cache-only blocks (registry is the sole holder) the
        pressure path could reclaim right now."""
        if not self._cache_held:
            return 0
        return sum(1 for b in self._cache_held
                   if self._refs.get(b) == 1)

    def can_fit(self, n_tokens: int) -> bool:
        # cache-held capacity counts as available: the persistent
        # prefix cache always yields to a real allocation
        return self.blocks_for(n_tokens) <= \
            len(self._free) + self.evictable_blocks

    def _evict_cache_for(self, need: int) -> None:
        """Pressure-driven eviction: free ``need`` blocks from the
        cache-only holdings, lowest id first (the same determinism
        discipline as the free list), unregistering their content."""
        if need <= 0 or not self._cache_held:
            return
        for blk in sorted(self._cache_held):
            if need <= 0:
                break
            if self._refs.get(blk) != 1:
                continue        # a live sequence still shares it
            self._cache_held.discard(blk)
            del self._refs[blk]
            self._block_gen.pop(blk, None)
            key = self._key_of.pop(blk, None)
            if key is not None:
                self._by_key.pop(key, None)
            self._free.append(blk)
            self.total_released += 1
            self.prefix_cache_evictions += 1
            need -= 1
        self._free.sort(reverse=True)

    def nbytes(self, per_block_bytes: int) -> int:
        return self.num_blocks * per_block_bytes

    # -- dirty tracking (streaming migration, docs/migration.md) ----------

    def _touch(self, blk: int) -> None:
        self.write_gen += 1
        self._block_gen[blk] = self.write_gen

    def dirty_since(self, gen: int) -> List[int]:
        """Live physical blocks whose pages changed after generation
        ``gen`` — one pre-copy round ships exactly these.  Pair with
        the current :attr:`write_gen` as the next round's floor."""
        return sorted(b for b, g in self._block_gen.items() if g > gen)

    # -- allocation -------------------------------------------------------

    def ensure(self, owner: object, n_tokens: int) -> bool:
        """Grow ``owner``'s table to cover ``n_tokens``; False (and no
        partial grab) when the pool cannot supply the growth."""
        table = self._owned.setdefault(owner, [])
        need = self.blocks_for(n_tokens) - len(table)
        if need <= 0:
            return True
        if need > len(self._free):
            self._evict_cache_for(need - len(self._free))
        if need > len(self._free):
            return False
        for _ in range(need):
            blk = self._free.pop()
            self._refs[blk] = 1
            table.append(blk)
            self._touch(blk)
        self.total_allocated += need
        self.peak_used = max(self.peak_used, self.used_blocks)
        return True

    def table(self, owner: object) -> List[int]:
        return list(self._owned.get(owner, ()))

    def _reclaim(self, blk: int, evicted: bool) -> None:
        """Drop one reference; free the block at refcount zero (raises
        on double-free — a negative refcount means table/refs drifted,
        which eviction bugs would otherwise silently corrupt)."""
        refs = self._refs.get(blk, 0)
        if refs <= 0:
            raise RuntimeError(f"double free of KV block {blk}")
        if refs > 1:
            self._refs[blk] = refs - 1
            return
        del self._refs[blk]
        self._block_gen.pop(blk, None)
        key = self._key_of.pop(blk, None)
        if key is not None:
            self._by_key.pop(key, None)
        self._free.append(blk)
        self.total_released += 1
        if evicted:
            self.evicted += 1

    def release(self, owner: object, evicted: bool = False) -> int:
        """Drop ``owner``'s references (retirement or preemption);
        returns the count of blocks physically reclaimed — shared
        blocks stay resident for their other holders and only return
        to the pool when the last reference goes."""
        table = self._owned.pop(owner, None)
        if not table:
            return 0
        freed_before = len(self._free)
        for blk in table:
            self._reclaim(blk, evicted)
        # keep the lowest-id-first discipline across reuse
        self._free.sort(reverse=True)
        return len(self._free) - freed_before

    def truncate(self, owner: object, n_tokens: int) -> int:
        """Shrink ``owner``'s table to exactly cover ``n_tokens`` —
        the speculative-decode rollback: blocks grown for rejected
        draft positions go back to the pool (refcount rules as in
        :meth:`release`).  Returns blocks physically reclaimed."""
        table = self._owned.get(owner)
        if table is None:
            return 0
        keep = self.blocks_for(n_tokens)
        if keep >= len(table):
            return 0
        freed_before = len(self._free)
        while len(table) > keep:
            self._reclaim(table.pop(), evicted=False)
        self._free.sort(reverse=True)
        return len(self._free) - freed_before

    # -- prefix sharing ---------------------------------------------------

    def refcount(self, blk: int) -> int:
        return self._refs.get(blk, 0)

    def lookup(self, key: int) -> Optional[int]:
        return self._by_key.get(key)

    def peek_match(self, keys: Sequence[Tuple[int, int]]
                   ) -> Tuple[int, int]:
        """Longest registered chain prefix of ``keys`` (as produced by
        :func:`prompt_block_keys`) WITHOUT adopting: returns
        ``(blocks, tokens)`` the registry could serve."""
        blocks = tokens = 0
        for key, covered in keys:
            if key not in self._by_key:
                break
            blocks += 1
            tokens = covered
        return blocks, tokens

    def adopt(self, owner: object, keys: Sequence[Tuple[int, int]]
              ) -> int:
        """Map ``owner``'s table onto the longest registered chain
        prefix of ``keys`` (refcount++ per adopted block).  Only legal
        while the table is empty (admission / re-admission).  Returns
        prompt tokens covered by the adopted blocks."""
        table = self._owned.setdefault(owner, [])
        if table:
            raise RuntimeError("adopt() on a non-empty block table")
        tokens = 0
        for key, covered in keys:
            blk = self._by_key.get(key)
            if blk is None:
                break
            table.append(blk)
            self._refs[blk] += 1
            tokens = covered
            self.prefix_hits += 1
        self.prefix_hit_tokens += tokens
        self.peak_used = max(self.peak_used, self.used_blocks)
        return tokens

    def adopt_block(self, owner: object, key: int) -> Optional[int]:
        """Append the registered block for ``key`` to ``owner``'s table
        (refcount++), or None on a registry miss — the per-block dedup
        the KV_SHIP ingest runs (a chain key encodes its whole prefix,
        so a hit at any index implies content-identical ancestry)."""
        blk = self._by_key.get(key)
        if blk is None:
            return None
        self._owned.setdefault(owner, []).append(blk)
        self._refs[blk] += 1
        self.prefix_hits += 1
        self.peak_used = max(self.peak_used, self.used_blocks)
        return blk

    def append_block(self, owner: object) -> Optional[int]:
        """Grow ``owner``'s table by ONE fresh block (KV_SHIP ingest
        writes shipped pages into it); None when the pool is out."""
        if not self._free:
            self._evict_cache_for(1)
        if not self._free:
            return None
        blk = self._free.pop()
        self._refs[blk] = 1
        self._owned.setdefault(owner, []).append(blk)
        self._touch(blk)
        self.total_allocated += 1
        self.peak_used = max(self.peak_used, self.used_blocks)
        return blk

    def publish(self, owner: object, index: int, key: int) -> bool:
        """Register ``owner``'s block at table ``index`` under ``key``
        (first-come wins; re-publishing an already-registered key is a
        no-op).  Registered content must stay immutable — later writes
        go through :meth:`writable`, which unregisters or CoWs."""
        if key in self._by_key:
            return False
        blk = self._owned[owner][index]
        if blk in self._key_of:      # block already carries other content
            return False
        self._by_key[key] = blk
        self._key_of[blk] = key
        if self.persistent_prefix and blk not in self._cache_held:
            # cache-owned reference: the content outlives its
            # sequences, reclaimed only by pressure eviction (or
            # drop_prefix_cache)
            self._cache_held.add(blk)
            self._refs[blk] += 1
        return True

    def drop_prefix_cache(self) -> int:
        """Release every cache-owned reference (engine shutdown /
        explicit flush).  Blocks still shared by live sequences stay
        resident for them; cache-only blocks return to the pool.
        Returns blocks physically reclaimed."""
        freed = 0
        for blk in sorted(self._cache_held):
            refs = self._refs.get(blk, 0)
            if refs <= 1:
                self._refs.pop(blk, None)
                self._block_gen.pop(blk, None)
                key = self._key_of.pop(blk, None)
                if key is not None:
                    self._by_key.pop(key, None)
                self._free.append(blk)
                self.total_released += 1
                freed += 1
            else:
                self._refs[blk] = refs - 1
        self._cache_held.clear()
        self._free.sort(reverse=True)
        return freed

    def writable(self, owner: object, index: int
                 ) -> Optional[Tuple[int, Optional[int]]]:
        """Secure ``owner``'s block at table ``index`` for a write.
        Returns ``(block, cow_src)``: ``cow_src`` is None for an
        in-place write, else the shared source block whose page the
        caller must copy into ``block`` BEFORE writing (copy-on-write —
        the table already points at the fresh copy).  Returns None when
        a needed CoW copy cannot be allocated (pool exhausted — the
        engine preempts and retries)."""
        table = self._owned[owner]
        blk = table[index]
        if self._refs[blk] > 1:
            if not self._free:
                self._evict_cache_for(1)
            if not self._free:
                return None
            new = self._free.pop()
            self._refs[new] = 1
            self._refs[blk] -= 1
            table[index] = new
            self._touch(new)
            self.cow_copies += 1
            self.total_allocated += 1
            self.peak_used = max(self.peak_used, self.used_blocks)
            return new, blk
        key = self._key_of.pop(blk, None)
        if key is not None:
            # sole holder writing into registered content: the entry
            # no longer describes the block, so it leaves the registry
            self._by_key.pop(key, None)
        self._touch(blk)
        return blk, None

    @property
    def shared_blocks(self) -> int:
        """Physical blocks currently mapped by more than one table."""
        return sum(1 for r in self._refs.values() if r > 1)

    @property
    def logical_blocks(self) -> int:
        """Sum of table lengths — what ``used_blocks`` would be with no
        sharing; the gap to ``used_blocks`` is the dedup win."""
        return sum(self._refs.values())

    def utilization_pct(self) -> float:
        if not self.usable_blocks:
            return 0.0
        return round(100.0 * self.used_blocks / self.usable_blocks, 3)

    def snapshot(self) -> Dict[str, float]:
        return {"num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "usable": self.usable_blocks,
                "used": self.used_blocks,
                "free": self.free_blocks,
                "peak_used": self.peak_used,
                "owners": len(self._owned),
                "allocated_total": self.total_allocated,
                "released_total": self.total_released,
                "evicted_total": self.evicted,
                "shared_blocks": self.shared_blocks,
                "logical_blocks": self.logical_blocks,
                "prefix_hits_total": self.prefix_hits,
                "prefix_hit_tokens_total": self.prefix_hit_tokens,
                "cow_copies_total": self.cow_copies,
                "registered_keys": len(self._by_key),
                "persistent_prefix": int(self.persistent_prefix),
                "cache_held_blocks": len(self._cache_held),
                "prefix_cache_evictions_total":
                    self.prefix_cache_evictions,
                "write_gen": self.write_gen,
                "utilization_pct": self.utilization_pct()}



# -- device-side storage + paged attention ---------------------------------


def init_paged_cache(config, num_blocks: int, block_size: int,
                     device: DeviceLike = "cuda") -> Dict:
    """Paged KV storage: per layer ``[num_blocks, n_kv, block_size, D]``
    for K and V, zeroed (unwritten slots of live blocks are read on every
    step: masked, they weigh 0, but 0 · NaN would be NaN).  One physical
    pool serves every sequence; block 0 is scratch (see module
    docstring).  ``config.kv_quant`` is not paged yet."""
    if getattr(config, "kv_quant", False):
        raise ValueError("paged KV cache does not support kv_quant yet "
                         "(use the contiguous int8 cache)")
    dev = resolve_device(device)
    shape = (num_blocks, config.n_kv_heads, block_size, config.head_dim)
    return {kind: [torch.zeros(shape, dtype=config.dtype, device=dev)
                   for _ in range(config.n_layers)]
            for kind in ("k", "v")}


def paged_cache_nbytes(config, num_blocks: int, block_size: int) -> int:
    """Physical footprint of the pool without materializing it."""
    itemsize = torch.empty((), dtype=config.dtype).element_size()
    per_block = config.n_kv_heads * block_size * config.head_dim * itemsize
    return 2 * config.n_layers * num_blocks * per_block


def _rope_at(x, theta: float, pos):
    """Rotary embedding at explicit per-row positions.

    ``x``: ``[..., H, D]`` where the leading axes carry one position
    each; ``pos``: integer tensor matching those leading axes.  f32
    angles, cos and sin cast to x's dtype before the multiply, and the
    pairs (0,1), (2,3), ... of ``llama._rope``."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    angles = pos.float()[..., None, None] * freqs          # [..., 1, D/2]
    cos = torch.cos(angles).to(x.dtype)
    sin = torch.sin(angles).to(x.dtype)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin,
                        x1 * sin + x2 * cos], dim=-1).reshape(x.shape)


def _attend(config, layer, x, cache, i, blk, slot, gather, pos, key_mask,
            scores_eq, out_eq):
    """One layer of the paged step: the projections at ``pos``, this
    step's K/V written into the pool at ``(blk, slot)`` in place, then
    attention over the pages ``gather`` names.  ``x``: ``[*lead, dim]``;
    ``key_mask`` broadcasts against the scores ``[*lead, n_kv, rep,
    keys]``.  Returns the layer's output."""
    p = layer["attn"]
    hd = config.head_dim
    n_kv = config.n_kv_heads
    rep = config.n_heads // n_kv
    lead = x.shape[:-1]
    h = llama._rms_norm(x, layer["attn_norm"], config.norm_eps)
    q = _mm(h, p["wq"]).reshape(*lead, config.n_heads, hd)
    k = _mm(h, p["wk"]).reshape(*lead, n_kv, hd)
    v = _mm(h, p["wv"]).reshape(*lead, n_kv, hd)
    q = _rope_at(q, config.rope_theta, pos)
    k = _rope_at(k, config.rope_theta, pos)
    ck, cv = cache["k"][i], cache["v"][i]
    # two advanced indices around the head slice put their axes first:
    # the written value is [*lead, n_kv, D]
    ck[blk, :, slot, :] = k.to(ck.dtype)
    cv[blk, :, slot, :] = v.to(cv.dtype)
    kk, vv = gather(ck), gather(cv)
    qg = q.reshape(*lead, n_kv, rep, hd)
    scores = torch.einsum(scores_eq, qg, kk) * hd ** -0.5
    scores = scores.masked_fill(~key_mask, -1e30)
    probs = torch.softmax(scores.float(), dim=-1)
    out = torch.einsum(out_eq, probs.to(vv.dtype), vv)
    x = x + _mm(out.reshape(*lead, config.n_heads * hd), p["wo"])
    return x + llama._mlp(
        layer["mlp"], llama._rms_norm(x, layer["mlp_norm"], config.norm_eps))


def _gather_rows(block_tables, n_kv, hd):
    """Each row's pages as ``[B, n_kv, M * bs, D]``: key index k of the
    gathered axis is cache position k of that row."""
    b, m = block_tables.shape

    def gather(layer_cache):
        bs = layer_cache.shape[2]
        return layer_cache[block_tables].permute(0, 2, 1, 3, 4) \
            .reshape(b, n_kv, m * bs, hd)
    return gather


def _logits(params, x, config):
    x = llama._rms_norm(x, params["final_norm"], config.norm_eps)
    return _mm(x, params["lm_head"]).float()


def paged_decode_step(params: Dict, token, cache: Dict, block_tables,
                      pos, config):
    """One decode step for ``B`` sequences sharing the paged pool.

    ``token``: ``[B]`` integers — each sequence's latest token (not yet
    in the cache); ``block_tables``: ``[B, M]`` rows of pool block ids
    (pad with 0 — masked out because padded positions exceed ``pos``);
    ``pos``: ``[B]`` — the cache index each token is written at (==
    tokens already cached), per sequence, RAGGED.  All on the pool's
    device.  Returns ``(logits [B, vocab] f32, cache)``, the cache
    written in place."""
    b = token.shape[0]
    m = block_tables.shape[1]
    bs = cache["k"][0].shape[2]
    pos = pos.long()
    block_tables = block_tables.long()
    rows = torch.arange(b, device=pos.device)
    blk = block_tables[rows, pos // bs]            # [B]
    slot = pos % bs                                # [B]
    key_mask = (torch.arange(m * bs, device=pos.device)[None, :]
                <= pos[:, None])[:, None, None, :]
    gather = _gather_rows(block_tables, config.n_kv_heads, config.head_dim)
    x = params["tok_emb"][token.long()]            # [B, dim]
    for i, layer in enumerate(params["layers"]):
        x = _attend(config, layer, x, cache, i, blk, slot, gather, pos,
                    key_mask, "bgrd,bgkd->bgrk", "bgrk,bgkd->bgrd")
    return _logits(params, x, config), cache


def paged_verify_step(params: Dict, tokens, cache: Dict, block_tables,
                      pos, config):
    """One fused speculative-verify step: ``S`` tokens per sequence for
    ``B`` sequences in one call.

    ``tokens``: ``[B, S]`` — per sequence, the latest real token
    followed by ``S-1`` draft proposals; ``block_tables``: ``[B, M]``;
    ``pos``: ``[B]`` — the cache index the FIRST token of each row is
    written at (ragged).  Token ``[b, s]`` lands at cache position
    ``pos[b] + s``; K/V for every position is written (rejected
    positions are overwritten later and masked until then).  Returns
    ``(logits [B, S, vocab] f32, cache)``; with ``S == 1`` this is
    :func:`paged_decode_step` with an extra axis."""
    b, s = tokens.shape
    m = block_tables.shape[1]
    bs = cache["k"][0].shape[2]
    pos = pos.long()
    block_tables = block_tables.long()
    rows = torch.arange(b, device=pos.device)
    pos_grid = pos[:, None] + torch.arange(s, device=pos.device)[None, :]
    blk = block_tables[rows[:, None], pos_grid // bs]     # [B, S]
    slot = pos_grid % bs                                  # [B, S]
    key_mask = (torch.arange(m * bs, device=pos.device)[None, None, :]
                <= pos_grid[:, :, None])[:, :, None, None, :]
    gather = _gather_rows(block_tables, config.n_kv_heads, config.head_dim)
    x = params["tok_emb"][tokens.long()]           # [B, S, dim]
    for i, layer in enumerate(params["layers"]):
        x = _attend(config, layer, x, cache, i, blk, slot, gather,
                    pos_grid, key_mask, "bsgrd,bgkd->bsgrk",
                    "bsgrk,bgkd->bsgrd")
    return _logits(params, x, config), cache


def paged_prefill_chunk(params: Dict, tokens, cache: Dict, block_table,
                        start_pos, config):
    """Prefill ``C`` prompt tokens of ONE sequence into its pages.

    ``tokens``: ``[C]``; ``block_table``: ``[M]`` (the sequence's pages,
    padded with 0); ``start_pos``: int — tokens already cached (0 for
    the first chunk).  Attends causally over the pages written so far
    plus the chunk itself.  Returns ``(last-position logits [vocab] f32,
    cache)`` — the logits only matter on the final chunk of the
    prompt."""
    c = tokens.shape[0]
    m = block_table.shape[0]
    bs = cache["k"][0].shape[2]
    n_kv, hd = config.n_kv_heads, config.head_dim
    dev = tokens.device
    block_table = block_table.long()
    positions = int(start_pos) + torch.arange(c, device=dev)   # [C]
    blk = block_table[positions // bs]
    slot = positions % bs
    # causal over history + chunk: key index k visible to query c when
    # k <= start_pos + c (key indices enumerate the gathered pages)
    key_mask = (torch.arange(m * bs, device=dev)[None, :]
                <= positions[:, None])[:, None, None, :]

    def gather(layer_cache):
        return layer_cache[block_table].permute(1, 0, 2, 3) \
            .reshape(n_kv, m * bs, hd)

    x = params["tok_emb"][tokens.long()]           # [C, dim]
    for i, layer in enumerate(params["layers"]):
        x = _attend(config, layer, x, cache, i, blk, slot, gather,
                    positions, key_mask, "cgrd,gkd->cgrk", "cgrk,gkd->cgrd")
    return _logits(params, x[-1], config), cache


def pow2_bucket(n: int, lo: int = 1) -> int:
    """Smallest power of two >= max(n, lo) — the compile-cache bucket
    for decode batch sizes and block-table widths."""
    b = max(lo, 1)
    while b < n:
        b <<= 1
    return b


def contiguous_to_paged(cache: Dict, paged: Dict, table: List[int],
                        n_tokens: int, block_size: int) -> Dict:
    """Copy a contiguous cache's first ``n_tokens`` into pool pages, in
    place (migration of a fixed-batch request onto the pool; also the
    cross-check the numerics tests use).  ``cache``: one sequence's
    contiguous view ``[1, n_kv, T, D]`` per layer."""
    for i in range(len(paged["k"])):
        for j, blk in enumerate(table):
            lo = j * block_size
            hi = min(lo + block_size, n_tokens)
            if lo >= hi:
                break
            span = hi - lo
            for kind in ("k", "v"):
                paged[kind][i][blk, :, :span, :] = cache[kind][i][0, :, lo:hi, :]
    return paged
