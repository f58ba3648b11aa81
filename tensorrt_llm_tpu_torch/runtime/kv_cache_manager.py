"""Paged KV-cache block manager with radix-tree prefix reuse.

Host-side port of ``tensorrt_llm_tpu/runtime/kv_cache_manager.py``
(``KVCacheManager`` with the speculative pair ``add_draft_tokens`` /
``rewind_tokens``, the VSWA dual-pool facade ``VswaKvManager``, and the
host and disk tiers): integer page ids only, no device tensors; the page
movers of the tiers are the engine's, injected as callbacks.

Semantics:
  * Block identity: ``BlockKey`` = (tokens_in_block, lora_task_id,
    cache_salt); exact-key per block, longest-prefix over the chain.
  * Reuse: finished sequences attach their chain to a radix tree;
    new sequences claim the longest matched prefix (ref-counted).
  * Eviction: priority-bucketed LRU over the deepest primary block of
    a path. With a host tier (``host_cache_blocks`` > 0 and the movers
    ``offload_fn`` / ``onboard_fn``) an evicted block of at least
    ``secondary_offload_min_priority`` offloads to host memory and
    onboards on a later prefix match; host-LRU victims demote to the
    disk store (``disk_store``, runtime/kv_tiers.py) when there is one,
    and promote disk -> device directly on a match.
  * Speculation: a verify step writes KV for its drafts
    (``add_draft_tokens``); rejected drafts' whole blocks go back to the
    free list (``rewind_tokens``).
  * Storing: a sequence stores only blocks whose every position holds
    KV the device wrote for one of its tokens (positions below
    ``num_device_tokens``). A decode step writes the KV of the token it
    consumes, so a sequence's last token never has KV: when it closes a
    block, that block stays out of the tree; after drafts, the last
    position may also hold a rejected draft's KV. (The JAX package
    stores by the token count alone, so a later prompt that extends the
    tokens reads the unwritten position.)
  * VSWA (sliding-window layers on a pool of their own): a sequence's
    sliding-pool blocks that no query still to be computed can see go
    back to the free list while it runs (``trim_prefix``); their ids stay
    in its page table as ``_TrimmedBlock`` placeholders (the kernels mask
    those positions), and a trimmed chain never enters the reuse tree.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

from .request import LlmRequest

DEFAULT_PRIORITY = 35


@dataclasses.dataclass(frozen=True)
class BlockKey:
    """Identity of one full KV block."""
    tokens: Tuple[int, ...]
    lora_task_id: Optional[int] = None
    cache_salt: Optional[str] = None
    extra_hashes: Tuple[int, ...] = ()


def stable_block_hash(tokens, parent_hash: Optional[int] = None,
                      lora_task_id: Optional[int] = None,
                      cache_salt: Optional[str] = None) -> int:
    """Chained content hash of one full KV block, stable across processes
    (sha256 over parent hash + token ids)."""
    import hashlib
    import struct as _struct
    h = hashlib.sha256()
    if parent_hash is not None:
        h.update(_struct.pack("<q", parent_hash))
    if lora_task_id is not None:
        h.update(b"L" + _struct.pack("<q", lora_task_id))
    if cache_salt:
        h.update(b"S" + cache_salt.encode())
    h.update(_struct.pack(f"<{len(tokens)}i", *tokens))
    return int.from_bytes(h.digest()[:8], "little", signed=True)


class RadixNode:
    """Reuse-tree node: holds a primary block, offloaded host data or a
    disk key (or, transiently, none of them before it is pruned)."""
    __slots__ = ("key", "parent", "children", "block", "host_data",
                 "disk_key", "priority", "_lru_tick", "content_hash")

    def __init__(self, key: Optional[BlockKey] = None,
                 parent: Optional["RadixNode"] = None):
        self.content_hash: Optional[int] = None
        self.key = key
        self.parent = parent
        self.children: Dict[BlockKey, "RadixNode"] = {}
        self.block: Optional["Block"] = None
        self.host_data = None
        self.disk_key = None
        self.priority = DEFAULT_PRIORITY
        self._lru_tick = 0

    @property
    def is_leaf(self) -> bool:
        return not self.children

    def detach(self) -> None:
        if self.parent is not None:
            self.parent.children.pop(self.key, None)
        self.parent = None
        self.children = {}
        self.host_data = None
        if self.block is not None:
            self.block.node = None
            self.block = None


class Block:
    __slots__ = ("block_id", "ref_count", "node")

    def __init__(self, block_id: int):
        self.block_id = block_id
        self.ref_count = 0
        self.node: Optional[RadixNode] = None


@dataclasses.dataclass
class KvCacheStats:
    max_blocks: int = 0
    free_blocks: int = 0
    used_blocks: int = 0
    reusable_blocks: int = 0
    alloc_total_blocks: int = 0
    alloc_new_blocks: int = 0
    reused_blocks: int = 0
    missed_blocks: int = 0
    cache_hit_rate: float = 0.0
    offloaded_blocks: int = 0
    disk_blocks: int = 0
    disk_onboarded_blocks: int = 0
    onboarded_blocks: int = 0
    host_blocks: int = 0


@dataclasses.dataclass
class KVCacheEvent:
    """Block stored/removed events for external routers."""
    event_id: int
    kind: str          # "stored" | "removed" | "offloaded" | "demoted_disk"
    block_hashes: List[int]


class KVCacheManager:
    """Paged KV allocator for one attention-window size. ``ids_attr`` is
    the request field that holds this pool's block ids (``kv_block_ids``;
    VSWA's sliding pool writes ``kv_block_ids_sw``)."""

    def __init__(self,
                 num_blocks: int,
                 tokens_per_block: int,
                 max_seq_len: int = 1 << 30,
                 enable_block_reuse: bool = True,
                 event_buffer_max_size: int = 0,
                 ids_attr: str = "kv_block_ids",
                 host_cache_blocks: int = 0,
                 offload_fn: Optional[Callable[[int], object]] = None,
                 onboard_fn: Optional[Callable[[int, object], None]] = None,
                 secondary_offload_min_priority: int = 0,
                 disk_store=None):
        if tokens_per_block <= 0:
            raise ValueError("tokens_per_block must be positive")
        self.ids_attr = ids_attr
        self.num_blocks = num_blocks
        self.tokens_per_block = tokens_per_block
        self.max_seq_len = max_seq_len
        self.enable_block_reuse = enable_block_reuse
        # the host tier: at most host_cache_blocks offloaded blocks, in
        # LRU order; the disk tier under it (kv_tiers.DiskKvStore)
        self.host_cache_blocks = host_cache_blocks
        self._offload_fn = offload_fn
        self._onboard_fn = onboard_fn
        self.secondary_offload_min_priority = secondary_offload_min_priority
        self._host_lru: "OrderedDict[RadixNode, None]" = OrderedDict()
        self._disk = disk_store
        self._claiming: Optional[RadixNode] = None   # see _claim_node

        self._blocks = [Block(i) for i in range(num_blocks)]
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))  # LIFO
        # reusable tree-attached blocks with ref 0:
        # priority -> OrderedDict[block_id, None] (LRU order)
        self._reusable: Dict[int, OrderedDict] = {}
        self._num_reusable = 0
        self._root = RadixNode()
        self._lru_clock = 0

        self._seq_blocks: Dict[int, List[Block]] = {}
        self._req_priority: Dict[int, int] = {}
        self._reusable_prio: Dict[int, int] = {}  # block_id -> bucket used

        self._stats = KvCacheStats(max_blocks=num_blocks)
        self._events: List[KVCacheEvent] = []
        self._event_buffer_max_size = event_buffer_max_size
        self._event_id = 0

    # ------------------------------------------------------------------ #
    # Capacity queries (used by the capacity scheduler)
    # ------------------------------------------------------------------ #
    @property
    def free_block_count(self) -> int:
        return len(self._free) + self._num_reusable

    def get_num_free_blocks(self) -> int:
        return self.free_block_count

    def blocks_for_tokens(self, num_tokens: int) -> int:
        return -(-num_tokens // self.tokens_per_block)

    @staticmethod
    def _device_progress(request: LlmRequest) -> int:
        """Allocation follows *device* progress, which runs ahead of the
        host-accepted token count by up to the executor pipeline depth."""
        return max(request.num_total_tokens, request.num_device_tokens)

    def get_needed_blocks_one_step(self, request: LlmRequest) -> int:
        have = len(self._seq_blocks.get(request.request_id, ()))
        if request.is_context_init_state:
            end = min(request.context_len,
                      request.context_current_position
                      + request.context_chunk_size)
            return max(0, self.blocks_for_tokens(end) - have)
        return max(0, self.blocks_for_tokens(
            self._device_progress(request) + 1) - have)

    def get_remaining_blocks_to_completion(self, request: LlmRequest) -> int:
        """Worst-case blocks to finish the request (GuaranteedNoEvict)."""
        total = request.prompt_len + request.max_new_tokens
        have = len(self._seq_blocks.get(request.request_id, ()))
        return max(0, self.blocks_for_tokens(total) - have)

    # ------------------------------------------------------------------ #
    # Allocation API
    # ------------------------------------------------------------------ #
    def add_sequence(self, request: LlmRequest,
                     enable_reuse: Optional[bool] = None) -> int:
        """Claim blocks for a new context-phase sequence with
        longest-prefix reuse over full blocks (all but the final token —
        its KV must be recomputed for logits)."""
        rid = request.request_id
        if rid in self._seq_blocks:
            raise ValueError(f"request {rid} already has KV blocks")
        chain: List[Block] = []
        reused_tokens = 0
        reuse = self.enable_block_reuse if enable_reuse is None \
            else enable_reuse
        if reuse:
            node = self._root
            matchable = request.context_len - 1
            pos = 0
            while matchable - pos >= self.tokens_per_block:
                child = node.children.get(self._make_key(request, pos))
                if child is None:
                    break
                block = self._claim_node(child)
                if block is None:
                    break    # no data in any tier, or no room to onboard
                chain.append(block)
                pos += self.tokens_per_block
                node = child
            reused_tokens = pos

        total_needed = self.blocks_for_tokens(request.context_len)
        new_needed = total_needed - len(chain)
        if new_needed > self.free_block_count:
            for b in chain:
                self._release_block(b)
            raise NoFreeBlocksError(
                f"need {new_needed} blocks, have {self.free_block_count}")
        for _ in range(new_needed):
            chain.append(self._allocate_block())
        self._seq_blocks[rid] = chain
        self._set_ids(request, chain)
        if reuse:
            request.num_cached_tokens = reused_tokens
        self._stats.reused_blocks += len(chain) - new_needed
        self._stats.missed_blocks += new_needed
        self._stats.alloc_new_blocks += new_needed
        self._stats.alloc_total_blocks += len(chain)
        return reused_tokens

    def add_token(self, request: LlmRequest) -> None:
        self._grow(request, self._device_progress(request) + 1)

    def add_tokens(self, request: LlmRequest, num_tokens: int) -> None:
        """Pre-allocate pages for a multi-step decode window (the device
        writes KV for up to ``num_tokens`` positions before the host sees
        the results)."""
        self._grow(request, self._device_progress(request) + num_tokens)

    def add_draft_tokens(self, request: LlmRequest, num_draft: int) -> None:
        """Pages for a verify step: the input token and ``num_draft``
        drafts behind it."""
        self._grow(request, self._device_progress(request) + 1 + num_draft)

    def rewind_tokens(self, request: LlmRequest, num_tokens: int) -> None:
        """Release the blocks past the last ``num_tokens`` of the host's
        tokens (speculative rejection: the executor rewinds by 0 after
        rolling ``num_device_tokens`` back)."""
        chain = self._seq_blocks[request.request_id]
        needed = self.blocks_for_tokens(
            max(1, request.num_total_tokens - num_tokens))
        while len(chain) > needed:
            block = chain.pop()
            if not isinstance(block, _TrimmedBlock):
                self._release_block(block)
        self._set_ids(request, chain)

    def _grow(self, request: LlmRequest, total_tokens: int) -> None:
        chain = self._seq_blocks[request.request_id]
        needed = self.blocks_for_tokens(total_tokens)
        while len(chain) < needed:
            chain.append(self._allocate_block())
            self._stats.alloc_new_blocks += 1
            self._stats.alloc_total_blocks += 1
        self._set_ids(request, chain)

    def _set_ids(self, request: LlmRequest, chain) -> None:
        setattr(request, self.ids_attr, [b.block_id for b in chain])

    def free_resources(self, request: LlmRequest,
                       store_for_reuse: Optional[bool] = None) -> None:
        """Release a sequence's blocks; optionally attach them to the
        reuse tree keyed by the tokens they hold."""
        rid = request.request_id
        chain = self._seq_blocks.pop(rid, None)
        if chain is None:
            return
        if any(isinstance(b, _TrimmedBlock) for b in chain):
            # the prefix's content is gone: release what is left directly
            for b in chain:
                if not isinstance(b, _TrimmedBlock):
                    self._release_block(b)
            self._set_ids(request, [])
            return
        store = self.enable_block_reuse if store_for_reuse is None \
            else store_for_reuse
        tokens = request.all_token_ids
        # positions whose KV the device wrote for one of these tokens
        valid = min(len(tokens), request.num_device_tokens)
        node: Optional[RadixNode] = self._root
        stored_hashes: List[int] = []
        phash: Optional[int] = None   # chained stable hash of the prefix
        for i, block in enumerate(chain):
            start = i * self.tokens_per_block
            full = start + self.tokens_per_block <= valid
            if store and full and node is not None and block.node is None:
                blk_tokens = tuple(
                    tokens[start:start + self.tokens_per_block])
                key = BlockKey(
                    tokens=blk_tokens,
                    lora_task_id=request.lora_task_id,
                    cache_salt=request.cache_salt)
                phash = stable_block_hash(blk_tokens, phash,
                                          request.lora_task_id,
                                          request.cache_salt)
                existing = node.children.get(key)
                if existing is not None:
                    # duplicate content: keep the existing node
                    self._release_block(block)
                    node = existing
                    continue
                child = RadixNode(key, node)
                child.block = block
                child.content_hash = phash
                child.priority = self._req_priority.get(
                    rid, DEFAULT_PRIORITY)
                block.node = child
                node.children[key] = child
                stored_hashes.append(phash)
                node = child
                self._release_block(block)
            elif block.node is not None:
                node = block.node
                phash = node.content_hash
                self._release_block(block)
            else:
                node = None  # chain broken: deeper blocks cannot attach
                self._release_block(block)
        if stored_hashes:
            self._push_event("stored", stored_hashes)
        self._set_ids(request, [])

    def pool_block_ids(self, request: LlmRequest
                       ) -> List[List[Optional[int]]]:
        """The sequence's block ids page by page, one list per KV pool
        (one here; ``VswaKvManager``: global, sliding), None where a block
        was released while it runs (``trim_prefix``): what a beam fork
        copies."""
        return [[None if isinstance(b, _TrimmedBlock) else b.block_id
                 for b in self._seq_blocks.get(request.request_id, ())]]

    def trim_prefix(self, request: LlmRequest, keep_from_block: int) -> int:
        """Release the sequence's blocks below ``keep_from_block`` to the
        free list, leaving their ids in the request's block list (the page
        table stays absolutely indexed). Returns the blocks released."""
        chain = self._seq_blocks.get(request.request_id)
        if chain is None:
            return 0
        freed = 0
        for i in range(min(keep_from_block, len(chain))):
            b = chain[i]
            if isinstance(b, _TrimmedBlock):
                continue
            self._release_block(b)
            chain[i] = _TrimmedBlock(b.block_id)
            freed += 1
        return freed

    def update_priority(self, request: LlmRequest, priority: int) -> None:
        """Retention priority: applied to tree nodes now and remembered
        for blocks stored at free time."""
        self._req_priority[request.request_id] = priority
        for b in self._seq_blocks.get(request.request_id, ()):
            if b.node is not None:
                b.node.priority = priority

    # ------------------------------------------------------------------ #
    # Stats / events
    # ------------------------------------------------------------------ #
    def get_stats(self) -> KvCacheStats:
        s = self._stats
        s.free_blocks = self.free_block_count
        s.used_blocks = self.num_blocks - s.free_blocks
        s.reusable_blocks = self._num_reusable
        s.host_blocks = len(self._host_lru)
        total = s.reused_blocks + s.missed_blocks
        s.cache_hit_rate = s.reused_blocks / total if total else 0.0
        return s

    def drop_device_blocks(self) -> int:
        """Forget the device data of every reusable block (the engine's
        pool was freed and allocated anew: sleep and wake); the host and
        disk tiers' copies stay matchable. Refused while a sequence holds
        blocks. Returns the blocks dropped."""
        if self._seq_blocks:
            raise RuntimeError("KV blocks are held by running sequences")
        dropped = 0
        for bucket in list(self._reusable.values()):
            for block_id in list(bucket):
                block = self._blocks[block_id]
                node = block.node
                self._reusable_remove(block, node)
                self._push_event("removed", [self._hash_of(node)])
                node.block = None
                block.node = None
                self._free.append(block_id)
                dropped += 1
                if node.is_leaf:
                    self._maybe_prune(node)
        return dropped

    def get_latest_events(self, clear: bool = True) -> List[KVCacheEvent]:
        ev = self._events
        if clear:
            self._events = []
        return ev

    # ------------------------------------------------------------------ #
    # Internals
    # ------------------------------------------------------------------ #
    def _make_key(self, request: LlmRequest, start: int) -> BlockKey:
        return BlockKey(
            tokens=tuple(request.context_token_ids[
                start:start + self.tokens_per_block]),
            lora_task_id=request.lora_task_id,
            cache_salt=request.cache_salt)

    def _claim_node(self, node: RadixNode) -> Optional[Block]:
        """Take a reference on a matched node's block, onboarding it from
        the host or the disk tier if need be; None when the node holds no
        data or no block is free to onboard it into."""
        if node.block is not None:
            if node.block.ref_count == 0:
                self._reusable_remove(node.block, node)
            node.block.ref_count += 1
            return node.block
        if node.host_data is not None and self._onboard_fn is not None:
            # the allocation may offload a block and overflow the host
            # LRU; the node being claimed must not be the one it drops
            self._claiming = node
            try:
                block = self._allocate_block()
            except NoFreeBlocksError:
                return None
            finally:
                self._claiming = None
            self._onboard_fn(block.block_id, node.host_data)
            self._host_lru.pop(node, None)
            node.host_data = None
            node.block = block
            block.node = node
            self._stats.onboarded_blocks += 1
            return block
        if node.disk_key is not None and self._disk is not None \
                and self._onboard_fn is not None:
            data = self._disk.get(node.disk_key)
            if data is None:
                node.disk_key = None
                return None
            try:
                block = self._allocate_block()
            except NoFreeBlocksError:
                return None
            # disk -> device promotion (skips the host tier)
            self._onboard_fn(block.block_id, data)
            self._disk.drop(node.disk_key)
            node.disk_key = None
            node.block = block
            block.node = node
            self._stats.onboarded_blocks += 1
            self._stats.disk_onboarded_blocks += 1
            return block
        return None

    def _release_block(self, block: Block) -> None:
        block.ref_count -= 1
        if block.ref_count < 0:
            raise AssertionError(f"double free of block {block.block_id}")
        if block.ref_count == 0:
            if block.node is not None:
                self._reusable_add(block, block.node)
            else:
                self._free.append(block.block_id)

    def _allocate_block(self) -> Block:
        if self._free:
            block = self._blocks[self._free.pop()]
        else:
            block = self._evict_one()
        block.ref_count = 1
        return block

    def _evict_one(self) -> Block:
        """Evict the lowest-priority LRU reusable block that is the
        deepest primary block of its path (offloaded descendants may stay
        below it); offload it to the host tier when there is one and its
        priority reaches ``secondary_offload_min_priority``."""
        def primary_below(n: RadixNode) -> bool:
            return any(c.block is not None or primary_below(c)
                       for c in n.children.values())

        for priority in sorted(self._reusable):
            bucket = self._reusable[priority]
            for block_id in bucket:
                block = self._blocks[block_id]
                node = block.node
                if node is None or (not node.is_leaf
                                    and primary_below(node)):
                    continue
                self._reusable_remove(block, node)
                if (self._offload_fn is not None
                        and self.host_cache_blocks > 0
                        and node.priority >=
                        self.secondary_offload_min_priority):
                    self._offload_node(node)
                else:
                    self._push_event("removed", [self._hash_of(node)])
                    parent = node.parent
                    node.detach()
                    self._maybe_prune(parent)
                block.node = None
                return block
        raise NoFreeBlocksError("no free or evictable KV blocks")

    @staticmethod
    def _hash_of(node: RadixNode) -> int:
        return node.content_hash if node.content_hash is not None \
            else hash(node.key)

    def _offload_node(self, node: RadixNode) -> None:
        """Move an evicted node's block to the host tier (its page copy is
        queued on the steps' stream before the block's next owner writes
        it), and demote the host LRU's overflow to disk, or drop it."""
        node.host_data = self._offload_fn(node.block.block_id)
        node.block = None
        self._host_lru[node] = None
        self._stats.offloaded_blocks += 1
        self._push_event("offloaded", [self._hash_of(node)])
        while len(self._host_lru) > self.host_cache_blocks:
            victim = next(n for n in self._host_lru
                          if n is not self._claiming)
            del self._host_lru[victim]
            if self._disk is not None:
                # the writer thread waits for the page's copy to land
                victim.disk_key = self._disk.put(victim.host_data)
                victim.host_data = None
                self._stats.disk_blocks += 1
                self._push_event("demoted_disk", [self._hash_of(victim)])
            elif victim.is_leaf:
                # only a leaf detaches; an interior victim waits, dataless
                parent = victim.parent
                victim.detach()
                self._maybe_prune(parent)
            else:
                victim.host_data = None

    def _maybe_prune(self, node: Optional[RadixNode]) -> None:
        """Remove dataless interior nodes that became childless."""
        while (node is not None and node is not self._root and node.is_leaf
               and node.block is None and node.host_data is None
               and node.disk_key is None):
            parent = node.parent
            node.detach()
            node = parent

    def _reusable_add(self, block: Block, node: RadixNode) -> None:
        self._lru_clock += 1
        node._lru_tick = self._lru_clock
        self._reusable.setdefault(node.priority, OrderedDict())[
            block.block_id] = None
        self._reusable_prio[block.block_id] = node.priority
        self._num_reusable += 1

    def _reusable_remove(self, block: Block, node: RadixNode) -> None:
        prio = self._reusable_prio.pop(block.block_id, node.priority)
        bucket = self._reusable.get(prio)
        if bucket is not None and block.block_id in bucket:
            del bucket[block.block_id]
            if not bucket:
                del self._reusable[prio]
            self._num_reusable -= 1

    def _push_event(self, kind: str, hashes: List[int]) -> None:
        if self._event_buffer_max_size <= 0:
            return
        self._event_id += 1
        self._events.append(KVCacheEvent(self._event_id, kind, hashes))
        if len(self._events) > self._event_buffer_max_size:
            self._events.pop(0)


class NoFreeBlocksError(RuntimeError):
    pass


class _TrimmedBlock:
    """A sliding-pool block released while its sequence runs: the id
    stays in the sequence's page table, the block is back in the free
    list."""
    __slots__ = ("block_id",)

    def __init__(self, block_id: int):
        self.block_id = block_id


class VswaKvManager:
    """Dual-pool facade (VSWA): the global layers allocate from
    ``global_mgr``, the sliding layers from ``sliding_mgr``, a smaller
    pool whose blocks are released once out of every future query's
    window. Unknown attributes go to the global manager (the capacity
    scheduler's math, events and stats follow the larger pool).

    The release rule: a query at position p sees keys above p - window,
    so before a step whose first new query sits at position q
    (``num_device_tokens``: the next decode step, or the first step of a
    K-step window), the blocks wholly below q - window + 1 are released.
    Nothing is released at admission: a prompt's early queries still
    need its early keys during its prefill. (The JAX package trims at
    admission, by the prompt's end, which lets a request admitted in the
    same step be given blocks the prefill still writes and reads.)
    Prefix reuse stays off under VSWA, as in the JAX package: a reused
    global prefix has no sliding-pool twin."""

    def __init__(self, global_mgr: KVCacheManager,
                 sliding_mgr: KVCacheManager, window: int):
        if (global_mgr.ids_attr, sliding_mgr.ids_attr) != (
                "kv_block_ids", "kv_block_ids_sw"):
            raise ValueError("VSWA's managers must write kv_block_ids and "
                             "kv_block_ids_sw")
        self.g = global_mgr
        self.s = sliding_mgr
        self.window = window
        self.tokens_per_block = global_mgr.tokens_per_block
        self.trimmed_blocks = 0      # sliding blocks released while running

    def __getattr__(self, name):
        return getattr(self.g, name)

    def _trim(self, req: LlmRequest) -> None:
        first_query = req.num_device_tokens
        keep_from = max(0, first_query - self.window + 1) \
            // self.tokens_per_block
        self.trimmed_blocks += self.s.trim_prefix(req, keep_from)

    def add_sequence(self, req: LlmRequest,
                     enable_reuse: Optional[bool] = None) -> int:
        reused = self.g.add_sequence(req, enable_reuse=False)
        try:
            self.s.add_sequence(req, enable_reuse=False)
        except NoFreeBlocksError:
            self.g.free_resources(req, store_for_reuse=False)
            raise
        return reused

    def add_token(self, req: LlmRequest) -> None:
        self._trim(req)
        self.g.add_token(req)
        self.s.add_token(req)

    def add_tokens(self, req: LlmRequest, num_tokens: int) -> None:
        self._trim(req)
        self.g.add_tokens(req, num_tokens)
        self.s.add_tokens(req, num_tokens)

    def add_draft_tokens(self, req: LlmRequest, num_draft: int) -> None:
        """After ``add_token`` (which trimmed for this step's first
        query): both pools grow by the drafts."""
        self.g.add_draft_tokens(req, num_draft)
        self.s.add_draft_tokens(req, num_draft)

    def rewind_tokens(self, req: LlmRequest, num_tokens: int) -> None:
        """Both pools give back the rejected drafts' blocks (the sliding
        pool's trimmed head stays as it is: the rewind never reaches
        below the step's first query)."""
        self.g.rewind_tokens(req, num_tokens)
        self.s.rewind_tokens(req, num_tokens)

    def free_resources(self, req: LlmRequest,
                       store_for_reuse: Optional[bool] = None) -> None:
        self.g.free_resources(req, store_for_reuse=store_for_reuse)
        self.s.free_resources(req, store_for_reuse=False)

    def get_num_free_blocks(self) -> int:
        return self.g.get_num_free_blocks()

    def pool_block_ids(self, req: LlmRequest) -> List[List[Optional[int]]]:
        return self.g.pool_block_ids(req) + self.s.pool_block_ids(req)
