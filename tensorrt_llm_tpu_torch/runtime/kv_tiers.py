"""Disk tier of the KV paging hierarchy, and the host pages it is fed.

Port of ``tensorrt_llm_tpu/runtime/kv_tiers.py``: the reuse tree
(runtime/kv_cache_manager.py) offloads evicted device pages to the host
tier; host-LRU victims demote to this store instead of being dropped, and
a later prefix match promotes disk -> device directly.

Copy-engine semantics, as in the JAX package:
  * ``put`` is asynchronous (one writer thread) and never blocks the
    executor loop; ``get`` joins an in-flight write when a block is
    promoted before it lands.
  * Write backpressure: at most ``max_inflight_bytes`` of queued writes;
    past that, new demotions are dropped (counted), not queued.
  * Byte-capacity eviction in priority-then-LRU order: the lowest
    retention priority first, ties oldest-first.
  * Stats: hits, misses, drops and bytes, and the reader's blocking
    time (``read_waits``, ``read_seconds``).

A block is a numpy array (saved with ``np.save``) or a torch tensor or
``HostPage`` (saved with ``torch.save``: bf16 has no numpy type), and
``get`` returns what was put. A ``HostPage`` is a page on its way from the
device to pinned host memory (``ModelEngine.offload_page``, into a page of
the engine's ``PinnedPages`` slab): the writer thread waits on its copy's
event before it reads the bytes.
"""
from __future__ import annotations

import os
import threading
import time
import uuid
import weakref
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..logger import logger


class HostPage:
    """A host tensor filled by a non-blocking copy from the device, and
    the CUDA event recorded behind that copy (None on the CPU, where the
    tensor is ready at once). ``get`` waits for the copy; ``ready`` says
    whether it has landed without waiting."""
    __slots__ = ("tensor", "event", "__weakref__")

    def __init__(self, tensor: torch.Tensor, event=None):
        self.tensor = tensor
        self.event = event

    @property
    def nbytes(self) -> int:
        return self.tensor.numel() * self.tensor.element_size()

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def get(self) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()
        return self.tensor


class PinnedPages:
    """One pinned host slab of ``n`` pages, handed out a page at a time
    (``take``); a page goes back to the free list when the ``HostPage``
    holding it dies. Pinning memory page by page costs a CUDA call each
    (~1 GB/s of offloads on an H100 host); the slab pins once. A page
    handed back while a copy reading it is still queued is safe to reuse:
    every copy into or out of it is queued on the same stream."""

    def __init__(self, n: int, shape, dtype: torch.dtype):
        self.slab = torch.empty((n, *shape), dtype=dtype, pin_memory=True)
        self._free = list(range(n - 1, -1, -1))
        # pages die on the disk writer's thread too
        self._lock = threading.Lock()

    def take(self) -> Optional[tuple]:
        """(page index, its tensor), or None when every page is out."""
        with self._lock:
            if not self._free:
                return None
            i = self._free.pop()
        return i, self.slab[i]

    def attach(self, page: "HostPage", i: int) -> None:
        """Return page ``i`` to the free list when ``page`` dies."""
        weakref.finalize(page, self._give_back, i)

    def _give_back(self, i: int) -> None:
        with self._lock:
            self._free.append(i)


def _nbytes(data) -> int:
    if isinstance(data, HostPage):
        return data.nbytes
    if isinstance(data, torch.Tensor):
        return data.numel() * data.element_size()
    return np.asarray(data).nbytes


@dataclass
class DiskTierStats:
    puts: int = 0
    put_drops: int = 0          # backpressure: demotion skipped
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    bytes_stored: int = 0
    bytes_written: int = 0
    bytes_read: int = 0
    # the reader's blocking time: reads that joined an in-flight write,
    # and the seconds ``get`` spent waiting and reading
    read_waits: int = 0
    read_seconds: float = 0.0

    def as_dict(self) -> Dict[str, int]:
        return dict(self.__dict__)


@dataclass(order=True)
class _Entry:
    priority: int
    seq: int
    key: str = field(compare=False)
    nbytes: int = field(compare=False, default=0)
    torch_data: bool = field(compare=False, default=False)


class DiskKvStore:
    def __init__(self, directory: str, max_blocks: int = 1 << 20,
                 max_bytes: Optional[int] = None,
                 max_inflight_bytes: int = 256 << 20):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.max_blocks = max_blocks
        self.max_bytes = max_bytes
        self.max_inflight_bytes = max_inflight_bytes
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._pending: Dict[str, Future] = {}
        self._inflight_bytes = 0
        self._seq = 0
        self._lock = threading.Lock()
        self._writer = ThreadPoolExecutor(1, thread_name_prefix="kv-disk")
        self.stats = DiskTierStats()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def _path(self, ent: _Entry) -> str:
        return os.path.join(self.dir,
                            ent.key + (".pt" if ent.torch_data else ".npy"))

    # ------------------------------------------------------------------ #
    def put(self, data, priority: int = 35) -> Optional[str]:
        """Schedule one block's write; returns the key, or None when
        write backpressure drops the demotion (the block is then not
        cached: it recomputes on a miss). ``priority``: the retention
        priority (higher = kept longer; 35 is the reuse tree's
        default)."""
        is_torch = isinstance(data, (torch.Tensor, HostPage))
        if not is_torch:
            data = np.asarray(data)
        nbytes = _nbytes(data)
        with self._lock:
            if self._inflight_bytes + nbytes > self.max_inflight_bytes:
                self.stats.put_drops += 1
                return None
            self._inflight_bytes += nbytes
            self._seq += 1
            key = uuid.uuid4().hex
            ent = _Entry(priority, self._seq, key, nbytes, is_torch)
            self._entries[key] = ent
            self._pending[key] = self._writer.submit(self._write, ent, data)
            self.stats.puts += 1
            self.stats.bytes_stored += nbytes
            self._evict_over_capacity_nolock()
        return key

    def _write(self, ent: _Entry, data) -> None:
        try:
            if isinstance(data, HostPage):
                data = data.get()        # the device copy has landed
            if ent.torch_data:
                # a copy of the block alone: a view would save the whole
                # storage it lies in (a slab of pinned pages)
                torch.save(data.clone(), self._path(ent))
            else:
                np.save(self._path(ent), data)
            self.stats.bytes_written += ent.nbytes
        except OSError as e:
            logger.warning("KV disk tier write failed: %s", e)
        finally:
            with self._lock:
                self._pending.pop(ent.key, None)
                self._inflight_bytes = max(
                    0, self._inflight_bytes - ent.nbytes)

    def _evict_over_capacity_nolock(self) -> None:
        def over():
            if len(self._entries) > self.max_blocks:
                return True
            return (self.max_bytes is not None
                    and self.stats.bytes_stored > self.max_bytes)
        while over() and self._entries:
            # lowest (priority, seq): lowest retention priority first,
            # ties oldest-first
            victim = min(self._entries.values())
            self._drop_nolock(victim.key)
            self.stats.evictions += 1

    # ------------------------------------------------------------------ #
    def get(self, key: str):
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.stats.misses += 1
                return None
            fut = self._pending.get(key)
            self._seq += 1
            ent.seq = self._seq          # LRU touch
        t0 = time.perf_counter()
        if fut is not None:
            fut.result()                 # join the in-flight write
            self.stats.read_waits += 1
        try:
            out = torch.load(self._path(ent), weights_only=True) \
                if ent.torch_data else np.load(self._path(ent))
        except OSError:
            with self._lock:
                self.stats.misses += 1
            return None
        finally:
            self.stats.read_seconds += time.perf_counter() - t0
        self.stats.hits += 1
        self.stats.bytes_read += ent.nbytes
        return out

    def get_many(self, keys: List[str]) -> list:
        """Promotion read-ahead: join every in-flight write first, then
        read in order."""
        with self._lock:
            futs = [self._pending.get(k) for k in keys]
        for f in futs:
            if f is not None:
                f.result()
        return [self.get(k) for k in keys]

    def drop(self, key: str) -> None:
        with self._lock:
            self._drop_nolock(key)

    def _drop_nolock(self, key: str) -> None:
        ent = self._entries.pop(key, None)
        if ent is None:
            return
        self.stats.bytes_stored -= ent.nbytes
        fut = self._pending.pop(key, None)
        if fut is not None:
            fut.cancel()
        try:
            os.remove(self._path(ent))
        except OSError:
            pass

    def shutdown(self) -> None:
        self._writer.shutdown(wait=True)
