"""Pluggable external KV-cache connector API.

Port of ``tensorrt_llm_tpu/runtime/kv_connector.py``: a scheduler half
decides which tokens an external store can supply and whether a finished
request saves asynchronously; a worker half moves the bytes through the
engine's ``extract_kv`` / ``inject_kv`` (one gather or scatter a request,
on the steps' stream).

The executor drives the manager:
  admission  -> query_match -> (load) -> after_alloc
  per batch  -> begin_batch (build_connector_meta, bind, start_load_kv)
  finish     -> on_request_finished (True: blocks held until saved)

Host data are torch CPU tensors. ``HostMemoryKvConnector`` keeps each
saved block as a slice of the pinned page that ``extract_kv`` filled
without blocking (``kv_tiers.HostPage``): the copy's event is waited on
only when the block is read (a load, or the disk connector's write).
"""
from __future__ import annotations

import dataclasses
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import torch

from .kv_cache_manager import stable_block_hash
from .kv_tiers import HostPage


@dataclasses.dataclass
class RequestData:
    """Per-request view handed to ``build_connector_meta``."""
    request_id: int
    new_tokens: List[int]
    new_block_ids: List[int]
    computed_position: int


@dataclasses.dataclass
class SchedulerOutput:
    """Batch view for connector metadata."""
    new_requests: List[RequestData] = dataclasses.field(default_factory=list)
    cached_requests: List[RequestData] = dataclasses.field(
        default_factory=list)


class KvCacheConnectorWorker(ABC):
    """Data-plane half. Runs wherever the engine runs."""

    def __init__(self):
        self._meta: Any = None
        self.engine = None

    def register_engine(self, engine) -> None:
        """Called once; gives the worker the engine's KV movers."""
        self.engine = engine

    def bind_connector_meta(self, metadata: Any) -> None:
        self._meta = metadata

    def get_connector_meta(self) -> Any:
        return self._meta

    def _clear_connector_meta(self) -> None:
        self._meta = None

    @abstractmethod
    def start_load_kv(self) -> None:
        """Begin loading the blocks named by the bound metadata into the
        device pool (may be asynchronous; completion is polled through
        ``get_finished``)."""

    def wait_for_save(self) -> None:
        """Block until every pending save has landed."""

    def get_finished(self) -> Tuple[Set[int], Set[int]]:
        """(request ids finished saving, request ids finished loading) of
        an asynchronous connector; a synchronous one returns empty
        sets."""
        return set(), set()


class KvCacheConnectorScheduler(ABC):
    """Control-plane half. Runs on the scheduling rank only."""

    @abstractmethod
    def get_num_new_matched_tokens(
            self, request, num_computed_tokens: int) -> Tuple[int, bool]:
        """How many tokens beyond ``num_computed_tokens`` the external
        store can supply for this request, and whether the load is
        asynchronous."""

    def update_state_after_alloc(self, request,
                                 block_ids: List[int]) -> None:
        """Blocks were allocated for a request whose prefix this
        connector promised."""

    def build_connector_meta(self, scheduler_output: SchedulerOutput) -> Any:
        """Metadata shipped to the worker for this batch."""
        return None

    def request_finished(self, request,
                         cache_block_ids: List[int]) -> bool:
        """Request completed; True to save asynchronously (the manager
        holds the blocks until the worker reports the save done)."""
        return False


class KvConnectorManager:
    """Executor-side glue of both halves in the iteration loop."""

    def __init__(self, worker: KvCacheConnectorWorker,
                 scheduler: Optional[KvCacheConnectorScheduler]):
        self.worker = worker
        self.scheduler = scheduler
        # request_id -> (request, block_ids) awaiting an async save
        self._saving: Dict[int, Tuple[Any, List[int]]] = {}
        self._output = SchedulerOutput()

    # -- admission -------------------------------------------------------
    def query_match(self, request, num_computed_tokens: int) -> int:
        if self.scheduler is None:
            return 0
        n, _async = self.scheduler.get_num_new_matched_tokens(
            request, num_computed_tokens)
        return max(0, int(n))

    def after_alloc(self, request, matched_extra: int) -> None:
        if self.scheduler is not None and matched_extra > 0:
            self.scheduler.update_state_after_alloc(
                request, list(request.kv_block_ids))
        self._output.new_requests.append(RequestData(
            request_id=request.request_id,
            new_tokens=list(request.prompt_token_ids),
            new_block_ids=list(request.kv_block_ids),
            computed_position=request.context_current_position))

    # -- per iteration ---------------------------------------------------
    def begin_batch(self) -> None:
        meta = None if self.scheduler is None else \
            self.scheduler.build_connector_meta(self._output)
        self._output = SchedulerOutput()
        self.worker.bind_connector_meta(meta)
        self.worker.start_load_kv()
        self.worker._clear_connector_meta()

    # -- completion ------------------------------------------------------
    def on_request_finished(self, request) -> bool:
        """True: the executor must not free the blocks yet."""
        if self.scheduler is None:
            return False
        hold = self.scheduler.request_finished(
            request, list(request.kv_block_ids))
        if hold:
            self._saving[request.request_id] = (
                request, list(request.kv_block_ids))
        return hold

    def poll_finished_saves(self) -> List[Any]:
        """Requests whose async save completed; the caller frees their
        KV."""
        if not self._saving:
            return []
        saved_ids, _ = self.worker.get_finished()
        done = []
        for rid in list(saved_ids):
            entry = self._saving.pop(rid, None)
            if entry is not None:
                done.append(entry[0])
        return done

    def shutdown(self) -> None:
        self.worker.wait_for_save()


class _SavedBlock:
    """Block ``index`` of a saved request's host page [L, n·page, ...],
    read through the engine (which counts a wait for a copy still in
    flight, ``ModelEngine.host_page``)."""
    __slots__ = ("engine", "page", "index", "tokens")

    def __init__(self, engine, page: HostPage, index: int, tokens: int):
        self.engine, self.page = engine, page
        self.index, self.tokens = index, tokens

    def get(self) -> torch.Tensor:
        t = self.engine.host_page(self.page)
        return t[:, self.index * self.tokens:(self.index + 1) * self.tokens]


# --------------------------------------------------------------------- #
# In-repo reference connector: an external host-memory prefix store
# --------------------------------------------------------------------- #
class HostMemoryKvConnector(KvCacheConnectorWorker,
                            KvCacheConnectorScheduler):
    """Both halves in one object (single-process deployments): a finished
    request's KV is copied to host memory keyed by stable block hashes;
    a later request with a matching token prefix loads it back instead of
    recomputing it. The external twin of the in-device reuse tree."""

    def __init__(self, tokens_per_block: int, max_blocks: int = 4096):
        KvCacheConnectorWorker.__init__(self)
        self.tokens_per_block = tokens_per_block
        self.max_blocks = max_blocks
        self._store: Dict[int, Any] = {}     # block hash -> host block
        self._loads: List[Tuple[List[int], List[int]]] = []
        # request_id -> tokens already on the device when queried (a
        # reused prefix: those blocks are shared, never written here)
        self._computed: Dict[int, int] = {}
        self.stats = {"saved_blocks": 0, "loaded_blocks": 0}

    # -- hashing ---------------------------------------------------------
    def _hashes(self, tokens: Sequence[int]) -> List[int]:
        out, parent = [], None
        tb = self.tokens_per_block
        for i in range(0, len(tokens) - tb + 1, tb):
            parent = stable_block_hash(tuple(tokens[i:i + tb]), parent)
            out.append(parent)
        return out

    # -- scheduler half --------------------------------------------------
    def get_num_new_matched_tokens(self, request,
                                   num_computed_tokens: int):
        tokens = request.prompt_token_ids
        # the last token is never supplied: its KV is recomputed for the
        # logits (the reuse tree's rule)
        hashes = self._hashes(tokens[:len(tokens) - 1]
                              if len(tokens) % self.tokens_per_block == 0
                              else tokens)
        matched = 0
        for h in hashes:
            if h in self._store:
                matched += self.tokens_per_block
            else:
                break
        self._computed[request.request_id] = num_computed_tokens
        return max(0, matched - num_computed_tokens), False

    def update_state_after_alloc(self, request, block_ids) -> None:
        hashes = self._hashes(request.prompt_token_ids)
        tb = self.tokens_per_block
        skip = self._computed.pop(request.request_id, 0) // tb
        n_load = request.context_current_position // tb
        want = [h for h in hashes[skip:n_load] if h in self._store]
        if want:
            self._loads.append((want, block_ids[skip:skip + len(want)]))

    def request_finished(self, request, cache_block_ids) -> bool:
        if self.engine is None:
            return False
        hashes = self._hashes(request.all_token_ids)
        keep = [i for i, h in enumerate(hashes)
                if h not in self._store][:len(cache_block_ids)]
        if keep and len(self._store) < self.max_blocks:
            tb = self.tokens_per_block
            page = self.engine.extract_kv(cache_block_ids[:len(hashes)],
                                          len(hashes) * tb)
            for i in keep:
                self._store[hashes[i]] = _SavedBlock(self.engine, page, i,
                                                     tb)
                self.stats["saved_blocks"] += 1
        return False    # synchronous save: blocks free at once

    # -- worker half -----------------------------------------------------
    def start_load_kv(self) -> None:
        while self._loads:
            want, block_ids = self._loads.pop()
            parts = [self._store[h] for h in want]
            kv = torch.cat([p.get() if isinstance(p, _SavedBlock) else p
                            for p in parts], dim=1)   # [L, n·page, ...]
            self.engine.inject_kv(block_ids, kv)
            self.stats["loaded_blocks"] += len(want)


class DiskKvConnector(HostMemoryKvConnector):
    """Disk prefix store: block payloads live as files under
    ``cache_dir`` keyed by stable block hash (``torch.save``, read back
    memory-mapped); the in-memory index holds only paths. It survives a
    restart: a new ``LLM`` over the same directory serves the prefixes
    saved before."""

    def __init__(self, tokens_per_block: int, cache_dir: str,
                 max_blocks: int = 1 << 20):
        super().__init__(tokens_per_block, max_blocks)
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        # restart recovery: adopt the block files already there
        self._store = _DiskStore(self.cache_dir)


class _DiskStore(dict):
    """A dict over ``<hash>.pt`` files."""

    def __init__(self, root: Path):
        super().__init__()
        self.root = root
        for f in root.glob("*.pt"):
            try:
                super().__setitem__(int(f.stem), f)
            except ValueError:
                continue

    def __setitem__(self, h, block):
        t = block.get() if isinstance(block, _SavedBlock) else block
        path = self.root / f"{h}.pt"
        # a copy of the block alone: a slice would save the whole page
        torch.save(t.clone(), path)
        super().__setitem__(h, path)

    def __getitem__(self, h):
        return torch.load(super().__getitem__(h), mmap=True,
                          weights_only=True)
