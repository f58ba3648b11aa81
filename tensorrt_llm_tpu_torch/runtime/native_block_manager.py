"""The native KV block manager: ctypes bindings over csrc/host/
block_manager.cpp.

Port of ``tensorrt_llm_tpu/runtime/native_block_manager.py``. The ``LLM``
takes ``NativeKVCacheManager`` in place of the Python ``KVCacheManager``
(runtime/kv_cache_manager.py, the behavioural reference) when
``TLLM_TPU_NATIVE=1``. The library is built with ``g++`` at first use
into ``tensorrt_llm_tpu_torch/_build/``, under a name that carries a hash
of the source; a failed build raises (the JAX module falls back to the
Python manager with a warning). The manager keeps no event buffer
(``get_latest_events`` is empty, as in the JAX package) and no host or
disk tier (the ``LLM`` refuses both beside it by name).

Unlike the JAX bindings, the block-id buffer a grow writes into is sized
at the chain's length when that is longer than the step needs: the
library copies the whole chain, and the JAX buffer (sized by the step)
takes only its head, after a K-step window's pre-allocation (ROADMAP C).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

from .kv_cache_manager import KvCacheStats, NoFreeBlocksError
from .request import LlmRequest

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "host" / "block_manager.cpp"
BUILD_DIR = _PKG / "_build"


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libtllm_host-{digest}.so"


def build() -> Path:
    """Compile the library unless this source's build exists; raises on
    a failed build (no fallback)."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("the native block manager needs g++ (or $CXX)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [cxx, "-O2", "-std=c++17", "-fPIC", "-Wall", "-shared", "-o",
         str(tmp), str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    P, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_longlong
    for name, res, args in (
            ("bm_create", P, [I32, I32, I32]),
            ("bm_destroy", None, [P]),
            ("bm_free_blocks", I64, [P]),
            ("bm_add_sequence", I64, [P, I64, i32p, I32, I32, I32, i32p]),
            ("bm_grow", I64, [P, I64, I64, i32p]),
            ("bm_rewind", I64, [P, I64, I64]),
            ("bm_free_sequence", I64, [P, I64, i32p, I32, I32, I32]),
            ("bm_set_priority", I64, [P, I64, I32]),
            ("bm_num_seq_blocks", I64, [P, I64]),
            ("bm_stats", I64, [P] + [ctypes.POINTER(I64)] * 3)):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


class NativeKVCacheManager:
    """The ``KVCacheManager`` calls the executor and schedulers make, over
    the native library."""

    def __init__(self, num_blocks: int, tokens_per_block: int,
                 max_seq_len: int = 1 << 30, enable_block_reuse: bool = True,
                 event_buffer_max_size: int = 0):
        self._lib = _lib()
        self.num_blocks = num_blocks
        self.tokens_per_block = tokens_per_block
        self.max_seq_len = max_seq_len
        self.enable_block_reuse = enable_block_reuse
        self._h = self._lib.bm_create(num_blocks, tokens_per_block,
                                      int(enable_block_reuse))
        self._stats = KvCacheStats(max_blocks=num_blocks)
        self._seq_ids = set()
        # the statistics of the libraries that ``drop_device_blocks``
        # replaced
        self._past = (0, 0)

    def __del__(self):
        try:
            self._lib.bm_destroy(self._h)
        except Exception:  # interpreter teardown: nothing left to free
            pass

    @property
    def _seq_blocks(self):
        """The running sequences' ids (the capacity scheduler asks which
        requests hold blocks)."""
        return self._seq_ids

    @staticmethod
    def _salt(request: LlmRequest) -> int:
        parts = (request.cache_salt, request.lora_task_id)
        return (hash(parts) & 0x7FFFFFFF) if any(
            p is not None for p in parts) else 0

    # ------------------------------------------------------------------ #
    @property
    def free_block_count(self) -> int:
        return int(self._lib.bm_free_blocks(self._h))

    def get_num_free_blocks(self) -> int:
        return self.free_block_count

    def blocks_for_tokens(self, num_tokens: int) -> int:
        return -(-num_tokens // self.tokens_per_block)

    @staticmethod
    def _device_progress(request: LlmRequest) -> int:
        return max(request.num_total_tokens, request.num_device_tokens)

    def _have(self, request: LlmRequest) -> int:
        return int(self._lib.bm_num_seq_blocks(self._h, request.request_id))

    def get_needed_blocks_one_step(self, request: LlmRequest) -> int:
        have = self._have(request)
        if request.is_context_init_state:
            end = min(request.context_len, request.context_current_position
                      + request.context_chunk_size)
            return max(0, self.blocks_for_tokens(end) - have)
        return max(0, self.blocks_for_tokens(
            self._device_progress(request) + 1) - have)

    def get_remaining_blocks_to_completion(self, request: LlmRequest) -> int:
        total = request.prompt_len + request.max_new_tokens
        return max(0, self.blocks_for_tokens(total) - self._have(request))

    # ------------------------------------------------------------------ #
    def add_sequence(self, request: LlmRequest,
                     enable_reuse: Optional[bool] = None) -> int:
        """Blocks for a new context-phase sequence, its longest prefix of
        full blocks (all but the last token) reused."""
        ctx = np.asarray(request.context_token_ids, np.int32)
        out = np.zeros(max(1, self.blocks_for_tokens(len(ctx))), np.int32)
        reuse = self.enable_block_reuse if enable_reuse is None \
            else enable_reuse
        r = self._lib.bm_add_sequence(self._h, request.request_id, ctx,
                                      len(ctx), self._salt(request),
                                      int(reuse), out)
        if r == -1:
            raise NoFreeBlocksError("no free or evictable KV blocks")
        if r == -2:
            raise ValueError(f"request {request.request_id} already has "
                             "KV blocks")
        self._seq_ids.add(request.request_id)
        request.kv_block_ids = out[:self.blocks_for_tokens(len(ctx))] \
            .tolist()
        if reuse:
            request.num_cached_tokens = int(r)
        return int(r)

    def _grow(self, request: LlmRequest, total: int) -> None:
        # the library copies the whole chain, which a window's
        # pre-allocation may have made longer than ``total`` needs
        n = max(self.blocks_for_tokens(max(total, 1)), self._have(request))
        out = np.zeros(n, np.int32)
        r = self._lib.bm_grow(self._h, request.request_id, total, out)
        if r == -1:
            raise NoFreeBlocksError("no free or evictable KV blocks")
        request.kv_block_ids = out[:int(r)].tolist()

    def add_token(self, request: LlmRequest) -> None:
        self._grow(request, self._device_progress(request) + 1)

    def add_tokens(self, request: LlmRequest, num_tokens: int) -> None:
        self._grow(request, self._device_progress(request) + num_tokens)

    def add_draft_tokens(self, request: LlmRequest, num_draft: int) -> None:
        self._grow(request, self._device_progress(request) + 1 + num_draft)

    def rewind_tokens(self, request: LlmRequest, num_tokens: int) -> None:
        total = max(1, request.num_total_tokens - num_tokens)
        r = self._lib.bm_rewind(self._h, request.request_id, total)
        if r >= 0:
            request.kv_block_ids = request.kv_block_ids[:int(r)]

    def free_resources(self, request: LlmRequest,
                       store_for_reuse: Optional[bool] = None) -> None:
        """Release a sequence's blocks, its full blocks whose KV the
        device wrote stored for reuse (as the Python manager stores
        them)."""
        if request.request_id not in self._seq_ids:
            return
        store = self.enable_block_reuse if store_for_reuse is None \
            else store_for_reuse
        tokens = request.all_token_ids
        valid = min(len(tokens), request.num_device_tokens)
        toks = np.asarray(tokens[:valid], np.int32)
        self._lib.bm_free_sequence(self._h, request.request_id, toks,
                                   len(toks), self._salt(request),
                                   int(store))
        self._seq_ids.discard(request.request_id)
        request.kv_block_ids = []

    def update_priority(self, request: LlmRequest, priority: int) -> None:
        self._lib.bm_set_priority(self._h, request.request_id, priority)

    def drop_device_blocks(self) -> int:
        """Forget every reusable block (the engine's pool was freed and
        allocated anew): with no sequence running, a fresh library state.
        Returns the blocks dropped."""
        if self._seq_ids:
            raise RuntimeError("KV blocks are held by running sequences")
        s = self.get_stats()
        self._past = (s.reused_blocks, s.missed_blocks)
        self._lib.bm_destroy(self._h)
        self._h = self._lib.bm_create(self.num_blocks, self.tokens_per_block,
                                      int(self.enable_block_reuse))
        return s.reusable_blocks

    def get_stats(self) -> KvCacheStats:
        reused, missed, reusable = (ctypes.c_longlong() for _ in range(3))
        self._lib.bm_stats(self._h, ctypes.byref(reused),
                           ctypes.byref(missed), ctypes.byref(reusable))
        s = self._stats
        s.free_blocks = self.free_block_count
        s.used_blocks = self.num_blocks - s.free_blocks
        s.reusable_blocks = int(reusable.value)
        s.reused_blocks = self._past[0] + int(reused.value)
        s.missed_blocks = self._past[1] + int(missed.value)
        total = s.reused_blocks + s.missed_blocks
        s.cache_hit_rate = s.reused_blocks / total if total else 0.0
        return s

    def get_latest_events(self, clear: bool = True) -> List:
        return []
