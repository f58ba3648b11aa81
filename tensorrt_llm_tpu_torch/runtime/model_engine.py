"""Model engine: owns params + the KV pool and drives each step.

Port of ``tensorrt_llm_tpu/runtime/model_engine.py`` (``StepInputs``,
``prepare_inputs``, ``forward_step`` with its hidden rows for seeding the
draft head, the K-step decode window of ``_build_multi_step`` /
``forward_multi_step`` with its context riders and ``plan_ctx_chunks``,
the fused speculative window's entry points ``forward_spec_window`` /
``spec_seed`` and its state ``sd`` (runtime/spec_window.py), token and
row buckets, ``warmup`` / ``_warm_multi`` and KV-pool sizing, which
carves out the draft head's pool, and VSWA's second pool: ``_vswa``,
``num_sw_pages``, the sliding layers' page table and slot map in every
step and window, the quantized KV cache's NVFP4 flag and
``calibrate_kv_scales``, and the verify step of host-orchestrated
drafting: ``max_draft_len`` > 0 gives each decode row its drafts behind
its input token and G = max_draft_len + 1 logits rows, sampled rows
verifying by ``rejection_sample``, and the sampling surface: the
slot-indexed no-repeat-ngram history (``write_history``), the per-slot
embedding bias pool (``set_embedding_bias``), the bad-word ban, the
processed logits rows of the host logits-processor path
(``collect_logits``, ``_last_logits_rows``) and the beam fork's page copy
(``copy_pages``), and guided decoding: the device backend's pooled
grammar tables and per-slot state (``enable_guided``, ``guided_upload``,
``guided_set_state``), its mask and byte walk in every single step and
every step of a K-step window, and the host backend's [S, V] mask (packed
to a bit per token on its way up)) without LoRA, tree drafts, M-RoPE,
MoE statistics and pipeline parallelism.
MoE models run through the same steps and graphs: their routing is
computed on the device, and no MoE shape depends on it (ops/moe.py).

Every step is padded to a (token bucket, row bucket) pair, as the JAX
engine pads to its jit buckets. On CUDA, decode windows, spec windows and
decode-only single steps replay one CUDA graph per key
(runtime/cuda_graph.py), where the JAX engine replays one jitted
executable; ``warmup`` captures the greedy ones at build. A window is K
steps long whatever the rows' budgets, as the JAX scan is; a graph cannot
skip a step that has no live row, as the JAX package does with
``lax.cond``, so such a step runs with every row inactive
(``dead_window_steps`` counts the ones the host can foresee). Prefill
steps outside rider windows run eagerly, and so does every step with
prompt-embedding rows (``_prompt_embeds``: a one-token image chunk
would otherwise replay a decode graph that has no embedding input, as
the JAX engine keys its step functions by ``use_embeds``); a verify step
(decode rows with drafts, no prompt tokens) replays the graph of its key, whose
prefill-kernel grid the fixed ``max_q_len`` = G sets. Sampled tokens stay
on the device, scattered by sequence slot into ``prev_tokens``; the next
step gathers its decode inputs from there, so
the overlap scheduler (executor.py) never waits for a token on the host.
Host inputs go up in one pinned, non-blocking copy per step and results
come back the same way (``HostFuture``): the host only synchronizes when
it reads a result.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..llmapi.llm_args import LlmArgs
from ..logger import logger
from ..models.modeling_utils import DecoderModelForCausalLM
from ..ops.attention import AttentionMetadata
from ..ops.cuda import decode_attention as dec
from ..ops.sampling_ops import (NGRAM_MAX, SamplingTensors,
                                add_embedding_bias, ban_token_ids,
                                greedy_sample, ngram_ban_mask,
                                rejection_sample, sample, top_logprobs)
from . import spec_window
from .cuda_graph import GraphRunner, Inputs, upload
from .scheduler import ScheduledRequests


@dataclasses.dataclass(frozen=True)
class LogitsOps:
    """What a step does to its logits between the forward and the sampler,
    in the JAX engine's order (model_engine.py:435-480): the bad-word ban
    (``nb``: the padded width of the rows' id lists, 0 = none) and the
    host backend's guided mask (``mask``, a static [S, V] input; the JAX
    engine folds bad words into that mask, and the AND of the two is the
    same), the device backend's grammar mask (``guided``: each row's
    state in the pool, whose walk advances after sampling), the per-slot
    embedding bias, the no-repeat-ngram ban; and whether the processed
    logits leave the step for the host logits processors (``collect``).
    Part of every step, window and verify key, after the penalty flag:
    each combination is a graph of its own."""
    ngram: bool = False
    bias: bool = False
    nb: int = 0
    collect: bool = False
    guided: bool = False
    mask: bool = False


def _unpack_bits(bits: torch.Tensor, V: int) -> torch.Tensor:
    """bool[R, V] from bits u8[R, ceil(V/8)] packed little-endian, as
    ``np.packbits(..., bitorder="little")`` gives them."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return ((bits[:, :, None] >> shifts) & 1).reshape(
        bits.shape[0], -1)[:, :V].bool()


def _pack_mask(mask: np.ndarray) -> np.ndarray:
    """A bool [S, V] mask as the step's int32 input: a bit per token
    (little-endian), each row padded to whole int32 words."""
    bits = np.packbits(mask, axis=1, bitorder="little")
    pad = -bits.shape[1] % 4
    if pad:
        bits = np.pad(bits, ((0, 0), (0, pad)))
    return np.ascontiguousarray(bits).view(np.int32)


def _ngram_sizes(reqs, n: int) -> np.ndarray:
    """Each row's no_repeat_ngram_size (at most ``NGRAM_MAX``), padded to
    ``n`` rows with 0 (off)."""
    out = np.zeros(n, np.int32)
    for i, r in enumerate(reqs):
        out[i] = min(r.sampling_params.no_repeat_ngram_size, NGRAM_MAX)
    return out


def _seeded(reqs, greedy: bool) -> bool:
    """Whether a sampled step must draw seeded rows' counter-based noise:
    a key of its own, so that unseeded batches skip that work."""
    return not greedy and any(r.sampling_params.seed for r in reqs)


@dataclasses.dataclass
class StepInputs:
    """Host-built (numpy) inputs for one iteration, pre-padding."""
    token_ids: np.ndarray          # i32[T] host-known tokens (0 where device-sourced)
    prev_slot: np.ndarray          # i32[T] slot to gather prev token from, -1=host
    positions: np.ndarray          # i32[T]
    kv_lens: np.ndarray            # i32[S]
    page_indices: np.ndarray       # i32[S, P]
    cu_q_lens: np.ndarray          # i32[S+1]
    num_seqs: np.ndarray           # i32[1]
    slot_mapping: np.ndarray       # i32[T]
    logits_indices: np.ndarray     # i32[S*G] (G = logits rows per seq)
    out_slots: np.ndarray          # i32[S] slot to scatter sampled token to (-1 pad)
    num_tokens: int                # actual (unpadded) token count
    num_reqs: int
    max_q_len: int                 # longest query segment (1 = decode-only)
    max_kv_len: int                # longest KV length incl. this step
    draft_ids: np.ndarray          # i32[S*G] each logits row's draft, -1 none
    has_prompt: bool               # a context row is in the step
    # VSWA: the sliding layers' page table and slots (None: one pool)
    page_indices_sw: Optional[np.ndarray] = None   # i32[S, P]
    slot_mapping_sw: Optional[np.ndarray] = None   # i32[T]


def _pools(kv_pages) -> tuple:
    """A model's cache tensors: its KV pool, VSWA's pair, or a recurrent
    model's dict (the KV pool and the state pools)."""
    if isinstance(kv_pages, dict):
        return tuple(kv_pages.values())
    return kv_pages if isinstance(kv_pages, tuple) else (kv_pages,)


def _kv_pools(kv_pages) -> tuple:
    """The paged KV pools of a model's cache (not the state pools)."""
    if isinstance(kv_pages, dict):
        return (kv_pages["kv"],)
    return _pools(kv_pages)


def _ptrs(kv_pages) -> List[int]:
    """Device addresses of a model's cache tensors."""
    return [p.data_ptr() for p in _pools(kv_pages)]


def _sliding(**per_pool) -> Dict[str, Any]:
    """VSWA's fields from per-pool sequences past the global pool's:
    {name: the sliding pool's entry}, empty with one pool."""
    return {k: v[0] for k, v in per_pool.items() if len(v)}


class HostFuture:
    """Device tensors on their way to the host: a non-blocking copy into
    pinned memory plus an event, started at dispatch. ``get`` waits for
    the event only (CPU tensors are ready at once)."""

    def __init__(self, *tensors: torch.Tensor):
        self._event = None
        if tensors and tensors[0].device.type == "cuda":
            self._host = [torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True) for t in tensors]
            for h, t in zip(self._host, tensors):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = list(tensors)

    def get(self) -> List[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


class ModelEngine:
    NSTOP = 8  # stop-token ids checked on the device per row

    def __init__(self,
                 model: DecoderModelForCausalLM,
                 params: Dict[str, Any],
                 args: LlmArgs,
                 num_kv_pages: Optional[int] = None,
                 max_draft_len: int = 0,
                 guided_pool_states: int = 0):
        self.model = model
        # host-orchestrated drafting: drafts per decode row, and each
        # row's logits rows G = max_draft_len + 1 in every step
        self.max_draft_len = max_draft_len
        self.args = args
        self.device = model.device
        self.max_batch_size = args.max_batch_size
        self.page_size = args.kv_cache_config.tokens_per_block
        self.max_seq_len = args.max_seq_len
        self.pages_per_seq = -(-self.max_seq_len // self.page_size)
        self.token_buckets = args.bucketing_config.resolve_token_buckets(
            args.max_num_tokens)
        # a decode-only full batch is the hottest shape: give it an exact
        # bucket so it never pads to the next power (with drafts, the full
        # verify step too)
        self.token_buckets = sorted(set(self.token_buckets) | {
            min(self.max_batch_size * g, args.max_num_tokens)
            for g in {1, max_draft_len + 1}})
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(0)
        self.graphs = GraphRunner(self.device, self.generator,
                                  capture=self.device.type == "cuda")
        self.iter_counter = 0
        # decode steps dispatched (windows and single steps); mixed
        # windows: windows that carried riders, context tokens carved into
        # them; every window's steps, and the steps the host knew would
        # have no live row and no rider chunk
        self.decode_steps = 0
        self.mixed_windows_dispatched = 0
        self.mixed_ctx_carved = 0
        self.window_steps = 0
        self.dead_window_steps = 0
        # verify steps (a decode row carries drafts): all of them, and
        # those with prompt tokens, which run eagerly
        self.verify_steps = 0
        self.verify_steps_with_prompt = 0
        # eager steps that carried prompt-embedding rows
        self.embed_steps = 0
        self.params = params
        # NVFP4 KV: stamp the e2m1-grid flag into the model's attention
        # specs so that write_kv rounds appended K/V onto the grid (the
        # JAX engine's model_engine.py:110-117)
        if model.config.kv_fp4_grid:
            for attr in ("attn_spec", "sliding_spec"):
                sp = getattr(model, attr, None)
                if sp is not None:
                    setattr(model, attr, dataclasses.replace(sp, kv_fp4=True))
        # VSWA (Gemma 2 with max_attention_window): the sliding layers
        # keep their KV in a second, smaller pool; self.kv_pages is then
        # the pair (global, sliding)
        self._vswa = bool(getattr(model, "vswa_enabled", False))
        self.num_sw_pages = self._sw_pages() if self._vswa else 0
        # device-backend guided decoding (guided/device_guided.py): the
        # pool's tensors are allocated here, before the KV pool is sized
        # from free memory (so its bytes are counted off the KV budget)
        # and before any graph that reads them is captured; they are
        # written in place after. The grammar walk switches on with
        # ``enable_guided``
        self.g_enabled = False
        self.g_eos_id = -1
        self.g_state: Optional[torch.Tensor] = None
        self.guided_windows = 0
        self.guided_steps = 0
        if guided_pool_states:
            self._alloc_guided(guided_pool_states)
        # recurrent families (models/recurrent.py): state pools indexed by
        # sequence slot, [layers, max_batch_size + 1, ...] (the trash slot
        # last), made with the KV pool below and before any graph capture;
        # their bytes are counted off the KV pool's budget
        self._recurrent = bool(getattr(model, "has_recurrent_state", False))
        self.num_kv_pages = num_kv_pages or self._default_num_pages()
        logger.info("KV pool: %d pages x %d tokens (%.1f MB/layer)%s",
                    self.num_kv_pages, self.page_size,
                    self._kv_bytes_per_layer() / 1e6,
                    ", recurrent state %.1f MB (%d slots)" % (
                        self.recurrent_state_bytes() / 1e6,
                        self.max_batch_size + 1) if self._recurrent
                    else "")
        # the request field of each pool's block ids: the global pool's,
        # and under VSWA the sliding one's
        self.pool_ids = ["kv_block_ids"]
        if self._vswa:
            logger.info("VSWA sliding pool: %d pages (window %d)",
                        self.num_sw_pages, model.vswa_window)
            self.pool_ids.append("kv_block_ids_sw")
        extra = {"num_sw_pages": self.num_sw_pages} if self._vswa else {}
        if self._recurrent:
            extra["num_slots"] = self.max_batch_size + 1
        self.kv_pages = model.make_kv_pages(self.num_kv_pages,
                                            self.page_size, **extra)
        # slot-indexed device state; index max_batch_size is a trash slot
        # that absorbs the scatters of padding and inactive rows. Steps
        # update it in place: captured graphs hold its address
        self.prev_tokens = torch.zeros(self.max_batch_size + 1,
                                       dtype=torch.int64, device=self.device)
        self.token_counts: Optional[torch.Tensor] = None
        # the sampling surface's slot-indexed state, allocated at first use
        # (before any graph that reads it is captured) and then written in
        # place only: the no-repeat-ngram token history [S + 1,
        # max_seq_len] and the embedding bias pool [S + 1, V] (row S is the
        # trash slot); their bytes are counted when the KV pool is sized
        self.ngram_history: Optional[torch.Tensor] = None
        self.bias_pool: Optional[torch.Tensor] = None
        # collect_logits: (batch rows with a logits processor, their
        # processed logits rows [n, V] on the device) of the last step
        self._last_logits_rows = None
        # beam forks: pages copied (every pool's)
        self.pages_copied = 0
        # the fused speculative window's device state
        # (runtime/spec_window.py), set by ``enable_spec_device``
        self.sd: Optional[spec_window.SpecDeviceState] = None

    # ------------------------------------------------------------------ #
    # Sizing
    # ------------------------------------------------------------------ #
    @property
    def _pool_layers(self) -> int:
        """Layers of the (global) pool: half of them under VSWA; a
        recurrent model's attention layers (at least one)."""
        L = getattr(self.model, "kv_layers", self.model.num_layers)
        return L // 2 if self._vswa else L

    @property
    def has_recurrent_state(self) -> bool:
        """Whether the model keeps slot-indexed state pools."""
        return self._recurrent

    def recurrent_state_bytes(self) -> int:
        """Device bytes of a recurrent model's state pools (0 for the
        others)."""
        if not self._recurrent:
            return 0
        return self.model.state_bytes(self.max_batch_size + 1)

    @property
    def bytes_per_kv_block(self) -> int:
        """Device bytes of one page of the (global) pool, all its layers,
        from the model's own pool shape (MLA's latent rows as well as
        [2 * kv heads, head dim]); under VSWA a sliding-pool page has the
        same size (L/2 layers)."""
        el = torch.empty((), dtype=self.model.config.kv_cache_dtype) \
            .element_size()
        per_layer = math.prod(self.model.kv_pool_shape(1, self.page_size)[1:])
        return self._pool_layers * per_layer * el

    def _sw_pages(self) -> int:
        """The sliding pool's pages: the JAX engine's formula (a window
        plus a page, plus one, per sequence, and one max-length prompt's
        pages), with the K-step window's pre-allocation added to the
        window (the JAX engine trims after the window's allocation, this
        one before it). No more than every sequence in full."""
        ps = self.page_size
        reach = self.model.vswa_window + max(1, self.args.decode_multi_step)
        w_pages = -(-(reach + ps) // ps) + 1
        transient = -(-self.args.max_input_len // ps)
        return min(self.max_batch_size * w_pages + transient + 1,
                   self.max_batch_size * self.pages_per_seq + 1)

    @property
    def G(self) -> int:
        """Logits rows per sequence of a step: 1 + host drafts."""
        return self.max_draft_len + 1

    @property
    def spec_draft_len(self) -> int:
        """Drafts per iteration of the fused speculative window (0: no
        EAGLE3 or MTP window configured; host drafting, with
        ``device_window=False`` too, is ``max_draft_len``)."""
        sc = self.args.speculative_config
        if sc is None or sc.mode not in ("EAGLE3", "MTP") or \
                not sc.device_window:
            return 0
        return sc.max_draft_len or 4

    def spec_state_bytes(self) -> int:
        """Device bytes of the draft head's pool and pending features
        (``spec_window.head_pool_bytes``; 0 without a fused window): an
        EAGLE3 head's K/V of the target's geometry, an MTP head's latent
        of the target's MLA."""
        d = self.spec_draft_len
        if not d:
            return 0
        m = self.model
        el = torch.empty((), dtype=m.dtype).element_size()
        entry = m.latent_dim if self.args.speculative_config.mode == "MTP" \
            else 2 * m.num_kv_heads * m.head_dim
        return spec_window.head_pool_bytes(
            self.max_batch_size, self.max_seq_len, d, m.hidden_size, entry,
            el)

    def _kv_bytes_per_layer(self) -> int:
        return self.num_kv_pages * self.bytes_per_kv_block \
            // self._pool_layers

    def graph_pool_reserve(self) -> int:
        """Device bytes kept free for the CUDA graphs' shared pool when
        the KV pool is sized (0 on the CPU). An estimate from above, not
        a derivation. The pool holds about one step of the widest window
        (every row plus a full rider chunk), since a window's steps and
        the graphs, which replay one after another, reuse its blocks:

        - per token, one layer's activations
          (``model.act_width_per_token``): for a dense MLP 4 hidden-wide
          tensors (residual, normed input, attention output, o-projection
          output) and 3 intermediate-wide ones (gate and up projections,
          their product); for an MoE MLP, instead of the latter, k routed
          copies of the sorted input, gate|up at twice the experts'
          intermediate width, their product and the down output (a MoE
          model's ``intermediate_size`` does not enter), at 4 bytes
          though most are bf16;
        - the attention's own per-position scratch over the step's
          sequences (every row, and the rider chunk's sequences and its
          filler row) at ``max_seq_len`` positions
          (``model.attn_scratch_bytes``): none for the paged kernels;
          MLA's dense gather (models/deepseek.py) holds the gathered
          latents and, on each path, what grows with them;
        - per row, 6 [rows, vocab] float32 tensors of the sampler (logits,
          log-softmax, the generator's noise, the seeded rows' noise, the
          perturbed logits, their selection);
        - with speculation, a verify pass instead (the spec window's, or
          a host-drafted verify step's): rows x (d+1) tokens, and 10
          [rows x (d+1), vocab] float32 tensors (rejection sampling also
          holds the probabilities, the residual, a second noise draw and
          the draft one-hot);
        - a factor 2 of headroom for the allocator's block rounding and
          the blocks that the graphs' static outputs keep.

        On an H100 at bench.py's serving settings (1b geometry, 256 rows,
        a 512-token rider chunk) the six graphs of ``warmup`` took 178 MB
        against a 547 MB reserve; at ``LLM``'s defaults on the
        TinyLlama-1.1B geometry two graphs took 50 MB
        (``chip_smoke.py``, which prints both)."""
        if self.device.type != "cuda":
            return 0
        return self.graph_pool_estimate()

    def graph_pool_estimate(self) -> int:
        """``graph_pool_reserve``'s formula, whatever the device."""
        rows = self.max_batch_size
        tokens = rows + (self.mixed_ctx_tokens if self.riders_ok else 0)
        seqs = rows + (self.mixed_ctx_seqs + 1 if self.riders_ok else 0)
        sampler = rows * self.model.vocab_size * 4 * 6
        d = max(self.spec_draft_len, self.max_draft_len)
        if d:
            tokens = max(tokens, rows * (d + 1))
            sampler = max(sampler,
                          rows * (d + 1) * self.model.vocab_size * 4 * 10)
        acts = tokens * self.model.act_width_per_token() * 4 + \
            self.model.attn_scratch_bytes(seqs, tokens, self.max_seq_len)
        return 2 * (acts + sampler)

    def surface_state_bytes(self) -> int:
        """Device bytes of the sampling surface's slot-indexed state, when
        it is allocated: the no-repeat-ngram history (int32, max_seq_len
        per slot) and the embedding bias pool (float32, vocab per slot),
        the trash slot included."""
        slots = self.max_batch_size + 1
        return slots * 4 * (self.max_seq_len + self.model.vocab_size)

    def prompt_logprob_bytes(self) -> int:
        """Peak device bytes of one prompt-logprobs forward
        (evaluate/perplexity.py) at ``max_input_len``: its own pool of
        ceil(T / page) + 1 pages of every layer, and one chunk of
        ``PROMPT_LOGPROB_CHUNK`` rows' float32 logits, their log-softmax
        and its top-k scratch."""
        from ..evaluate.perplexity import PROMPT_LOGPROB_CHUNK
        ps = self.page_size
        pages = -(-self.args.max_input_len // ps) + 1
        per_page = self.bytes_per_kv_block * getattr(
            self.model, "kv_layers", self.model.num_layers) \
            // self._pool_layers
        rows = min(PROMPT_LOGPROB_CHUNK, self.args.max_input_len)
        return pages * per_page + 3 * rows * self.model.vocab_size * 4

    def _default_num_pages(self) -> int:
        """KV pool sizing from free device memory, less 1 GiB, the graph
        pool's reserve, the draft head's state, the sampling surface's
        slot state, the part of a prompt-logprobs forward that the memory
        outside ``free_gpu_memory_fraction`` does not hold, and under VSWA
        the sliding pool (a fixed 2 GiB budget on the CPU, the sliding
        pool included). The guided pool is already allocated by then, so
        free memory leaves it out."""
        cfg = self.args.kv_cache_config
        if cfg.max_tokens is not None:
            return -(-cfg.max_tokens // self.page_size)
        bytes_per_page = self.bytes_per_kv_block
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            kept = int(free * cfg.free_gpu_memory_fraction)
            budget = kept - (1 << 30) - self.graph_pool_reserve() \
                - self.spec_state_bytes() - self.surface_state_bytes() \
                - self.recurrent_state_bytes() \
                - max(0, self.prompt_logprob_bytes() - (free - kept))
        else:
            budget = 2 << 30
        budget -= self.num_sw_pages * bytes_per_page
        budget = max(budget, bytes_per_page * self.max_batch_size)
        pages = budget // bytes_per_page
        # at least one page per sequence; at most every sequence in full
        pages = min(pages, self.max_batch_size * self.pages_per_seq + 1)
        return int(max(pages, self.max_batch_size + 1))

    def _pick_bucket(self, n: int) -> int:
        for b in self.token_buckets:
            if n <= b:
                return b
        raise ValueError(f"{n} tokens exceeds max bucket "
                         f"{self.token_buckets[-1]}")

    @functools.cached_property
    def row_buckets(self) -> List[int]:
        S = self.max_batch_size
        return sorted({b for b in self.token_buckets if b < S} | {S})

    def _pick_row_bucket(self, n: int) -> int:
        for b in self.row_buckets:
            if n <= b:
                return b
        raise ValueError(f"{n} rows exceeds max_batch_size")

    def _kv_bound(self, n: int, reach: Optional[int] = None) -> int:
        """The decode kernel's ``max_kv_len`` hint for a step whose rows
        reach at most ``n`` positions: n rounded up to a power of two,
        capped at the page table's ``reach`` (the target pool's by
        default). A graph's key fixes the split count this bound gives,
        and eager steps pass the same bound, so both launch alike and give
        the same bits."""
        reach = reach or self.pages_per_seq * self.page_size
        return min(1 << (max(n, 1) - 1).bit_length(), reach)

    def head_kv_bound(self, n: int) -> int:
        """``_kv_bound`` over the draft head's page table: the hint of the
        head's chained decode-kernel steps in a spec window."""
        return self._kv_bound(n, self.sd.P_h * self.sd.ps_h)

    def _splits(self, rows: int, bound: int, head: bool = False):
        """KV splits of the decode kernel over ``rows`` at ``bound`` (1 on
        the CPU, whose plain version does not split): with ``head`` the
        draft head's layer (an int), else the target's layers, one count
        per distinct sliding window (``model.attention_windows``: a
        tuple, since Gemma's sliding and global layers split apart). A
        graph key holds this in place of the bound, as
        ``model.graph_bound_key`` has it (MLA keys by the bound)."""
        if head:
            spec = getattr(self.sd.drafter, "attn_spec", None)
            if spec is None:           # the MTP head's MLA gathers to it
                return ("kv_bound", bound)
            if self.device.type != "cuda":
                return 1
            return dec.splits_for(rows, spec.num_heads, spec.num_kv_heads,
                                  self.sd.P_h * self.sd.ps_h, bound,
                                  spec.sliding_window, self.device)
        return self.model.graph_bound_key(
            bound, lambda b: self._k1_splits(rows, b))

    def _k1_splits(self, rows: int, bound: int) -> tuple:
        windows = self.model.attention_windows()
        if self.device.type != "cuda" or not windows:
            return (1,) * len(windows)
        spec = self.model.attn_spec
        reach = self.pages_per_seq * self.page_size
        return tuple(dec.splits_for(rows, spec.num_heads, spec.num_kv_heads,
                                    reach, bound, w, self.device)
                     for w in windows)

    def _counts(self, use_penalties: bool) -> Optional[torch.Tensor]:
        if use_penalties and self.token_counts is None:
            self.token_counts = torch.zeros(
                (self.max_batch_size + 1, self.model.vocab_size),
                dtype=torch.int32, device=self.device)
        return self.token_counts if use_penalties else None

    def reset_slot_counts(self, slots: List[int]) -> None:
        """Zero the penalty counts of newly admitted slots so a recycled
        slot can't leak the previous request's token history."""
        if self.token_counts is None or not slots:
            return
        self.token_counts[torch.as_tensor(slots, device=self.device)] = 0

    # ------------------------------------------------------------------ #
    # The sampling surface's slot state (the JAX engine's
    # model_engine.py:199-245) and the beam fork's page copy (:1570-1582)
    # ------------------------------------------------------------------ #
    def write_history(self, slot: int, tokens) -> None:
        """Upload a request's context into the slot's no-repeat-ngram
        token history (steps and windows append their sampled tokens on
        the device). The history is allocated at the first call, before
        any graph that reads it exists, and written in place after."""
        L = self.max_seq_len
        if self.ngram_history is None:
            self.ngram_history = torch.zeros(
                (self.max_batch_size + 1, L), dtype=torch.int32,
                device=self.device)
        row = np.zeros(L, np.int32)
        m = min(len(tokens), L)
        row[:m] = np.asarray(tokens[:m], np.int32)
        self.ngram_history[slot].copy_(torch.from_numpy(row))

    def set_embedding_bias(self, slot: int, bias) -> None:
        """Land a request's [vocab] logit bias in the slot's row of the
        bias pool (None clears it: a recycled slot once the pool exists).
        The pool is allocated at the first bias and written in place
        after."""
        V = self.model.vocab_size
        if self.bias_pool is None:
            if bias is None:
                return
            self.bias_pool = torch.zeros(
                (self.max_batch_size + 1, V), dtype=torch.float32,
                device=self.device)
        vec = np.zeros(V, np.float32)
        if bias is not None:
            b = np.asarray(bias, np.float32).reshape(-1)
            vec[:min(V, b.shape[0])] = b[:V]
        self.bias_pool[slot].copy_(torch.from_numpy(vec))

    # ------------------------------------------------------------------ #
    # Device-backend guided decoding (the JAX engine's
    # model_engine.py:169-195, :245-250): the pool tensors that steps
    # and windows read by address, and writes into them in place
    # ------------------------------------------------------------------ #
    def _alloc_guided(self, pool_states: int) -> None:
        dev = self.device
        Vb = -(-self.model.vocab_size // 8)
        self.g_byte_table = torch.full((pool_states, 256), -1,
                                       dtype=torch.int16, device=dev)
        self.g_mask_bits = torch.zeros((pool_states, Vb), dtype=torch.uint8,
                                       device=dev)
        self.g_eos_ok = torch.zeros(pool_states, dtype=torch.bool,
                                    device=dev)
        # the last entry is the trash slot of padding and inactive rows
        self.g_state = torch.full((self.max_batch_size + 1,), -1,
                                  dtype=torch.int32, device=dev)

    def enable_guided(self, token_bytes: np.ndarray, token_lens: np.ndarray,
                      eos_id: int, pool_states: int = 8192) -> None:
        """Switch the grammar walk on: each token's bytes u8[V, L] and
        lengths i32[V] (L, the longest token, is the walk's unrolled step
        count) and the grammar EOS id, over the pool of ``pool_states``
        states allocated at construction (``guided_pool_states``)."""
        have = 0 if self.g_state is None else self.g_byte_table.shape[0]
        if have != pool_states:
            raise ValueError(
                f"guided pool: {pool_states} states asked for, {have} "
                "allocated at build (ModelEngine guided_pool_states)")
        self.g_token_bytes = torch.as_tensor(
            np.ascontiguousarray(token_bytes, np.uint8), device=self.device)
        self.g_token_lens = torch.as_tensor(
            np.asarray(token_lens, np.int32), device=self.device)
        self.g_eos_id = int(eos_id)
        self.g_enabled = True

    def guided_upload(self, base: int, byte_table: np.ndarray,
                      mask_bits: np.ndarray, eos_ok: np.ndarray) -> None:
        """Land one grammar segment in the pool, rows [base, base + n)
        written in place (captured graphs hold the pool's addresses)."""
        n = byte_table.shape[0]
        self.g_byte_table[base:base + n].copy_(
            torch.from_numpy(np.ascontiguousarray(byte_table, np.int16)))
        self.g_mask_bits[base:base + n].copy_(
            torch.from_numpy(np.ascontiguousarray(mask_bits, np.uint8)))
        self.g_eos_ok[base:base + n].copy_(
            torch.from_numpy(np.ascontiguousarray(eos_ok, bool)))

    def guided_set_state(self, slot: int, state: int) -> None:
        """state = pool-global grammar state; -1 clears the slot. An
        in-place write queued on the steps' stream, so it lands after the
        windows already in flight (a finished request's last windows still
        scatter into its slot) and before the next step reads it."""
        self.g_state[int(slot)] = int(state)

    def _guided_mask(self, logits: torch.Tensor, st: torch.Tensor,
                     act: torch.Tensor) -> torch.Tensor:
        """The device grammar mask: rows ``act`` keep only the tokens
        their state ``st`` admits, and EOS where the state allows it
        (``g_eos_ok``); other rows pass unmasked."""
        V = logits.shape[-1]
        gsc = st.clamp(min=0).long()
        allowed = _unpack_bits(self.g_mask_bits[gsc], V)
        if 0 <= self.g_eos_id < V:
            allowed[:, self.g_eos_id] = self.g_eos_ok[gsc]
        return torch.where(act[:, None] & ~allowed,
                           torch.finfo(torch.float32).min, logits)

    def _guided_walk(self, tok: torch.Tensor,
                     st: torch.Tensor) -> torch.Tensor:
        """The state after ``tok``: its bytes walked through the pooled
        byte DFA, L unrolled steps (a dead state stays dead); EOS leaves
        the state as it was."""
        fb = self.g_token_bytes[tok].long()          # [R, L]
        flen = self.g_token_lens[tok]
        cur = st
        for j in range(fb.shape[1]):
            nxt = self.g_byte_table[cur.clamp(min=0).long(),
                                    fb[:, j]].to(torch.int32)
            cur = torch.where((j < flen) & (cur >= 0), nxt, cur)
        return torch.where(tok == self.g_eos_id, st, cur)

    @torch.no_grad()
    def copy_pages(self, src: List[int], dst: List[int],
                   pool: int = 0) -> None:
        """Copy pages ``src`` onto pages ``dst`` of every layer of KV pool
        ``pool`` (VSWA's sliding pool is 1) on the device, in one gather
        and one scatter: every source is read before any destination is
        written, so a fork that swaps two rows' pages copies what each
        held (the JAX engine copies page by page, in order). The copy is
        queued on the stream of the steps, so it lands before the next
        step reads the pages."""
        if not src:
            return
        kv = _kv_pools(self.kv_pages)[pool]
        s_idx = torch.as_tensor(src, dtype=torch.long).to(self.device)
        d_idx = torch.as_tensor(dst, dtype=torch.long).to(self.device)
        kv[:, d_idx] = kv[:, s_idx]
        self.pages_copied += len(src)

    @torch.no_grad()
    def copy_slot_states(self, src: List[int], dst: List[int]) -> None:
        """Copy a recurrent model's state of slots ``src`` onto slots
        ``dst`` in every state pool (a beam fork: the row that takes
        another's continuation takes its state too), all sources read
        before any destination is written, on the stream of the steps."""
        if not src or not self._recurrent:
            return
        s_idx = torch.as_tensor(src, dtype=torch.long).to(self.device)
        d_idx = torch.as_tensor(dst, dtype=torch.long).to(self.device)
        for name, pool in self.kv_pages.items():
            if name != "kv":
                pool[:, d_idx] = pool[:, s_idx]

    def _logits_ops(self, logits: torch.Tensor, v, ops: LogitsOps,
                    out_slots: torch.Tensor, sample_idx: torch.Tensor,
                    valid: torch.Tensor, G: int = 1,
                    gst: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The step's logits work between the forward and the sampler, in
        the JAX engine's order: bad-word ban and host guided mask, device
        grammar mask (``gst``: each row's grammar state), embedding bias,
        no-repeat-ngram ban (model_engine.py:435-480). ``out_slots`` /
        ``sample_idx`` / ``valid``: each batch row's slot, the sequence
        index its sample lands at, and whether it is a live row; with G
        logits rows per batch row each row's mask repeats G times."""
        if not (ops.nb or ops.bias or ops.ngram or ops.mask or ops.guided):
            return logits
        trash = self.max_batch_size
        slot_idx = torch.where(valid, out_slots, trash).long()
        if ops.nb:
            bad = v["bad_ids"]
            logits = ban_token_ids(
                logits, bad.repeat_interleave(G, 0) if G > 1 else bad)
        if ops.mask:
            allowed = _unpack_bits(v["mask"].view(torch.uint8),
                                   logits.shape[-1])
            if G > 1:
                allowed = allowed.repeat_interleave(G, 0)
            logits = torch.where(allowed, logits,
                                 torch.finfo(torch.float32).min)
        if ops.guided:
            logits = self._guided_mask(logits, gst, valid & (gst >= 0))
        if ops.bias:
            brow = self.bias_pool[slot_idx]
            logits = add_embedding_bias(
                logits, brow.repeat_interleave(G, 0) if G > 1 else brow)
        if ops.ngram:
            n = v["ngram_n"]
            ban = ngram_ban_mask(self.ngram_history[slot_idx], n, sample_idx,
                                 valid & (n > 0), logits.shape[-1])
            if G > 1:
                ban = ban.repeat_interleave(G, 0)
            logits = torch.where(ban, torch.finfo(torch.float32).min,
                                 logits)
        return logits

    def _append_history(self, tokens: torch.Tensor, out_slots: torch.Tensor,
                        at: torch.Tensor, write: torch.Tensor) -> None:
        """Each row's sampled token into its slot's history at sequence
        index ``at`` where ``write`` (rows past the history's end, padding
        and inactive rows go to the trash slot)."""
        L = self.ngram_history.shape[1]
        rows = torch.where(write & (at < L), out_slots,
                           self.max_batch_size).long()
        self.ngram_history[rows, at.clamp(0, L - 1).long()] = \
            tokens.to(torch.int32)

    def _forward(self, tokens: torch.Tensor, metadata: AttentionMetadata,
                 collect_hidden: bool = False,
                 input_embeds: Optional[torch.Tensor] = None):
        """The model over the KV pool, which it updates in place (captured
        graphs hold the pool's address): logits, and with
        ``collect_hidden`` (logits, pre-final-norm hidden rows).
        ``input_embeds`` [T, H]: the step's prompt-embedding rows."""
        kw = {} if input_embeds is None else {"input_embeds": input_embeds}
        out = self.model.forward(self.params, tokens, self.kv_pages,
                                 metadata, collect_hidden=collect_hidden,
                                 **kw)
        if _ptrs(out[1]) != _ptrs(self.kv_pages):
            raise RuntimeError("the model moved the KV pool")
        return (out[0], out[2]) if collect_hidden else out[0]

    @torch.no_grad()
    def calibrate_kv_scales(self, token_ids: np.ndarray
                            ) -> Optional[np.ndarray]:
        """Set the per-layer KV scales from one prefill pass over
        calibration tokens: each layer's absmax of its fresh K/V
        projections over the grid's top, no less than 1e-6 (the JAX
        engine's model_engine.py:1043-1081: the same token count, the
        same float32 formula). The top is 127 for int8, 448 for e4m3 and
        6 for the NVFP4 grid, where the JAX engine takes 448 and clips
        every value above 6/448 of the absmax. Each scale is written into
        its layer's tensor in place (``copy_``), so graphs captured before
        read it. Runs at build, before any request owns KV pages, so the
        pass's writes to the pool are scratch. None, changing nothing,
        for a pool that is not quantized or a model without per-layer
        scales (``per_layer_kv_scale``)."""
        layers = self.params.get("layers") or []
        cfg = self.model.config
        if not cfg.uses_kv_quant or not layers \
                or "kv_scale" not in layers[0]:
            return None
        ps = self.page_size
        T = int(min(len(token_ids), self.args.max_num_tokens,
                    (self.num_kv_pages - 1) * ps, self.max_seq_len))
        n_pages = -(-T // ps)
        dev = self.device
        i32 = dict(dtype=torch.int32, device=dev)
        metadata = AttentionMetadata(
            kv_lens=torch.tensor([T], **i32),
            page_indices=torch.arange(n_pages, **i32)[None, :],
            cu_q_lens=torch.tensor([0, T], **i32),
            num_seqs=torch.tensor([1], **i32),
            slot_mapping=torch.arange(T, **i32),
            positions=torch.arange(T, **i32),
            logits_indices=torch.tensor([T - 1], **i32),
            max_q_len=T, max_kv_len=T)
        tokens = torch.as_tensor(np.asarray(token_ids[:T], np.int64),
                                 device=dev)
        _, _, stats = self.model.forward(self.params, tokens, self.kv_pages,
                                         metadata, collect_kv_stats=True)
        qmax = 127.0 if cfg.kv_cache_dtype == torch.int8 else \
            (6.0 if cfg.kv_fp4_grid else 448.0)
        scales = np.maximum(stats.cpu().numpy().astype(np.float32)
                            / np.float32(qmax), np.float32(1e-6))
        for layer, sc in zip(layers, scales):
            layer["kv_scale"].copy_(torch.tensor(sc, dtype=torch.float32))
        logger.info("calibrated KV scales over %d tokens: min=%.4g max=%.4g",
                    T, scales.min(), scales.max())
        return scales

    # ------------------------------------------------------------------ #
    # Input preparation (host, numpy)
    # ------------------------------------------------------------------ #
    def prepare_inputs(self, batch: ScheduledRequests) -> StepInputs:
        """Flatten the scheduled batch into ragged arrays. A generation
        row's drafts ride behind its input token at the next positions,
        one logits row per fed token (the JAX engine's chain branch,
        model_engine.py:1155-1251); each row fills its G logits rows,
        repeating its last one."""
        S, P, ps = self.max_batch_size, self.pages_per_seq, self.page_size
        G = self.G
        reqs = batch.context_requests + batch.generation_requests
        if len(reqs) > S:
            raise ValueError(f"{len(reqs)} > max_batch_size {S}")
        tok_list: List[int] = []
        prev_list: List[int] = []
        pos_list: List[int] = []
        kv_lens = np.zeros(S, np.int32)
        cu_q = np.zeros(S + 1, np.int32)
        logits_idx = np.zeros(S * G, np.int32)
        draft_ids = np.full(S * G, -1, np.int32)
        out_slots = np.full(S, -1, np.int32)
        # per KV pool: its page table and its slots of this step's tokens
        tables = np.zeros((len(self.pool_ids), S, P), np.int32)
        slot_maps: List[List[int]] = [[] for _ in self.pool_ids]
        max_q = 0
        for i, req in enumerate(reqs):
            chains = [getattr(req, attr) for attr in self.pool_ids]
            for table, chain in zip(tables, chains):
                table[i, :len(chain)] = chain
            last_chunk_row = True
            if req.is_context_init_state:
                start = req.context_current_position
                end = min(req.context_len, start + req.context_chunk_size)
                last_chunk_row = end >= req.context_len
                tok_list.extend(req.context_token_ids[start:end])
                prev_list.extend([-1] * (end - start))
                pos_list.extend(range(start, end))
                span = range(start, end)
                kv_lens[i] = end
                max_q = max(max_q, end - start)
                logits_idx[i * G:(i + 1) * G] = len(tok_list) - 1
            else:
                # generation: the input token comes from prev_tokens[slot]
                # (device, overlap mode) or the host (sync mode); drafts
                # ride behind it at the next positions
                pos = req.num_device_tokens
                if req.host_token_override is not None:
                    tok_list.append(req.host_token_override)
                    prev_list.append(-1)
                else:
                    tok_list.append(0)
                    prev_list.append(req.seq_slot)
                drafts = req.draft_tokens[:self.max_draft_len]
                tok_list.extend(drafts)
                prev_list.extend([-1] * len(drafts))
                n = 1 + len(drafts)
                span = range(pos, pos + n)
                pos_list.extend(span)
                kv_lens[i] = pos + n
                max_q = max(max_q, n)
                base = len(tok_list) - n
                logits_idx[i * G:(i + 1) * G] = base + np.minimum(
                    np.arange(G), len(drafts))
                draft_ids[i * G:i * G + len(drafts)] = drafts
            for sm, chain in zip(slot_maps, chains):
                sm.extend(chain[p // ps] * ps + p % ps for p in span)
            cu_q[i + 1] = len(tok_list)
            # mid-chunk context rows produce no real sample: route their
            # scatter to the trash slot so junk tokens can't pollute
            # prev_tokens / token_counts for the slot
            out_slots[i] = req.seq_slot if last_chunk_row else -1
        cu_q[len(reqs) + 1:] = len(tok_list)
        slot_maps = [np.asarray(sm, np.int32) for sm in slot_maps]
        return StepInputs(
            token_ids=np.asarray(tok_list, np.int32),
            prev_slot=np.asarray(prev_list, np.int32),
            positions=np.asarray(pos_list, np.int32),
            kv_lens=kv_lens, page_indices=tables[0], cu_q_lens=cu_q,
            num_seqs=np.asarray([len(reqs)], np.int32),
            slot_mapping=slot_maps[0],
            logits_indices=logits_idx, out_slots=out_slots,
            num_tokens=len(tok_list), num_reqs=len(reqs), max_q_len=max_q,
            max_kv_len=int(kv_lens.max()), draft_ids=draft_ids,
            has_prompt=bool(batch.context_requests),
            **_sliding(page_indices_sw=tables[1:],
                       slot_mapping_sw=slot_maps[1:]))

    def _prompt_embeds(self, batch: ScheduledRequests,
                       T: int) -> Optional[torch.Tensor]:
        """The step's prompt-embedding rows, float32 [T, H] on the device,
        in ``prepare_inputs``' token order: each context row's chunk
        ``[context_current_position, + context_chunk_size)`` of its
        request's ``prompt_embeds``, NaN (the token lookup) elsewhere, as
        the JAX engine builds them (model_engine.py:1689-1705); None when
        no context row has embeddings. A request's rows go to the device
        once (its first chunk) and stay there; positions past the prompt
        (a request recomputed after a pause) take the lookup."""
        ctx = batch.context_requests
        widths = [r.prompt_embeds.shape[1] for r in ctx
                  if r.prompt_embeds is not None]
        if not widths:
            return None
        H = widths[0]
        dev = self.device
        parts, n = [], 0
        for r in ctx:
            start = r.context_current_position
            end = min(r.context_len, start + r.context_chunk_size)
            pe = r.prompt_embeds
            if pe is not None:
                if not isinstance(pe, torch.Tensor):
                    pe = torch.as_tensor(np.asarray(pe, np.float32))
                # a no-op for rows already on the device
                pe = r.prompt_embeds = pe.to(dev, torch.float32)
            have = 0 if pe is None else max(0, min(end, pe.shape[0]) - start)
            if have:
                parts.append(pe[start:start + have].float())
            if end - start - have:
                parts.append(torch.full((end - start - have, H), math.nan,
                                        dtype=torch.float32, device=dev))
            n += end - start
        if T > n:
            parts.append(torch.full((T - n, H), math.nan,
                                    dtype=torch.float32, device=dev))
        return torch.cat(parts)

    # ------------------------------------------------------------------ #
    # One step for one scheduled batch
    # ------------------------------------------------------------------ #
    def _step_inputs(self, inp: StepInputs, reqs, T: int, greedy: bool,
                     ops: LogitsOps = LogitsOps(),
                     bad_ids: Optional[np.ndarray] = None,
                     mask: Optional[np.ndarray] = None) -> Inputs:
        """A step's host inputs, padded to the token bucket T; with
        ``ops`` the rows' no_repeat_ngram_size, their bad-word ids
        (``bad_ids`` i32[S, ops.nb], -1 padding; None: none) and the host
        guided mask (``mask`` bool[S, V], packed; None: all allowed)."""
        n, S = inp.num_tokens, self.max_batch_size
        tokens = np.zeros(T, np.int32)
        tokens[:n] = inp.token_ids
        prev_slot = np.full(T, -1, np.int32)
        prev_slot[:n] = inp.prev_slot
        positions = np.zeros(T, np.int32)
        positions[:n] = inp.positions
        # padding tokens write to an out-of-range slot -> dropped
        slots = np.full(T, self.num_kv_pages * self.page_size, np.int32)
        slots[:n] = inp.slot_mapping
        seeds = np.zeros(S, np.int32)
        for i, r in enumerate(reqs):
            if r.sampling_params.seed:
                seeds[i] = r.sampling_params.seed & 0x7FFFFFFF or 1
        inputs = dict(tokens=tokens, prev_slot=prev_slot,
                      positions=positions, slot_mapping=slots,
                      kv_lens=inp.kv_lens, cu_q_lens=inp.cu_q_lens,
                      logits_indices=inp.logits_indices,
                      out_slots=inp.out_slots, num_seqs=inp.num_seqs,
                      seeds=seeds, page_indices=inp.page_indices)
        if self._vswa:
            slots_sw = np.full(T, self.num_sw_pages * self.page_size,
                               np.int32)
            slots_sw[:n] = inp.slot_mapping_sw
            inputs.update(page_indices_sw=inp.page_indices_sw,
                          slot_mapping_sw=slots_sw)
        if not greedy:
            inputs["samp_ints"], inputs["samp_floats"] = \
                SamplingTensors.rows(reqs, S)
            if self.G > 1:
                inputs["draft_ids"] = inp.draft_ids
        if ops.ngram:
            inputs["ngram_n"] = _ngram_sizes(reqs, S)
        if ops.nb:
            bad = np.full((S, ops.nb), -1, np.int32)
            if bad_ids is not None:
                bad[:bad_ids.shape[0], :bad_ids.shape[1]] = bad_ids
            inputs["bad_ids"] = bad
        if ops.mask:
            V = self.model.vocab_size
            full = np.ones((S, V), bool)
            if mask is not None:
                # a tokenizer's vocabulary may stop short of the model's:
                # its tokens past the table are empty, so a guided row
                # never takes one (as on the device backend), an unguided
                # (all-True) row may
                w = min(V, mask.shape[1])
                full[:, :w] = mask[:, :w]
                full[:, w:] = mask.all(axis=1)[:, None]
            inputs["mask"] = _pack_mask(full)
        return inputs

    def _step_key(self, T: int, bound: int, greedy: bool,
                  use_penalties: bool, k_lp: int,
                  seeded: bool = False, hidden: bool = False,
                  ops: LogitsOps = LogitsOps()) -> tuple:
        return ("step", T, self._splits(min(self.max_batch_size, T), bound),
                greedy, use_penalties, ops, k_lp, seeded, hidden)

    def _verify_key(self, T: int, greedy: bool, use_penalties: bool,
                    k_lp: int, seeded: bool = False,
                    ops: LogitsOps = LogitsOps(),
                    hidden: bool = False) -> tuple:
        return ("verify", T, self.G, greedy, use_penalties, ops, k_lp,
                seeded, hidden)

    def _logits_ops_of(self, reqs, bad_ids: Optional[np.ndarray],
                       collect_logits: bool,
                       mask: Optional[np.ndarray] = None) -> LogitsOps:
        """The logits work the rows ``reqs`` ask of a step: the history
        and the bias pool only once a request has written them (the JAX
        engine's ``use_ngram`` / ``use_bias``), and the device grammar
        walk when a row holds a device-guided slot and the step has one
        logits row per row (a verify step gets none, as in the JAX engine,
        model_engine.py:1709-1713)."""
        return LogitsOps(
            ngram=self.ngram_history is not None and any(
                r.sampling_params.no_repeat_ngram_size > 0 for r in reqs),
            bias=self.bias_pool is not None and any(
                r.sampling_params.embedding_bias is not None for r in reqs),
            nb=0 if bad_ids is None else bad_ids.shape[1],
            collect=collect_logits,
            guided=self.g_enabled and self.G == 1 and any(
                r.guided_device for r in reqs),
            mask=mask is not None)

    @torch.no_grad()
    def forward_step(self, batch: ScheduledRequests,
                     use_penalties: bool = False,
                     collect_hidden: bool = False,
                     bad_ids: Optional[np.ndarray] = None,
                     collect_logits: bool = False,
                     logits_mask: Optional[np.ndarray] = None):
        """Launch one iteration. Returns device tensors indexed by logits
        row, G per batch row: (tokens, logprobs), then (top values, top
        ids) when a request asked for logprobs, then with
        ``collect_hidden`` the pre-final-norm hidden rows (which seed the
        draft head, ``spec_seed``). ``bad_ids`` (i32[rows, nb], -1
        padding; of the executor's ``_apply_bad_words``) bans each row's
        ids; ``logits_mask`` (bool[max_batch_size, V], the host guided
        backend's ``build_mask``) keeps only each row's allowed tokens;
        rows of device-guided requests mask and advance their grammar
        state on the device; with ``collect_logits`` the processed logits of the rows
        whose request has a logits processor land in
        ``_last_logits_rows`` (their batch rows and a [n, V] copy on the
        device; the first logits row of each). A decode-only batch
        replays the graph of its key, and so does a verify step (drafts
        behind decode rows, no prompt tokens): its key fixes
        ``max_q_len`` = G, the prefill kernel's grid, and rows with fewer
        drafts are data. A batch with prompt tokens runs eagerly."""
        inp = self.prepare_inputs(batch)
        T = self._pick_bucket(inp.num_tokens)
        self.iter_counter += 1
        reqs = batch.context_requests + batch.generation_requests
        greedy = not use_penalties and \
            all(r.sampling_params.greedy for r in reqs)
        k_lp = min(20, max((r.sampling_params.logprobs or 0)
                           for r in reqs) if reqs else 0)
        seeded = _seeded(reqs, greedy)
        if bad_ids is not None:
            # the id lists' width, bucketed to a power of two (>= 8), so
            # that few widths make graphs of their own
            nb = max(8, 1 << (max(1, bad_ids.shape[1]) - 1).bit_length())
            pad = np.full((bad_ids.shape[0], nb), -1, np.int32)
            pad[:, :bad_ids.shape[1]] = bad_ids
            bad_ids = pad
        ops = self._logits_ops_of(reqs, bad_ids, collect_logits, logits_mask)
        self.guided_steps += ops.guided or ops.mask
        inputs = self._step_inputs(inp, reqs, T, greedy, ops, bad_ids,
                                   logits_mask)
        self._counts(use_penalties)
        verify = bool((inp.draft_ids >= 0).any())
        self.verify_steps += verify
        embeds = self._prompt_embeds(batch, T)
        if (inp.max_q_len > 1 and inp.has_prompt) or embeds is not None:
            self.verify_steps_with_prompt += verify
            body = self._step_body(inp.max_q_len, inp.max_kv_len, greedy,
                                   use_penalties, k_lp, seeded,
                                   collect_hidden, ops)
            views = upload(inputs, self.device)
            if embeds is not None:
                self.embed_steps += 1
                views["input_embeds"] = embeds
            outs = body(views)
        elif verify:
            # the prefill kernel takes no KV hint: the page table's reach
            reach = self.pages_per_seq * self.page_size
            outs = self.graphs.run(
                self._verify_key(T, greedy, use_penalties, k_lp, seeded,
                                 ops, collect_hidden),
                inputs,
                self._step_body(self.G, reach, greedy, use_penalties, k_lp,
                                seeded, collect_hidden, ops),
                inert=lambda: self._step_inputs(
                    self.prepare_inputs(ScheduledRequests()), [], T,
                    greedy, ops))
        else:
            bound = self._kv_bound(inp.max_kv_len)
            self.decode_steps += 1
            outs = self.graphs.run(
                self._step_key(T, bound, greedy, use_penalties, k_lp, seeded,
                               collect_hidden, ops),
                inputs,
                self._step_body(1, bound, greedy, use_penalties, k_lp,
                                seeded, collect_hidden, ops),
                inert=lambda: self._step_inputs(
                    self.prepare_inputs(ScheduledRequests()), [], T, greedy,
                    ops))
        if not collect_logits:
            return outs
        # a copy of the processor rows: the graph's static output is
        # rewritten by the key's next replay
        rows = [i for i, r in enumerate(reqs)
                if r.sampling_params.logits_processor is not None]
        idx = torch.as_tensor([i * self.G for i in rows],
                              dtype=torch.long).to(self.device)
        self._last_logits_rows = (rows, outs[-1][idx])
        return outs[:-1]

    def _step_body(self, max_q_len: int, kv_bound: int, greedy: bool,
                   use_penalties: bool, k_lp: int, seeded: bool = False,
                   collect_hidden: bool = False,
                   ops: LogitsOps = LogitsOps()):
        S, G = self.max_batch_size, self.G

        def body(v):
            prev = v["prev_slot"].long()
            tokens = torch.where(prev >= 0,
                                 self.prev_tokens[prev.clamp(min=0)],
                                 v["tokens"].long())
            embeds = v.get("input_embeds")
            logits = self._forward(tokens, AttentionMetadata(
                kv_lens=v["kv_lens"], page_indices=v["page_indices"],
                cu_q_lens=v["cu_q_lens"], num_seqs=v["num_seqs"],
                slot_mapping=v["slot_mapping"], positions=v["positions"],
                logits_indices=v["logits_indices"].long(),
                max_q_len=max_q_len, max_kv_len=kv_bound,
                page_indices_sw=v.get("page_indices_sw"),
                slot_mapping_sw=v.get("slot_mapping_sw"),
                seq_slots=v["out_slots"]),
                collect_hidden=collect_hidden,
                **({} if embeds is None else {"input_embeds": embeds}))
            if collect_hidden:
                logits, hidden = logits
            out_slots = v["out_slots"]
            valid = out_slots >= 0
            gst = self.g_state[torch.where(valid, out_slots, S).long()] \
                if ops.guided else None
            logits = self._logits_ops(logits, v, ops, out_slots,
                                      v["kv_lens"], valid, G, gst)
            st = None if greedy else SamplingTensors.from_rows(
                v["samp_ints"], v["samp_floats"])
            seeds = v["seeds"] if seeded else None
            positions, drafts = v["kv_lens"], None
            if G > 1:
                # logits row g of a row samples at position pos_base + g,
                # pos_base = kv_lens - drafts (the spread of the row's
                # logits indices): the position a step without drafts
                # would sample that token at (JAX model_engine.py:495-520)
                li = v["logits_indices"].view(S, G)
                g = torch.arange(G, dtype=torch.int32, device=li.device)
                positions = ((v["kv_lens"] - (li[:, -1] - li[:, 0]))
                             [:, None] + g).reshape(-1)
                if st is not None:
                    st = st.repeat_rows(G)
                    drafts = v["draft_ids"]
                if seeds is not None:
                    seeds = seeds.repeat_interleave(G)
            outs = self._sample(logits, st, seeds, positions,
                                torch.where(out_slots >= 0, out_slots,
                                            S).long(), use_penalties,
                                draft_ids=drafts)
            if ops.ngram:
                # the sampled token lands at sequence index kv_lens
                self._append_history(outs[0].view(-1, G)[:, 0], out_slots,
                                     v["kv_lens"], out_slots >= 0)
            if ops.guided:
                # advance each guided row's grammar state by its token
                act = valid & (gst >= 0)
                self.g_state[torch.where(act, out_slots, S).long()] = \
                    torch.where(act, self._guided_walk(outs[0], gst), gst)
            if k_lp:
                outs += top_logprobs(logits, k_lp)
            if collect_hidden:
                outs += (hidden,)
            if ops.collect:
                outs += (logits,)
            return outs
        return body

    def _sample(self, logits, st: Optional[SamplingTensors], seeds,
                positions, slot_idx, use_penalties: bool,
                draft_ids: Optional[torch.Tensor] = None):
        """Sample (argmax when ``st`` is None; ``seeds`` None when no row
        has a seed, which skips the seeded rows' noise), scatter the tokens
        by slot for the next step's gather (padding and inactive rows land
        in the trash slot) and count them for the penalties. With G > 1
        logits rows per slot (a verify step: ``st``, ``seeds`` and
        ``positions`` per logits row) sampled rows verify by
        ``rejection_sample`` against ``draft_ids``, and each slot's first
        row is the one scattered and counted."""
        G = logits.shape[0] // slot_idx.shape[0]
        counts = self.token_counts[slot_idx] if use_penalties else None
        row_seeds = None if seeds is None else (seeds, positions)
        if st is None:
            tok, lp = greedy_sample(logits)
        elif draft_ids is not None:
            tok, lp = rejection_sample(
                logits, st, self.generator, draft_ids,
                token_counts=None if counts is None
                else counts.repeat_interleave(G, 0), row_seeds=row_seeds)
        else:
            tok, lp = sample(logits, st, self.generator,
                             token_counts=counts, row_seeds=row_seeds)
        first = tok.view(-1, G)[:, 0]
        self.prev_tokens[slot_idx] = first
        if use_penalties:
            self.token_counts.index_put_(
                (slot_idx, first),
                torch.ones_like(first, dtype=torch.int32),
                accumulate=True)
        return tok, lp

    # ------------------------------------------------------------------ #
    # K-step decode window: K decode iterations dispatched back to back
    # with the sampled tokens kept on the device, per-row stop handling
    # (stop ids / min_tokens / token budget) on the device, and one host
    # fetch per window. With riders, each step also prefills a planned
    # chunk of context tokens in the same forward.
    # ------------------------------------------------------------------ #
    @property
    def mixed_ctx_tokens(self) -> int:
        """C: context tokens carried per window step (0 = disabled)."""
        return self.args.mixed_window_ctx

    @property
    def riders_ok(self) -> bool:
        """Whether windows carry context riders: ``mixed_window_ctx`` > 0,
        no recurrent state (a rider's chunk would continue a prompt, which
        the state pools, written at a segment's end, do not follow), and
        one KV pool (the JAX executor's ``_mixed_ok`` also keeps them
        off under VSWA)."""
        return self.mixed_ctx_tokens > 0 and not self._vswa \
            and not self._recurrent

    @property
    def mixed_ctx_seqs(self) -> int:
        """NC: context sequences per window step (plus one filler row)."""
        C = self.mixed_ctx_tokens
        return max(2, min(16, C // 64)) if C else 0

    def plan_ctx_chunks(self, ctx_requests, K: int):
        """Carve the scheduled context requests' chunk ranges into K
        per-step rider chunks (host, numpy). Returns (xs dict with
        leading K axis, carved token count per request)."""
        C, NC = self.mixed_ctx_tokens, self.mixed_ctx_seqs
        ps, P = self.page_size, self.pages_per_seq
        oob = self.num_kv_pages * ps
        tok = np.zeros((K, C), np.int32)
        pos = np.zeros((K, C), np.int32)
        slot = np.full((K, C), oob, np.int32)
        kvl = np.ones((K, NC + 1), np.int32)
        cu = np.zeros((K, NC + 2), np.int32)
        pages = np.zeros((K, NC + 1, P), np.int32)
        carved = [0] * len(ctx_requests)
        offs = [r.context_current_position for r in ctx_requests]
        ends = [min(r.context_len,
                    r.context_current_position + r.context_chunk_size)
                for r in ctx_requests]
        ri = 0
        for k in range(K):
            used, row = 0, 0
            while ri < len(ctx_requests) and used < C and row < NC:
                r = ctx_requests[ri]
                take = min(ends[ri] - offs[ri], C - used)
                if take <= 0:
                    ri += 1
                    continue
                s, e = offs[ri], offs[ri] + take
                blk = np.asarray(r.kv_block_ids, np.int32)
                ppos = np.arange(s, e, dtype=np.int32)
                tok[k, used:used + take] = r.context_token_ids[s:e]
                pos[k, used:used + take] = ppos
                slot[k, used:used + take] = blk[ppos // ps] * ps + ppos % ps
                pages[k, row, :len(blk)] = blk
                kvl[k, row] = e
                cu[k, row + 1] = used + take
                used += take
                row += 1
                offs[ri] += take
                carved[ri] += take
                if offs[ri] >= ends[ri]:
                    ri += 1
            for rr in range(row, NC):
                cu[k, rr + 1] = used
            cu[k, NC + 1] = C
            # filler row self-attends over the pad region (garbage in,
            # output discarded; KV writes routed out of bounds)
            kvl[k, NC] = max(1, C - used)
            pos[k, used:] = np.arange(C - used, dtype=np.int32)
        xs = dict(tokens=tok, positions=pos, slots=slot, kv_lens=kvl, cu=cu,
                  pages=pages)
        return xs, carved

    def _window_inputs(self, reqs, Sb: int, K: int, greedy: bool,
                       riders=None, ops: LogitsOps = LogitsOps()):
        """Host inputs of a K-step window over the generation rows
        ``reqs`` padded to Sb rows, with the rider plan of ``riders``
        (None: a window without the rider branch) and with ``ops.ngram``
        the rows' no_repeat_ngram_size. Returns (inputs, carved)."""
        P, NSTOP = self.pages_per_seq, self.NSTOP
        # rows: token_ids, prev_slot, start_pos, out_slots, max_new,
        # stop_gate; padding rows have no slot, so they never run
        rows = np.zeros((6, Sb), np.int32)
        rows[1] = -1
        rows[3] = -1
        seeds = np.zeros(Sb, np.int32)
        stop_ids = np.full((Sb, NSTOP), -1, np.int32)
        tables = np.zeros((len(self.pool_ids), Sb, P), np.int32)
        for i, r in enumerate(reqs):
            sp = r.sampling_params
            ndt = r.num_device_tokens
            if r.host_token_override is not None:
                rows[0, i] = r.host_token_override
            else:
                rows[1, i] = r.seq_slot
            rows[2, i] = ndt
            rows[3, i] = r.seq_slot
            rows[4, i] = r.multi_step_budget
            rows[5, i] = max(0, sp.min_tokens - (ndt - r.prompt_len))
            if sp.seed:
                seeds[i] = sp.seed & 0x7FFFFFFF or 1
            ids = list(sp.stop_id_list())[:NSTOP]
            stop_ids[i, :len(ids)] = ids
            for table, attr in zip(tables, self.pool_ids):
                chain = getattr(r, attr)
                table[i, :len(chain)] = chain
        inputs = dict(rows=rows, seeds=seeds, stop_ids=stop_ids,
                      page_indices=tables[0],
                      **_sliding(page_indices_sw=tables[1:]))
        if not greedy:
            inputs["samp_ints"], inputs["samp_floats"] = \
                SamplingTensors.rows(reqs, Sb)
        if ops.ngram:
            inputs["ngram_n"] = _ngram_sizes(reqs, Sb)
        carved: List[int] = []
        if riders is not None:
            xs, carved = self.plan_ctx_chunks(riders, K)
            inputs.update(("ctx_" + k, a) for k, a in xs.items())
        return inputs, carved

    def _window_key(self, K: int, Sb: int, C: int, bound: int,
                    greedy: bool, use_penalties: bool,
                    seeded: bool = False,
                    ops: LogitsOps = LogitsOps()) -> tuple:
        # a rider window's attention is the ragged kernel alone: no splits
        splits = self.model.graph_bound_key(bound, lambda b: 1) if C \
            else self._splits(Sb, bound)
        return ("multi", K, Sb, C, self.mixed_ctx_seqs if C else 0, splits,
                greedy, use_penalties, ops, seeded)

    @torch.no_grad()
    def forward_multi_step(self, batch: ScheduledRequests, K: int,
                           use_penalties: bool = False, ctx_requests=None):
        """Launch one K-step decode window for a generation-only batch.
        Each request must carry ``multi_step_budget`` (set by the executor
        after KV pre-allocation). Returns device tensors (tokens [K, Sb],
        logprobs [K, Sb], emitted [Sb]), of which a row's tokens past its
        emitted count are not outputs, and ``carved``: the context tokens
        consumed per request of ``ctx_requests``. With ``ctx_requests``
        (a mixed window), each step also prefills a planned context
        chunk."""
        reqs = batch.generation_requests
        n = len(reqs)
        Sb = self._pick_row_bucket(n)
        self.iter_counter += 1
        greedy = not use_penalties and \
            all(r.sampling_params.greedy for r in reqs)
        seeded = _seeded(reqs, greedy)
        riders = ctx_requests or None
        # rows with bad words or a logits processor never take a window
        # (the executor's _multi_rows_ok)
        ops = self._logits_ops_of(reqs, None, False)
        self.guided_windows += ops.guided
        inputs, carved = self._window_inputs(reqs, Sb, K, greedy, riders,
                                             ops)
        C = self.mixed_ctx_tokens if riders else 0
        rows = inputs["rows"]
        # steps the host knows to be live: every row is done by its
        # budget, and the plan says which steps carry a chunk
        live = int(rows[4].max()) if n else 0
        if riders:
            self.mixed_windows_dispatched += 1
            self.mixed_ctx_carved += sum(carved)
            chunk_steps = np.flatnonzero(inputs["ctx_cu"][:, -2])
            live = max(live, int(chunk_steps[-1]) + 1 if chunk_steps.size
                       else 0)
        self.decode_steps += K
        self.window_steps += K
        self.dead_window_steps += max(0, K - live)
        reach = (int(rows[2].max()) if n else 0) + K
        if riders:
            # the bound also covers the riders' chunks, whose KV MLA
            # gathers up to it (models/deepseek.py)
            reach = max(reach, int(inputs["ctx_kv_lens"].max()))
        bound = self._kv_bound(reach)
        self._counts(use_penalties)
        out = self.graphs.run(
            self._window_key(K, Sb, C, bound, greedy, use_penalties, seeded,
                             ops),
            inputs,
            self._window_body(K, Sb, C, bound, greedy, use_penalties, seeded,
                              ops),
            inert=lambda: self._window_inputs(
                [], Sb, K, greedy, [] if riders else None, ops)[0])
        return (*out, carved)

    def _window_body(self, K: int, Sb: int, C: int, kv_bound: int,
                     greedy: bool, use_penalties: bool,
                     seeded: bool = False, ops: LogitsOps = LogitsOps()):
        ps, P = self.page_size, self.pages_per_seq
        NC = self.mixed_ctx_seqs if C else 0
        oob = self.num_kv_pages * ps
        oob_sw = self.num_sw_pages * ps
        vswa = self._vswa
        trash = self.max_batch_size
        dev = self.device

        def body(v):
            token_ids, prev_slot, start_pos, out_slots, max_new, \
                stop_gate = v["rows"]
            stops, pages = v["stop_ids"], v["page_indices"]
            st = None if greedy else SamplingTensors.from_rows(
                v["samp_ints"], v["samp_floats"])
            valid = out_slots >= 0
            iota = torch.arange(Sb, device=dev)
            cu_q = torch.arange(Sb + 1, dtype=torch.int32, device=dev)
            num_seqs = torch.full((1,), Sb + (NC + 1 if C else 0),
                                  dtype=torch.int32, device=dev)
            prev = prev_slot.long()
            cur = torch.where(prev >= 0, self.prev_tokens[prev.clamp(min=0)],
                              token_ids.long())
            pos = start_pos
            active = valid & (max_new > 0)
            emitted = torch.zeros(Sb, dtype=torch.int32, device=dev)
            toks, lps = [], []
            slot_rows = torch.where(valid, out_slots, trash).long()
            # the rows' bias, gathered once (the JAX window's ``brow``)
            brow = self.bias_pool[slot_rows] if ops.bias else None
            # each row's grammar state rides the window and is scattered
            # back to its slot at the end (the JAX window's ``gst``)
            gst0 = gst = self.g_state[slot_rows] if ops.guided else None
            for k in range(K):
                kv_len = torch.where(valid, pos + 1, 1).to(torch.int32)
                page_col = (pos // ps).clamp(0, P - 1).long()
                slot_map = torch.where(active,
                                       pages[iota, page_col] * ps + pos % ps,
                                       oob).to(torch.int32)
                sw = {}
                if vswa:
                    # the sliding layers' slots in their own pool
                    pages_sw = v["page_indices_sw"]
                    sw = dict(page_indices_sw=pages_sw,
                              slot_mapping_sw=torch.where(
                                  active,
                                  pages_sw[iota, page_col] * ps + pos % ps,
                                  oob_sw).to(torch.int32))
                if C:
                    # context riders: the step's planned chunk (C tokens
                    # over NC sequences and a filler row) joins the
                    # decode rows in one forward, one ragged-kernel
                    # launch per layer whose grid C fixes (a chunk row may
                    # hold several tokens, so at least 2); logits are
                    # taken at the decode rows only
                    logits = self._forward(
                        torch.cat([cur, v["ctx_tokens"][k].long()]),
                        AttentionMetadata(
                            kv_lens=torch.cat([kv_len,
                                               v["ctx_kv_lens"][k]]),
                            page_indices=torch.cat([pages,
                                                    v["ctx_pages"][k]]),
                            cu_q_lens=torch.cat([cu_q,
                                                 Sb + v["ctx_cu"][k, 1:]]),
                            num_seqs=num_seqs,
                            slot_mapping=torch.cat([slot_map,
                                                    v["ctx_slots"][k]]),
                            positions=torch.cat([pos,
                                                 v["ctx_positions"][k]]),
                            logits_indices=iota, max_q_len=max(C, 2),
                            max_kv_len=kv_bound))
                else:
                    # a row that is done stops updating its slot's
                    # recurrent state
                    logits = self._forward(cur, AttentionMetadata(
                        kv_lens=kv_len, page_indices=pages, cu_q_lens=cu_q,
                        num_seqs=num_seqs, slot_mapping=slot_map,
                        positions=pos, logits_indices=iota, max_q_len=1,
                        max_kv_len=kv_bound,
                        seq_slots=torch.where(active, out_slots, -1), **sw))
                if ops.guided:
                    g_act = valid & (gst >= 0)
                    logits = self._guided_mask(logits, gst, g_act)
                if brow is not None:
                    logits = add_embedding_bias(logits, brow)
                if ops.ngram:
                    # the sampled token lands at pos + 1
                    n = v["ngram_n"]
                    ban = ngram_ban_mask(self.ngram_history[slot_rows], n,
                                         pos + 1, active & (n > 0),
                                         logits.shape[-1])
                    logits = torch.where(
                        ban, torch.finfo(torch.float32).min, logits)
                tok, lp = self._sample(
                    logits, st, v["seeds"] if seeded else None, kv_len,
                    torch.where(active, out_slots, trash).long(),
                    use_penalties)
                if ops.ngram:
                    self._append_history(tok, out_slots, pos + 1, active)
                if ops.guided:
                    gst = torch.where(active & g_act,
                                      self._guided_walk(tok, gst), gst)
                new_emitted = emitted + active.to(torch.int32)
                hit_stop = (tok[:, None] == stops).any(dim=1)
                stopped = hit_stop & (new_emitted >= stop_gate)
                len_done = new_emitted >= max_new
                pos = pos + active.to(pos.dtype)
                active = active & ~stopped & ~len_done
                emitted = new_emitted
                cur = tok
                toks.append(tok)
                lps.append(lp)
            if ops.guided:
                keep = valid & (gst0 >= 0)
                self.g_state[torch.where(keep, out_slots, trash).long()] = gst
            return torch.stack(toks), torch.stack(lps), emitted
        return body

    # ------------------------------------------------------------------ #
    # Fused speculative window (runtime/spec_window.py)
    # ------------------------------------------------------------------ #
    def spec_key(self, Sb: int, greedy: bool, seeded: bool, k_lp: int,
                 head_bound: int, bound: int) -> tuple:
        """A spec window's graph key: the head's split count (EAGLE3) or
        bound (MTP), and what the target verify's ``bound`` changes (an
        MLA target's gather; nothing for the ragged prefill kernel)."""
        return ("spec", self.sd.K, Sb, greedy, seeded, k_lp,
                self._splits(Sb, head_bound, head=True),
                self.model.graph_bound_key(bound, lambda b: ()))

    @torch.no_grad()
    def forward_spec_window(self, batch: ScheduledRequests):
        """Fused speculative decode window (runtime/spec_window.py)."""
        return spec_window.forward_spec_window(self, batch)

    @torch.no_grad()
    def spec_seed(self, tokens: torch.Tensor, hidden: torch.Tensor,
                  rows: List[int], slots: List[int], positions: List[int],
                  emitted: List[int]) -> None:
        spec_window.spec_seed(self, tokens, hidden, rows, slots, positions,
                              emitted)

    # ------------------------------------------------------------------ #
    # Warmup: capture the serving graphs at build (the JAX engine's
    # warmup / _warm_multi compile the same shapes)
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def warmup(self) -> None:
        """Capture the greedy window of every row bucket at K (and at K/4,
        the TTFT-budget window, when ``ttft_slo_ms`` is set), with and
        without riders when ``mixed_window_ctx`` > 0, the greedy spec
        window of every row bucket when speculation is on, the greedy
        decode-only single step of every token bucket a decode batch
        takes, and with host drafting the greedy verify step of every
        token bucket a verify step takes. Every row is inactive and the
        rider chunks are empty, so no device state changes. Sampled,
        penalty and logprob variants, and other KV split counts, are
        captured at first use."""
        K = self.args.decode_multi_step
        if self.sd is not None:
            for Sb in self.row_buckets:
                self._warm_spec(Sb)
        # under speculation no row takes a multi-step window (the
        # executor's _multi_rows_ok, as in the JAX package)
        if K > 1 and self.sd is None and not self.max_draft_len:
            Ks = {K, max(1, K // 4)} if self.args.ttft_slo_ms > 0 else {K}
            riders = [None] + ([[]] if self.riders_ok else [])
            for Sb in self.row_buckets:
                for k in sorted(Ks):
                    for r in riders:
                        self._warm_multi(k, Sb, r)
        for T in self.token_buckets:
            if T <= self.max_batch_size:
                bound = self._kv_bound(1)
                self.graphs.ensure(
                    self._step_key(T, bound, True, False, 0),
                    self._step_inputs(self.prepare_inputs(
                        ScheduledRequests()), [], T, True),
                    self._step_body(1, bound, True, False, 0))
            if self.max_draft_len and T <= self.max_batch_size * self.G:
                reach = self.pages_per_seq * self.page_size
                self.graphs.ensure(
                    self._verify_key(T, True, False, 0),
                    self._step_inputs(self.prepare_inputs(
                        ScheduledRequests()), [], T, True),
                    self._step_body(self.G, reach, True, False, 0))
        # the inert steps scattered into the trash slot only; clear it in
        # place all the same (the graphs hold its address)
        self.prev_tokens.zero_()
        logger.info("captured %d graphs in %.1f s", self.graphs.num_graphs,
                    self.graphs.capture_seconds)

    def _warm_spec(self, Sb: int) -> None:
        """Capture one greedy spec window (all rows inactive)."""
        sd = self.sd
        reach = sd.K * (sd.d + 1) + sd.d
        head_bound, bound = self.head_kv_bound(reach), self._kv_bound(reach)
        self.graphs.ensure(
            self.spec_key(Sb, True, False, 0, head_bound, bound),
            spec_window.spec_inputs(self, [], Sb, True),
            spec_window.build_spec_window(self, sd.K, Sb, True, False, 0,
                                          head_bound, bound))

    def _warm_multi(self, K: int, Sb: int, riders) -> None:
        """Capture one greedy window (all rows inactive; ``riders`` [] for
        the rider branch with an empty chunk, None without it)."""
        inert, _ = self._window_inputs([], Sb, K, True, riders)
        C = self.mixed_ctx_tokens if riders is not None else 0
        bound = self._kv_bound(K)
        self.graphs.ensure(self._window_key(K, Sb, C, bound, True, False),
                           inert,
                           self._window_body(K, Sb, C, bound, True, False))
