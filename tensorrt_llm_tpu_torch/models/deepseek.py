"""DeepSeek-V3 and DeepSeek-V2: MLA (multi-head latent attention) over a
paged latent cache, and MoE layers with shared experts.

Port of ``tensorrt_llm_tpu/models/deepseek.py`` (``DeepseekV3ForCausalLM``,
``DeepseekV2ForCausalLM``) on one GPU.

The KV pool holds one latent row a token and layer, ``kv_lora_rank +
qk_rope_head_dim`` wide (576 in the published configs): ``[L, pages,
page, latent]`` (``kv_pool_shape``), written in place by ``scatter_slots``
(ops/attention.py), which drops out-of-range slots as ``write_kv`` does.
A quantized KV cache is refused by name: the JAX package allocates this
pool in the model's type while its engine sizes pages by the KV type's
element size.

MLA is plain torch, as the JAX package computes it in XLA (no Pallas
kernel does, and neither K1 nor K2 is called: ``attention_windows`` is
empty). Per layer: q from ``q_a -> q_a_norm -> q_b`` (``q_lora_rank``) or
one ``q`` projection; the latent ``c_kv`` (``kv_a`` then ``kv_a_norm``)
and ``k_pe``, both with interleaved rope on the rope dims; the latents of
every sequence gathered densely from its page table, bounded by the
step's ``max_kv_len`` (positions past it are masked in the JAX package
all the same). The path is chosen statically, as in the JAX model
(deepseek.py:270-282):

- absorbed (``T == S``, a decode-shaped step, and ``uk`` present):
  ``q_nope . W_UK`` scored against the raw latents, the value path in
  latent space, then ``W_UV`` per head;
- decompressed otherwise (prefill, rider windows, verify steps):
  ``kv_b`` over the gathered latents, the scores of each token against
  its sequence's keys. Where the JAX model gathers the keys once a token,
  the port gathers them once a tile of up to ``MLA_TILE`` consecutive
  tokens of one sequence (``_query_tiles``, shapes static, filled on the
  device), and decompresses the latents a chunk of positions at a time,
  each chunk's keys and values and each chunk of tiles' scores at most
  ``MLA_CHUNK_BYTES``, merged by an online softmax (running maximum and
  sum): the same products, with neither a [T, positions, heads, dims]
  gather nor every sequence's keys and values at once, so that a step's
  scratch grows with the positions by the latents alone.

Scores, softmax and both einsum chains run in float32 from the model's
type, with the causal and length mask at float32's minimum. ``uk`` /
``uv`` are split from the checkpoint's float ``kv_b`` at load, under a
method that quantizes at load too (as the JAX model splits them from the
raw array); a prequantized ``kv_b`` would leave decode decompressed.
Each layer's call adds one to ``MLA_ABSORBED`` or ``MLA_DECOMPRESSED``
(``_build.count_launch``: a CUDA graph counts them once per replay).

The rotary embedding follows the config's ``rope_scaling`` (yarn for
every published DeepSeek config) and the softmax scale is multiplied by
``mscale(factor, mscale_all_dim)^2``, as the checkpoints' own modeling
code and transformers' DeepSeek-V3 attention do; the JAX model ignores
both (ROADMAP C). Routing (ops/moe.py): V3 sigmoid scores chosen with the
correction bias, group-limited by top-2 sums (``sigmoid_bias_routing``,
router logits of the model's type accumulated in float32); V2 softmax
scores, group-limited by maxima under ``topk_method`` =
"group_limited_greedy" (``softmax_group_routing``), never renormalised.

Parameters: embed, final_norm, lm_head, and layers[l] = {input_norm,
post_norm, q | (q_a, q_a_norm, q_b), kv_a, kv_a_norm, kv_b, o, [uk
[nh, nope, lora], uv [nh, lora, vd]]}, then for the first
``first_k_dense_replace`` layers the gated MLP "gate_up" / "down", for the
others "router" [E, H], "router_bias" [E] (float32), "w_gate_up"
[E, H, 2I], "w_down" [E, I, H] and the shared experts' "se_gate_up" /
"se_down".
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from ..ops.attention import AttentionMetadata, layer_metadata, scatter_slots
from ..ops.cuda._build import count_launch
from ..ops.linear import LinearMethod, dot_f32
from ..ops.moe import (check_grouped, moe_mlp_routed, moe_mlp_zero_experts,
                       moe_route, sigmoid_bias_routing,
                       softmax_group_routing)
from ..ops.norm import rms_norm
from ..ops.rope import RopeConfig, apply_rope, rope_cos_sin
from ..quantization.checkpoint import PrequantizedWeight
from .llama import LlamaForCausalLM
from .modeling_utils import (DecoderModelForCausalLM, ModelConfig,
                             apply_pair, fuse_projections, hf_transpose,
                             quantize_linear, register_model)

# MLA layer calls by path (counted as kernel launches are)
MLA_ABSORBED = 0
MLA_DECOMPRESSED = 0
# the decompressed path: query rows of a tile, and device bytes of one
# chunk of positions' keys and values, and of one chunk of tiles' scores
MLA_TILE = 128
MLA_CHUNK_BYTES = 1 << 30


def yarn_mscale(scale: float, mscale: float) -> float:
    """DeepSeek's yarn magnitude factor (``yarn_get_mscale``)."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


@register_model("deepseek_v3")
class DeepseekV3ForCausalLM(DecoderModelForCausalLM):
    architectures = ("DeepseekV3ForCausalLM",)
    # DeepSeek-V2: softmax scores, greedy or group-limited greedy top k
    moe_softmax_greedy = False

    def __init__(self, model_config: ModelConfig):
        super().__init__(model_config)
        hf = self.hf
        if model_config.uses_kv_quant:
            raise NotImplementedError(
                f"a {model_config.kv_cache_dtype} KV cache on "
                f"{hf.model_type}'s MLA latent pool is not supported by "
                "this package (the latent pool is kept in the model's type)")
        self.hidden_size = hf.hidden_size
        self.num_heads = hf.num_attention_heads
        self.intermediate_size = hf.intermediate_size
        self.q_lora_rank = getattr(hf, "q_lora_rank", None)
        self.kv_lora_rank = hf.kv_lora_rank
        self.qk_rope = hf.qk_rope_head_dim
        self.qk_nope = hf.qk_nope_head_dim
        self.v_dim = hf.v_head_dim
        self.latent_dim = self.kv_lora_rank + self.qk_rope
        self.rms_eps = getattr(hf, "rms_norm_eps", 1e-6)
        self.tie_embeddings = getattr(hf, "tie_word_embeddings", False)
        self.rope_cfg = RopeConfig.from_hf_config(hf, self.qk_rope)
        self.sm_scale = 1.0 / math.sqrt(self.qk_nope + self.qk_rope)
        rope = self.rope_cfg
        if rope.mscale_all_dim:
            m = yarn_mscale(rope.scaling_factor, rope.mscale_all_dim)
            self.sm_scale *= m * m
        # MoE geometry
        self.first_dense = getattr(hf, "first_k_dense_replace", 0)
        self.num_experts = getattr(hf, "n_routed_experts", 0)
        self.top_k = getattr(hf, "num_experts_per_tok", 0)
        self.n_shared = getattr(hf, "n_shared_experts", 0) or 0
        self.moe_inter = getattr(hf, "moe_intermediate_size", 0)
        self.routed_scale = getattr(hf, "routed_scaling_factor", 1.0)
        self.norm_topk = getattr(hf, "norm_topk_prob", True)
        self.n_group = getattr(hf, "n_group", None) or 1
        self.topk_group = getattr(hf, "topk_group", None) or self.n_group
        self.m_lin = self._method("attn")
        self.m_mlp = self._method("mlp")
        self.m_lm_head = self._method("lm_head")
        self.zero_experts = getattr(hf, "zero_expert_num", 0) or 0
        if self.num_layers > self.first_dense and \
                self.device.type == "cuda" and \
                moe_route(self.dtype, self.device) == "grouped":
            check_grouped(self.hidden_size, self.moe_inter, self.device,
                          dropped=self.zero_experts > 0)

    # ------------------------------------------------------------------ #
    # The latent pool and the engine's sizing
    # ------------------------------------------------------------------ #
    def kv_pool_shape(self, num_pages: int, page_size: int) -> tuple:
        return (self.num_layers, num_pages, page_size, self.latent_dim)

    def attention_windows(self) -> tuple:
        """MLA launches neither K1 nor K2: no window to split K1 by."""
        return ()

    def graph_bound_key(self, bound: int, splits) -> tuple:
        """MLA gathers every sequence's latents up to the bound: a graph
        captured at one bound reads no further, so the bound keys it."""
        return ("kv_bound", bound)

    def act_width_per_token(self) -> int:
        """Activation elements per token of one layer (the graph pool's
        estimate): 4 hidden-wide tensors, q, the latent and its rope
        part, the absorbed query and latent output, the attention output,
        and the wider of the dense MLP and the MoE block (the router's E
        logits, k routed copies as in ``MixtralForCausalLM``, the shared
        experts)."""
        H, nh = self.hidden_size, self.num_heads
        attn = (nh * (self.qk_nope + self.qk_rope) + 2 * self.latent_dim
                + 2 * nh * self.kv_lora_rank + nh * self.v_dim
                + (self.q_lora_rank or 0))
        Im = self.moe_inter
        moe = self.num_experts + self.top_k * (2 * H + 3 * Im) \
            + 3 * Im * self.n_shared
        return 4 * H + attn + max(3 * self.intermediate_size, moe)

    def attn_scratch_bytes(self, seqs: int, tokens: int,
                           positions: int) -> int:
        """Peak bytes of one MLA call that grow with the positions, the
        larger of its two paths'. Absorbed (a token a sequence): the
        gathered latents (2 bytes an element at most), their float32
        copy, and four float32 score-wide tensors over the heads.
        Decompressed: the gathered latents, the query tiles' mask (a byte
        per tile row and position; at most ``tokens`` + ``seqs`` *
        ``MLA_TILE`` rows), and two ``MLA_CHUNK_BYTES`` (a chunk's keys
        and values, a chunk of tiles' scores)."""
        lat, nh = self.latent_dim, self.num_heads
        absorbed = seqs * positions * (6 * lat + 16 * nh)
        decompressed = seqs * positions * 2 * lat + \
            (tokens + seqs * MLA_TILE) * positions + 2 * MLA_CHUNK_BYTES
        return max(absorbed, decompressed)

    # ------------------------------------------------------------------ #
    # Parameters
    # ------------------------------------------------------------------ #
    def _is_moe(self, idx: int) -> bool:
        return idx >= self.first_dense

    def _lin(self, method: LinearMethod, w, bias=None) -> Dict[str, Any]:
        return quantize_linear(method, hf_transpose(w), bias=bias,
                               dtype=self.dtype, device=self.device)

    def _vec(self, a, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return torch.as_tensor(a).to(device=self.device,
                                     dtype=dtype or self.dtype).contiguous()

    def _absorbed(self, kv_b) -> Dict[str, torch.Tensor]:
        """W_UK [nh, nope, lora] and W_UV [nh, lora, vd] split from the
        checkpoint's float kv_b [nh*(nope+vd), lora] (the JAX
        ``_absorbed_from_kvb``, deepseek.py:101-117): under a method that
        quantizes at load as well, the absorbed path then using them in
        the model's type; nothing from a prequantized kv_b."""
        if isinstance(kv_b, PrequantizedWeight):
            return {}
        nh, nope, lora = self.num_heads, self.qk_nope, self.kv_lora_rank
        w = torch.as_tensor(kv_b).float().reshape(nh, -1, lora)
        return {"uk": self._vec(w[:, :nope]),
                "uv": self._vec(w[:, nope:].transpose(1, 2))}

    def _layer(self, idx: int, weight: Callable[[str], Any]
               ) -> Dict[str, Any]:
        """Layer ``idx``'s parameters from ``weight(name)`` ([out, in]
        floats for projections, vectors for norms, [E, ...] stacks for the
        experts)."""
        lin, m = self._lin, self.m_lin
        layer = {"input_norm": self._vec(weight("input_norm")),
                 "post_norm": self._vec(weight("post_norm")),
                 "kv_a": lin(m, weight("kv_a")),
                 "kv_a_norm": self._vec(weight("kv_a_norm")),
                 "kv_b": lin(m, weight("kv_b")),
                 "o": lin(m, weight("o"))}
        layer.update(self._absorbed(weight("kv_b")))
        if self.q_lora_rank:
            layer["q_a"] = lin(m, weight("q_a"))
            layer["q_a_norm"] = self._vec(weight("q_a_norm"))
            layer["q_b"] = lin(m, weight("q_b"))
        else:
            layer["q"] = lin(m, weight("q"))
        mm = self.m_mlp
        if not self._is_moe(idx):
            layer.update(fuse_projections(
                "gate_up", ("gate", "up"), (mm, mm),
                [lin(mm, weight("gate")), lin(mm, weight("up"))]))
            layer["down"] = lin(mm, weight("down"))
            return layer
        layer["router"] = self._vec(weight("router"))
        layer["router_bias"] = self._vec(weight("router_bias"),
                                         torch.float32).reshape(-1)
        layer["w_gate_up"] = self._vec(weight("w_gate_up"))
        layer["w_down"] = self._vec(weight("w_down"))
        if self.n_shared:
            layer.update(fuse_projections(
                "se_gate_up", ("se_gate", "se_up"), (mm, mm),
                [lin(mm, weight("se_gate")), lin(mm, weight("se_up"))]))
            layer["se_down"] = lin(mm, weight("se_down"))
        return layer

    # lm_head as the Llama trunk keeps it (the embed tensor when tied)
    _lm_head = LlamaForCausalLM._lm_head

    def init_params(self, seed: int = 0) -> Dict[str, Any]:
        """Random weights (load_format="dummy"): normal(0, 0.02) matrices
        and unit norms drawn on the target device from a seeded
        ``torch.Generator``, a zero router bias."""
        H, V, nh = self.hidden_size, self.vocab_size, self.num_heads
        dev, dt = self.device, self.dtype
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def mat(*shape):
            if len(shape) == 3:
                # an expert stack, one expert at a time: its float32 draw
                # at DeepSeek-V3's width would take 30 GB
                out = torch.empty(shape, device=dev, dtype=dt)
                for e in range(shape[0]):
                    out[e] = mat(*shape[1:])
                return out
            return (torch.randn(shape, generator=gen, device=dev,
                                dtype=torch.float32) * 0.02).to(dt)

        def ones(n=H):
            return torch.ones(n, device=dev, dtype=dt)

        qd = nh * (self.qk_nope + self.qk_rope)
        I, Im, E = self.intermediate_size, self.moe_inter, self.num_experts
        layers = []
        for i in range(self.num_layers):
            w = {"input_norm": ones(), "post_norm": ones(),
                 "kv_a": mat(self.latent_dim, H),
                 "kv_a_norm": ones(self.kv_lora_rank),
                 "kv_b": mat(nh * (self.qk_nope + self.v_dim),
                             self.kv_lora_rank),
                 "o": mat(H, nh * self.v_dim)}
            if self.q_lora_rank:
                w.update(q_a=mat(self.q_lora_rank, H),
                         q_a_norm=ones(self.q_lora_rank),
                         q_b=mat(qd, self.q_lora_rank))
            else:
                w["q"] = mat(qd, H)
            if not self._is_moe(i):
                w.update(gate=mat(I, H), up=mat(I, H), down=mat(H, I))
            else:
                SI = Im * self.n_shared
                w.update(router=mat(E, H), router_bias=torch.zeros(E),
                         w_gate_up=mat(E, H, 2 * Im), w_down=mat(E, Im, H),
                         se_gate=mat(SI, H), se_up=mat(SI, H),
                         se_down=mat(H, SI))
            layers.append(self._layer(i, w.__getitem__))
        embed = mat(V, H)
        lm_head = None if self.tie_embeddings else mat(V, H)
        return {"embed": embed, "layers": layers, "final_norm": ones(),
                "lm_head": self._lm_head(embed, lm_head)}

    _HF_NAMES = {
        "input_norm": "input_layernorm.weight",
        "post_norm": "post_attention_layernorm.weight",
        "q": "self_attn.q_proj.weight", "q_a": "self_attn.q_a_proj.weight",
        "q_a_norm": "self_attn.q_a_layernorm.weight",
        "q_b": "self_attn.q_b_proj.weight",
        "kv_a": "self_attn.kv_a_proj_with_mqa.weight",
        "kv_a_norm": "self_attn.kv_a_layernorm.weight",
        "kv_b": "self_attn.kv_b_proj.weight",
        "o": "self_attn.o_proj.weight",
        "gate": "mlp.gate_proj.weight", "up": "mlp.up_proj.weight",
        "down": "mlp.down_proj.weight", "router": "mlp.gate.weight",
        "router_bias": "mlp.gate.e_score_correction_bias",
        "se_gate": "mlp.shared_experts.gate_proj.weight",
        "se_up": "mlp.shared_experts.up_proj.weight",
        "se_down": "mlp.shared_experts.down_proj.weight"}

    def _hf_weight(self, sd: Mapping[str, Any], p: str, name: str):
        """Parameter ``name`` of the layer at checkpoint prefix ``p`` (the
        experts stacked into ops/moe.py's layout one expert at a time on
        the target device; V2's router has no correction bias: zeros, as
        in the JAX loader)."""
        E, Im, H = self.num_experts, self.moe_inter, self.hidden_size
        if name == "router_bias":
            return sd.get(p + self._HF_NAMES[name], torch.zeros(E))
        if name in ("w_gate_up", "w_down"):
            e = p + "mlp.experts.{}."
            if name == "w_down":
                out = torch.empty((E, Im, H), dtype=self.dtype,
                                  device=self.device)
                for j in range(E):
                    out[j] = torch.as_tensor(
                        sd[e.format(j) + "down_proj.weight"]).t()
                return out
            out = torch.empty((E, H, 2 * Im), dtype=self.dtype,
                              device=self.device)
            for j in range(E):
                out[j, :, :Im] = torch.as_tensor(
                    sd[e.format(j) + "gate_proj.weight"]).t()
                out[j, :, Im:] = torch.as_tensor(
                    sd[e.format(j) + "up_proj.weight"]).t()
            return out
        return sd[p + self._HF_NAMES[name]]

    def hf_layer(self, sd: Mapping[str, Any], idx: int) -> Dict[str, Any]:
        """Checkpoint layer ``idx``'s parameters (the MTP drafter reads
        its module at index ``num_hidden_layers`` through this)."""
        p = f"model.layers.{idx}."
        return self._layer(idx, lambda n: self._hf_weight(sd, p, n))

    def _embed_and_head(self, sd: Mapping[str, Any]) -> Dict[str, Any]:
        embed = self._vec(sd["model.embed_tokens.weight"])
        lm_head = None if self.tie_embeddings or "lm_head.weight" not in sd \
            else sd["lm_head.weight"]
        return {"embed": embed,
                "final_norm": self._vec(sd["model.norm.weight"]),
                "lm_head": self._lm_head(embed, lm_head)}

    def load_hf_state_dict(self, sd: Mapping[str, Any]) -> Dict[str, Any]:
        """HF checkpoint names -> parameters."""
        return dict(self._embed_and_head(sd), layers=[
            self.hf_layer(sd, i) for i in range(self.num_layers)])

    # ------------------------------------------------------------------ #
    # MLA over the paged latent cache
    # ------------------------------------------------------------------ #
    def _mla_context(self, metadata: AttentionMetadata, T: int, ps: int,
                     absorbed: bool):
        """What every layer's MLA shares in a step: the page count of the
        gather (the step's ``max_kv_len`` in pages), and the positions each
        query sees (causal, below its sequence's length): on the absorbed
        path each token's sequence and the [T, positions] mask, on the
        decompressed one the query tiles of ``_query_tiles`` and their
        [tiles, B, positions] mask. Returns (pages, mask, sequences or
        None, tiles or None)."""
        S, P = metadata.page_indices.shape
        n_pages = P if metadata.max_kv_len is None else \
            max(1, min(P, -(-metadata.max_kv_len // ps)))
        dev = metadata.kv_lens.device
        cu = metadata.cu_q_lens
        kv_pos = torch.arange(n_pages * ps, dtype=cu.dtype, device=dev)
        if absorbed:
            # each token's sequence (the identity in a decode step)
            tok = torch.arange(T, dtype=cu.dtype, device=dev)
            seq_of = torch.searchsorted(cu[1:].contiguous(), tok,
                                        right=True).clamp(max=S - 1).long()
            kv_len = metadata.kv_lens[seq_of]
            tok_pos = kv_len - (cu[1:] - cu[:-1])[seq_of] + (tok - cu[seq_of])
            valid = (kv_pos[None, :] <= tok_pos[:, None]) & \
                (kv_pos[None, :] < kv_len[:, None])
            return n_pages, valid, seq_of, None
        tiles = self._query_tiles(metadata, T)
        tile_seq, tok_pos = tiles[0], tiles[3]
        kv_len = metadata.kv_lens[tile_seq][:, None, None]
        valid = (kv_pos <= tok_pos[:, :, None]) & (kv_pos < kv_len)
        return n_pages, valid, None, tiles

    @staticmethod
    def _query_tiles(metadata: AttentionMetadata, T: int):
        """The step's query tokens as tiles of B consecutive tokens of one
        sequence (B: ``MLA_TILE``, or less for short segments), so that
        the decompressed keys are gathered once a tile rather than once a
        token. Static shapes: at most ceil(T / B) + S tiles, filled on the
        device; where ``max_q_len`` fits one tile (a verify pass, a rider
        window), exactly S tiles, tile i sequence i. Returns (each tile's
        sequence [n], each row's token index [n, B] (T for a row past its
        segment), whether the row holds a token [n, B], each row's
        position [n, B])."""
        S = metadata.page_indices.shape[0]
        cu = metadata.cu_q_lens.long()
        dev = cu.device
        max_q = max(1, metadata.max_q_len or T)
        B = min(MLA_TILE, 1 << (max_q - 1).bit_length())
        q_lens = cu[1:S + 1] - cu[:S]
        if max_q <= B:
            # every segment fits one tile: tile i is sequence i (S tiles,
            # which ``_decompressed`` reads without a gather)
            seq = torch.arange(S, device=dev)
            off = torch.arange(B, device=dev)[None, :]
            live = off < q_lens[:, None]
            tok = torch.where(live, cu[:S, None] + off, T)
            pos = metadata.kv_lens[:S].long()[:, None] - q_lens[:, None] \
                + off
            return seq, tok, live, pos
        n = -(-T // B) + S
        per = (q_lens + B - 1) // B
        end = torch.cumsum(per, 0)
        i = torch.arange(n, device=dev)
        seq = torch.searchsorted(end, i, right=True).clamp(max=S - 1)
        off = (i - (end[seq] - per[seq]))[:, None] * B + \
            torch.arange(B, device=dev)[None, :]
        live = (off < q_lens[seq][:, None]) & (i < end[-1])[:, None]
        tok = torch.where(live, cu[seq][:, None] + off, T)
        pos = metadata.kv_lens[seq].long()[:, None] - q_lens[seq][:, None] \
            + off
        return seq, tok, live, pos

    def _decompressed(self, q_nope: torch.Tensor, q_pe: torch.Tensor,
                      c_all: torch.Tensor, kpe: torch.Tensor,
                      decompress: Callable[[torch.Tensor], torch.Tensor],
                      ctx) -> torch.Tensor:
        """The decompressed path (float32 [T, heads, v_dim]): each query
        tile against its sequence's latents ``c_all`` [S, positions,
        lora] decompressed by ``decompress`` ([rows, lora] -> [rows,
        heads * (nope + vd)]) and rope keys ``kpe`` [S, positions, rope]:
        chunks of positions whose keys and values take at most
        ``MLA_CHUNK_BYTES`` (the model's type and float32), in each chunks
        of tiles whose scores do, merged by an online softmax."""
        T, nh, nope = q_nope.shape
        vd = self.v_dim
        S, N, lora = c_all.shape
        _, valid, _, (seq, tok, _, _) = ctx
        n, B = tok.shape
        # tile i is sequence i (``_query_tiles``): keys read in place
        ident = n == S
        idx = tok.clamp(max=T - 1)
        qn = q_nope.float()[idx]                       # [n, B, nh, nope]
        qp = q_pe.float()[idx]
        width = nh * (nope + vd)
        span = max(1, min(N, MLA_CHUNK_BYTES // (S * width * 6)))
        per_tile = span * nh * (2 * (nope + vd) + kpe.shape[-1]
                                + 3 * B) * 4
        chunk = max(1, MLA_CHUNK_BYTES // per_tile)
        neg = torch.finfo(torch.float32).min
        dev = q_nope.device
        run_max = torch.full((n, nh, B), -math.inf, device=dev)
        run_sum = torch.zeros((n, nh, B), device=dev)
        acc = torch.zeros((n, B, nh, vd), device=dev)
        for p0 in range(0, N, span):
            pos = slice(p0, p0 + span)
            c = c_all[:, pos]
            knv = decompress(c.reshape(-1, lora)).view(
                S, c.shape[1], nh, nope + vd).float()
            kpe_c = kpe[:, pos].float()
            for c0 in range(0, n, chunk):
                sl = slice(c0, c0 + chunk)
                kv_t = knv[sl] if ident else knv[seq[sl]]
                kp_t = kpe_c[sl] if ident else kpe_c[seq[sl]]
                scores = torch.einsum("cbhd,ckhd->chbk", qn[sl],
                                      kv_t[..., :nope]) + \
                    torch.einsum("cbhd,ckd->chbk", qp[sl], kp_t)
                scores = torch.where(valid[sl][:, None, :, pos],
                                     scores * self.sm_scale, neg)
                new_max = torch.maximum(run_max[sl], scores.amax(-1))
                probs = torch.exp(scores - new_max[..., None])
                keep = torch.exp(run_max[sl] - new_max)
                run_sum[sl] = run_sum[sl] * keep + probs.sum(-1)
                run_max[sl] = new_max
                acc[sl] = acc[sl] * keep.transpose(1, 2)[..., None] + \
                    torch.einsum("chbk,ckhd->cbhd", probs, kv_t[..., nope:])
        out = acc / run_sum.transpose(1, 2)[..., None]
        # back to token order; rows past their segment land in row T
        flat = torch.zeros((T + 1, nh, vd), dtype=out.dtype,
                           device=out.device)
        flat.index_copy_(0, tok.reshape(-1), out.reshape(n * B, nh, vd))
        return flat[:T]

    def _mla_attention(self, layer: Dict[str, Any], x: torch.Tensor,
                       pool: torch.Tensor, md: AttentionMetadata, ctx,
                       cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        """One layer's MLA (``pool``: the flat all-layers pool
        [(L*P), page, latent]; ``md``: the layer's metadata view)."""
        T = x.shape[0]
        nh, lora, rope_d = self.num_heads, self.kv_lora_rank, self.qk_rope
        nope, vd = self.qk_nope, self.v_dim
        m = self.m_lin
        if self.q_lora_rank:
            q = m.apply(layer["q_b"], rms_norm(m.apply(layer["q_a"], x),
                                               layer["q_a_norm"],
                                               self.rms_eps))
        else:
            q = m.apply(layer["q"], x)
        q = q.reshape(T, nh, nope + rope_d)
        q_nope = q[..., :nope]
        q_pe = apply_rope(q[..., nope:], cos, sin, is_neox=False)
        kv_a = m.apply(layer["kv_a"], x)
        c_kv = rms_norm(kv_a[:, :lora], layer["kv_a_norm"], self.rms_eps)
        k_pe = apply_rope(kv_a[:, lora:].reshape(T, 1, rope_d), cos, sin,
                          is_neox=False)[:, 0]
        ps, latent = pool.shape[1], pool.shape[2]
        scatter_slots(pool.view(-1, latent),
                      torch.cat([c_kv, k_pe], dim=-1).to(pool.dtype),
                      md.slot_mapping)

        n_pages, valid, seq_of = ctx[0], ctx[1], ctx[2]
        # each token's sequence's latents (absorbed), or each sequence's
        pages = md.page_indices[:, :n_pages] if seq_of is None else \
            md.page_indices[seq_of, :n_pages]
        lat = pool[pages.reshape(-1).long()].view(pages.shape[0],
                                                  n_pages * ps, latent)
        c_all, kpe_all = lat[..., :lora], lat[..., lora:]
        if seq_of is not None:
            # a decode-shaped step (T == S, uk at hand): each token scored
            # against its sequence's raw latents
            count_launch(__name__, "MLA_ABSORBED")
            q_abs = torch.einsum("thd,hdl->thl", q_nope.float(),
                                 layer["uk"].float())
            c_t = c_all.float()
            scores = (torch.einsum("thl,tkl->thk", q_abs, c_t) +
                      torch.einsum("thd,tkd->thk", q_pe.float(),
                                   kpe_all.float())) * self.sm_scale
            probs = torch.softmax(torch.where(
                valid[:, None, :], scores, torch.finfo(torch.float32).min),
                dim=-1)
            out = torch.einsum("thl,hlv->thv",
                               torch.einsum("thk,tkl->thl", probs, c_t),
                               layer["uv"].float())
        else:
            count_launch(__name__, "MLA_DECOMPRESSED")
            out = self._decompressed(
                q_nope, q_pe, c_all, kpe_all,
                lambda c: m.apply(layer["kv_b"], c), ctx)
        return m.apply(layer["o"], out.reshape(T, nh * vd).to(self.dtype))

    # ------------------------------------------------------------------ #
    # MLP
    # ------------------------------------------------------------------ #
    def _route(self, layer: Dict[str, Any], x: torch.Tensor):
        logits = dot_f32(x, layer["router"])
        if self.moe_softmax_greedy:
            grouped = getattr(self.hf, "topk_method", "greedy") == \
                "group_limited_greedy"
            return softmax_group_routing(
                logits, self.top_k, self.routed_scale,
                self.n_group if grouped else 1, self.topk_group)
        return sigmoid_bias_routing(logits, layer["router_bias"],
                                    self.top_k, self.norm_topk,
                                    self.routed_scale, self.n_group,
                                    self.topk_group)

    def _gated(self, layer: Dict[str, Any], x: torch.Tensor, fused: str,
               names, down: str, width: int) -> torch.Tensor:
        mm = self.m_mlp
        gate, up = apply_pair(mm, layer, fused, names, x, width)
        return mm.apply(layer[down], F.silu(gate.float()).to(self.dtype) * up)

    def _mlp(self, layer: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        if "router" not in layer:
            return self._gated(layer, x, "gate_up", ("gate", "up"), "down",
                               self.intermediate_size)
        w, idx = self._route(layer, x)
        out = moe_mlp_routed(x, layer["w_gate_up"], layer["w_down"], w, idx)
        if self.n_shared:
            out = out + self._gated(layer, x, "se_gate_up",
                                    ("se_gate", "se_up"), "se_down",
                                    self.moe_inter * self.n_shared)
        return out

    # ------------------------------------------------------------------ #
    def forward(self, params: Dict[str, Any], token_ids: torch.Tensor,
                kv_pages: torch.Tensor, metadata: AttentionMetadata,
                collect_hidden: bool = False):
        """(logits [S, V] float32 at ``logits_indices``, kv_pages), and
        with ``collect_hidden`` the pre-final-norm hidden rows there (the
        JAX model's MTP features)."""
        eps = self.rms_eps
        h = params["embed"][token_ids].to(self.dtype)
        cos, sin = rope_cos_sin(self.rope_cfg, metadata.positions)
        L, P, ps = kv_pages.shape[:3]
        flat = kv_pages.view((L * P,) + tuple(kv_pages.shape[2:]))
        T = h.shape[0]
        # the path, chosen statically as the JAX model chooses it
        absorbed = T == metadata.page_indices.shape[0] and \
            "uk" in params["layers"][0]
        ctx = self._mla_context(metadata, T, ps, absorbed)

        def attn(li: int, x: torch.Tensor) -> torch.Tensor:
            layer = params["layers"][li]
            return self._mla_attention(
                layer, rms_norm(x, layer["input_norm"], eps), flat,
                layer_metadata(metadata, li, P, ps, L), ctx, cos, sin)
        h = self._decoder(params, h, attn)
        rows = h[metadata.logits_indices]
        last = rms_norm(rows, params["final_norm"], eps)
        logits = self.m_lm_head.apply(params["lm_head"], last).float()
        if collect_hidden:
            return logits, kv_pages, rows
        return logits, kv_pages

    def _decoder(self, params: Dict[str, Any], h: torch.Tensor,
                 attn: Callable[[int, torch.Tensor], torch.Tensor]
                 ) -> torch.Tensor:
        """The decoder layers over the embedded tokens ``h``; ``attn(li,
        h)``: layer li's MLA over its input-normed ``h``."""
        eps = self.rms_eps
        for li, layer in enumerate(params["layers"]):
            h = h + attn(li, h)
            h = h + self._mlp(layer, rms_norm(h, layer["post_norm"], eps))
        return h


@register_model("deepseek_v2")
class DeepseekV2ForCausalLM(DeepseekV3ForCausalLM):
    """DeepSeek-V2 (and -Lite): the same MLA latent cache; softmax
    routing, greedy or group-limited (``topk_method``), no correction
    bias, never renormalised."""
    architectures = ("DeepseekV2ForCausalLM",)
    moe_softmax_greedy = True


@register_model("longcat_flash")
class LongcatFlashForCausalLM(DeepseekV3ForCausalLM):
    """LongCat-Flash: the shortcut-connected MoE (ScMoE) over MLA (the JAX
    ``LongcatFlashForCausalLM``, deepseek.py:449-616).

    Each checkpoint layer (a "pair") holds two MLA + dense-MLP sublayers,
    kept here as flat layers 2i and 2i+1 of ``params["layers"]`` and of
    the latent pool (``2 * num_layers`` pool layers). The routed MoE of
    pair i (``params["pairs"][i]``: "router" [E+Z, H], "router_bias"
    [E+Z] float32, "w_gate_up", "w_down") is computed from sublayer 0's
    post-attention normed stream and added after sublayer 1's dense MLP.
    At load, ``sqrt(H / q_lora_rank)`` and ``sqrt(H / kv_lora_rank)`` are
    folded into q_b and kv_b (in float32, before any quantization).
    Routing: float32 softmax scores over the E routed and Z zero experts,
    the top k of the scores plus the correction bias, weights the unbiased
    scores times ``routed_scaling_factor``; a zero-expert pick adds w * x
    (``ops.moe.moe_mlp_zero_experts``). The forward collects no hidden
    rows, as the JAX one does not (no MTP drafting for this target)."""
    architectures = ("LongcatFlashForCausalLM",)

    def __init__(self, model_config: ModelConfig):
        hf = model_config.hf_config
        # transformers' names onto DeepSeek-V3's, as the JAX model sets
        # them; the pool holds two sublayers a pair (transformers' own
        # model sets num_hidden_layers so)
        hf.num_hidden_layers = 2 * hf.num_layers
        hf.first_k_dense_replace = 0
        hf.num_experts_per_tok = hf.moe_topk
        hf.moe_intermediate_size = hf.expert_ffn_hidden_size
        hf.intermediate_size = hf.ffn_hidden_size
        hf.n_shared_experts = 0
        super().__init__(model_config)
        self.n_pairs = hf.num_layers

    def _is_moe(self, idx: int) -> bool:
        return False            # every flat sublayer has a dense MLP

    def act_width_per_token(self) -> int:
        """The V3 estimate with both MLPs of a pair alive at once (the
        shortcut MoE's output waits for sublayer 1)."""
        Im = self.moe_inter
        moe = self.num_experts + self.zero_experts + \
            self.top_k * (2 * self.hidden_size + 3 * Im)
        return super().act_width_per_token() + moe

    def checkpoint_shapes(self) -> Dict[str, tuple]:
        """{name: shape} of a LongCat-Flash checkpoint of this config
        under the published names (one tensor an expert)."""
        H, nh, V = self.hidden_size, self.num_heads, self.vocab_size
        qd = nh * (self.qk_nope + self.qk_rope)
        I, Im = self.intermediate_size, self.moe_inter
        E, Z = self.num_experts, self.zero_experts
        shapes = {"model.embed_tokens.weight": (V, H),
                  "model.norm.weight": (H,), "lm_head.weight": (V, H)}
        for i in range(self.n_pairs):
            p = f"model.layers.{i}."
            for s in (0, 1):
                a = f"{p}self_attn.{s}."
                shapes.update({
                    f"{p}input_layernorm.{s}.weight": (H,),
                    f"{p}post_attention_layernorm.{s}.weight": (H,),
                    a + "q_a_proj.weight": (self.q_lora_rank, H),
                    a + "q_a_layernorm.weight": (self.q_lora_rank,),
                    a + "q_b_proj.weight": (qd, self.q_lora_rank),
                    a + "kv_a_proj_with_mqa.weight": (self.latent_dim, H),
                    a + "kv_a_layernorm.weight": (self.kv_lora_rank,),
                    a + "kv_b_proj.weight": (
                        nh * (self.qk_nope + self.v_dim), self.kv_lora_rank),
                    a + "o_proj.weight": (H, nh * self.v_dim),
                    f"{p}mlps.{s}.gate_proj.weight": (I, H),
                    f"{p}mlps.{s}.up_proj.weight": (I, H),
                    f"{p}mlps.{s}.down_proj.weight": (H, I)})
            shapes[p + "mlp.router.classifier.weight"] = (E + Z, H)
            shapes[p + "mlp.router.e_score_correction_bias"] = (E + Z,)
            for e in range(E):
                x = f"{p}mlp.experts.{e}."
                shapes.update({x + "gate_proj.weight": (Im, H),
                               x + "up_proj.weight": (Im, H),
                               x + "down_proj.weight": (H, Im)})
        return shapes

    def init_params(self, seed: int = 0) -> Dict[str, Any]:
        """Random weights (load_format="dummy"): a seeded
        ``RandomCheckpoint`` of ``checkpoint_shapes``, drawn on the target
        device one tensor at a time, through the checkpoint loader."""
        from .recurrent import RandomCheckpoint
        return self.load_hf_state_dict(RandomCheckpoint(
            self.checkpoint_shapes(), self.device, self.dtype, seed))

    def load_hf_state_dict(self, sd: Mapping[str, Any]) -> Dict[str, Any]:
        """Sublayer j = 2i + s reads pair i's ``self_attn.{s}``,
        ``mlps.{s}`` and ``*_layernorm.{s}`` tensors; the router, its
        correction bias and the experts stay keyed by pair."""
        scale = {"q_b": (self.hidden_size / self.q_lora_rank) ** 0.5,
                 "kv_b": (self.hidden_size / self.kv_lora_rank) ** 0.5}

        def sub_weight(j: int, name: str):
            i, s = divmod(j, 2)
            head, rest = self._HF_NAMES[name].split(".", 1)
            head = "mlps" if head == "mlp" else head
            w = sd[f"model.layers.{i}.{head}.{s}.{rest}"]
            if name in scale:
                w = torch.as_tensor(w).float() * scale[name]
            return w

        layers = [self._layer(j, lambda n, j=j: sub_weight(j, n))
                  for j in range(self.num_layers)]
        pairs = []
        for i in range(self.n_pairs):
            p = f"model.layers.{i}."
            pairs.append({
                "router": self._vec(sd[p + "mlp.router.classifier.weight"]),
                "router_bias": self._vec(
                    sd[p + "mlp.router.e_score_correction_bias"],
                    torch.float32).reshape(-1),
                "w_gate_up": self._hf_weight(sd, p, "w_gate_up"),
                "w_down": self._hf_weight(sd, p, "w_down")})
        return dict(self._embed_and_head(sd), layers=layers, pairs=pairs)

    def sc_route(self, pair: Dict[str, Any], x: torch.Tensor):
        """(weights float32 [T, k], expert indices [T, k]) of the shortcut
        MoE: indices >= E are zero experts."""
        scores = torch.softmax(dot_f32(x, pair["router"]), dim=-1)
        _, idx = torch.topk(scores + pair["router_bias"], self.top_k, dim=-1)
        return scores.gather(1, idx) * self.routed_scale, idx

    def sc_moe(self, pair: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        """The JAX ``_sc_moe`` (deepseek.py:549-568)."""
        w, idx = self.sc_route(pair, x)
        return moe_mlp_zero_experts(x, pair["w_gate_up"], pair["w_down"],
                                    w, idx)

    def forward(self, params: Dict[str, Any], token_ids: torch.Tensor,
                kv_pages: torch.Tensor, metadata: AttentionMetadata,
                collect_hidden: bool = False):
        if collect_hidden:
            raise NotImplementedError(
                "hidden rows of a longcat_flash target (MTP or EAGLE3 "
                "drafting) are not supported by this package, nor by the "
                "JAX package's LongcatFlashForCausalLM.forward")
        return super().forward(params, token_ids, kv_pages, metadata)

    def _decoder(self, params: Dict[str, Any], h: torch.Tensor,
                 attn: Callable[[int, torch.Tensor], torch.Tensor]
                 ) -> torch.Tensor:
        """The pair forward (deepseek.py:590-608): sublayer 0's MLA and
        dense MLP, the shortcut MoE from its post-attention normed stream,
        sublayer 1's MLA and dense MLP, then the shortcut."""
        eps = self.rms_eps
        layers = params["layers"]
        for i, pair in enumerate(params["pairs"]):
            a0, a1 = layers[2 * i], layers[2 * i + 1]
            h = h + attn(2 * i, h)
            normed = rms_norm(h, a0["post_norm"], eps)
            shortcut = self.sc_moe(pair, normed)
            h = h + self._mlp(a0, normed)
            h = h + attn(2 * i + 1, h)
            h = h + self._mlp(a1, rms_norm(h, a1["post_norm"], eps)) + \
                shortcut
        return h
