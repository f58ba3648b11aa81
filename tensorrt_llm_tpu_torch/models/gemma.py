"""Gemma 2 and Gemma 3 (text) decoders.

Port of ``tensorrt_llm_tpu/models/gemma.py``: the Llama trunk
(models/llama.py) with Gemma's conventions:

- the RMS norm is ``x * rsqrt(mean x^2 + eps) * (1 + w)`` in float32
  (``ops/norm.py`` ``gemma_rms_norm``), four per layer (before and after
  attention, before and after the MLP);
- the embeddings are scaled by sqrt(hidden) cast to the model's type
  first (in bf16 sqrt(3584) is 59.75);
- the MLP is GELU-tanh on the gate in float32;
- ``query_pre_attn_scalar`` gives the attention scale;
- sliding-window and global layers alternate by ``layer_types``, else by
  Gemma 2's even/odd rule or Gemma 3's five local to one global;
- Gemma 2 caps the attention logits (``attn_logit_softcapping``, in the
  kernels) and the final logits (``final_logit_softcapping``);
- Gemma 3 normalises each head of q and k (gemma norms, float32 weights)
  and rotates its sliding layers by ``rope_local_base_freq`` without
  scaling, its global layers by ``rope_theta`` with the config's scaling;
- the lm_head is the embedding.

The JAX model picks each layer's attention inside its layer scan with a
``lax.cond``; here the Python loop takes each layer's ``AttentionSpec``.

VSWA (``enable_vswa``, Gemma 2 only, as in the JAX package): the sliding
layers keep their KV in a second, smaller pool (``make_kv_pages`` returns
(global [L/2, P, ps, 2kvh, hd], sliding [L/2, Psw, ps, 2kvh, hd])) and
read it through the metadata's sliding page table and slot map
(``AttentionMetadata.for_sliding_pool``); their window is the
``max_attention_window`` minimum. It needs strict alternation starting
with a sliding layer.

Parameters: those of models/llama.py with ``post_attn_norm``,
``pre_ffn_norm`` and ``post_ffn_norm`` in place of ``post_norm``, and for
Gemma 3 ``q_norm`` / ``k_norm`` [hd] in float32. The EAGLE3 head cannot
draft for these models (their forward collects no hidden rows, nor does
the JAX one's): ``llmapi/llm_args.check_ported_spec`` refuses it. On a
quantized KV cache every layer takes the config's scale (the JAX
gemma.py:157, 305, 425), and both VSWA pools hold the cache's type.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..ops.attention import AttentionMetadata, layer_metadata
from ..ops.norm import gemma_rms_norm
from ..ops.rope import RopeConfig, rope_cos_sin
from .llama import LlamaForCausalLM
from .modeling_utils import (AttentionSpec, attention_block, embed_tokens,
                             override_rows, register_model)


@register_model("gemma2")
class Gemma2ForCausalLM(LlamaForCausalLM):
    architectures = ("Gemma2ForCausalLM",)
    per_layer_kv_scale = False
    # the JAX Gemma loader folds no SmoothQuant scales
    takes_smoothing = False
    # the sqrt(hidden) embedding scale applies to prompt-embedding rows too
    scale_input_embeds = True

    _HF_MODULES = {**LlamaForCausalLM._HF_MODULES,
                   "pre_ffn_norm": "pre_feedforward_layernorm",
                   "post_ffn_norm": "post_feedforward_layernorm"}

    def __init__(self, model_config):
        super().__init__(model_config)
        hf = self.hf
        self.tie_embeddings = True
        self.final_softcap = getattr(hf, "final_logit_softcapping", 30.0)
        self.mlp_act = "gelu_tanh"
        self.sliding_window = getattr(hf, "sliding_window", 4096)
        self.attn_spec = AttentionSpec(
            num_heads=self.num_heads, num_kv_heads=self.num_kv_heads,
            head_dim=self.head_dim,
            sm_scale=self._query_scalar() ** -0.5,
            rope=RopeConfig.from_hf_config(hf, self.head_dim),
            soft_cap=getattr(hf, "attn_logit_softcapping", 50.0),
            is_neox=True)
        self.local_rope = self.attn_spec.rope
        # sqrt(hidden) in the model's type, as the JAX model takes it
        self.embed_scale = torch.tensor(math.sqrt(self.hidden_size),
                                        dtype=self.dtype).item()
        # set by enable_vswa: the sliding layers' window and pool
        self.vswa_window: Optional[int] = None

    def _query_scalar(self) -> float:
        return getattr(self.hf, "query_pre_attn_scalar", self.head_dim)

    def _layer_is_sliding(self, idx: int) -> bool:
        """HF Gemma 2: even layers slide, odd layers are global."""
        lt = getattr(self.hf, "layer_types", None)
        if lt:
            return lt[idx] == "sliding_attention"
        return idx % 2 == 0

    @property
    def layer_specs(self) -> List[AttentionSpec]:
        """Each layer's attention: the global spec, or for a sliding layer
        the same with its window (the VSWA window when enabled) and the
        local rotary base."""
        sliding = dataclasses.replace(
            self.attn_spec, rope=self.local_rope,
            sliding_window=self.vswa_window or self.sliding_window)
        return [sliding if self._layer_is_sliding(i) else self.attn_spec
                for i in range(self.num_layers)]

    def act_width_per_token(self) -> int:
        """``LlamaForCausalLM.act_width_per_token`` plus the two extra
        norms' outputs and the MLP gate in float32 (one more
        intermediate-wide tensor)."""
        return 6 * self.hidden_size + 4 * self.intermediate_size

    # ------------------------------------------------------------------ #
    # VSWA: the sliding layers on a pool of their own
    # ------------------------------------------------------------------ #
    def enable_vswa(self, window: int) -> None:
        """Split the alternating sliding/global layers onto two KV pools
        (strict alternation starting with a sliding layer, HF Gemma 2's
        layout; anything else raises, as in the JAX package)."""
        L = self.num_layers
        pattern = [self._layer_is_sliding(i) for i in range(L)]
        if L % 2 or pattern != [i % 2 == 0 for i in range(L)]:
            raise ValueError("VSWA needs strict sliding/global alternation")
        self.vswa_window = int(window)

    @property
    def vswa_enabled(self) -> bool:
        return self.vswa_window is not None

    def kv_layout(self) -> List[Tuple[int, int]]:
        """Each layer's (pool, layer within that pool): every layer on
        the one pool, or under VSWA the global (odd) layers on pool 0 and
        the sliding (even) ones on pool 1, half the layers each."""
        if not self.vswa_enabled:
            return [(0, i) for i in range(self.num_layers)]
        return [(1 - i % 2, i // 2) for i in range(self.num_layers)]

    def make_kv_pages(self, num_pages: int, page_size: int,
                      num_sw_pages: Optional[int] = None):
        """One pool, or under VSWA (global pool, sliding pool)."""
        if not self.vswa_enabled:
            return super().make_kv_pages(num_pages, page_size)
        half = self.num_layers // 2
        shape = (page_size, 2 * self.num_kv_heads, self.head_dim)
        return tuple(torch.zeros((half, n) + shape,
                                 dtype=self.config.kv_cache_dtype,
                                 device=self.device)
                     for n in (num_pages, num_sw_pages))

    # ------------------------------------------------------------------ #
    # Parameters
    # ------------------------------------------------------------------ #
    def _layer(self, input_norm: torch.Tensor, post_norm: torch.Tensor,
               weight: Callable[[str], Any],
               bias: Callable[[str], Any] = lambda name: None,
               smooth: Callable[[str], Any] = lambda name: None,
               idx: int = 0) -> Dict[str, Any]:
        """``LlamaForCausalLM._layer`` with Gemma's four norms
        (``post_norm`` is the post-attention one) and Gemma 3's q/k norm
        weights kept in float32."""
        layer = super()._layer(input_norm, post_norm, weight, bias, smooth,
                               idx=idx)
        layer["post_attn_norm"] = layer.pop("post_norm")
        for name in ("pre_ffn_norm", "post_ffn_norm"):
            layer[name] = torch.as_tensor(weight(name)).to(
                device=self.device, dtype=self.dtype)
        if self.use_qk_norm:
            for name in ("q_norm", "k_norm"):
                layer[name] = torch.as_tensor(weight(name)).to(
                    device=self.device, dtype=torch.float32)
        return layer

    def init_params(self, seed: int = 0) -> Dict[str, Any]:
        """Random weights (load_format="dummy"): normal(0, 0.02) matrices
        drawn on the target device from a seeded ``torch.Generator``, and
        zero norm weights (Gemma's norms scale by 1 + w)."""
        H, V = self.hidden_size, self.vocab_size
        nq, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        dev, dt = self.device, self.dtype
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def mat(*shape):
            return (torch.randn(shape, generator=gen, device=dev,
                                dtype=torch.float32) * 0.02).to(dt)

        def zeros(n=H):
            return torch.zeros(n, device=dev, dtype=dt)

        layers = []
        for _ in range(self.num_layers):
            q, k, v = mat((nq + 2 * nkv) * hd, H).split(
                [nq * hd, nkv * hd, nkv * hd])
            w = {"q": q, "k": k, "v": v, "o": mat(H, nq * hd),
                 "pre_ffn_norm": zeros(), "post_ffn_norm": zeros(),
                 "q_norm": zeros(hd), "k_norm": zeros(hd)}
            w.update(self._init_mlp(mat))
            layers.append(self._layer(zeros(), zeros(), w.__getitem__))
        embed = mat(V, H)
        return {"embed": embed, "layers": layers, "final_norm": zeros(),
                "lm_head": self._lm_head(embed, None)}

    # ------------------------------------------------------------------ #
    # Forward
    # ------------------------------------------------------------------ #
    def _qk_norms(self):
        if not self.use_qk_norm:
            return None, None
        eps = self.rms_eps
        return (lambda layer, q: gemma_rms_norm(q, layer["q_norm"], eps),
                lambda layer, k: gemma_rms_norm(k, layer["k_norm"], eps))

    def forward(self, params: Dict[str, Any], token_ids: torch.Tensor,
                kv_pages, metadata: AttentionMetadata,
                collect_hidden: bool = False, input_embeds=None):
        """(logits [S, V] float32 at ``logits_indices``, kv_pages).
        ``kv_pages`` is one pool [L, P, ps, 2kvh, hd], or under VSWA the
        pair (global, sliding), each updated in place."""
        if collect_hidden:
            raise NotImplementedError(
                "the Gemma forward collects no hidden rows (no EAGLE3 "
                "draft head for a Gemma target)")
        eps = self.rms_eps
        q_norm, k_norm = self._qk_norms()
        # the sqrt(H) scale applies to overridden rows too (JAX gemma.py:
        # 141-142), unless the model scales only the looked-up rows
        # (Gemma 3's image rows, multimodal/gemma3_vl.py)
        if self.scale_input_embeds:
            h = embed_tokens(params["embed"], token_ids, input_embeds,
                             self.dtype) * self.embed_scale
        else:
            h = override_rows(embed_tokens(params["embed"], token_ids, None,
                                           self.dtype) * self.embed_scale,
                              input_embeds)
        specs = self.layer_specs
        cos_sin = {s.rope: rope_cos_sin(s.rope, metadata.positions)
                   for s in specs}
        pools = kv_pages if isinstance(kv_pages, tuple) else (kv_pages,)
        mds = [metadata] + [metadata.for_sliding_pool()] * (len(pools) - 1)
        flat = [p.view((p.shape[0] * p.shape[1],) + tuple(p.shape[2:]))
                for p in pools]
        for (pi, pl), layer, spec in zip(self.kv_layout(), params["layers"],
                                         specs):
            L, P, ps = pools[pi].shape[:3]
            md_l = layer_metadata(mds[pi], pl, P, ps, L)
            x = gemma_rms_norm(h, layer["input_norm"], eps)
            a = attention_block(layer, x, flat[pi], md_l, spec,
                                self.attn_methods,
                                rope_cos_sin=cos_sin[spec.rope],
                                q_norm=q_norm, k_norm=k_norm,
                                kv_scale=self.kv_scale)
            h = h + gemma_rms_norm(a, layer["post_attn_norm"], eps)
            x = gemma_rms_norm(h, layer["pre_ffn_norm"], eps)
            h = h + gemma_rms_norm(self._mlp(layer, x),
                                   layer["post_ffn_norm"], eps)
        # the norm is row-wise: gather the logits rows first
        last = gemma_rms_norm(h[metadata.logits_indices],
                              params["final_norm"], eps)
        logits = self.m_lm_head.apply(params["lm_head"], last).float()
        if self.final_softcap:
            logits = self.final_softcap * torch.tanh(
                logits / self.final_softcap)
        return logits, kv_pages


@register_model("gemma3_text")
class Gemma3ForCausalLM(Gemma2ForCausalLM):
    """Gemma 3 (text): Gemma 2's conventions without the soft caps, with
    per-head q/k gemma norms and two rotary bases."""
    architectures = ("Gemma3ForCausalLM", "Gemma3TextModel")

    def __init__(self, model_config):
        super().__init__(model_config)
        hf = self.hf
        self.use_qk_norm = True
        self.final_softcap = getattr(hf, "final_logit_softcapping", None)
        self.attn_spec = dataclasses.replace(
            self.attn_spec, soft_cap=getattr(hf, "attn_logit_softcapping",
                                             None))
        base = getattr(hf, "rope_local_base_freq", None)
        if base is None:
            # transformers 5: the sliding layers' own rope_parameters
            self.local_rope = RopeConfig.from_hf_config(
                hf, self.head_dim, "sliding_attention")
        else:
            self.local_rope = RopeConfig(
                head_dim=self.head_dim, rope_theta=base,
                max_position_embeddings=hf.max_position_embeddings,
                is_neox=True)

    def _query_scalar(self) -> float:
        return getattr(self.hf, "query_pre_attn_scalar", 256)

    def _layer_is_sliding(self, idx: int) -> bool:
        """Five local layers to one global."""
        lt = getattr(self.hf, "layer_types", None)
        if lt:
            return lt[idx] == "sliding_attention"
        return (idx + 1) % 6 != 0
