"""Llama-family decoder (Llama 2/3, TinyLlama, Mistral), the trunk that
Qwen2/Qwen3 (models/qwen.py) and the MoE families (models/mixtral.py,
models/qwen_moe.py) extend.

Port of ``tensorrt_llm_tpu/models/llama.py`` (``LlamaForCausalLM``):
pre-norm blocks of paged attention and a gated-SiLU MLP. The JAX version
scans one stacked layer body; here a Python loop walks a list of per-layer
parameter dicts. The KV pool stays one flat all-layers pool in which
layer l's pages sit at ``l*P + i`` (ops/attention.py layer_metadata), and
each layer's KV append updates it in place.

Parameters:
  embed [V, H]; final_norm [H]; lm_head (the embed tensor itself when
  embeddings are tied and lm_head is unquantized); layers[l] =
  {input_norm, post_norm, qkv, o, gate_up, down}, plus q_norm and k_norm
  with ``use_qk_norm`` (per-head [hd] weights, or with ``qk_norm_full``
  weights over the whole q and k projections). Each projection is the
  parameter dict of its linear method (ops/linear.py): unquantized
  {"weight": [out, in]}, e.g. qkv [(nq+2nkv)*hd, H] and gate_up [2I, H];
  weight-only quantized {"weight": int8 [K, N] or packed [K/2, N],
  "weight_scale", optionally "weight_zero"}. Methods are chosen per
  projection name (q_proj, k_proj, o_proj, mlp, lm_head) so that
  ``exclude_modules`` is honoured; when q and k/v differ, a layer holds
  "q", "k", "v" apart instead of "qkv". A checkpoint's q/k/v/o biases
  (Qwen2) ride in the projections' "bias" and through the fusion. On a
  quantized KV cache each layer also holds ``kv_scale``, a 0-dim float32
  device tensor (the config's default until ``ModelEngine.
  calibrate_kv_scales`` writes the calibrated value into it in place);
  the MoE and Gemma families keep one scale for every layer
  (``per_layer_kv_scale`` False; the model's ``kv_scale``), as the JAX
  package does.

The JAX ``LlamaForCausalLM``'s knobs, which the Llama-derived families
set (models/granite.py, olmo.py, phi.py, glm.py, llama_variants.py):
``norm_placement`` "pre" (norm each sublayer's input), "post" (OLMo 2,
EXAONE 4: norm each sublayer's output, with ``input_norm`` after
attention and ``post_norm`` after the MLP) or "sandwich" (GLM-4: the
pre-norms and extra norms ``post_attn_extra`` / ``post_mlp_extra`` on the
sublayers' outputs); Granite's ``embedding_multiplier``,
``residual_multiplier`` and ``logits_scaling``; ``mlp_act`` (silu,
gelu_tanh, relu); and ``layer_specs``, each layer's ``AttentionSpec``
(a window on some layers, no rotary embedding on others: ``rope`` None),
static per layer, so that the step and window graphs hold no branch.

Under SmoothQuant with smoothing scales (``smooth_scales``, set by the
``LLM``'s inline-model entry, keyed by checkpoint weight name) each
projection is smoothed at load and keeps its own vector; such
projections stay apart (models/modeling_utils.fuse_projections). The MoE
and Gemma families take no smoothing (``takes_smoothing``), as in the
JAX package, whose loaders of those families read none.

Subclasses change the MLP through ``_mlp_params`` (its parameters, from a
``weight(name)`` source) and ``_mlp`` (its forward), and the checkpoint
names through ``_hf_module``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Mapping

import torch
import torch.nn.functional as F

from ..ops.attention import AttentionMetadata, layer_metadata
from ..ops.linear import LinearMethod
from ..ops.norm import rms_norm
from ..ops.rope import RopeConfig, rope_cos_sin
from .modeling_utils import (AttentionMethods, AttentionSpec,
                             DecoderModelForCausalLM, ModelConfig,
                             apply_pair, attention_block, embed_tokens,
                             fuse_projections, hf_transpose, quantize_linear,
                             register_model)

# the gated MLP's activations (``mlp_act``), applied in float32
_ACTS = {"silu": F.silu,
         "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
         "relu": F.relu}


@register_model("llama", "mistral", "tinyllama")
class LlamaForCausalLM(DecoderModelForCausalLM):
    architectures = ("LlamaForCausalLM", "MistralForCausalLM")
    # each layer its own (calibrated) KV scale on a quantized KV cache
    per_layer_kv_scale = True
    # SmoothQuant's smoothing scales are folded into the projections
    takes_smoothing = True
    # the checkpoint's two norms of a layer, read into input_norm and
    # post_norm (OLMo 2 and EXAONE 4 name their output norms)
    _NORM_NAMES = ("input_layernorm", "post_attention_layernorm")
    # further per-layer norm weights, by the names of ``_HF_MODULES``
    _extra_norms: tuple = ()

    def __init__(self, model_config: ModelConfig):
        super().__init__(model_config)
        hf = self.hf
        self.hidden_size = hf.hidden_size
        self.num_heads = hf.num_attention_heads
        self.intermediate_size = hf.intermediate_size
        self.rms_eps = getattr(hf, "rms_norm_eps", 1e-6)
        self.tie_embeddings = getattr(hf, "tie_word_embeddings", False)
        self.attn_spec = AttentionSpec(
            num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads,
            head_dim=self.head_dim,
            sm_scale=1.0 / math.sqrt(self.head_dim),
            rope=RopeConfig.from_hf_config(hf, self.head_dim),
            sliding_window=self._sliding_window(hf),
            is_neox=True)
        # Qwen3-style per-head RMS norm on q/k before RoPE, or with
        # qk_norm_full (OLMoE) one RMS norm over the whole projection
        self.use_qk_norm = False
        self.qk_norm_full = False
        # the JAX model's knobs (module docstring)
        self.norm_placement = "pre"
        self.embedding_multiplier = 1.0
        self.residual_multiplier = 1.0
        self.logits_scaling = 1.0
        self.mlp_act = "silu"
        # SmoothQuant: {checkpoint weight name: s [K]} (llmapi/llm.py)
        self.smooth_scales: Dict[str, Any] = {}
        # per-projection linear methods (exclude_modules goes by name)
        self.m_q = self._method("q_proj")
        self.m_kv = self._method("k_proj")
        self.m_o = self._method("o_proj")
        self.m_mlp = self._method("mlp")
        self.m_lm_head = self._method("lm_head")
        self.attn_methods = AttentionMethods(self.m_q, self.m_kv, self.m_o)

    @property
    def layer_specs(self) -> List[AttentionSpec]:
        """Each layer's attention: ``attn_spec`` for every layer here;
        EXAONE 4 and SmolLM3 differ per layer."""
        return [self.attn_spec] * self.num_layers

    def attention_windows(self) -> tuple:
        """The distinct sliding windows of the model's layers (None for
        global attention): the decode kernel's split count is taken per
        window, and the engine keys its CUDA graphs by all of them."""
        return tuple(dict.fromkeys(s.sliding_window
                                   for s in self.layer_specs))

    def act_width_per_token(self) -> int:
        """Activation elements per token of one layer (the graph pool's
        estimate, ``ModelEngine.graph_pool_reserve``): 4 hidden-wide
        tensors (residual, normed input, attention output, o-projection
        output) and 3 intermediate-wide ones (gate and up projections,
        their product)."""
        return 4 * self.hidden_size + 3 * self.intermediate_size

    @staticmethod
    def _sliding_window(hf) -> Any:
        """The window as the JAX model reads it (``sliding_window``),
        unless the config turns it off (Qwen's ``use_sliding_window``)."""
        if getattr(hf, "use_sliding_window", True) is False:
            return None
        return getattr(hf, "sliding_window", None)

    # ------------------------------------------------------------------ #
    # Parameters
    # ------------------------------------------------------------------ #
    def _qk_norm_widths(self) -> tuple:
        """The q_norm and k_norm weights' widths."""
        hd = self.head_dim
        if self.qk_norm_full:
            return self.num_heads * hd, self.num_kv_heads * hd
        return hd, hd

    def _lin(self, method: LinearMethod, w, bias=None,
             smooth=None) -> Dict[str, Any]:
        """One [out, in] projection (floats or a ``PrequantizedWeight``)
        through its method onto the target device (``smooth``: its
        SmoothQuant vector, under a method that takes one)."""
        if type(method) is LinearMethod:
            smooth = None
        return quantize_linear(method, hf_transpose(w), bias=bias,
                               dtype=self.dtype, device=self.device,
                               smooth=smooth)

    def _layer(self, input_norm: torch.Tensor, post_norm: torch.Tensor,
               weight: Callable[[str], Any],
               bias: Callable[[str], Any] = lambda name: None,
               smooth: Callable[[str], Any] = lambda name: None,
               idx: int = 0) -> Dict[str, Any]:
        """Layer ``idx``'s parameters. ``weight(name)`` gives projection
        ``name`` (q, k, v, o and the MLP's, ``_mlp_params``) as [out, in]
        floats or a ``PrequantizedWeight``, and with ``use_qk_norm`` the
        q_norm / k_norm weights; each goes through its method on the
        target device, one at a time. ``smooth(name)``: the projection's
        SmoothQuant vector or None."""
        def lin(method: LinearMethod, name: str):
            return self._lin(method, weight(name), bias(name), smooth(name))

        layer = {"input_norm": input_norm, "post_norm": post_norm}
        layer.update(fuse_projections(
            "qkv", ("q", "k", "v"), (self.m_q, self.m_kv, self.m_kv),
            [lin(self.m_q, "q"), lin(self.m_kv, "k"), lin(self.m_kv, "v")]))
        layer["o"] = lin(self.m_o, "o")
        norms = self._extra_norms + (("q_norm", "k_norm")
                                     if self.use_qk_norm else ())
        for name in norms:
            layer[name] = torch.as_tensor(weight(name)).to(
                device=self.device, dtype=self.dtype)
        layer.update(self._layer_mlp_params(idx, weight, bias, smooth))
        if self.per_layer_kv_scale and self.config.uses_kv_quant:
            layer["kv_scale"] = torch.full((), self.config.kv_scale,
                                           dtype=torch.float32,
                                           device=self.device)
        return layer

    def _layer_mlp_params(self, idx: int, weight: Callable[[str], Any],
                          bias: Callable[[str], Any],
                          smooth: Callable[[str], Any]) -> Dict[str, Any]:
        """Layer ``idx``'s MLP parameters: ``_mlp_params`` in every layer
        here (GLM-4.5 and ERNIE 4.5 keep their first layers dense)."""
        return self._mlp_params(weight, bias, smooth)

    def _layer_init_mlp(self, idx: int, mat: Callable[..., torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """Random MLP weights of layer ``idx`` for
        ``_layer_mlp_params``."""
        return self._init_mlp(mat)

    def _mlp_params(self, weight: Callable[[str], Any],
                    bias: Callable[[str], Any],
                    smooth: Callable[[str], Any] = lambda name: None
                    ) -> Dict[str, Any]:
        """The gated MLP: gate and up fused where they can be, down."""
        m = self.m_mlp

        def lin(name):
            return self._lin(m, weight(name), bias(name), smooth(name))
        out = fuse_projections("gate_up", ("gate", "up"), (m, m),
                               [lin("gate"), lin("up")])
        out["down"] = lin("down")
        return out

    def _lm_head(self, embed: torch.Tensor, weight) -> Dict[str, Any]:
        """``weight``: [V, H] floats, a ``PrequantizedWeight``, or None
        for tied embeddings."""
        if type(self.m_lm_head) is LinearMethod and weight is None:
            return {"weight": embed}              # share the tensor
        return quantize_linear(
            self.m_lm_head, hf_transpose(embed if weight is None else weight),
            dtype=self.dtype, device=self.device)

    def init_params(self, seed: int = 0) -> Dict[str, Any]:
        """Random weights (load_format="dummy"): normal(0, 0.02) matrices
        and unit norms, drawn on the target device from a seeded
        ``torch.Generator``, then quantized by each projection's method."""
        H, V = self.hidden_size, self.vocab_size
        nq, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        dev, dt = self.device, self.dtype
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def mat(*shape):
            return (torch.randn(shape, generator=gen, device=dev,
                                dtype=torch.float32) * 0.02).to(dt)

        def ones():
            return torch.ones(H, device=dev, dtype=dt)

        layers = []
        for i in range(self.num_layers):
            q, k, v = mat((nq + 2 * nkv) * hd, H).split(
                [nq * hd, nkv * hd, nkv * hd])
            w = {"q": q, "k": k, "v": v, "o": mat(H, nq * hd)}
            w.update({name: ones() for name in self._extra_norms})
            if self.use_qk_norm:
                qw, kw = self._qk_norm_widths()
                w["q_norm"] = torch.ones(qw, device=dev, dtype=dt)
                w["k_norm"] = torch.ones(kw, device=dev, dtype=dt)
            w.update(self._layer_init_mlp(i, mat))
            layers.append(self._layer(ones(), ones(), w.pop, idx=i))
        embed = mat(V, H)
        lm_head = None if self.tie_embeddings else mat(V, H)
        return {"embed": embed, "layers": layers, "final_norm": ones(),
                "lm_head": self._lm_head(embed, lm_head)}

    def _init_mlp(self, mat: Callable[..., torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """Random MLP weights of one layer for ``_mlp_params``."""
        H, I = self.hidden_size, self.intermediate_size
        gate, up = mat(2 * I, H).split(I)
        return {"gate": gate, "up": up, "down": mat(H, I)}

    def load_hf_state_dict(self, sd: Mapping[str, Any]) -> Dict[str, Any]:
        """HF checkpoint names -> parameter dict (tensors, numpy arrays
        or ``PrequantizedWeight``s in; tensors on the model's device out,
        floats in its dtype)."""
        dev, dt = self.device, self.dtype

        def t(name):
            return torch.as_tensor(sd[name]).to(device=dev, dtype=dt)

        scales = self.smooth_scales if self.takes_smoothing else {}
        layers = []
        n_in, n_post = self._NORM_NAMES
        for i in range(self.num_layers):
            p = f"model.layers.{i}."
            layers.append(self._layer(
                t(p + n_in + ".weight"), t(p + n_post + ".weight"),
                lambda n: self._hf_weight(sd, p, n),
                lambda n: sd.get(p + self._hf_module(n) + ".bias"),
                lambda n: scales.get(p + self._hf_module(n) + ".weight"),
                idx=i))
        embed = t("model.embed_tokens.weight")
        lm_head = None if self.tie_embeddings or "lm_head.weight" not in sd \
            else sd["lm_head.weight"]
        return {"embed": embed, "layers": layers,
                "final_norm": t("model.norm.weight"),
                "lm_head": self._lm_head(embed, lm_head)}

    _HF_MODULES = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
                   "v": "self_attn.v_proj", "o": "self_attn.o_proj",
                   "q_norm": "self_attn.q_norm", "k_norm": "self_attn.k_norm",
                   "gate": "mlp.gate_proj", "up": "mlp.up_proj",
                   "down": "mlp.down_proj"}

    def _hf_module(self, name: str) -> str:
        """The checkpoint module (below ``model.layers.{i}.``) of the
        layer weight ``name``."""
        return self._HF_MODULES[name]

    def _hf_weight(self, sd: Mapping[str, Any], prefix: str, name: str):
        """Layer weight ``name`` of the layer at ``prefix``."""
        return sd[prefix + self._hf_module(name) + ".weight"]

    # ------------------------------------------------------------------ #
    # Forward
    # ------------------------------------------------------------------ #
    def forward(self, params: Dict[str, Any], token_ids: torch.Tensor,
                kv_pages: torch.Tensor, metadata: AttentionMetadata,
                collect_hidden: bool = False, collect_kv_stats: bool = False,
                input_embeds=None):
        """(logits [S, V] float32 at ``logits_indices``, kv_pages), and
        with ``collect_hidden`` also the pre-final-norm hidden rows at
        ``logits_indices`` (the EAGLE draft head's features), or with
        ``collect_kv_stats`` each layer's absmax of its fresh K and V,
        float32 [L] (the KV-scale calibration pass)."""
        eps = self.rms_eps
        q_norm, k_norm = self._qk_norms()
        h = embed_tokens(params["embed"], token_ids, input_embeds, self.dtype)
        if self.embedding_multiplier != 1.0:
            h = h * self.embedding_multiplier
        rm = self.residual_multiplier
        post = self.norm_placement == "post"
        sandwich = self.norm_placement == "sandwich"
        specs = self.layer_specs
        cos_sin = {s.rope: rope_cos_sin(s.rope, metadata.positions)
                   for s in specs if s.rope is not None}
        L, P, ps = kv_pages.shape[:3]
        kv_flat = kv_pages.view((L * P,) + tuple(kv_pages.shape[2:]))
        stats = []
        for li, (layer, spec) in enumerate(zip(params["layers"], specs)):
            md_l = layer_metadata(metadata, li, P, ps, L)
            x = h if post else rms_norm(h, layer["input_norm"], eps)
            a = attention_block(layer, x, kv_flat, md_l, spec,
                                self.attn_methods,
                                rope_cos_sin=cos_sin.get(spec.rope),
                                q_norm=q_norm, k_norm=k_norm,
                                kv_scale=layer.get("kv_scale", self.kv_scale),
                                collect_kv_stats=collect_kv_stats)
            if collect_kv_stats:
                a, stat = a
                stats.append(stat)
            if post:
                a = rms_norm(a, layer["input_norm"], eps)
            elif sandwich:
                a = rms_norm(a, layer["post_attn_extra"], eps)
            h = h + (a if rm == 1.0 else rm * a)
            m = self._mlp(layer, h if post else
                          rms_norm(h, layer["post_norm"], eps))
            if post:
                m = rms_norm(m, layer["post_norm"], eps)
            elif sandwich:
                m = rms_norm(m, layer["post_mlp_extra"], eps)
            h = h + (m if rm == 1.0 else rm * m)
        # RMSNorm is row-wise: gather the logits rows first, then norm
        rows = h[metadata.logits_indices]
        last = rms_norm(rows, params["final_norm"], eps)
        logits = self.m_lm_head.apply(params["lm_head"], last).float()
        if self.logits_scaling != 1.0:
            logits = logits / self.logits_scaling
        if collect_hidden:
            return logits, kv_pages, rows
        if collect_kv_stats:
            return logits, kv_pages, torch.stack(stats)
        return logits, kv_pages

    def _mlp(self, layer: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        """The gated MLP (``mlp_act`` on the gate in float32, times up,
        then down) over the post-attention rows."""
        mlp = self.m_mlp
        gate, up = apply_pair(mlp, layer, "gate_up", ("gate", "up"), x,
                              self.intermediate_size)
        act = _ACTS[self.mlp_act](gate.float()).to(self.dtype) * up
        return mlp.apply(layer["down"], act)

    def _qk_norms(self):
        """(q_norm, k_norm) hooks of ``attention_block``: functions of
        (layer params, [T, heads, hd]) that RMS-normalise each head over
        hd, or with ``qk_norm_full`` the flattened projection; (None,
        None) without ``use_qk_norm``."""
        if not self.use_qk_norm:
            return None, None
        eps = self.rms_eps
        if self.qk_norm_full:
            def norm(w, x):
                return rms_norm(x.reshape(x.shape[0], -1), w,
                                eps).reshape(x.shape)
        else:
            def norm(w, x):
                return rms_norm(x, w, eps)
        return (lambda layer, q: norm(layer["q_norm"], q),
                lambda layer, k: norm(layer["k_norm"], k))
