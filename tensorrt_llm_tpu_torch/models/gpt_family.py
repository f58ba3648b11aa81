"""LayerNorm-family decoders: GPT-NeoX/Pythia, GPT-J, Falcon, StarCoder2,
Command-R (Cohere, Cohere2), Nemotron, StableLM, BLOOM, MPT and OPT.

Port of ``tensorrt_llm_tpu/models/gpt_family.py`` (``LnFamilyModel``,
:46-286, and its subclasses :288-999): one block with knobs instead of
eleven near-copies, each subclass mapping its checkpoint names and fused
QKV layouts onto the shared layer layout. The knobs:

- the block: sequential (h += attn(ln1 h); h += mlp(ln2 h)) or
  ``parallel_block`` (h += attn(ln1 h) + mlp(ln2 h)), with ``shared_ln``
  one norm feeding both (GPT-J, Falcon-7B, Cohere);
- LayerNorm with or without bias (float32 statistics, ops/norm.py);
  Nemotron's layernorm1p folded at load (weight + 1);
- the MLP: fc -> act -> proj, or ``gated_mlp`` act(fc) * fc2 -> proj,
  the activation (``_ACTS``) in float32;
- ``logit_scale`` on the float32 logits (Cohere);
- learned positions ``wpe`` read at position + ``pos_offset`` (OPT's +2),
  and BLOOM's ``embed_ln`` after the embedding;
- per-layer attention (``layer_specs``): a sliding window on some layers
  (StarCoder2 on all, Cohere2 on three of four, the others with no rotary
  embedding), ALiBi (BLOOM, MPT), partial rotary in the neox or the gpt-j
  (interleaved) style.

Parameters: embed [V, H]; final_norm {"w", "b"?}; lm_head; optional
"wpe" [P, H] and "embed_ln" {"w", "b"}; layers[l] = {"ln1": {"w",
"b"?}, "ln2" (absent with ``shared_ln``), "qkv" (or "q", "k", "v" when
their methods differ), "o", "fc" and "proj", or for a gated MLP
"fc_pair" (fc | fc2 joined) or "fc" and "fc2"}; each projection is the
parameter dict of its linear method (ops/linear.py), biases in "bias".
The methods are chosen by the names "attn", "mlp" and "lm_head", as in
the JAX package. Every layer takes the config's KV scale on a quantized
KV cache (the JAX family passes ``config.kv_scale``).

Where the port parts from the JAX package (ROADMAP C, reference faults):
the rotary style of GPT-J and Cohere is the checkpoints' interleaved one
(the JAX ``AttentionSpec.is_neox`` stays True, so those models rotate
halves there); "gelu" is the exact erf GELU (``jax.nn.gelu`` defaults to
the tanh approximation, which GPT-NeoX, Falcon and MPT do not use);
Falcon's fused QKV bias is split with its weight; configurations the JAX
models would serve wrong are refused by name (Falcon ALiBi, StableLM's
parallel residual and q/k LayerNorm, BLOOM's residual after the norm,
OPT's post-LN and embedding projection).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Mapping, Optional

import torch
import torch.nn.functional as F

from ..ops.attention import AttentionMetadata, layer_metadata
from ..ops.linear import LinearMethod
from ..ops.norm import layer_norm, layer_norm_residual
from ..ops.rope import RopeConfig, rope_cos_sin
from ..quantization.lazy_state_dict import strip_prefix
from .modeling_utils import (AttentionMethods, AttentionSpec,
                             DecoderModelForCausalLM, ModelConfig,
                             alibi_slopes, apply_pair, attention_block,
                             embed_tokens, fuse_projections, hf_transpose,
                             quantize_linear, register_model)

# the MLP activations, applied in float32
_ACTS: Dict[str, Callable] = {
    "gelu": F.gelu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "relu2": lambda x: torch.square(F.relu(x)),
    "silu": F.silu,
}


class LnFamilyModel(DecoderModelForCausalLM):
    """Shared forward of the LayerNorm GPT family."""

    # knobs set by subclasses
    parallel_block = False
    shared_ln = False          # parallel with ONE norm (GPT-J, Falcon-7B)
    act_name = "gelu"
    attn_bias = True           # init_params: biased projections
    mlp_bias = True
    gated_mlp = False          # Cohere, StableLM: act(gate) * up -> proj
    logit_scale = 1.0
    # the checkpoint's LayerNorms carry biases (init_params)
    ln_bias = True

    def __init__(self, model_config: ModelConfig):
        super().__init__(model_config)
        hf = self.hf
        self.hidden_size = hf.hidden_size
        self.num_heads = hf.num_attention_heads
        self.inner = self._inner_size()
        self.ln_eps = self._ln_eps()
        rope = self._rope_config()
        self.attn_spec = AttentionSpec(
            num_heads=self.num_heads, num_kv_heads=self.num_kv_heads,
            head_dim=self.head_dim,
            sm_scale=1.0 / math.sqrt(self.head_dim), rope=rope,
            is_neox=rope is None or rope.is_neox)
        self.m_attn = self._method("attn")
        self.m_mlp = self._method("mlp")
        self.m_lm_head = self._method("lm_head")
        self.attn_methods = AttentionMethods(self.m_attn, self.m_attn,
                                             self.m_attn)
        # the sliding layers' attention (Cohere2), and which layers slide
        self.sliding_spec: Optional[AttentionSpec] = None
        self.layer_sliding: List[bool] = [False] * self.num_layers
        # learned-position offset (OPT stores position p at p + 2)
        self.pos_offset = 0
        # ALiBi's slopes on the device (BLOOM, MPT; ``_use_alibi``)
        self.alibi_t: Optional[torch.Tensor] = None

    # ---- subclass hooks ------------------------------------------------
    def _inner_size(self) -> int:
        return getattr(self.hf, "intermediate_size", None) or \
            4 * self.hf.hidden_size

    def _ln_eps(self) -> float:
        for name in ("layer_norm_eps", "layer_norm_epsilon", "norm_eps"):
            if getattr(self.hf, name, None) is not None:
                return getattr(self.hf, name)
        return 1e-5

    def _rope_config(self) -> Optional[RopeConfig]:
        return RopeConfig.from_hf_config(self.hf, self.head_dim)

    def _use_alibi(self) -> None:
        """ALiBi in place of a rotary embedding: the spec's static slopes
        and their float32 device tensor, which the forward hands the
        kernels (made here, before any graph is captured)."""
        slopes = alibi_slopes(self.num_heads)
        self.attn_spec = dataclasses.replace(self.attn_spec, rope=None,
                                             alibi_slopes=slopes)
        self.alibi_t = torch.tensor(slopes, dtype=torch.float32,
                                    device=self.device)

    @property
    def layer_specs(self) -> List[AttentionSpec]:
        """Each layer's attention: ``attn_spec``, or ``sliding_spec`` on
        the sliding layers."""
        return [self.sliding_spec if self.sliding_spec is not None and s
                else self.attn_spec for s in self.layer_sliding]

    def attention_windows(self) -> tuple:
        """The distinct sliding windows of the layers (None: global): the
        decode kernel's split counts and the CUDA graphs' keys."""
        return tuple(dict.fromkeys(s.sliding_window
                                   for s in self.layer_specs))

    def act_width_per_token(self) -> int:
        """Activation elements per token of one layer (the graph pool's
        estimate): 4 hidden-wide tensors and 3 intermediate-wide ones."""
        return 4 * self.hidden_size + 3 * self.inner

    # ---- parameters ----------------------------------------------------
    def _lin(self, method, w, bias=None) -> Dict[str, Any]:
        """One [out, in] projection through its method onto the device."""
        return quantize_linear(method, hf_transpose(w), bias=bias,
                               dtype=self.dtype, device=self.device)

    def _ln(self, w, b=None) -> Dict[str, Any]:
        """A LayerNorm's {"w", "b"?} on the device."""
        return {k: torch.as_tensor(v).to(device=self.device,
                                         dtype=self.dtype)
                for k, v in (("w", w), ("b", b)) if v is not None}

    def _layer(self, norms: Dict[str, tuple], projs: Dict[str, tuple]
               ) -> Dict[str, Any]:
        """One layer from its norms ({"ln1": (w, b), ...}) and projections
        ({"q": ([out, in], bias or None), ...}); q/k/v and a gated MLP's
        fc/fc2 join where their methods let them."""
        layer = {k: self._ln(*v) for k, v in norms.items()}
        m, mm = self.m_attn, self.m_mlp

        def lin(method, name):
            return self._lin(method, *projs[name])
        layer.update(fuse_projections(
            "qkv", ("q", "k", "v"), (m, m, m),
            [lin(m, "q"), lin(m, "k"), lin(m, "v")]))
        layer["o"] = lin(m, "o")
        if self.gated_mlp:
            layer.update(fuse_projections("fc_pair", ("fc", "fc2"), (mm, mm),
                                          [lin(mm, "fc"), lin(mm, "fc2")]))
        else:
            layer["fc"] = lin(mm, "fc")
        layer["proj"] = lin(mm, "proj")
        return layer

    def _norm_names(self) -> tuple:
        """The layer norms of this model: ln1, and ln2 unless one norm
        feeds both branches."""
        return ("ln1",) if self.parallel_block and self.shared_ln \
            else ("ln1", "ln2")

    def init_params(self, seed: int = 0) -> Dict[str, Any]:
        """Random weights (load_format="dummy"): normal(0, 0.02) matrices,
        unit norm weights and zero biases, drawn on the target device
        from a seeded ``torch.Generator``."""
        H, V, I = self.hidden_size, self.vocab_size, self.inner
        nq, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        dev, dt = self.device, self.dtype
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def mat(*shape):
            return (torch.randn(shape, generator=gen, device=dev,
                                dtype=torch.float32) * 0.02).to(dt)

        def zeros(n, on=True):
            return torch.zeros(n, device=dev, dtype=dt) if on else None

        def norm():
            return (torch.ones(H, device=dev, dtype=dt),
                    zeros(H, self.ln_bias))

        shapes = {"q": (nq * hd, H), "k": (nkv * hd, H), "v": (nkv * hd, H),
                  "o": (H, nq * hd), "fc": (I, H), "fc2": (I, H),
                  "proj": (H, I)}
        layers = []
        for _ in range(self.num_layers):
            projs = {n: (mat(*shape), zeros(shape[0], self.attn_bias
                                            if n in "qkvo" else
                                            self.mlp_bias))
                     for n, shape in shapes.items()
                     if n != "fc2" or self.gated_mlp}
            layers.append(self._layer({n: norm()
                                       for n in self._norm_names()}, projs))
        params = {"embed": mat(V, H), "layers": layers,
                  "final_norm": self._ln(*norm())}
        params["lm_head"] = self._lin(self.m_lm_head, mat(V, H))
        params.update(self._init_extra(mat, norm))
        return params

    def _init_extra(self, mat, norm) -> Dict[str, Any]:
        """Random model-level parameters of a subclass (wpe, embed_ln)."""
        return {}

    def load_hf_state_dict(self, sd: Mapping[str, Any]) -> Dict[str, Any]:
        """HF checkpoint names -> parameters, through the subclass's
        ``_hf_layer`` (one layer's norms and projections) and ``_hf_top``
        (the embedding, final norm, head and extras)."""
        sd = self._prepare(sd)
        layers = [self._layer(*self._hf_layer(sd, i))
                  for i in range(self.num_layers)]
        top = self._hf_top(sd)
        embed = torch.as_tensor(top["embed"]).to(device=self.device,
                                                 dtype=self.dtype)
        tied = top["lm_head"][0] is top["embed"] and \
            len(top["lm_head"]) == 1 and type(self.m_lm_head) is LinearMethod
        params = {"embed": embed, "layers": layers,
                  "final_norm": self._ln(*top["final_norm"]),
                  # a tied, unquantized head shares the embedding's tensor
                  "lm_head": {"weight": embed} if tied
                  else self._lin(self.m_lm_head, *top["lm_head"])}
        if "wpe" in top:
            params["wpe"] = torch.as_tensor(top["wpe"]).to(
                device=self.device, dtype=self.dtype)
        if "embed_ln" in top:
            params["embed_ln"] = self._ln(*top["embed_ln"])
        return params

    def _prepare(self, sd: Dict[str, Any]) -> Dict[str, Any]:
        """The checkpoint's names as ``_hf_layer`` reads them."""
        return sd

    def _hf_layer(self, sd: Dict[str, Any], i: int):
        raise NotImplementedError

    def _hf_top(self, sd: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError

    @staticmethod
    def _pair(sd, name):
        """(weight, bias or None) of checkpoint module ``name``."""
        return sd[name + ".weight"], sd.get(name + ".bias")

    def _projs(self, sd, pre: str, names: Dict[str, str]):
        """{layer name: (weight, bias)} of the modules ``names`` maps to
        under ``pre``."""
        return {k: self._pair(sd, pre + v) for k, v in names.items()}

    # ---- forward -------------------------------------------------------
    def forward(self, params: Dict[str, Any], token_ids: torch.Tensor,
                kv_pages: torch.Tensor, metadata: AttentionMetadata,
                collect_hidden: bool = False, input_embeds=None):
        """(logits [S, V] float32 at ``logits_indices``, kv_pages)."""
        if collect_hidden:
            raise NotImplementedError(
                "the LayerNorm-family forward collects no hidden rows (no "
                "EAGLE3 draft head for these targets)")
        eps = self.ln_eps

        def ln(x, p):
            return layer_norm(x, p["w"], p.get("b"), eps)

        h = embed_tokens(params["embed"], token_ids, input_embeds, self.dtype)
        if "wpe" in params:
            h = h + params["wpe"][metadata.positions.long()
                                  + self.pos_offset].to(self.dtype)
        if "embed_ln" in params:
            h = ln(h, params["embed_ln"])
        specs = self.layer_specs
        cos_sin = {s.rope: rope_cos_sin(s.rope, metadata.positions)
                   for s in specs if s.rope is not None}
        L, P, ps = kv_pages.shape[:3]
        kv_flat = kv_pages.view((L * P,) + tuple(kv_pages.shape[2:]))
        for li, (layer, spec) in enumerate(zip(params["layers"], specs)):
            md_l = layer_metadata(metadata, li, P, ps, L)
            x1 = ln(h, layer["ln1"])
            a = attention_block(layer, x1, kv_flat, md_l, spec,
                                self.attn_methods,
                                rope_cos_sin=cos_sin.get(spec.rope),
                                kv_scale=self.kv_scale,
                                alibi_slopes=self.alibi_t)
            if self.parallel_block:
                x2 = x1 if self.shared_ln else ln(h, layer["ln2"])
                h = h + a + self._mlp(layer, x2)
            else:
                x2, h = layer_norm_residual(a, h, layer["ln2"]["w"],
                                            layer["ln2"].get("b"), eps)
                h = h + self._mlp(layer, x2)
        # LayerNorm is row-wise: gather the logits rows first
        last = ln(h[metadata.logits_indices], params["final_norm"])
        logits = self.m_lm_head.apply(params["lm_head"], last).float()
        if self.logit_scale != 1.0:
            logits = logits * self.logit_scale
        return logits, kv_pages

    def _mlp(self, layer: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        m = self.m_mlp
        act = _ACTS[self.act_name]
        if self.gated_mlp:
            g, u = apply_pair(m, layer, "fc_pair", ("fc", "fc2"), x,
                              self.inner)
            a = act(g.float()).to(self.dtype) * u
        else:
            a = act(m.apply(layer["fc"], x).float()).to(self.dtype)
        return m.apply(layer["proj"], a)


def _split_heads(w, heads: int, parts: int, hd: int):
    """A fused per-head [heads * parts * hd, ...] weight or bias -> its
    ``parts`` pieces [heads * hd, ...] (GPT-NeoX's and BLOOM's q|k|v of
    each head side by side)."""
    w = torch.as_tensor(w)
    r = w.reshape((heads, parts, hd) + tuple(w.shape[1:]))
    return [r[:, j].reshape((heads * hd,) + tuple(w.shape[1:]))
            for j in range(parts)]


def _qkv_per_head(sd, name: str, heads: int, hd: int) -> Dict[str, tuple]:
    """{q, k, v: (weight, bias)} of a per-head fused QKV module."""
    ws = _split_heads(sd[name + ".weight"], heads, 3, hd)
    b = sd.get(name + ".bias")
    bs = _split_heads(b, heads, 3, hd) if b is not None else [None] * 3
    return {n: (ws[j], bs[j]) for j, n in enumerate("qkv")}


@register_model("gpt_neox")
class GPTNeoXForCausalLM(LnFamilyModel):
    """Pythia / GPT-NeoX: fused per-head-interleaved QKV, parallel
    residual with a separate MLP norm (``use_parallel_residual``), partial
    rotary."""
    architectures = ("GPTNeoXForCausalLM",)
    act_name = "gelu"

    def __init__(self, model_config):
        self.parallel_block = getattr(model_config.hf_config,
                                      "use_parallel_residual", True)
        super().__init__(model_config)

    def _hf_layer(self, sd, i):
        pre = f"gpt_neox.layers.{i}."
        projs = _qkv_per_head(sd, pre + "attention.query_key_value",
                              self.num_heads, self.head_dim)
        projs.update(self._projs(sd, pre, {
            "o": "attention.dense", "fc": "mlp.dense_h_to_4h",
            "proj": "mlp.dense_4h_to_h"}))
        return ({"ln1": self._pair(sd, pre + "input_layernorm"),
                 "ln2": self._pair(sd, pre + "post_attention_layernorm")},
                projs)

    def _hf_top(self, sd):
        return {"embed": sd["gpt_neox.embed_in.weight"],
                "final_norm": self._pair(sd, "gpt_neox.final_layer_norm"),
                "lm_head": (sd["embed_out.weight"],)}


@register_model("gptj")
class GPTJForCausalLM(LnFamilyModel):
    """GPT-J 6B: parallel block with one shared LN, interleaved partial
    rotary, biased MLP, unbiased attention, lm_head with a bias."""
    architectures = ("GPTJForCausalLM",)
    parallel_block = True
    shared_ln = True
    act_name = "gelu_new"
    attn_bias = False

    @property
    def num_layers(self):
        return self.hf.n_layer

    @property
    def num_kv_heads(self):
        return self.hf.n_head

    @property
    def head_dim(self):
        return self.hf.n_embd // self.hf.n_head

    def _inner_size(self):
        return getattr(self.hf, "n_inner", None) or 4 * self.hf.n_embd

    def _rope_config(self):
        hd = self.head_dim
        return RopeConfig(
            head_dim=hd, rope_theta=10000.0,
            max_position_embeddings=self.hf.n_positions, is_neox=False,
            partial_rotary_factor=(self.hf.rotary_dim or hd) / hd)

    def _hf_layer(self, sd, i):
        pre = f"transformer.h.{i}."
        return ({"ln1": self._pair(sd, pre + "ln_1")},
                self._projs(sd, pre, {
                    "q": "attn.q_proj", "k": "attn.k_proj",
                    "v": "attn.v_proj", "o": "attn.out_proj",
                    "fc": "mlp.fc_in", "proj": "mlp.fc_out"}))

    def _hf_top(self, sd):
        return {"embed": sd["transformer.wte.weight"],
                "final_norm": self._pair(sd, "transformer.ln_f"),
                "lm_head": self._pair(sd, "lm_head")}

    def init_params(self, seed: int = 0):
        params = super().init_params(seed)
        params["lm_head"]["bias"] = torch.zeros(
            self.vocab_size, device=self.device, dtype=self.dtype)
        return params


@register_model("falcon")
class FalconForCausalLM(LnFamilyModel):
    """Falcon: fused grouped QKV, parallel attention, MQA (7B, one norm)
    or GQA with the new decoder's two norms (40B, 180B)."""
    architectures = ("FalconForCausalLM",)
    act_name = "gelu"

    def __init__(self, model_config):
        hf = model_config.hf_config
        if getattr(hf, "alibi", False):
            raise NotImplementedError(
                "Falcon with alibi=True is not supported by this package "
                "(the JAX model applies RoPE to it)")
        self.parallel_block = getattr(hf, "parallel_attn", True)
        self.new_arch = getattr(hf, "new_decoder_architecture", False)
        self.shared_ln = not self.new_arch
        self.attn_bias = self.mlp_bias = getattr(hf, "bias", False)
        super().__init__(model_config)

    @property
    def num_kv_heads(self):
        hf = self.hf
        if getattr(hf, "new_decoder_architecture", False):
            return hf.num_kv_heads
        if getattr(hf, "multi_query", True):
            return 1
        return hf.num_attention_heads

    def _hf_layer(self, sd, i):
        nq, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        pre = f"transformer.h.{i}."
        name = pre + "self_attention.query_key_value"
        projs = {}
        for suffix in ("weight", "bias"):
            t = sd.get(f"{name}.{suffix}")
            if t is None:
                continue
            # grouped layout: [nkv, nq / nkv + 2, hd, ...]
            t = torch.as_tensor(t)
            g = t.reshape((nkv, nq // nkv + 2, hd) + tuple(t.shape[1:]))
            tail = tuple(t.shape[1:])
            projs[suffix] = (g[:, :-2].reshape((nq * hd,) + tail),
                             g[:, -2].reshape((nkv * hd,) + tail),
                             g[:, -1].reshape((nkv * hd,) + tail))
        bias = projs.get("bias", (None,) * 3)
        qkv = {n: (projs["weight"][j], bias[j]) for j, n in enumerate("qkv")}
        qkv.update(self._projs(sd, pre, {
            "o": "self_attention.dense", "fc": "mlp.dense_h_to_4h",
            "proj": "mlp.dense_4h_to_h"}))
        if self.new_arch:
            norms = {"ln1": self._pair(sd, pre + "ln_attn"),
                     "ln2": self._pair(sd, pre + "ln_mlp")}
        else:
            norms = {"ln1": self._pair(sd, pre + "input_layernorm")}
        return norms, qkv

    def _hf_top(self, sd):
        wte = sd["transformer.word_embeddings.weight"]
        return {"embed": wte,
                "final_norm": self._pair(sd, "transformer.ln_f"),
                "lm_head": (sd.get("lm_head.weight", wte),)}


_LLAMA_NAMES = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
                "v": "self_attn.v_proj", "o": "self_attn.o_proj"}


@register_model("starcoder2")
class Starcoder2ForCausalLM(LnFamilyModel):
    """StarCoder2: Llama's module names, LayerNorm and a plain tanh-GELU
    MLP, biased projections, a sliding window on every layer."""
    architectures = ("Starcoder2ForCausalLM",)
    act_name = "gelu_pytorch_tanh"

    def __init__(self, model_config):
        super().__init__(model_config)
        sw = getattr(self.hf, "sliding_window", None)
        if sw:
            self.attn_spec = dataclasses.replace(self.attn_spec,
                                                 sliding_window=sw)

    def _hf_layer(self, sd, i):
        pre = f"model.layers.{i}."
        return ({"ln1": self._pair(sd, pre + "input_layernorm"),
                 "ln2": self._pair(sd, pre + "post_attention_layernorm")},
                self._projs(sd, pre, dict(_LLAMA_NAMES, fc="mlp.c_fc",
                                          proj="mlp.c_proj")))

    def _hf_top(self, sd):
        wte = sd["model.embed_tokens.weight"]
        return {"embed": wte,
                "final_norm": self._pair(sd, "model.norm"),
                "lm_head": (sd.get("lm_head.weight", wte),)}


@register_model("cohere")
class CohereForCausalLM(LnFamilyModel):
    """Cohere Command-R: parallel attention + MLP behind one bias-free
    LayerNorm, gated SiLU MLP, interleaved RoPE, tied embeddings, logits
    times ``logit_scale``."""
    architectures = ("CohereForCausalLM",)
    parallel_block = True
    shared_ln = True
    gated_mlp = True
    act_name = "silu"
    attn_bias = False
    mlp_bias = False
    ln_bias = False

    def __init__(self, model_config):
        super().__init__(model_config)
        if getattr(self.hf, "use_qk_norm", False):
            raise NotImplementedError("cohere use_qk_norm not supported")
        self.logit_scale = getattr(self.hf, "logit_scale", 1.0)

    def _rope_config(self):
        theta = RopeConfig.from_hf_config(self.hf, self.head_dim).rope_theta
        return RopeConfig(
            head_dim=self.head_dim, rope_theta=theta,
            max_position_embeddings=self.hf.max_position_embeddings,
            is_neox=False)

    def _hf_layer(self, sd, i):
        pre = f"model.layers.{i}."
        return ({"ln1": self._pair(sd, pre + "input_layernorm")},
                self._projs(sd, pre, dict(
                    _LLAMA_NAMES, fc="mlp.gate_proj", fc2="mlp.up_proj",
                    proj="mlp.down_proj")))

    def _hf_top(self, sd):
        wte = sd["model.embed_tokens.weight"]
        return {"embed": wte, "final_norm": (sd["model.norm.weight"],),
                "lm_head": (sd.get("lm_head.weight", wte),)}


@register_model("nemotron")
class NemotronForCausalLM(LnFamilyModel):
    """Nemotron: layernorm1p (weight + 1, folded at load), squared-ReLU
    plain MLP, partial rotary, no projection biases."""
    architectures = ("NemotronForCausalLM",)
    act_name = "relu2"
    attn_bias = False
    mlp_bias = False

    def _rope_config(self):
        hf = self.hf
        pct = getattr(hf, "partial_rotary_factor",
                      getattr(hf, "rope_percent", 0.5))
        return dataclasses.replace(
            RopeConfig.from_hf_config(hf, self.head_dim),
            scaling_type="none", partial_rotary_factor=pct)

    def _ln1p(self, sd, name):
        """(weight + 1 in float32, bias) of a layernorm1p module."""
        w, b = self._pair(sd, name)
        return torch.as_tensor(w).float() + 1.0, b

    def _hf_layer(self, sd, i):
        pre = f"model.layers.{i}."
        return ({"ln1": self._ln1p(sd, pre + "input_layernorm"),
                 "ln2": self._ln1p(sd, pre + "post_attention_layernorm")},
                self._projs(sd, pre, dict(_LLAMA_NAMES, fc="mlp.up_proj",
                                          proj="mlp.down_proj")))

    def _hf_top(self, sd):
        w, b = self._ln1p(sd, "model.norm")
        return {"embed": sd["model.embed_tokens.weight"],
                "final_norm": (w, b if b is not None
                               else torch.zeros(self.hidden_size)),
                "lm_head": (sd["lm_head.weight"],)}


@register_model("cohere2")
class Cohere2ForCausalLM(CohereForCausalLM):
    """Cohere2 (Command-R7B): the Cohere block with sliding layers (three
    of four, ``layer_types``) that rotate, and global layers without a
    rotary embedding (NoPE)."""
    architectures = ("Cohere2ForCausalLM",)

    def __init__(self, model_config):
        super().__init__(model_config)
        hf = self.hf
        sw = getattr(hf, "sliding_window", None)
        self.layer_sliding = [
            lt == "sliding_attention"
            for lt in (getattr(hf, "layer_types", None) or
                       ["full_attention"] * self.num_layers)
        ][:self.num_layers]
        if sw and any(self.layer_sliding):
            self.sliding_spec = dataclasses.replace(self.attn_spec,
                                                    sliding_window=sw)

    @property
    def layer_specs(self) -> List[AttentionSpec]:
        """Sliding layers: the window and RoPE; global layers: neither
        (with no sliding layer at all, every layer rotates)."""
        if self.sliding_spec is None:
            return [self.attn_spec] * self.num_layers
        nope = dataclasses.replace(self.attn_spec, rope=None)
        return [self.sliding_spec if s else nope
                for s in self.layer_sliding]


@register_model("stablelm")
class StableLmForCausalLM(LnFamilyModel):
    """StableLM: biased LayerNorm, gated SiLU MLP, partial rotary (0.25 by
    default), q/k/v biases where the checkpoint has them."""
    architectures = ("StableLmForCausalLM",)
    gated_mlp = True
    act_name = "silu"
    attn_bias = False
    mlp_bias = False

    def __init__(self, model_config):
        hf = model_config.hf_config
        for knob in ("use_parallel_residual", "qk_layernorm"):
            if getattr(hf, knob, False):
                raise NotImplementedError(
                    f"StableLM with {knob}=True is not supported by this "
                    "package (the JAX model ignores it)")
        super().__init__(model_config)

    def _rope_config(self):
        hf = self.hf
        return dataclasses.replace(
            RopeConfig.from_hf_config(hf, self.head_dim),
            scaling_type="none",
            partial_rotary_factor=getattr(hf, "partial_rotary_factor",
                                          0.25))

    def _hf_layer(self, sd, i):
        pre = f"model.layers.{i}."
        return ({"ln1": self._pair(sd, pre + "input_layernorm"),
                 "ln2": self._pair(sd, pre + "post_attention_layernorm")},
                self._projs(sd, pre, dict(
                    _LLAMA_NAMES, fc="mlp.gate_proj", fc2="mlp.up_proj",
                    proj="mlp.down_proj")))

    def _hf_top(self, sd):
        wte = sd["model.embed_tokens.weight"]
        return {"embed": wte, "final_norm": self._pair(sd, "model.norm"),
                "lm_head": (sd.get("lm_head.weight", wte),)}


@register_model("bloom")
class BloomForCausalLM(LnFamilyModel):
    """BLOOM: ALiBi attention (no rotary embedding, no positions), a
    LayerNorm after the embedding, per-head fused QKV, biased projections,
    tanh-GELU MLP, tied head."""
    architectures = ("BloomForCausalLM",)
    act_name = "gelu_pytorch_tanh"

    def __init__(self, model_config):
        if getattr(model_config.hf_config,
                   "apply_residual_connection_post_layernorm", False):
            raise NotImplementedError(
                "BLOOM with apply_residual_connection_post_layernorm=True "
                "is not supported by this package (the JAX model ignores "
                "it)")
        super().__init__(model_config)
        self._use_alibi()

    def _rope_config(self):
        return None

    def _init_extra(self, mat, norm):
        return {"embed_ln": self._ln(*norm())}

    def _hf_layer(self, sd, i):
        pre = f"transformer.h.{i}."
        projs = _qkv_per_head(sd, pre + "self_attention.query_key_value",
                              self.num_heads, self.head_dim)
        projs.update(self._projs(sd, pre, {
            "o": "self_attention.dense", "fc": "mlp.dense_h_to_4h",
            "proj": "mlp.dense_4h_to_h"}))
        return ({"ln1": self._pair(sd, pre + "input_layernorm"),
                 "ln2": self._pair(sd, pre + "post_attention_layernorm")},
                projs)

    def _hf_top(self, sd):
        wte = sd["transformer.word_embeddings.weight"]
        return {"embed": wte,
                "embed_ln": self._pair(
                    sd, "transformer.word_embeddings_layernorm"),
                "final_norm": self._pair(sd, "transformer.ln_f"),
                "lm_head": (sd.get("lm_head.weight", wte),)}


@register_model("mpt")
class MptForCausalLM(LnFamilyModel):
    """MPT: ALiBi, bias-free LayerNorm and projections, fused Wqkv, GELU
    MLP, tied head."""
    architectures = ("MptForCausalLM", "MPTForCausalLM")
    act_name = "gelu"
    attn_bias = False
    mlp_bias = False
    ln_bias = False

    def __init__(self, model_config):
        super().__init__(model_config)
        self._use_alibi()

    def _inner_size(self):
        return getattr(self.hf, "expansion_ratio", 4) * self.hf.hidden_size

    @property
    def num_kv_heads(self):
        # attn_config may set kv_n_heads (grouped); MHA by default
        ac = getattr(self.hf, "attn_config", None)
        kv = ac.get("kv_n_heads") if isinstance(ac, dict) else \
            getattr(ac, "kv_n_heads", None)
        return kv or self.hf.num_attention_heads

    def _ln_eps(self):
        return getattr(self.hf, "layer_norm_epsilon", 1e-5)

    def _rope_config(self):
        return None

    def _hf_layer(self, sd, i):
        nq, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        pre = f"transformer.blocks.{i}."
        w = torch.as_tensor(sd[pre + "attn.Wqkv.weight"])
        q, k, v = w.split([nq * hd, nkv * hd, nkv * hd])
        projs = {"q": (q, None), "k": (k, None), "v": (v, None)}
        projs.update(self._projs(sd, pre, {
            "o": "attn.out_proj", "fc": "ffn.up_proj",
            "proj": "ffn.down_proj"}))
        return ({"ln1": self._pair(sd, pre + "norm_1"),
                 "ln2": self._pair(sd, pre + "norm_2")}, projs)

    def _hf_top(self, sd):
        wte = sd["transformer.wte.weight"]
        return {"embed": wte,
                "final_norm": self._pair(sd, "transformer.norm_f"),
                "lm_head": (sd.get("lm_head.weight", wte),)}


@register_model("opt")
class OPTForCausalLM(LnFamilyModel):
    """OPT: learned positions at offset +2, biased projections, ReLU MLP,
    pre-LN, tied head."""
    architectures = ("OPTForCausalLM",)
    act_name = "relu"

    def __init__(self, model_config):
        hf = model_config.hf_config
        if not getattr(hf, "do_layer_norm_before", True) or \
                getattr(hf, "word_embed_proj_dim", hf.hidden_size) \
                != hf.hidden_size:
            raise NotImplementedError(
                "OPT with do_layer_norm_before=False or a "
                "word_embed_proj_dim other than hidden_size (OPT-350m) is "
                "not supported by this package (the JAX model ignores "
                "both)")
        super().__init__(model_config)
        self.pos_offset = 2

    def _inner_size(self):
        return self.hf.ffn_dim

    def _ln_eps(self):
        return 1e-5

    def _rope_config(self):
        return None

    def _init_extra(self, mat, norm):
        return {"wpe": mat(self.hf.max_position_embeddings + 2,
                           self.hidden_size)}

    def _prepare(self, sd):
        return strip_prefix(sd, "model.")

    def _hf_layer(self, sd, i):
        pre = f"decoder.layers.{i}."
        return ({"ln1": self._pair(sd, pre + "self_attn_layer_norm"),
                 "ln2": self._pair(sd, pre + "final_layer_norm")},
                self._projs(sd, pre, {
                    "q": "self_attn.q_proj", "k": "self_attn.k_proj",
                    "v": "self_attn.v_proj", "o": "self_attn.out_proj",
                    "fc": "fc1", "proj": "fc2"}))

    def _hf_top(self, sd):
        wte = sd["decoder.embed_tokens.weight"]
        return {"embed": wte, "wpe": sd["decoder.embed_positions.weight"],
                "final_norm": self._pair(sd, "decoder.final_layer_norm"),
                "lm_head": (sd.get("lm_head.weight", wte),)}
