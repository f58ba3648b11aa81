"""Llama-family decoder (Llama 2/3, TinyLlama, Mistral).

Port of ``tensorrt_llm_tpu/models/llama.py`` (``LlamaForCausalLM``):
pre-norm blocks of paged attention and a gated-SiLU MLP. The JAX version
scans one stacked layer body; here a Python loop walks a list of per-layer
parameter dicts. The KV pool stays one flat all-layers pool in which
layer l's pages sit at ``l*P + i`` (ops/attention.py layer_metadata), and
each layer's KV append updates it in place.

Parameters (weights in PyTorch's [out, in] layout):
  embed [V, H]; final_norm [H]; lm_head {"weight": [V, H]} (the embed
  tensor itself when embeddings are tied); layers[l] = {input_norm,
  post_norm, qkv {"weight": [(nq+2nkv)*hd, H]}, o, gate_up
  {"weight": [2I, H]}, down}.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import torch
import torch.nn.functional as F

from ..ops.attention import AttentionMetadata, layer_metadata
from ..ops.linear import LinearMethod
from ..ops.norm import rms_norm
from ..ops.rope import RopeConfig, rope_cos_sin
from .modeling_utils import (AttentionSpec, DecoderModelForCausalLM,
                             ModelConfig, attention_block, register_model)


@register_model("llama", "mistral", "tinyllama")
class LlamaForCausalLM(DecoderModelForCausalLM):
    architectures = ("LlamaForCausalLM", "MistralForCausalLM")

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
            sliding_window=getattr(hf, "sliding_window", None),
            is_neox=True)
        self.linear = LinearMethod()

    # ------------------------------------------------------------------ #
    # Parameters
    # ------------------------------------------------------------------ #
    def init_params(self, seed: int = 0) -> Dict[str, Any]:
        """Random weights (load_format="dummy"): normal(0, 0.02) matrices
        and unit norms, drawn on the target device from a seeded
        ``torch.Generator``."""
        H, V, I = self.hidden_size, self.vocab_size, self.intermediate_size
        nq, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        dev, dt = self.device, self.dtype
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def mat(*shape):
            return (torch.randn(shape, generator=gen, device=dev,
                                dtype=torch.float32) * 0.02).to(dt)

        def ones():
            return torch.ones(H, device=dev, dtype=dt)

        layers = [{
            "input_norm": ones(), "post_norm": ones(),
            "qkv": {"weight": mat((nq + 2 * nkv) * hd, H)},
            "o": {"weight": mat(H, nq * hd)},
            "gate_up": {"weight": mat(2 * I, H)},
            "down": {"weight": mat(H, I)},
        } for _ in range(self.num_layers)]
        embed = mat(V, H)
        lm_head = embed if self.tie_embeddings else mat(V, H)
        return {"embed": embed, "layers": layers, "final_norm": ones(),
                "lm_head": {"weight": lm_head}}

    def load_hf_state_dict(self, sd: Mapping[str, Any]) -> Dict[str, Any]:
        """HF checkpoint names -> parameter dict (tensors or numpy arrays
        in, tensors of the model's dtype on its device out)."""
        dev, dt = self.device, self.dtype

        def t(name):
            return torch.as_tensor(sd[name]).to(device=dev, dtype=dt)

        def cat(*names):
            return torch.cat([t(n) for n in names], dim=0).contiguous()

        layers = []
        for i in range(self.num_layers):
            p = f"model.layers.{i}."
            layers.append({
                "input_norm": t(p + "input_layernorm.weight"),
                "post_norm": t(p + "post_attention_layernorm.weight"),
                "qkv": {"weight": cat(p + "self_attn.q_proj.weight",
                                      p + "self_attn.k_proj.weight",
                                      p + "self_attn.v_proj.weight")},
                "o": {"weight": t(p + "self_attn.o_proj.weight")},
                "gate_up": {"weight": cat(p + "mlp.gate_proj.weight",
                                          p + "mlp.up_proj.weight")},
                "down": {"weight": t(p + "mlp.down_proj.weight")},
            })
        embed = t("model.embed_tokens.weight")
        lm_head = embed if self.tie_embeddings or "lm_head.weight" not in sd \
            else t("lm_head.weight")
        return {"embed": embed, "layers": layers,
                "final_norm": t("model.norm.weight"),
                "lm_head": {"weight": lm_head}}

    # ------------------------------------------------------------------ #
    # Forward
    # ------------------------------------------------------------------ #
    def forward(self, params: Dict[str, Any], token_ids: torch.Tensor,
                kv_pages: torch.Tensor, metadata: AttentionMetadata):
        spec, eps, lin = self.attn_spec, self.rms_eps, self.linear
        inter = self.intermediate_size
        h = params["embed"][token_ids].to(self.dtype)
        cos_sin = rope_cos_sin(spec.rope, metadata.positions)
        L, P, ps = kv_pages.shape[:3]
        kv_flat = kv_pages.view((L * P,) + tuple(kv_pages.shape[2:]))
        for li, layer in enumerate(params["layers"]):
            md_l = layer_metadata(metadata, li, P, ps, L)
            x = rms_norm(h, layer["input_norm"], eps)
            h = h + attention_block(layer, x, kv_flat, md_l, spec, lin,
                                    rope_cos_sin=cos_sin)
            normed = rms_norm(h, layer["post_norm"], eps)
            gate, up = lin.apply(layer["gate_up"], normed).split(inter, -1)
            act = F.silu(gate.float()).to(self.dtype) * up
            h = h + lin.apply(layer["down"], act)
        # RMSNorm is row-wise: gather the logits rows first, then norm
        last = rms_norm(h[metadata.logits_indices], params["final_norm"], eps)
        logits = lin.apply(params["lm_head"], last).float()
        return logits, kv_pages
