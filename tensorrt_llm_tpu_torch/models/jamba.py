"""Jamba: Mamba-1 and attention layers with dense and MoE MLPs at their
periods.

Port of ``tensorrt_llm_tpu/models/jamba.py``: layer i is attention when
``i % attn_layer_period == attn_layer_offset`` (no positional encoding),
else a Mamba-1 mixer (models/mamba.py) with weighted RMS norms on dt, B
and C; its MLP is an MoE when ``i % expert_layer_period ==
expert_layer_offset`` (softmax top-k, the chosen weights not
renormalised), else a dense gated SiLU MLP. The JAX model scans over
periods; here a Python loop walks the layers, the attention layers
through ``attention_block`` (K1/K2 on CUDA).

Layer parameters: norm, ff_norm, the mixer's (``load_mamba_layer`` plus
dt_ln, b_ln, c_ln) or the attention's (qkv or q/k/v, o), and router /
w_gate_up / w_down or gate_up / down.
"""
from __future__ import annotations

import math
from typing import Any, Dict

from ..ops.moe import moe_mlp
from ..ops.norm import rms_norm
from .mamba import load_mamba_layer, mamba_mixer
from .modeling_utils import AttentionSpec, embed_tokens, register_model
from .recurrent import RecurrentModel, stack_experts


@register_model("jamba")
class JambaForCausalLM(RecurrentModel):
    architectures = ("JambaForCausalLM",)
    hf_class = "JambaForCausalLM"

    def __init__(self, model_config):
        super().__init__(model_config)
        hf = self.hf
        self.num_heads = hf.num_attention_heads
        self.eps = getattr(hf, "rms_norm_eps", 1e-6)
        self.top_k = hf.num_experts_per_tok
        self.inner = hf.mamba_expand * hf.hidden_size
        self.state_size = hf.mamba_d_state
        self.conv_kernel = hf.mamba_d_conv
        self.dt_rank = hf.mamba_dt_rank if hf.mamba_dt_rank != "auto" \
            else math.ceil(hf.hidden_size / 16)
        L = hf.num_hidden_layers
        self._set_blocks([
            self.ATTENTION if i % hf.attn_layer_period ==
            hf.attn_layer_offset else "mamba" for i in range(L)])
        self.is_moe = [i % hf.expert_layer_period == hf.expert_layer_offset
                       for i in range(L)]
        self.attn_spec = AttentionSpec(
            num_heads=self.num_heads, num_kv_heads=self.num_kv_heads,
            head_dim=self.head_dim, sm_scale=1.0 / math.sqrt(self.head_dim),
            rope=None)

    def state_shapes(self):
        return {"conv_state": (self.n_state, (self.inner,
                                              self.conv_kernel - 1)),
                "ssm_state": (self.n_state, (self.inner, self.state_size))}

    def _widest(self) -> int:
        return max(2 * self.inner,
                   2 * self.hf.intermediate_size * self.top_k)

    def load_hf_state_dict(self, sd) -> Dict[str, Any]:
        layers = []
        for i, bt in enumerate(self.block_types):
            p = f"model.layers.{i}."
            if bt == self.ATTENTION:
                a = p + "self_attn."
                layer = {**self._pair("qkv", ("q", "k", "v"), [
                    sd[a + n + "_proj.weight"] for n in "qkv"]),
                    "o": self._lin(sd[a + "o_proj.weight"])}
            else:
                m = p + "mamba."
                layer = load_mamba_layer(self, sd, m)
                for n, k in (("dt_ln", "dt_layernorm"), ("b_ln", "b_layernorm"),
                             ("c_ln", "c_layernorm")):
                    layer[n] = self._t(sd[m + k + ".weight"])
            layer["norm"] = self._t(sd[p + "input_layernorm.weight"])
            layer["ff_norm"] = self._t(sd[p + "pre_ff_layernorm.weight"])
            f = p + "feed_forward."
            if self.is_moe[i]:
                layer["router"] = self._t(sd[f + "router.weight"])
                layer["w_gate_up"], layer["w_down"] = stack_experts(
                    self, sd, f + "experts.", self.hf.num_experts)
            else:
                layer.update(self._pair("gate_up", ("gate", "up"), [
                    sd[f + "gate_proj.weight"], sd[f + "up_proj.weight"]]))
                layer["down"] = self._lin(sd[f + "down_proj.weight"])
            layers.append(layer)
        return {"layers": layers, **self._head(
            sd, "model.embed_tokens.weight",
            "model.final_layernorm.weight")}

    def forward(self, params, token_ids, kv_pages, metadata,
                collect_hidden: bool = False, collect_kv_stats: bool = False,
                input_embeds=None):
        self._check_slots(metadata)
        eps = self.eps
        m = self._method("mlp")
        h = embed_tokens(params["embed"], token_ids, input_embeds, self.dtype)
        for i, layer in enumerate(params["layers"]):
            x = rms_norm(h, layer["norm"], eps)
            if self.block_types[i] == self.ATTENTION:
                h = h + self._attention(layer, x, kv_pages, metadata, i,
                                        self.attn_spec)
            else:
                h = h + mamba_mixer(
                    layer, x, self._state(kv_pages, "conv_state", i),
                    self._state(kv_pages, "ssm_state", i), metadata,
                    self.inner, self.dt_rank, self.state_size, m, self.dtype,
                    bcdt_norm_eps=eps)
            x = rms_norm(h, layer["ff_norm"], eps)
            if self.is_moe[i]:
                h = h + moe_mlp(x, layer["w_gate_up"], layer["w_down"],
                                layer["router"], self.top_k,
                                renormalize=False)
            else:
                h = h + self._gated_mlp(layer, x)
        return self._finish(h, params, metadata, collect_hidden, kv_pages,
                            eps)
