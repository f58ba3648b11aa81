"""Bamba: Mamba2 and attention layers, each followed by a dense gated MLP
(IBM's Bamba-9B).

Port of ``tensorrt_llm_tpu/models/bamba.py``. Every layer is pre-norm
(``input_layernorm``), a Mamba2 mixer (models/mamba2.py) or GQA
attention with partial rotary embedding, then a pre-norm
(``pre_ff_layernorm``) SiLU-gated MLP. The JAX model scans runs of
same-type layers (bamba.py:52-63); here a Python loop walks the layers,
and each attention layer goes through ``attention_block`` onto its layer
of the KV pool: K1/K2 on CUDA.

Layer parameters: norm, ff_norm, gate_up, down, and the mixer's
(``load_mamba2_layer``) or the attention's (qkv or q/k/v, o).
"""
from __future__ import annotations

import math
from typing import Any, Dict

from ..ops.norm import rms_norm
from ..ops.rope import RopeConfig
from .mamba2 import load_mamba2_layer, mamba2_geom, mamba2_mixer
from .modeling_utils import AttentionSpec, register_model
from .recurrent import RecurrentModel


@register_model("bamba")
class BambaForCausalLM(RecurrentModel):
    architectures = ("BambaForCausalLM",)
    hf_class = "BambaForCausalLM"
    # the checkpoint's names of a layer's two norms and its MLP
    _NORMS = ("input_layernorm", "pre_ff_layernorm")

    def __init__(self, model_config):
        super().__init__(model_config)
        hf = self.hf
        self.num_heads = hf.num_attention_heads
        self.eps = getattr(hf, "rms_norm_eps", 1e-5)
        inner = int(hf.mamba_expand * hf.hidden_size)
        self.geom = mamba2_geom(
            hf, inner, hf.mamba_n_heads,
            getattr(hf, "mamba_d_head", None) or inner // hf.mamba_n_heads,
            hf.mamba_n_groups, hf.mamba_d_state, hf.mamba_d_conv, self.eps)
        self._set_blocks(self._layer_types())
        self.attn_spec = AttentionSpec(
            num_heads=self.num_heads, num_kv_heads=self.num_kv_heads,
            head_dim=self.head_dim, sm_scale=self._sm_scale(),
            rope=self._rope())

    def _layer_types(self):
        return list(self.hf.layers_block_type)

    def _sm_scale(self) -> float:
        return 1.0 / math.sqrt(self.head_dim)

    def _rope(self):
        return RopeConfig.from_hf_config(self.hf, self.head_dim)

    def state_shapes(self):
        return self.geom.state_shapes(self.n_state)

    def _widest(self) -> int:
        return max(self.geom.in_width, 2 * self.hf.intermediate_size)

    # ------------------------------------------------------------------ #
    def _mlp_params(self, sd, lp: str) -> Dict[str, Any]:
        """The MLP of the layer at prefix ``lp``."""
        p = lp + "feed_forward."
        return {**self._pair("gate_up", ("gate", "up"),
                             [sd[p + "gate_proj.weight"],
                              sd[p + "up_proj.weight"]]),
                "down": self._lin(sd[p + "down_proj.weight"])}

    def _attn_params(self, sd, a: str) -> Dict[str, Any]:
        return {**self._pair("qkv", ("q", "k", "v"),
                             [sd[a + n + "_proj.weight"] for n in "qkv"]),
                "o": self._lin(sd[a + "o_proj.weight"])}

    def load_hf_state_dict(self, sd) -> Dict[str, Any]:
        n_in, n_ff = self._NORMS
        layers = []
        for i, bt in enumerate(self.block_types):
            p = f"model.layers.{i}."
            if bt == self.ATTENTION:
                layer = self._attn_params(sd, p + "self_attn.")
            else:
                layer = load_mamba2_layer(self, sd, p + "mamba")
            layer["norm"] = self._t(sd[p + n_in + ".weight"])
            layer["ff_norm"] = self._t(sd[p + n_ff + ".weight"])
            layer.update(self._mlp_params(sd, p))
            layers.append(layer)
        return {"layers": layers, **self._head(
            sd, "model.embed_tokens.weight", self._final_norm_name())}

    def _final_norm_name(self) -> str:
        return "model.final_layernorm.weight"

    # ------------------------------------------------------------------ #
    def _mixer(self, layer, x, kv_pages, metadata, i: int):
        """Layer ``i``'s token mixer on its normed input."""
        if self.block_types[i] == self.ATTENTION:
            return self._attention(layer, x, kv_pages, metadata, i,
                                   self.attn_spec)
        return mamba2_mixer(layer, x,
                            self._state(kv_pages, "conv_state", i),
                            self._state(kv_pages, "ssm_state", i),
                            metadata, self.geom, self._method("mlp"),
                            self.dtype)

    def _ff(self, layer, x):
        return self._gated_mlp(layer, x)

    def forward(self, params, token_ids, kv_pages, metadata,
                collect_hidden: bool = False, collect_kv_stats: bool = False):
        self._check_slots(metadata)
        eps = self.eps
        h = params["embed"][token_ids].to(self.dtype)
        for i, layer in enumerate(params["layers"]):
            h = h + self._mixer(layer, rms_norm(h, layer["norm"], eps),
                                kv_pages, metadata, i)
            h = h + self._ff(layer, rms_norm(h, layer["ff_norm"], eps))
        return self._finish(h, params, metadata, collect_hidden, kv_pages,
                            eps)
