"""GraniteMoeHybrid (Granite 4.0-H): Bamba's Mamba2 and attention layers
with an MoE plus a shared MLP after each, and Granite's multipliers.

Port of ``tensorrt_llm_tpu/models/granite_hybrid.py``: attention without
a rotary embedding unless ``position_embedding_type == "rope"``, scaled
by ``attention_multiplier``; the embedding times
``embedding_multiplier``; every residual add times
``residual_multiplier``; the logits divided by ``logits_scaling``. The
MoE (packed ``input_linear`` / ``output_linear`` experts, a softmax top-k
renormalised router) runs on ops/moe.py's routes; the shared MLP is a
gated SiLU MLP. Layer parameters: Bamba's, with router / w_gate_up /
w_down (when the config has experts) and s_gate_up / s_down.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..ops.moe import moe_mlp
from ..ops.norm import rms_norm
from ..ops.rope import RopeConfig
from .bamba import BambaForCausalLM
from .modeling_utils import embed_tokens, register_model


@register_model("granitemoehybrid")
class GraniteMoeHybridForCausalLM(BambaForCausalLM):
    architectures = ("GraniteMoeHybridForCausalLM",)
    hf_class = "GraniteMoeHybridForCausalLM"
    _NORMS = ("input_layernorm", "post_attention_layernorm")

    def __init__(self, model_config):
        super().__init__(model_config)
        hf = self.hf
        self.num_experts = getattr(hf, "num_local_experts", 0)
        self.top_k = getattr(hf, "num_experts_per_tok", 0)
        self.shared_inter = getattr(hf, "shared_intermediate_size", 0)
        self.embedding_multiplier = getattr(hf, "embedding_multiplier", 1.0)
        self.residual_multiplier = getattr(hf, "residual_multiplier", 1.0)
        self.logits_scaling = getattr(hf, "logits_scaling", 1.0)

    def _layer_types(self):
        return list(self.hf.layer_types)

    def _sm_scale(self) -> float:
        return getattr(self.hf, "attention_multiplier", None) or \
            super()._sm_scale()

    def _rope(self):
        if getattr(self.hf, "position_embedding_type", None) != "rope":
            return None
        return RopeConfig.from_hf_config(self.hf, self.head_dim)

    def _final_norm_name(self) -> str:
        return "model.norm.weight"

    def _widest(self) -> int:
        return max(self.geom.in_width, 2 * self.shared_inter,
                   2 * self.hf.intermediate_size * max(self.top_k, 1))

    def _mlp_params(self, sd, lp: str) -> Dict[str, Any]:
        """The MoE's packed experts (``block_sparse_moe``) and the shared
        MLP of the layer at prefix ``lp``."""
        out = {}
        b = lp + "block_sparse_moe."
        if self.num_experts and b + "input_linear.weight" in sd:
            w_in = self._t(sd[b + "input_linear.weight"])    # [E, 2I, H]
            out["router"] = self._t(sd[b + "router.layer.weight"])
            out["w_gate_up"] = w_in.transpose(1, 2).contiguous()
            out["w_down"] = self._t(
                sd[b + "output_linear.weight"]).transpose(1, 2).contiguous()
        s = lp + "shared_mlp."
        w_in = torch.as_tensor(sd[s + "input_linear.weight"])
        out["s_gate_up"] = self._lin(w_in)
        out["s_down"] = self._lin(sd[s + "output_linear.weight"])
        return out

    def _ff(self, layer, x):
        out = self._gated_mlp(layer, x, fused="s_gate_up", down="s_down")
        if "router" in layer:
            out = out + moe_mlp(x, layer["w_gate_up"], layer["w_down"],
                                layer["router"], self.top_k)
        return out

    def forward(self, params, token_ids, kv_pages, metadata,
                collect_hidden: bool = False, collect_kv_stats: bool = False,
                input_embeds=None):
        self._check_slots(metadata)
        eps, rm = self.eps, self.residual_multiplier
        h = embed_tokens(params["embed"], token_ids, input_embeds, self.dtype)
        if self.embedding_multiplier != 1.0:
            h = h * self.embedding_multiplier
        for i, layer in enumerate(params["layers"]):
            h = h + rm * self._mixer(layer, rms_norm(h, layer["norm"], eps),
                                     kv_pages, metadata, i)
            h = h + rm * self._ff(layer, rms_norm(h, layer["ff_norm"], eps))
        return self._finish(h, params, metadata, collect_hidden, kv_pages,
                            eps, self.logits_scaling)
