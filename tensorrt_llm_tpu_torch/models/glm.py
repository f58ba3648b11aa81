"""GLM and GLM-4 decoders (GlmForCausalLM, Glm4ForCausalLM).

Port of ``tensorrt_llm_tpu/models/glm.py``: the Llama trunk with the
checkpoint's packed ``mlp.gate_up_proj`` split at load, q/k/v biases,
and partial (``partial_rotary_factor``, 0.5 by default) interleaved
(gpt-j style) rotary embeddings; GLM-4 adds the sandwich norms
(``post_self_attn_layernorm`` and ``post_mlp_layernorm`` on the
sublayers' outputs, ``norm_placement="sandwich"``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from ..ops.rope import RopeConfig
from .llama import LlamaForCausalLM
from .modeling_utils import register_model


@register_model("glm")
class GlmForCausalLM(LlamaForCausalLM):
    architectures = ("GlmForCausalLM",)

    def __init__(self, model_config):
        super().__init__(model_config)
        hf = self.hf
        rope = RopeConfig.from_hf_config(hf, self.head_dim)
        self.attn_spec = dataclasses.replace(
            self.attn_spec, is_neox=False,
            rope=dataclasses.replace(
                rope, is_neox=False, partial_rotary_factor=getattr(
                    hf, "partial_rotary_factor", 0.5)))

    def _hf_weight(self, sd: Mapping[str, Any], prefix: str, name: str):
        packed = prefix + "mlp.gate_up_proj.weight"
        if name in ("gate", "up") and packed in sd:
            w, I = sd[packed], self.intermediate_size
            return w[:I] if name == "gate" else w[I:]
        return super()._hf_weight(sd, prefix, name)


@register_model("glm4")
class Glm4ForCausalLM(GlmForCausalLM):
    architectures = ("Glm4ForCausalLM",)
    _HF_MODULES = dict(LlamaForCausalLM._HF_MODULES,
                       post_attn_extra="post_self_attn_layernorm",
                       post_mlp_extra="post_mlp_layernorm")
    _extra_norms = ("post_attn_extra", "post_mlp_extra")

    def __init__(self, model_config):
        super().__init__(model_config)
        self.norm_placement = "sandwich"
