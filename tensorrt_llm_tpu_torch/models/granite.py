"""IBM Granite decoder.

Port of ``tensorrt_llm_tpu/models/granite.py``: the Llama trunk with the
four scalar multipliers of its muP-style parameterization:
``embedding_multiplier`` (scales the embeddings), ``attention_multiplier``
(the softmax scale, in place of 1/sqrt(head_dim)), ``residual_multiplier``
(scales each sublayer's output before the residual add) and
``logits_scaling`` (divides the final logits).
"""
from __future__ import annotations

import dataclasses

from .llama import LlamaForCausalLM
from .modeling_utils import register_model


def set_granite_multipliers(model: LlamaForCausalLM) -> None:
    """Set the four multipliers of ``model``'s config on the Llama trunk
    (Granite and Granite-MoE, models/granite_moe.py)."""
    hf = model.hf
    model.embedding_multiplier = getattr(hf, "embedding_multiplier", 1.0)
    model.residual_multiplier = getattr(hf, "residual_multiplier", 1.0)
    model.logits_scaling = getattr(hf, "logits_scaling", 1.0)
    am = getattr(hf, "attention_multiplier", None)
    if am is not None:
        model.attn_spec = dataclasses.replace(model.attn_spec, sm_scale=am)


@register_model("granite")
class GraniteForCausalLM(LlamaForCausalLM):
    architectures = ("GraniteForCausalLM",)

    def __init__(self, model_config):
        super().__init__(model_config)
        set_granite_multipliers(self)
