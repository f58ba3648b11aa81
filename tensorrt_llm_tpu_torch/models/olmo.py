"""AI2 OLMo 2 decoder.

Port of ``tensorrt_llm_tpu/models/olmo.py``: the Llama trunk with the RMS
norms on the sublayers' outputs (``norm_placement="post"``: the
checkpoint's ``post_attention_layernorm`` after attention, its
``post_feedforward_layernorm`` after the MLP) and one RMS norm of q and
one of k over the whole projection before RoPE (``qk_norm_full``).
"""
from __future__ import annotations

from .llama import LlamaForCausalLM
from .modeling_utils import register_model


@register_model("olmo2")
class Olmo2ForCausalLM(LlamaForCausalLM):
    architectures = ("Olmo2ForCausalLM",)
    _NORM_NAMES = ("post_attention_layernorm", "post_feedforward_layernorm")

    def __init__(self, model_config):
        super().__init__(model_config)
        self.use_qk_norm = True
        self.qk_norm_full = True
        self.norm_placement = "post"
