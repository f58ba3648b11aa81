"""Qwen2 / Qwen3 decoders.

Port of ``tensorrt_llm_tpu/models/qwen.py``. Both are the Llama trunk
(models/llama.py):

- Qwen2: the q/k/v projections carry biases, which the Llama loader
  takes from the checkpoint into each projection (and through the fused
  qkv);
- Qwen3: an RMS norm over each head's hd of q and k after the projection
  and before RoPE (``self_attn.q_norm`` / ``k_norm``), no attention bias.
"""
from __future__ import annotations

from .llama import LlamaForCausalLM
from .modeling_utils import register_model


@register_model("qwen2")
class Qwen2ForCausalLM(LlamaForCausalLM):
    architectures = ("Qwen2ForCausalLM",)


@register_model("qwen3")
class Qwen3ForCausalLM(LlamaForCausalLM):
    architectures = ("Qwen3ForCausalLM",)

    def __init__(self, model_config):
        super().__init__(model_config)
        self.use_qk_norm = True
