"""Phi-3 decoder.

Port of ``tensorrt_llm_tpu/models/phi.py``: the Llama trunk, whose
checkpoint stores fused projections, ``self_attn.qkv_proj`` [(nq + 2
nkv) * hd, H] and ``mlp.gate_up_proj`` [2I, H]. They are split at load
into q, k, v and gate, up, so that each is quantized as its own
projection (as in the JAX package: a per-tensor scale is then each
part's), and joined again where their methods allow. Within the original
context the unscaled rotary table is exact, which is what both packages
use (``longrope``'s long factors are not applied).

Head dim 96 (Phi-3-mini) is served on the CPU and on the card, where the
attention kernels stage it as 128-wide tiles.
"""
from __future__ import annotations

from typing import Any, Mapping

from .llama import LlamaForCausalLM
from .modeling_utils import register_model


@register_model("phi3")
class Phi3ForCausalLM(LlamaForCausalLM):
    architectures = ("Phi3ForCausalLM",)

    def _hf_weight(self, sd: Mapping[str, Any], prefix: str, name: str):
        nq = self.num_heads * self.head_dim
        nkv = self.num_kv_heads * self.head_dim
        I = self.intermediate_size
        if name in ("q", "k", "v"):
            w = sd[prefix + "self_attn.qkv_proj.weight"]
            lo = {"q": 0, "k": nq, "v": nq + nkv}[name]
            return w[lo:lo + (nq if name == "q" else nkv)]
        if name in ("gate", "up"):
            w = sd[prefix + "mlp.gate_up_proj.weight"]
            return w[:I] if name == "gate" else w[I:]
        return super()._hf_weight(sd, prefix, name)
