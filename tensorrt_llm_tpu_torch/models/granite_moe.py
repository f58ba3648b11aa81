"""IBM Granite-MoE decoder.

Port of ``tensorrt_llm_tpu/models/granite_moe.py``: the Mixtral layer
(models/mixtral.py) with Granite's four multipliers (models/granite.py
``set_granite_multipliers``) and renormalised top-k routing. The
checkpoint packs each layer's experts: ``block_sparse_moe.input_linear.
weight`` [E, 2I, H] (gate rows, then up) and ``output_linear.weight``
[E, H, I], with the router at ``block_sparse_moe.router.layer.weight``;
they become ops/moe.py's ``w_gate_up`` [E, H, 2I] and ``w_down`` [E, I, H]
by one transpose each.
"""
from __future__ import annotations

from typing import Any, Mapping

import torch

from .granite import set_granite_multipliers
from .mixtral import MixtralForCausalLM
from .modeling_utils import register_model


@register_model("granitemoe")
class GraniteMoeForCausalLM(MixtralForCausalLM):
    architectures = ("GraniteMoeForCausalLM",)
    _ROUTER = "block_sparse_moe.router.layer"

    def __init__(self, model_config):
        super().__init__(model_config)
        set_granite_multipliers(self)
        self.renormalize = True       # GraniteMoe softmaxes the top k

    def _stack_experts(self, sd: Mapping[str, Any], prefix: str,
                       name: str) -> torch.Tensor:
        packed = "input_linear" if name == "w_gate_up" else "output_linear"
        w = torch.as_tensor(sd[prefix + f"block_sparse_moe.{packed}.weight"])
        return w.transpose(1, 2).to(device=self.device,
                                    dtype=self.dtype).contiguous()
