"""GLM-4.5 / GLM-4.6 (glm4_moe) and ERNIE 4.5 MoE (ernie4_5_moe).

Port of ``tensorrt_llm_tpu/models/glm4_moe.py`` on one GPU: the Llama
attention (paged GQA through K1 and K2, partial rotary, optional per-head
q/k RMS norm, q/k/v biases) and DeepSeek-style MoE layers:

- the first ``first_k_dense_replace`` layers keep the gated MLP of
  ``intermediate_size``, the others are MoE layers, all on one KV pool in
  layer order (glm4_moe.py:203-206);
- GLM-4.5 routes as DeepSeek-V3 (ops/moe.py ``sigmoid_bias_routing``:
  sigmoid scores chosen with ``e_score_correction_bias``, renormalised
  with ``norm_topk_prob``, times ``routed_scaling_factor``), ERNIE 4.5
  with softmax scores chosen with its bias and renormalised over a sum
  clamped at ``moe_norm_min`` (``softmax_bias_routing``); the router's
  logits are float32 products of float32 inputs (glm4_moe.py:144-145);
- the always-on shared experts (``n_shared_experts`` of
  ``moe_intermediate_size`` each, one MLP of their summed width) go
  through the MLP's linear method and are added ungated; the routed
  experts stay in the model's type under any weight quantization, as in
  the JAX package (glm4_moe.py:114-119).

GLM-4.5's router is group-limited when ``n_group`` > 1 (transformers'
``Glm4MoeTopkRouter``); the JAX model ignores ``n_group`` (the published
configs set 1, where both agree) and the port limits the groups as
transformers does. ERNIE 4.5's MoE layers are ``moe_layer_start_index``
up to the last layer; another ``moe_layer_interval`` or
``moe_layer_end_index``, and ``use_bias`` (whose o, expert and lm_head
biases the JAX loader drops), are refused by name.

Layer parameters: the Llama attention's, then for a dense layer
"gate_up" / "down", for a MoE layer "router" [E, H] (the model's type),
"router_bias" [E] (float32), "w_gate_up" [E, H, 2I], "w_down" [E, I, H]
and the shared experts' "se_gate_up" (or "se_gate", "se_up") and
"se_down".
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

from ..ops.moe import (moe_mlp_routed, sigmoid_bias_routing,
                       softmax_bias_routing)
from .llama import LlamaForCausalLM
from .mixtral import MixtralForCausalLM
from .modeling_utils import register_model


@register_model("glm4_moe")
class Glm4MoeForCausalLM(MixtralForCausalLM):
    architectures = ("Glm4MoeForCausalLM",)
    _ROUTER = "mlp.gate"
    _EXPERTS = ("mlp.experts.{e}.gate_proj", "mlp.experts.{e}.up_proj",
                "mlp.experts.{e}.down_proj")
    _HF_MODULES = dict(
        LlamaForCausalLM._HF_MODULES,
        se_gate="mlp.shared_experts.gate_proj",
        se_up="mlp.shared_experts.up_proj",
        se_down="mlp.shared_experts.down_proj")

    def __init__(self, model_config):
        super().__init__(model_config)
        hf = self.hf
        self.first_dense = getattr(hf, "first_k_dense_replace", 0)
        self.num_experts = hf.n_routed_experts
        self.top_k = hf.num_experts_per_tok
        self.renormalize = getattr(hf, "norm_topk_prob", True)
        self.routed_scale = getattr(hf, "routed_scaling_factor", 1.0)
        self.n_group = getattr(hf, "n_group", None) or 1
        self.topk_group = getattr(hf, "topk_group", None) or self.n_group
        self.use_qk_norm = bool(getattr(hf, "use_qk_norm", False))
        self.n_shared = getattr(hf, "n_shared_experts", 0) or 0
        self.has_shared_expert = self.n_shared > 0
        self.shared_expert_gated = False

    @property
    def moe_intermediate(self) -> int:
        return self.hf.moe_intermediate_size

    @property
    def shared_intermediate(self) -> int:
        return self.moe_intermediate * self.n_shared

    def act_width_per_token(self) -> int:
        """The wider of a dense layer's and a MoE layer's activations."""
        return max(LlamaForCausalLM.act_width_per_token(self),
                   super().act_width_per_token())

    def _is_moe(self, idx: int) -> bool:
        return idx >= self.first_dense

    # ------------------------------------------------------------------ #
    # Parameters
    # ------------------------------------------------------------------ #
    def _layer_mlp_params(self, idx: int, weight, bias, smooth
                          ) -> Dict[str, Any]:
        if not self._is_moe(idx):
            return LlamaForCausalLM._mlp_params(self, weight, bias, smooth)
        out = super()._mlp_params(weight, bias, smooth)
        out["router_bias"] = torch.as_tensor(weight("router_bias")).to(
            device=self.device, dtype=torch.float32).reshape(-1)
        return out

    def _layer_init_mlp(self, idx: int, mat: Callable[..., torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        if not self._is_moe(idx):
            return LlamaForCausalLM._init_mlp(self, mat)
        w = super()._init_mlp(mat)
        w["router_bias"] = torch.zeros(self.num_experts, device=self.device)
        return w

    def _hf_weight(self, sd, prefix: str, name: str):
        if name == "router_bias":
            return sd[prefix + "mlp.gate.e_score_correction_bias"]
        return super()._hf_weight(sd, prefix, name)

    # ------------------------------------------------------------------ #
    # Forward
    # ------------------------------------------------------------------ #
    def _route(self, layer: Dict[str, Any], x: torch.Tensor):
        logits = F.linear(x.float(), layer["router"].float())
        return sigmoid_bias_routing(logits, layer["router_bias"],
                                    self.top_k, self.renormalize,
                                    self.routed_scale, self.n_group,
                                    self.topk_group)

    def _mlp(self, layer: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        if "router" not in layer:            # one of the dense layers
            return LlamaForCausalLM._mlp(self, layer, x)
        w, idx = self._route(layer, x)
        out = moe_mlp_routed(x, layer["w_gate_up"], layer["w_down"], w, idx)
        if self.has_shared_expert:
            out = out + self._shared_expert(layer, x)
        return out


@register_model("ernie4_5_moe")
class Ernie45MoeForCausalLM(Glm4MoeForCausalLM):
    """ERNIE 4.5 MoE: the glm4_moe body with interleaved rotary and
    ERNIE's routing (module docstring)."""
    architectures = ("Ernie4_5_MoeForCausalLM",)

    def __init__(self, model_config):
        hf = model_config.hf_config
        L = hf.num_hidden_layers
        end = getattr(hf, "moe_layer_end_index", L - 1)
        if getattr(hf, "moe_layer_interval", 1) != 1 or end not in (-1,
                                                                    L - 1):
            raise NotImplementedError(
                "ernie4_5_moe with moe_layer_interval != 1 or "
                "moe_layer_end_index before the last layer is not supported "
                "by this package")
        if getattr(hf, "use_bias", False):
            raise NotImplementedError(
                "ernie4_5_moe use_bias=True is not supported by this package "
                "(the JAX package drops its o, expert and lm_head biases)")
        # ERNIE's names onto the glm4_moe expectations, as the JAX model
        hf.first_k_dense_replace = getattr(hf, "moe_layer_start_index", 0)
        hf.n_routed_experts = hf.moe_num_experts
        hf.num_experts_per_tok = hf.moe_k
        hf.n_shared_experts = getattr(hf, "moe_num_shared_experts", 0)
        super().__init__(model_config)
        self.n_group = self.topk_group = 1
        self.norm_min = getattr(hf, "moe_norm_min", 1e-12)
        self.attn_spec = dataclasses.replace(
            self.attn_spec, is_neox=False,
            rope=dataclasses.replace(self.attn_spec.rope, is_neox=False))

    def _hf_weight(self, sd, prefix: str, name: str):
        if name == "router_bias":       # stored [1, E]
            return sd[prefix + "mlp.moe_statics.e_score_correction_bias"]
        return super()._hf_weight(sd, prefix, name)

    def _route(self, layer: Dict[str, Any], x: torch.Tensor):
        logits = F.linear(x.float(), layer["router"].float())
        return softmax_bias_routing(logits, layer["router_bias"],
                                    self.top_k, self.norm_min)
