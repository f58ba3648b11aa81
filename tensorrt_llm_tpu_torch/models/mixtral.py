"""Mixtral: the Llama attention block with a routed MoE MLP in each layer.

Port of ``tensorrt_llm_tpu/models/mixtral.py`` (``MixtralForCausalLM``,
forward :134-256) on one GPU: top-k routing over E experts through
ops/moe.py, the optional always-on shared expert behind a float32
sigmoid gate (Qwen2-MoE, :206-219; ungated with ``shared_expert_gated``
False, HunYuan-MoE), the q/k-norm selection of the Llama trunk
(:148-166) and the Granite multipliers of the trunk's forward
(``embedding_multiplier``, ``residual_multiplier``, ``logits_scaling``,
:138-140, 251-252; Granite-MoE sets them, models/granite_moe.py). Left
out: the wide-EP replica slots, deepstack inputs and MoE statistics; the
families that need them are not registered here.

Parameters of a layer's MLP (``_mlp_params``): "router" [E, H] in the
model's type; "w_gate_up" [E, H, 2I] and "w_down" [E, I, H] (ops/moe.py's
layout); with a shared expert "se_gate_up" and "se_down" through the MLP's
linear method and, when it is gated, "se_gate_w" [1, H]. As in the JAX
package the experts stay in the model's type under weight-only
quantization: only attention, the shared expert and lm_head go through
their methods.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import torch
import torch.nn.functional as F

from ..ops.linear import dot_f32
from ..ops.moe import check_grouped, moe_mlp, moe_route
from ..quantization.checkpoint import PrequantizedWeight
from .llama import LlamaForCausalLM
from .modeling_utils import apply_pair, fuse_projections, register_model


@register_model("mixtral")
class MixtralForCausalLM(LlamaForCausalLM):
    architectures = ("MixtralForCausalLM",)
    # one KV scale, the config's, for every layer (the JAX mixtral.py:181)
    per_layer_kv_scale = False
    # the JAX MoE loaders fold no SmoothQuant scales
    takes_smoothing = False
    # checkpoint modules below model.layers.{i}.: the router, and the
    # experts' gate, up and down projections ({e}: the expert)
    _ROUTER = "block_sparse_moe.gate"
    _EXPERTS = ("block_sparse_moe.experts.{e}.w1",
                "block_sparse_moe.experts.{e}.w3",
                "block_sparse_moe.experts.{e}.w2")

    def __init__(self, model_config):
        super().__init__(model_config)
        hf = self.hf
        self.num_experts = getattr(hf, "num_local_experts", None) or \
            getattr(hf, "num_experts", 0)
        self.top_k = getattr(hf, "num_experts_per_tok", 1)
        # routing renormalization (Mixtral yes; Qwen2-MoE no by default)
        self.renormalize = True
        # Qwen2-MoE's always-on shared expert behind a sigmoid gate
        # (HunYuan-MoE's and the DeepSeek-style families' add ungated)
        self.has_shared_expert = False
        self.shared_expert_gated = True
        if self.device.type == "cuda" and \
                moe_route(self.dtype, self.device) == "grouped":
            check_grouped(self.hidden_size, self.moe_intermediate,
                          self.device)

    @property
    def moe_intermediate(self) -> int:
        """Each expert's intermediate width."""
        return self.hf.intermediate_size

    @property
    def shared_intermediate(self) -> int:
        return self.hf.shared_expert_intermediate_size

    def act_width_per_token(self) -> int:
        """Activation elements per token of one layer (the graph pool's
        estimate, ``ModelEngine.graph_pool_reserve``): 4 hidden-wide
        tensors, the router's E logits, and per routed copy (k of them)
        the sorted input and down output (H each), gate|up (2I) and their
        product (I); a shared expert adds its 3 widths."""
        H, I = self.hidden_size, self.moe_intermediate
        width = 4 * H + self.num_experts + self.top_k * (2 * H + 3 * I)
        if self.has_shared_expert:
            width += 3 * self.shared_intermediate
        return width

    # ------------------------------------------------------------------ #
    # Parameters
    # ------------------------------------------------------------------ #
    def _init_mlp(self, mat: Callable[..., torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        H, I, E = self.hidden_size, self.moe_intermediate, self.num_experts
        w = {"router": mat(E, H), "w_gate_up": mat(E, H, 2 * I),
             "w_down": mat(E, I, H)}
        if self.has_shared_expert:
            SI = self.shared_intermediate
            w["se_gate"], w["se_up"] = mat(2 * SI, H).split(SI)
            w["se_down"] = mat(H, SI)
            if self.shared_expert_gated:
                w["se_gate_w"] = mat(1, H)
        return w

    def _mlp_params(self, weight: Callable[[str], Any],
                    bias: Callable[[str], Any],
                    smooth: Callable[[str], Any] = lambda name: None
                    ) -> Dict[str, Any]:
        def dense(name):
            w = weight(name)
            if isinstance(w, PrequantizedWeight):
                raise NotImplementedError(
                    f"a prequantized MoE {name} is not supported by this "
                    "package (the experts stay in the model's type)")
            return torch.as_tensor(w).to(device=self.device,
                                         dtype=self.dtype).contiguous()

        out = {k: dense(k) for k in ("router", "w_gate_up", "w_down")}
        if self.has_shared_expert:
            m = self.m_mlp
            out.update(fuse_projections(
                "se_gate_up", ("se_gate", "se_up"), (m, m),
                [self._lin(m, weight("se_gate"), bias("se_gate")),
                 self._lin(m, weight("se_up"), bias("se_up"))]))
            out["se_down"] = self._lin(m, weight("se_down"),
                                       bias("se_down"))
            if self.shared_expert_gated:
                out["se_gate_w"] = dense("se_gate_w")
        return out

    _HF_MODULES = dict(
        LlamaForCausalLM._HF_MODULES,
        se_gate="mlp.shared_expert.gate_proj",
        se_up="mlp.shared_expert.up_proj",
        se_down="mlp.shared_expert.down_proj",
        se_gate_w="mlp.shared_expert_gate")

    def _hf_module(self, name: str) -> str:
        return self._ROUTER if name == "router" else self._HF_MODULES[name]

    def _hf_weight(self, sd: Mapping[str, Any], prefix: str, name: str):
        if name in ("w_gate_up", "w_down"):
            return self._stack_experts(sd, prefix, name)
        return super()._hf_weight(sd, prefix, name)

    def _stack_experts(self, sd: Mapping[str, Any], prefix: str,
                       name: str) -> torch.Tensor:
        """The layer's experts in ops/moe.py's layout, filled one expert
        at a time on the target device: "w_gate_up" [E, H, 2I] from the
        gate and up projections ([I, H] each), "w_down" [E, I, H] from
        the down projections ([H, I])."""
        H, I, E = self.hidden_size, self.moe_intermediate, self.num_experts
        gate, up, down = (prefix + m + ".weight" for m in self._EXPERTS)

        def w(fmt, e):
            return torch.as_tensor(sd[fmt.format(e=e)]).t()

        if name == "w_down":
            out = torch.empty((E, I, H), dtype=self.dtype,
                              device=self.device)
            for e in range(E):
                out[e] = w(down, e)
            return out
        out = torch.empty((E, H, 2 * I), dtype=self.dtype,
                          device=self.device)
        for e in range(E):
            out[e, :, :I] = w(gate, e)
            out[e, :, I:] = w(up, e)
        return out

    # ------------------------------------------------------------------ #
    # Forward
    # ------------------------------------------------------------------ #
    def _mlp(self, layer: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        out = moe_mlp(x, layer["w_gate_up"], layer["w_down"],
                      layer["router"], self.top_k,
                      renormalize=self.renormalize)
        if self.has_shared_expert:
            se = self._shared_expert(layer, x)
            if self.shared_expert_gated:
                g = torch.sigmoid(dot_f32(x, layer["se_gate_w"]))
                se = g.to(self.dtype) * se
            out = out + se
        return out

    def _shared_expert(self, layer: Dict[str, Any],
                       x: torch.Tensor) -> torch.Tensor:
        """The always-on shared expert (a gated-SiLU MLP through the MLP's
        linear method), before any gate."""
        m = self.m_mlp
        gate, up = apply_pair(m, layer, "se_gate_up", ("se_gate", "se_up"),
                              x, self.shared_intermediate)
        return m.apply(layer["se_down"],
                       F.silu(gate.float()).to(self.dtype) * up)
