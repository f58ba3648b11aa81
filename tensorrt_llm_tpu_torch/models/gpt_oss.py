"""GPT-OSS (OpenAI's open-weight MoE).

Port of ``tensorrt_llm_tpu/models/gpt_oss.py`` (``GptOssForCausalLM``,
:37-232) on one GPU: the Llama trunk (models/llama.py, RMS norms, biased
q/k/v/o) through the Mixtral layer (models/mixtral.py) with

- a learned per-head sink logit (``use_sinks``: params["sinks"], float32
  [heads]) that joins every softmax and is dropped after it, in K1 and K2;
- ``layer_types`` alternating sliding (``sliding_window``, 128) and full
  attention (``_layer_is_sliding``, even layers slide without
  ``layer_types``), static per layer;
- YaRN rope at the full head dim (ops/rope.py);
- the MoE of every layer (ops/moe.py ``moe_mlp_swiglu``): router with a
  bias, top k, softmax over the selected logits; the experts' gate and up
  products and down product with float32 biases and the clamped SwiGLU
  (``swiglu_limit``), on the ``grouped`` route in bf16 on CUDA.

The checkpoint's experts store gate and up INTERLEAVED along the output
columns (``gate_up_proj`` [E, H, 2I], gate at even columns); they are
de-interleaved once at load into ``w_gate_up`` [E, H, 2I] (gate, then up)
and ``b_gate_up`` [E, 2I] (float32), as the JAX loader does (:108-117).
An MXFP4 checkpoint (the release format: ``*_blocks`` / ``*_scales``,
[E, out, in]) is dequantized on the host at load
(quantization/mxfp4.py) and transposed to [E, in, out]; the experts are
then served in the model's type, as in the JAX package.

Layer parameters beyond the Llama attention's: "sinks"; "router" [E, H]
(the model's type) and "router_bias" [E]; "w_gate_up", "b_gate_up",
"w_down" [E, I, H], "b_down" [E, H] (biases float32).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping

import numpy as np
import torch

from ..ops.moe import moe_mlp_swiglu
from ..quantization.lazy_state_dict import RenamedStateDict
from ..quantization.mxfp4 import normalize_mxfp4_state_dict
from .mixtral import MixtralForCausalLM
from .modeling_utils import AttentionSpec, register_model


@register_model("gpt_oss")
class GptOssForCausalLM(MixtralForCausalLM):
    architectures = ("GptOssForCausalLM",)
    _ROUTER = "mlp.router"

    def __init__(self, model_config):
        super().__init__(model_config)
        hf = self.hf
        self.swiglu_limit = getattr(hf, "swiglu_limit", 7.0)
        self.sliding_window = hf.sliding_window
        self.attn_spec = dataclasses.replace(
            self.attn_spec, sliding_window=None, use_sinks=True)
        self.sliding_spec = dataclasses.replace(
            self.attn_spec, sliding_window=self.sliding_window)

    def _layer_is_sliding(self, idx: int) -> bool:
        lt = getattr(self.hf, "layer_types", None)
        if lt is not None:
            return lt[idx] == "sliding_attention"
        return idx % 2 == 0

    @property
    def layer_specs(self) -> List[AttentionSpec]:
        return [self.sliding_spec if self._layer_is_sliding(i)
                else self.attn_spec for i in range(self.num_layers)]

    def act_width_per_token(self) -> int:
        """``MixtralForCausalLM.act_width_per_token``, its MoE tensors
        counted in float32 (the biased gate|up, its activation and the down
        output are float32 here): twice the routed copies' widths."""
        H, I = self.hidden_size, self.moe_intermediate
        return 4 * H + self.num_experts + 2 * self.top_k * (2 * H + 3 * I)

    # ------------------------------------------------------------------ #
    # Parameters
    # ------------------------------------------------------------------ #
    def _layer(self, input_norm, post_norm, weight: Callable[[str], Any],
               bias: Callable[[str], Any] = lambda name: None,
               smooth: Callable[[str], Any] = lambda name: None,
               idx: int = 0) -> Dict[str, Any]:
        layer = super()._layer(input_norm, post_norm, weight, bias, smooth,
                               idx=idx)
        layer["sinks"] = self._f32(weight("sinks"))
        return layer

    def _f32(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(device=self.device,
                                     dtype=torch.float32).contiguous()

    def _init_mlp(self, mat) -> Dict[str, torch.Tensor]:
        """Random experts, zero biases and sinks (load_format="dummy")."""
        H, I, E = self.hidden_size, self.moe_intermediate, self.num_experts
        dev = self.device
        return {"router": mat(E, H), "w_gate_up": mat(E, H, 2 * I),
                "w_down": mat(E, I, H),
                "router_bias": torch.zeros(E, device=dev),
                "b_gate_up": torch.zeros(E, 2 * I, device=dev),
                "b_down": torch.zeros(E, H, device=dev),
                "sinks": torch.zeros(self.num_heads, device=dev)}

    def init_params(self, seed: int = 0) -> Dict[str, Any]:
        """``LlamaForCausalLM.init_params`` with the attention's biases at
        zero (the checkpoint's q/k/v/o are biased)."""
        params = super().init_params(seed)
        for layer in params["layers"]:
            for name in ("qkv", "q", "k", "v", "o"):
                p = layer.get(name)
                if p is not None and "bias" not in p:
                    n = p["weight"].shape[0] if "weight_scale" not in p \
                        else p["weight_scale"].shape[-1]
                    p["bias"] = torch.zeros(n, device=self.device,
                                            dtype=self.dtype)
        return params

    def _mlp_params(self, weight, bias, smooth=lambda name: None
                    ) -> Dict[str, Any]:
        out = super()._mlp_params(weight, bias, smooth)
        for name in ("router_bias", "b_gate_up", "b_down"):
            out[name] = self._f32(weight(name))
        return out

    def load_hf_state_dict(self, sd: Mapping[str, Any]) -> Dict[str, Any]:
        """The checkpoint (bf16 experts, or MXFP4 blocks and scales) in
        the Llama loader's names: the experts' interleaved gate|up
        columns split, the sinks and router bias under their names."""
        if any(k.endswith("gate_up_proj_blocks") for k in sd):
            deq = normalize_mxfp4_state_dict(sd)
            # the dequantized experts transposed, each when it is read
            sd = RenamedStateDict(deq, {k: k for k in deq}, {
                f"model.layers.{i}.mlp.experts.{nm}":
                (lambda k=f"model.layers.{i}.mlp.experts.{nm}":
                 np.ascontiguousarray(np.transpose(np.asarray(deq[k]),
                                                   (0, 2, 1))))
                for i in range(self.num_layers)
                for nm in ("gate_up_proj", "down_proj")})
        return super().load_hf_state_dict(sd)

    def _hf_weight(self, sd: Mapping[str, Any], prefix: str, name: str):
        e = prefix + "mlp.experts."
        if name == "sinks":
            return sd[prefix + "self_attn.sinks"]
        if name == "router_bias":
            return sd[prefix + self._ROUTER + ".bias"]
        if name in ("w_gate_up", "b_gate_up"):
            suffix = "" if name == "w_gate_up" else "_bias"
            gu = torch.as_tensor(sd[e + "gate_up_proj" + suffix])
            # [.., 2I] interleaved -> gate columns, then up columns
            gu = torch.cat([gu[..., 0::2], gu[..., 1::2]], dim=-1)
            return gu.to(device=self.device,
                         dtype=self.dtype if suffix == "" else
                         torch.float32).contiguous()
        if name == "w_down":
            return torch.as_tensor(sd[e + "down_proj"]).to(
                device=self.device, dtype=self.dtype).contiguous()
        if name == "b_down":
            return sd[e + "down_proj_bias"]
        return super()._hf_weight(sd, prefix, name)

    # ------------------------------------------------------------------ #
    # Forward
    # ------------------------------------------------------------------ #
    def _mlp(self, layer: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        return moe_mlp_swiglu(x, layer["router"], layer["router_bias"],
                              layer["w_gate_up"], layer["b_gate_up"],
                              layer["w_down"], layer["b_down"], self.top_k,
                              self.swiglu_limit)
