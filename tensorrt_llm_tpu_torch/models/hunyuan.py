"""HunYuan v1 dense and MoE, Seed-OSS and ERNIE 4.5 (dense) decoders.

Port of ``tensorrt_llm_tpu/models/hunyuan.py``, on the Llama trunk:

- hunyuan_v1_dense: the Qwen3 trunk (per-head q/k RMS norms) with the
  norms named ``query_layernorm`` / ``key_layernorm``;
- hunyuan_v1_moe: the Mixtral layer with renormalised softmax routing,
  the router at ``mlp.gate.wg``, the same q/k norms and an always-on
  UNGATED shared MLP (``mlp.shared_mlp``; JAX qwen_moe.py:114,
  mixtral.py:214); ``moe_topk``, ``moe_intermediate_size`` and
  ``num_experts`` may be per-layer lists, which must be uniform (the JAX
  model reads their first entry);
- seed_oss: Llama with q/k/v biases (and whatever other biases the
  checkpoint holds);
- ernie4_5: Llama with interleaved rotary (``is_neox`` False in the spec
  and its rope, hunyuan.py:86-98).

HunYuan applies its q/k norms AFTER the rotary embedding and rotates by
a base raised by ``rope_scaling["alpha"]`` (transformers'
``HunYuanDenseV1Attention`` and its DynamicNTKAlpha rotary embedding);
the JAX package norms before the rotation and ignores ``alpha``. Both
agree only at unit norm weights and without ``alpha``; the port does
what the checkpoint does.
"""
from __future__ import annotations

import dataclasses

from .llama import LlamaForCausalLM
from .mixtral import MixtralForCausalLM
from .modeling_utils import register_model
from .qwen import Qwen3ForCausalLM
from .qwen_moe import _QwenMoeBase

_QK_NORMS = dict(q_norm="self_attn.query_layernorm",
                 k_norm="self_attn.key_layernorm")


def _uniform(value, name: str, model_type: str):
    """A per-layer list's one value (or the scalar itself)."""
    if isinstance(value, (list, tuple)):
        if len(set(value)) != 1:
            raise NotImplementedError(
                f"{model_type} with {name} that differs between layers is "
                "not supported by this package")
        return value[0]
    return value


def _hunyuan_attention(model: LlamaForCausalLM) -> None:
    """HunYuan's q/k norms after the rotary embedding, and its rotary base
    raised by ``alpha`` (base * alpha ** (d / (d - 2)), transformers'
    DynamicNTKAlpha rotary) when the config sets one."""
    rope = model.attn_spec.rope
    hf = model.hf
    # transformers 5 keeps the scaling in rope_parameters
    rs = getattr(hf, "rope_scaling", None) or \
        getattr(hf, "rope_parameters", None) or {}
    alpha = rs.get("alpha") if rs.get("rope_type", rs.get("type")) == \
        "dynamic" else None
    if alpha:
        d = model.head_dim
        rope = dataclasses.replace(
            rope, rope_theta=rope.rope_theta * alpha ** (d / (d - 2)),
            scaling_type="none")
    model.attn_spec = dataclasses.replace(model.attn_spec, rope=rope,
                                          qk_norm_after_rope=True)


@register_model("hunyuan_v1_dense")
class HunYuanDenseV1ForCausalLM(Qwen3ForCausalLM):
    architectures = ("HunYuanDenseV1ForCausalLM",)
    _HF_MODULES = dict(LlamaForCausalLM._HF_MODULES, **_QK_NORMS)

    def __init__(self, model_config):
        super().__init__(model_config)
        _hunyuan_attention(self)


@register_model("hunyuan_v1_moe")
class HunYuanMoEV1ForCausalLM(_QwenMoeBase):
    architectures = ("HunYuanMoEV1ForCausalLM",)
    _ROUTER = "mlp.gate.wg"
    _HF_MODULES = dict(MixtralForCausalLM._HF_MODULES, **_QK_NORMS,
                       se_gate="mlp.shared_mlp.gate_proj",
                       se_up="mlp.shared_mlp.up_proj",
                       se_down="mlp.shared_mlp.down_proj")

    def __init__(self, model_config):
        super().__init__(model_config)
        hf = self.hf
        mt = hf.model_type
        self.num_experts = _uniform(hf.num_experts, "num_experts", mt)
        self.top_k = _uniform(getattr(hf, "moe_topk", 1), "moe_topk", mt)
        self.renormalize = True
        self.use_qk_norm = True
        self.has_shared_expert = True
        self.shared_expert_gated = False
        _hunyuan_attention(self)

    @property
    def moe_intermediate(self) -> int:
        mi = getattr(self.hf, "moe_intermediate_size", None) or \
            self.hf.intermediate_size
        return _uniform(mi, "moe_intermediate_size", self.hf.model_type)

    @property
    def shared_intermediate(self) -> int:
        """transformers' shared MLP: ``intermediate_size`` per shared
        expert (``num_shared_expert``, 1 without it)."""
        n = _uniform(getattr(self.hf, "num_shared_expert", 1) or 1,
                     "num_shared_expert", self.hf.model_type)
        return self.hf.intermediate_size * n


@register_model("seed_oss")
class SeedOssForCausalLM(LlamaForCausalLM):
    architectures = ("SeedOssForCausalLM",)


@register_model("ernie4_5")
class Ernie45ForCausalLM(LlamaForCausalLM):
    architectures = ("Ernie4_5ForCausalLM",)

    def __init__(self, model_config):
        super().__init__(model_config)
        self.attn_spec = dataclasses.replace(
            self.attn_spec, is_neox=False,
            rope=dataclasses.replace(self.attn_spec.rope, is_neox=False))
