"""Qwen2-MoE, Qwen3-MoE and OLMoE decoders.

Port of ``tensorrt_llm_tpu/models/qwen_moe.py``: Mixtral-shaped sparse
MoE models (models/mixtral.py) with the Qwen checkpoint names (router
``mlp.gate``, experts ``mlp.experts.{e}.{gate,up,down}_proj``) and their
own trims:

- Qwen2-MoE: softmax routing renormalised only with ``norm_topk_prob``
  (off by default), plus the always-on shared expert scaled by a
  per-token sigmoid gate; its q/k/v biases ride in the projections (the
  JAX package's loader drops them);
- Qwen3-MoE: renormalised routing (``norm_topk_prob``, on by default),
  Qwen3's per-head q/k RMS norm, no shared expert;
- OLMoE: the q/k RMS norm over the whole projection, routing renormalised
  only with ``norm_topk_prob`` (off by default), experts of
  ``intermediate_size``.

Layers that stay dense (``mlp_only_layers``, ``decoder_sparse_step`` other
than 1) and OLMoE's ``clip_qkv`` are refused by name.
"""
from __future__ import annotations

from .mixtral import MixtralForCausalLM
from .modeling_utils import register_model


class _QwenMoeBase(MixtralForCausalLM):
    """Weight naming shared by the Qwen-style MoE families."""
    _ROUTER = "mlp.gate"
    _EXPERTS = ("mlp.experts.{e}.gate_proj", "mlp.experts.{e}.up_proj",
                "mlp.experts.{e}.down_proj")

    def __init__(self, model_config):
        super().__init__(model_config)
        self.num_experts = self.hf.num_experts

    @property
    def moe_intermediate(self) -> int:
        return self.hf.moe_intermediate_size

    def _refuse_dense_layers(self) -> None:
        hf = self.hf
        if getattr(hf, "mlp_only_layers", None) or \
                getattr(hf, "decoder_sparse_step", 1) != 1:
            raise NotImplementedError(
                f"{hf.model_type} with dense interleaved layers "
                "(mlp_only_layers, decoder_sparse_step != 1) is not "
                "supported by this package")


@register_model("qwen2_moe")
class Qwen2MoeForCausalLM(_QwenMoeBase):
    architectures = ("Qwen2MoeForCausalLM",)

    def __init__(self, model_config):
        super().__init__(model_config)
        self._refuse_dense_layers()
        self.renormalize = getattr(self.hf, "norm_topk_prob", False)
        self.has_shared_expert = True


@register_model("qwen3_moe")
class Qwen3MoeForCausalLM(_QwenMoeBase):
    architectures = ("Qwen3MoeForCausalLM",)

    def __init__(self, model_config):
        super().__init__(model_config)
        self._refuse_dense_layers()
        self.renormalize = getattr(self.hf, "norm_topk_prob", True)
        self.use_qk_norm = True


@register_model("olmoe")
class OlmoeForCausalLM(_QwenMoeBase):
    architectures = ("OlmoeForCausalLM",)

    def __init__(self, model_config):
        super().__init__(model_config)
        if getattr(self.hf, "clip_qkv", None) is not None:
            raise NotImplementedError(
                "olmoe clip_qkv is not supported by this package")
        self.use_qk_norm = True
        self.qk_norm_full = True
        self.renormalize = bool(getattr(self.hf, "norm_topk_prob", False))

    @property
    def moe_intermediate(self) -> int:
        return self.hf.intermediate_size
