"""Llama-architecture variants: EXAONE 4, SmolLM3, Helium, Arcee.

Port of ``tensorrt_llm_tpu/models/llama_variants.py``. Each is the Llama
trunk with a few of its knobs set; what differs per layer is static, in
``layer_specs`` (a layer without rotary embeddings has ``rope`` None, and
skipping the rotation equals the JAX model's rotation by cos 1, sin 0).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping

from .llama import LlamaForCausalLM
from .modeling_utils import AttentionSpec, register_model


@register_model("exaone4")
class Exaone4ForCausalLM(LlamaForCausalLM):
    """EXAONE 4.0: norms on the sublayers' outputs only, a per-head q/k
    RMS norm, and sliding-window layers (``layer_types``) beside global
    ones, with RoPE on the sliding layers only; without a window every
    layer is global and rotates."""
    architectures = ("Exaone4ForCausalLM",)
    _NORM_NAMES = ("post_attention_layernorm", "post_feedforward_layernorm")

    def __init__(self, model_config):
        super().__init__(model_config)
        self.use_qk_norm = True
        self.norm_placement = "post"
        hf = self.hf
        sw = getattr(hf, "sliding_window", None)
        types = getattr(hf, "layer_types", None) or \
            [("sliding_attention" if sw else "full_attention")] * \
            self.num_layers
        self.layer_sliding = [t == "sliding_attention" for t in types]
        self.sliding_spec = None
        if sw and any(self.layer_sliding):
            # the global layers carry no window, the sliding ones do
            self.attn_spec = dataclasses.replace(self.attn_spec,
                                                 sliding_window=None)
            self.sliding_spec = dataclasses.replace(self.attn_spec,
                                                    sliding_window=sw)

    @property
    def layer_specs(self) -> List[AttentionSpec]:
        if self.sliding_spec is None:
            return [self.attn_spec] * self.num_layers
        nope = dataclasses.replace(self.attn_spec, rope=None)
        return [self.sliding_spec if s else nope
                for s in self.layer_sliding[:self.num_layers]]


@register_model("smollm3")
class SmolLM3ForCausalLM(LlamaForCausalLM):
    """SmolLM3: the Llama body with NoPE layers (``no_rope_layers``: 1
    rotates, 0 does not; by default every fourth layer)."""
    architectures = ("SmolLM3ForCausalLM",)

    def __init__(self, model_config):
        super().__init__(model_config)
        self.use_rope = [bool(x) for x in (
            getattr(self.hf, "no_rope_layers", None) or
            [1] * self.num_layers)]

    @property
    def layer_specs(self) -> List[AttentionSpec]:
        nope = dataclasses.replace(self.attn_spec, rope=None)
        return [self.attn_spec if r else nope
                for r in self.use_rope[:self.num_layers]]


@register_model("helium")
class HeliumForCausalLM(LlamaForCausalLM):
    """Kyutai Helium: the Llama architecture (its own theta and eps)."""
    architectures = ("HeliumForCausalLM",)


@register_model("arcee")
class ArceeForCausalLM(LlamaForCausalLM):
    """Arcee AFM: a gateless ReLU^2 MLP, down(relu(up(x))^2), loaded as
    the JAX package loads it: gate := up under a relu activation
    (relu(u) * u == relu(u)^2 exactly)."""
    architectures = ("ArceeForCausalLM",)

    def __init__(self, model_config):
        super().__init__(model_config)
        self.mlp_act = "relu"

    def _hf_weight(self, sd: Mapping[str, Any], prefix: str, name: str):
        if name == "gate" and prefix + "mlp.gate_proj.weight" not in sd:
            name = "up"
        return super()._hf_weight(sd, prefix, name)
