"""LLaVA vision-language model (LLaVA-1.5).

Port of ``tensorrt_llm_tpu/multimodal/llava.py``
(``LlavaForConditionalGeneration``): the CLIP tower's penultimate-layer
patch features (class token dropped) through a two-layer GELU projector,
spliced into the language model's embedding stream. The language half is
the Llama trunk (models/llama.py) over the config's ``text_config``: its
prefill and decode run K2 and K1 like any text model's. The tower and the
projector run once per request, outside the serving step, on the model's
device (multimodal/processor.py), in plain PyTorch as the JAX package
leaves them to XLA.

``VisionLanguageModel`` is the base of the four splice-only families
(llava, llava_next, mistral3, internvl): it splits a checkpoint into the
trunk's, the tower's and the projector's names (transformers' ``model.``
prefix stripped), and draws seeded random weights by the ``transformers``
model's own shapes (``init_params``), on the device, one tensor at a time.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from ..models.llama import LlamaForCausalLM
from ..models.modeling_utils import ModelConfig, register_model
from ..quantization.lazy_state_dict import RenamedStateDict
from .encoders import VisionTower, linear


def image_token_of(cfg) -> int:
    """The config's image placeholder id (``image_token_index``, or
    ``image_token_id`` in newer configs)."""
    tok = getattr(cfg, "image_token_index", None)
    return tok if tok is not None else cfg.image_token_id


def split_checkpoint(sd: Mapping[str, Any], vision: str = "vision_tower."
                     ) -> Tuple[Mapping, Mapping, Mapping]:
    """(trunk, tower, projector) views of a vision-language checkpoint:
    the trunk's under the Llama names (``model.layers...``,
    ``lm_head.weight``), the tower's and the projector's below their
    prefixes (``vision``: the tower's, ``vision_model.`` for Mllama)."""
    lm, vis, pj = {}, {}, {}
    for k in sd:
        k2 = k[len("model."):] if k.startswith("model.") else k
        if k2.startswith("language_model."):
            lm["model." + k2[len("language_model."):]] = k
        elif k2.startswith(vision):
            vis[k2[len(vision):]] = k
        elif k2.startswith("multi_modal_projector."):
            pj[k2[len("multi_modal_projector."):]] = k
        elif k2 == "lm_head.weight":
            lm["lm_head.weight"] = k
    return (RenamedStateDict(sd, lm), RenamedStateDict(sd, vis),
            RenamedStateDict(sd, pj))


class VisionLanguageModel(LlamaForCausalLM):
    """A Llama trunk over ``text_config`` with a vision tower and a
    projector beside it."""
    # the transformers class whose meta-device shapes ``init_params`` draws
    hf_class = ""

    def __init__(self, model_config: ModelConfig):
        self.vlm_config = model_config.hf_config
        super().__init__(dataclasses.replace(
            model_config, hf_config=model_config.hf_config.text_config))
        self.vision_params: Dict[str, Any] = {}
        self.projector: Dict[str, Any] = {}

    def split_state_dict(self, sd: Mapping[str, Any]
                         ) -> Tuple[Mapping, Mapping, Mapping]:
        return split_checkpoint(sd)

    def tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(device=self.device, dtype=self.dtype)

    def proj_linear(self, pj: Mapping[str, Any], name: str
                    ) -> Dict[str, torch.Tensor]:
        """Projector layer ``name`` as {"weight" [in, out], "bias"?}."""
        out = {"weight": self.tensor(pj[name + ".weight"]).t().contiguous()}
        if name + ".bias" in pj:
            out["bias"] = self.tensor(pj[name + ".bias"])
        return out

    def load_hf_state_dict(self, sd: Mapping[str, Any]) -> Dict[str, Any]:
        lm, vis, pj = self.split_state_dict(sd)
        self.load_vision(vis, pj)
        return super().load_hf_state_dict(lm)

    def load_vision(self, vis: Mapping, pj: Mapping) -> None:
        raise NotImplementedError

    def init_params(self, seed: int = 0) -> Dict[str, Any]:
        """Seeded random weights by the ``transformers`` model's shapes
        (``models.recurrent.RandomCheckpoint``: norms one, biases zero,
        the rest normal(0, 0.02)), drawn on the device as they are read
        (the JAX package refuses to serve these types without weights)."""
        import transformers
        from ..models.recurrent import RandomCheckpoint, meta_shapes
        shapes = meta_shapes(getattr(transformers, self.hf_class),
                             self.vlm_config)
        return self.load_hf_state_dict(RandomCheckpoint(
            shapes, self.device, self.dtype, seed=seed))


@register_model("llava")
class LlavaForConditionalGeneration(VisionLanguageModel):
    architectures = ("LlavaForConditionalGeneration",)
    processor_type = "llava"
    hf_class = "LlavaForConditionalGeneration"

    def __init__(self, model_config: ModelConfig):
        super().__init__(model_config)
        vlm = self.vlm_config
        self.image_token_index = image_token_of(vlm)
        self.vision_feature_layer = getattr(vlm, "vision_feature_layer", -2)
        self.vision_select = getattr(vlm, "vision_feature_select_strategy",
                                     "default")
        self.tower = VisionTower(vlm.vision_config, flavor="clip",
                                 dtype=self.dtype, device=self.device)
        self.vision_tokens_per_image = self.tower.num_patches \
            if self.vision_select == "default" else self.tower.num_pos

    def load_vision(self, vis: Mapping, pj: Mapping) -> None:
        self.vision_params = self.tower.load_hf_state_dict(vis)
        self.projector = {"l1": self.proj_linear(pj, "linear_1"),
                          "l2": self.proj_linear(pj, "linear_2")}

    @torch.no_grad()
    def encode_images(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """[B, 3, H, W] -> projected features [B, tokens_per_image, H_lm]
        in the model's type."""
        h = self.tower(self.vision_params, pixel_values,
                       feature_layer=self.vision_feature_layer)
        if self.vision_select == "default":
            h = h[:, 1:]                       # drop the class token
        x = linear(self.projector["l1"], h)
        x = F.gelu(x.float()).to(self.dtype)
        return linear(self.projector["l2"], x)
