"""PaliGemma 2 vision-language model (PaliGemmaForConditionalGeneration).

Port of ``tensorrt_llm_tpu/multimodal/paligemma.py``: the SigLIP tower
(``last_hidden_state`` with the post-LayerNorm) through a linear
projector, divided by sqrt(text hidden) (the Gemma 2 trunk's embedding
scale multiplies it back), spliced into the Gemma 2 text trunk
(models/gemma.py). PaliGemma is a prefix LM: at inference the whole
prompt attends bidirectionally, so the processor puts every prompt token
in image group 0, on the image-group pool of Gemma 3's glue
(multimodal/gemma3_vl.py ``ImageGroupModel``); generated tokens stay
causal. A Gemma-1 text config is refused, as the JAX package refuses it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Tuple

import torch

from ..models.gemma import Gemma2ForCausalLM
from ..models.modeling_utils import ModelConfig, register_model
from .encoders import linear_f32
from .gemma3_vl import ImageGroupModel
from .processor import (expand, image_list, mm_hash, pixels,
                        register_input_processor, splice)


@register_model("paligemma")
class PaliGemmaForConditionalGeneration(ImageGroupModel, Gemma2ForCausalLM):
    architectures = ("PaliGemmaForConditionalGeneration",)
    processor_type = "paligemma"
    hf_class = "PaliGemmaForConditionalGeneration"

    def __init__(self, model_config: ModelConfig):
        text = model_config.hf_config.text_config
        if text.model_type != "gemma2":
            raise NotImplementedError(
                "paligemma is served over gemma2 text configs (PaliGemma "
                f"2); a {text.model_type} text config (PaliGemma 1) is not "
                "supported by this package, nor by the JAX package")
        super().__init__(model_config)
        self.vision_tokens_per_image = self.tower.num_patches

    def load_projector(self, pj: Mapping[str, Any]) -> None:
        self.projector = {
            "w": self.tensor(pj["linear.weight"]).t().contiguous(),
            "b": self.tensor(pj["linear.bias"])}

    @torch.no_grad()
    def encode_images(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """[B, 3, H, W] -> float32 [B, patches, text hidden]: the
        projector summed in float32 plus its bias, over sqrt(hidden)."""
        h = self.tower(self.vision_params, pixel_values, feature_layer=-1,
                       apply_post_ln=True)
        h = linear_f32(h, self.projector["w"]) + self.projector["b"]
        return h / math.sqrt(self.hidden_size)


@register_input_processor("paligemma")
class PaliGemmaInputProcessor:
    """A prefix LM: every prompt token in group 0, so the whole prompt
    attends bidirectionally (JAX paligemma.py:104-142)."""

    def __init__(self, model):
        self.model = model
        self.image_token = model.image_token_index
        self.tokens_per_image = model.vision_tokens_per_image

    def __call__(self, token_ids: List[int], mm_data: Dict[str, Any]
                 ) -> Tuple[List[int], torch.Tensor, str, Dict[str, Any]]:
        images = image_list(mm_data)
        token_ids = expand(token_ids, self.image_token,
                           [self.tokens_per_image] * len(images))
        dev = self.model.device
        feats = self.model.encode_images(
            torch.stack([pixels(im, dev) for im in images]))
        rows = splice(token_ids, self.image_token,
                      feats.reshape(-1, feats.shape[-1]))
        return token_ids, rows, mm_hash(images), \
            {"mm_group_ids": torch.zeros(len(token_ids),
                                         dtype=torch.int32).numpy()}
