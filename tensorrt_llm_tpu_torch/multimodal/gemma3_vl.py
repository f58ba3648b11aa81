"""Gemma 3 vision-language model (Gemma3ForConditionalGeneration).

Port of ``tensorrt_llm_tpu/multimodal/gemma3_vl.py``: the SigLIP tower
(``last_hidden_state`` with the post-LayerNorm) average-pooled from its
patch grid to ``mm_tokens_per_image`` tokens, the zero-centred RMS norm
(its +1 folded in at load) and the ``[vis_h, text_h]`` projection,
spliced into the Gemma 3 text trunk (models/gemma.py). The tower and
projector run once per request on the caller's thread, in plain PyTorch,
as the JAX package leaves them to XLA.

An image's tokens attend to each other bidirectionally (transformers'
``token_type_ids`` or-mask). ``ImageGroupModel`` carries that mask for
Gemma 3 and PaliGemma (multimodal/paligemma.py): the cache is the dict
{"kv": the trunk's pool, "mm_group": i32[pages * page_size]}, the
persistent image group of every KV slot (-1: none), and each forward
scatters its tokens' groups (``AttentionMetadata.mm_groups_q``) into it
at ``slot_mapping`` before the layers run, so later chunks and decode
rows see the groups of earlier ones. Where a step carries no groups (the
decode windows) every appended slot gets -1: the JAX forward then leaves
the slot's previous owner's group in place (gemma3_vl.py:60-70). The
kernels apply the or-mask (ops/cuda/prefill_attention.py); decode rows
carry group -1 and go to the decode kernel as any text row.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Tuple

import torch

from ..models.gemma import Gemma3ForCausalLM
from ..models.modeling_utils import ModelConfig, register_model
from ..ops.attention import AttentionMetadata, scatter_slots
from .encoders import VisionTower
from .llava import image_token_of, split_checkpoint
from .processor import (expand, image_list, mm_hash, pixels,
                        register_input_processor, splice)


class ImageGroupModel:
    """The image-group glue, mixed in before a Gemma trunk class: the
    text config as the trunk's, the tower beside it, the group pool in
    the cache and its scatter in every forward."""
    uses_mm_groups = True
    # the transformers class whose meta-device shapes ``init_params`` draws
    hf_class = ""

    def __init__(self, model_config: ModelConfig):
        if model_config.uses_kv_quant:
            raise NotImplementedError(
                f"an 8-bit KV cache on {model_config.hf_config.model_type} "
                "is not supported by this package (the prefill kernel's "
                "image-group or-mask takes pools of the model's type)")
        self.vlm_config = model_config.hf_config
        super().__init__(dataclasses.replace(
            model_config, hf_config=model_config.hf_config.text_config))
        self.image_token_index = image_token_of(self.vlm_config)
        self.tower = VisionTower(self.vlm_config.vision_config,
                                 flavor="siglip", dtype=self.dtype,
                                 device=self.device)
        self.vision_params: Dict[str, Any] = {}
        self.projector: Dict[str, torch.Tensor] = {}

    def enable_vswa(self, window: int) -> None:
        raise NotImplementedError(
            f"VSWA (max_attention_window) is not served for "
            f"{self.vlm_config.model_type}: its image-group pool follows "
            "the one KV pool")

    def make_kv_pages(self, num_pages: int, page_size: int):
        return {"kv": super().make_kv_pages(num_pages, page_size),
                "mm_group": torch.full((num_pages * page_size,), -1,
                                       dtype=torch.int32,
                                       device=self.device)}

    def forward(self, params: Dict[str, Any], token_ids: torch.Tensor,
                kv_pages, metadata: AttentionMetadata,
                collect_hidden: bool = False, input_embeds=None):
        """The trunk's forward over ``kv_pages["kv"]``, after this step's
        groups (-1 where the step has none) are written into the group
        pool in place; returns (logits, kv_pages)."""
        pool = kv_pages["mm_group"]
        groups = metadata.mm_groups_q
        if groups is None:
            groups = torch.full_like(metadata.slot_mapping, -1)
        scatter_slots(pool, groups.to(torch.int32), metadata.slot_mapping)
        md = dataclasses.replace(metadata, mm_group_pool=pool)
        logits, _ = super().forward(params, token_ids, kv_pages["kv"], md,
                                    collect_hidden=collect_hidden,
                                    input_embeds=input_embeds)
        return logits, kv_pages

    def tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x).to(device=self.device,
                                     dtype=dtype or self.dtype)

    def load_hf_state_dict(self, sd: Mapping[str, Any]) -> Dict[str, Any]:
        lm, vis, pj = split_checkpoint(sd)
        self.vision_params = self.tower.load_hf_state_dict(vis)
        self.load_projector(pj)
        return super().load_hf_state_dict(lm)

    def load_projector(self, pj: Mapping[str, Any]) -> None:
        raise NotImplementedError

    def init_params(self, seed: int = 0) -> Dict[str, Any]:
        """Seeded random weights by the ``transformers`` model's shapes
        (``models.recurrent.RandomCheckpoint``; the JAX package refuses
        to serve these types without weights)."""
        import transformers
        from ..models.recurrent import RandomCheckpoint, meta_shapes
        shapes = meta_shapes(getattr(transformers, self.hf_class),
                             self.vlm_config)
        return self.load_hf_state_dict(RandomCheckpoint(
            shapes, self.device, self.dtype, seed=seed))


@register_model("gemma3", "gemma3_vl")
class Gemma3ForConditionalGeneration(ImageGroupModel, Gemma3ForCausalLM):
    architectures = ("Gemma3ForConditionalGeneration",)
    processor_type = "gemma3_vl"
    hf_class = "Gemma3ForConditionalGeneration"
    # the image rows enter unscaled, as transformers' Gemma3Model splices
    # them after its scaled embedding lookup; the JAX forward multiplies
    # them by sqrt(hidden) with the looked-up rows (ROADMAP C)
    scale_input_embeds = False

    def __init__(self, model_config: ModelConfig):
        super().__init__(model_config)
        self.mm_tokens_per_image = self.vlm_config.mm_tokens_per_image

    def load_projector(self, pj: Mapping[str, Any]) -> None:
        # the zero-centred gamma (Gemma3RMSNorm): the +1 folded at load
        self.projector = {
            "norm": self.tensor(torch.as_tensor(
                pj["mm_soft_emb_norm.weight"]).float() + 1.0),
            "proj": self.tensor(pj["mm_input_projection_weight"])}

    @torch.no_grad()
    def encode_images(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """[B, 3, H, W] -> [B, mm_tokens_per_image, text hidden] in the
        model's type (the JAX ``encode_images``)."""
        grid = self.tower.image_size // self.tower.patch
        side = int(round(math.sqrt(self.mm_tokens_per_image)))
        ks = grid // side
        eps = getattr(self.vlm_config.vision_config, "layer_norm_eps", 1e-6)
        h = self.tower(self.vision_params, pixel_values, feature_layer=-1,
                       apply_post_ln=True)            # [B, grid * grid, D]
        B, _, D = h.shape
        h = h.reshape(B, side, ks, side, ks, D).mean((2, 4))
        h = h.reshape(B, side * side, D).float()
        var = h.square().mean(-1, keepdim=True)
        h = (h * torch.rsqrt(var + eps) * self.projector["norm"].float()
             ).to(self.dtype)
        return h @ self.projector["proj"]


def image_groups(token_ids: List[int], image_token: int,
                 per_image: int) -> torch.Tensor:
    """int32 [T]: image i's run of ``per_image`` placeholders in group
    i, -1 elsewhere (the JAX processor's ids)."""
    groups = torch.full((len(token_ids),), -1, dtype=torch.int32)
    pos = [i for i, t in enumerate(token_ids) if t == image_token]
    for g in range(len(pos) // per_image):
        groups[pos[g * per_image:(g + 1) * per_image]] = g
    return groups


@register_input_processor("gemma3_vl")
class Gemma3VLInputProcessor:
    """``image``: a list of [3, H, W] images at the SigLIP input size. The
    placeholders expand to ``mm_tokens_per_image`` each; each image's run
    is its group (JAX gemma3_vl.py:128-173)."""

    def __init__(self, model):
        self.model = model
        self.image_token = model.image_token_index
        self.tokens_per_image = model.mm_tokens_per_image

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
        groups = image_groups(token_ids, self.image_token,
                              self.tokens_per_image)
        return token_ids, rows, mm_hash(images), \
            {"mm_group_ids": groups.numpy()}
