"""LLaVA-NeXT (LLaVA-1.6): anyres tiling.

Port of ``tensorrt_llm_tpu/multimodal/llava_next.py``. On top of
LLaVA-1.5 (multimodal/llava.py): an image comes as a base view and the
tiles of the best grid of ``image_grid_pinpoints``; the tiles' features
are put back into their 2D layout, cut back to the image's aspect ratio
(unpadded), and each row of features ends in the ``image_newline``
embedding. The packing runs on the device, in the tower's output type,
once per request; ``select_best_resolution``, ``get_anyres_image_grid_shape``
and ``unpad_image`` are the JAX package's (and transformers') pure
functions, kept here as a copy.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import torch

from ..models.modeling_utils import register_model
from .llava import LlavaForConditionalGeneration
from .processor import (expand, host_array, image_list, mm_hash, pixels,
                        register_input_processor, splice)


def select_best_resolution(orig_hw: Tuple[int, int],
                           possible: List[List[int]]) -> Tuple[int, int]:
    """transformers' select_best_resolution: the largest effective
    resolution, then the least wasted area."""
    oh, ow = orig_hw
    best, best_fit, min_waste = None, 0, None
    for h, w in possible:
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        eff = min(dw * dh, ow * oh)
        waste = (w * h) - eff
        if eff > best_fit or (eff == best_fit and
                              (min_waste is None or waste < min_waste)):
            best_fit, min_waste, best = eff, waste, (h, w)
    return best


def get_anyres_image_grid_shape(image_size, pinpoints, patch_size):
    h, w = select_best_resolution(tuple(image_size), pinpoints)
    return h // patch_size, w // patch_size


def unpad_image(tensor, original_size):
    """Remove the letterbox padding of a [C, H, W] feature grid
    (transformers' unpad_image: round, then floor the padding)."""
    oh, ow = original_size
    ch, cw = tensor.shape[1], tensor.shape[2]
    if ow / oh > cw / ch:
        new_h = int(round(oh * (cw / ow), 7))
        pad = (ch - new_h) // 2
        return tensor[:, pad:ch - pad, :]
    new_w = int(round(ow * (ch / oh), 7))
    pad = (cw - new_w) // 2
    return tensor[:, :, pad:cw - pad]


@register_model("llava_next")
class LlavaNextForConditionalGeneration(LlavaForConditionalGeneration):
    architectures = ("LlavaNextForConditionalGeneration",)
    processor_type = "llava_next"
    hf_class = "LlavaNextForConditionalGeneration"

    def load_hf_state_dict(self, sd: Mapping[str, Any]):
        key = "model.image_newline" if "model.image_newline" in sd \
            else "image_newline"
        self.image_newline = torch.as_tensor(sd[key]).to(
            device=self.device, dtype=torch.float32)
        return super().load_hf_state_dict(sd)


@register_input_processor("llava_next")
class LlavaNextInputProcessor:
    """Anyres feature assembly. ``mm_data``: ``image`` = one tile stack
    [num_tiles, 3, s, s] per image (transformers' image processor's
    output) and ``image_sizes`` = [(H, W), ...]."""

    def __init__(self, model):
        self.model = model
        self.image_token = model.image_token_index
        cfg = model.vlm_config
        self.pinpoints = cfg.image_grid_pinpoints
        self.vis_size = cfg.vision_config.image_size
        self.grid = self.vis_size // cfg.vision_config.patch_size

    def pack_one(self, feats: torch.Tensor, image_size) -> torch.Tensor:
        """feats [num_tiles, g*g, H] -> packed float32 [n_tokens, H]
        (transformers' pack_image_features)."""
        g = self.grid
        H = feats.shape[-1]
        feats = feats.float()
        nl = self.model.image_newline
        if feats.shape[0] == 1:
            return torch.cat([feats[0], nl[None]], dim=0)
        base, tiles = feats[0], feats[1:]
        nph, npw = get_anyres_image_grid_shape(image_size, self.pinpoints,
                                               self.vis_size)
        f = tiles.reshape(nph, npw, g, g, H).permute(4, 0, 2, 1, 3) \
            .reshape(H, nph * g, npw * g)
        f = unpad_image(f, image_size)
        newline = nl[:, None, None].expand(H, f.shape[1], 1)
        f = torch.cat([f, newline], dim=2).reshape(H, -1).t()
        return torch.cat([base, f], dim=0)

    def __call__(self, token_ids: List[int], mm_data: Dict[str, Any]
                 ) -> Tuple[List[int], torch.Tensor, str]:
        images = image_list(mm_data)
        sizes = mm_data.get("image_sizes")
        if sizes is None:
            raise ValueError("llava_next needs mm_data['image_sizes']")
        dev = self.model.device
        packed = [self.pack_one(self.model.encode_images(pixels(t, dev)),
                                tuple(int(x) for x in sz))
                  for t, sz in zip(images, sizes)]
        out_ids = expand(token_ids, self.image_token,
                         [len(p) for p in packed])
        return (out_ids, splice(out_ids, self.image_token,
                                torch.cat(packed, dim=0)),
                mm_hash([host_array(i) for i in images]))
