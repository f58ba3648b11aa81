"""Multimodal input processors: token ids and images -> (token ids,
prompt embeddings, salt).

Port of ``tensorrt_llm_tpu/multimodal/processor.py`` (the registry,
``create_input_processor``, ``mm_hash``, ``LlavaInputProcessor``). A
processor expands each image placeholder to the image's feature count,
runs the model's vision tower and projector, and returns the rows the
engine splices (``models/modeling_utils.embed_tokens``): float32 [T, H] on
the model's device, NaN where the token lookup stands. The JAX processor
returns the same rows on the host; here they stay on the device, where
the tower made them (at LLaVA-1.5-7B's width a 640-token prompt's rows are
10.5 MB, which would otherwise go up again with each prefill chunk).

The image hash doubles as the KV-reuse salt: two requests share cached
prefix blocks only when their token ids and their images' bytes match.
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

INPUT_PROCESSOR_REGISTRY: Dict[str, Callable] = {}


def register_input_processor(*model_types: str):
    def deco(cls):
        for mt in model_types:
            INPUT_PROCESSOR_REGISTRY[mt] = cls
        return cls
    return deco


def create_input_processor(model) -> Optional[Any]:
    """The processor registered for the model's ``processor_type`` (or
    its config's model type), or None."""
    mt = getattr(getattr(model, "vlm_config", None), "model_type", None) \
        or getattr(model.hf, "model_type", None)
    cls = INPUT_PROCESSOR_REGISTRY.get(getattr(model, "processor_type", mt))
    return cls(model) if cls is not None else None


def host_array(x) -> np.ndarray:
    """An image (numpy array or tensor) as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def mm_hash(images: Sequence[Any]) -> str:
    """Content hash of the image set: each image's shape and bytes (the
    JAX ``mm_hash``, so the two packages salt equal images alike)."""
    h = hashlib.sha256()
    for im in images:
        arr = np.ascontiguousarray(host_array(im))
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return "mm-" + h.hexdigest()[:32]


def image_list(mm_data: Dict[str, Any]) -> List[Any]:
    images = mm_data.get("image") or []
    return list(images) if isinstance(images, (list, tuple)) else [images]


def pixels(image, device: torch.device) -> torch.Tensor:
    """One image as float32 on ``device``."""
    return torch.as_tensor(host_array(image) if not isinstance(
        image, torch.Tensor) else image).to(device=device,
                                            dtype=torch.float32)


def expand(token_ids: Sequence[int], image_token: int,
           counts: Sequence[int]) -> List[int]:
    """One placeholder per image becomes ``counts[i]`` placeholders
    (transformers' processors expand already; id prompts may carry one
    marker an image); ids otherwise stay as they are."""
    n_ph = sum(1 for t in token_ids if t == image_token)
    if n_ph != len(counts):
        return list(token_ids)
    out: List[int] = []
    i = 0
    for t in token_ids:
        if t == image_token:
            out.extend([image_token] * counts[i])
            i += 1
        else:
            out.append(t)
    return out


def splice(token_ids: Sequence[int], image_token: int,
           feats: torch.Tensor) -> torch.Tensor:
    """float32 [T, H] on ``feats``' device: the feature rows [n, H] at
    the image tokens' positions, NaN elsewhere."""
    pos = [i for i, t in enumerate(token_ids) if t == image_token]
    if len(pos) != feats.shape[0]:
        raise ValueError(f"prompt has {len(pos)} image tokens, images "
                         f"supply {feats.shape[0]} feature rows")
    embeds = torch.full((len(token_ids), feats.shape[-1]), float("nan"),
                        dtype=torch.float32, device=feats.device)
    embeds[torch.as_tensor(pos, dtype=torch.long,
                           device=feats.device)] = feats.float()
    return embeds


@register_input_processor("llava")
class LlavaInputProcessor:
    """LLaVA-1.5: CLIP penultimate-layer patch features (class token
    dropped) through a two-layer GELU projector, spliced at the expanded
    image-token positions."""

    def __init__(self, model):
        self.model = model
        self.image_token = model.image_token_index
        self.tokens_per_image = model.vision_tokens_per_image

    def __call__(self, token_ids: List[int], mm_data: Dict[str, Any]
                 ) -> Tuple[List[int], torch.Tensor, str]:
        images = image_list(mm_data)
        token_ids = expand(token_ids, self.image_token,
                           [self.tokens_per_image] * len(images))
        dev = self.model.device
        feats = self.model.encode_images(
            torch.stack([pixels(im, dev) for im in images]))
        return (token_ids, splice(token_ids, self.image_token,
                                  feats.reshape(-1, feats.shape[-1])),
                mm_hash(images))
