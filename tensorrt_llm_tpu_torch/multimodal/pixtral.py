"""Pixtral vision tower and Mistral3 (Mistral Small 3.1).

Port of ``tensorrt_llm_tpu/multimodal/pixtral.py``
(``PixtralVisionTower``, ``Mistral3ForConditionalGeneration``,
``Mistral3InputProcessor``). The Pixtral ViT takes images of any size (H
and W multiples of the patch): a patch projection without bias, an RMS
pre-norm, a 2D rotary embedding indexed by each patch's (row, column),
block-diagonal attention (a patch sees the patches of its own image
only), a SiLU-gated MLP. The Mistral3 projector: RMS norm, the 2x2 patch
merger (unfold and a linear map), a two-layer GELU projector. All plain
PyTorch on the model's device, as the JAX package leaves them to XLA;
where the JAX version keeps a product in float32 (``preferred_element_
type``), so does this one.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as F

from ..models.modeling_utils import ModelConfig, register_model
from ..ops.norm import rms_norm
from .encoders import attend, linear_f32
from .llava import VisionLanguageModel, image_token_of
from .processor import (expand, host_array, image_list, mm_hash, pixels,
                        register_input_processor, splice)


class PixtralVisionTower:
    def __init__(self, vc, dtype: torch.dtype, device):
        self.vc = vc
        self.dtype = dtype
        self.device = torch.device(device)
        self.D = vc.hidden_size
        self.layers = vc.num_hidden_layers
        self.heads = vc.num_attention_heads
        self.hd = getattr(vc, "head_dim", None) or self.D // self.heads
        self.patch = vc.patch_size
        self.maxp = vc.image_size // vc.patch_size
        self.theta = getattr(vc, "rope_theta", None) or (
            getattr(vc, "rope_parameters", None) or {}).get(
                "rope_theta", 10000.0)
        self.eps = 1e-5
        # the 2D rotary table [maxp * maxp, hd / 2]: rows take the even
        # frequencies, columns the odd ones (transformers'
        # PixtralRotaryEmbedding layout)
        fr = 1.0 / (self.theta ** (torch.arange(
            0, self.hd, 2, dtype=torch.float32) / self.hd))
        idx = torch.arange(self.maxp, dtype=torch.float32)
        fh = torch.outer(idx, fr[0::2])
        fw = torch.outer(idx, fr[1::2])
        n = self.maxp
        self.rope_table = torch.cat(
            [fh[:, None, :].expand(n, n, fh.shape[1]),
             fw[None, :, :].expand(n, n, fw.shape[1])],
            dim=-1).reshape(n * n, self.hd // 2).to(self.device)

    def load_hf_state_dict(self, sd: Mapping[str, Any]) -> Dict[str, Any]:
        dev, dt = self.device, self.dtype

        def g(n):
            return torch.as_tensor(sd[n]).to(device=dev, dtype=dt)

        def t(n):
            return g(n).t().contiguous()

        def layer(i):
            p = f"transformer.layers.{i}."
            return {
                "attn_norm": g(p + "attention_norm.weight"),
                "ffn_norm": g(p + "ffn_norm.weight"),
                "q": t(p + "attention.q_proj.weight"),
                "k": t(p + "attention.k_proj.weight"),
                "v": t(p + "attention.v_proj.weight"),
                "o": t(p + "attention.o_proj.weight"),
                "gate": t(p + "feed_forward.gate_proj.weight"),
                "up": t(p + "feed_forward.up_proj.weight"),
                "down": t(p + "feed_forward.down_proj.weight"),
            }

        pc = g("patch_conv.weight")                   # [D, 3, P, P]
        return {"patch_w": pc.reshape(pc.shape[0], -1).t().contiguous(),
                "ln_pre": g("ln_pre.weight"),
                "layers": [layer(i) for i in range(self.layers)]}

    @torch.no_grad()
    def forward(self, params: Dict[str, Any], patches: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor,
                seg: torch.Tensor) -> torch.Tensor:
        dt, nh, hd = self.dtype, self.heads, self.hd
        x = patches.to(dt) @ params["patch_w"]
        x = rms_norm(x, params["ln_pre"], self.eps)
        L = x.shape[0]
        keep = (seg[:, None] == seg[None, :])[None, None]

        def rot(u):
            uf = u.float()
            u1, u2 = uf[..., :hd // 2], uf[..., hd // 2:]
            c, s = cos[:, None], sin[:, None]
            return torch.cat([u1 * c - u2 * s, u2 * c + u1 * s], -1)

        for blk in params["layers"]:
            h = rms_norm(x, blk["attn_norm"], self.eps)
            q, k, v = ((h @ blk[n]).view(L, nh, hd) for n in "qkv")
            o = attend(rot(q)[None], rot(k)[None], v[None],
                       1.0 / math.sqrt(hd), keep)[0]
            x = x + o.to(dt) @ blk["o"]
            h = rms_norm(x, blk["ffn_norm"], self.eps)
            gg = linear_f32(h, blk["gate"])
            uu = h @ blk["up"]
            x = x + (F.silu(gg).to(dt) * uu) @ blk["down"]
        return x

    def encode(self, params: Dict[str, Any],
               images: List[torch.Tensor]) -> torch.Tensor:
        """images: [3, H, W] each (H, W multiples of the patch) -> the
        per-patch features of all of them, [L, D], row-major per image."""
        P = self.patch
        rows, pos, seg = [], [], []
        for i, im in enumerate(images):
            c, H, W = im.shape
            hp, wp = H // P, W // P
            rows.append(im.reshape(c, hp, P, wp, P).permute(1, 3, 0, 2, 4)
                        .reshape(hp * wp, c * P * P))
            hh, ww = torch.meshgrid(torch.arange(hp), torch.arange(wp),
                                    indexing="ij")
            pos.append((hh * self.maxp + ww).reshape(-1))
            seg.append(torch.full((hp * wp,), i, dtype=torch.int32))
        emb = self.rope_table[torch.cat(pos).to(self.device)]
        return self.forward(params, torch.cat(rows), torch.cos(emb),
                            torch.sin(emb), torch.cat(seg).to(self.device))


@register_model("mistral3")
class Mistral3ForConditionalGeneration(VisionLanguageModel):
    architectures = ("Mistral3ForConditionalGeneration",)
    processor_type = "mistral3"
    hf_class = "Mistral3ForConditionalGeneration"

    def __init__(self, model_config: ModelConfig):
        super().__init__(model_config)
        self.image_token_index = image_token_of(self.vlm_config)
        self.spatial_merge = self.vlm_config.spatial_merge_size
        self.tower = PixtralVisionTower(self.vlm_config.vision_config,
                                        self.dtype, self.device)

    def load_vision(self, vis: Mapping, pj: Mapping) -> None:
        self.vision_params = self.tower.load_hf_state_dict(vis)
        self.projector = {
            "norm": self.tensor(pj["norm.weight"]),
            "merge": self.proj_linear(pj, "patch_merger.merging_layer")[
                "weight"],
            "l1": self.proj_linear(pj, "linear_1"),
            "l2": self.proj_linear(pj, "linear_2")}

    @torch.no_grad()
    def encode_images(self, images: List[torch.Tensor]) -> torch.Tensor:
        """[3, H, W] each -> merged and projected features, float32
        [n_tokens, H_lm]."""
        feats = self.tower.encode(self.vision_params, images)
        pj, dt = self.projector, self.dtype
        feats = rms_norm(feats, pj["norm"], self.rms_eps)
        m, P = self.spatial_merge, self.tower.patch
        merged, off = [], 0
        for im in images:
            hp, wp = im.shape[1] // P, im.shape[2] // P
            f = feats[off:off + hp * wp].reshape(hp, wp, -1)
            d = f.shape[-1]
            # unfold m x m blocks, channel-major within the block (torch
            # unfold's layout)
            merged.append(f.reshape(hp // m, m, wp // m, m, d)
                          .permute(0, 2, 4, 1, 3)
                          .reshape((hp // m) * (wp // m), d * m * m))
            off += hp * wp
        x = linear_f32(torch.cat(merged), pj["merge"])
        for name in ("l1", "l2"):
            if name == "l2":
                x = F.gelu(x)
            x = linear_f32(x.to(dt), pj[name]["weight"])
            if "bias" in pj[name]:
                x = x + pj[name]["bias"]
        return x


@register_input_processor("mistral3")
class Mistral3InputProcessor:
    """``image`` = [3, H, W] arrays, H and W multiples of patch x
    spatial_merge (transformers' processor makes them so)."""

    def __init__(self, model):
        self.model = model
        self.image_token = model.image_token_index

    def __call__(self, token_ids: List[int], mm_data: Dict[str, Any]
                 ) -> Tuple[List[int], torch.Tensor, str]:
        images = image_list(mm_data)
        m, P = self.model.spatial_merge, self.model.tower.patch
        dev = self.model.device
        ims = [pixels(im, dev) for im in images]
        counts = [(im.shape[1] // P // m) * (im.shape[2] // P // m)
                  for im in ims]
        out_ids = expand(token_ids, self.image_token, counts)
        feats = self.model.encode_images(ims)
        return (out_ids, splice(out_ids, self.image_token, feats),
                mm_hash([host_array(i) for i in images]))
