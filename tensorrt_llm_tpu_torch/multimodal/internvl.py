"""InternVL 3 vision-language model.

Port of ``tensorrt_llm_tpu/multimodal/internvl.py``: the InternViT tower
(class token and learned positions, pre-norm blocks with LayerScale
lambdas, optional q/k RMS norms over the whole projection), the class
token dropped, the pixel shuffle (ratio 0.5: each 2x2 block of patches
becomes one token four times as wide), then LayerNorm and a two-layer
GELU projector into the text model, which rides the Llama trunk (a Qwen2
text config's attention biases included). Plain PyTorch on the model's
device, as the JAX package leaves it to XLA.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as F

from ..models.modeling_utils import ModelConfig, register_model
from ..ops.norm import layer_norm_f32
from .encoders import attend, linear, linear_f32
from .llava import VisionLanguageModel
from .processor import (expand, host_array, image_list, mm_hash, pixels,
                        register_input_processor, splice)


class InternVLVisionTower:
    def __init__(self, vc, dtype: torch.dtype, device):
        self.vc = vc
        self.dtype = dtype
        self.device = torch.device(device)
        self.D = vc.hidden_size
        self.heads = vc.num_attention_heads
        self.hd = self.D // self.heads
        self.layers = vc.num_hidden_layers
        self.eps = getattr(vc, "layer_norm_eps", 1e-6)
        img, pat = vc.image_size, vc.patch_size
        self.image_size = img[0] if isinstance(img, (list, tuple)) else img
        self.patch = pat[0] if isinstance(pat, (list, tuple)) else pat
        self.grid = self.image_size // self.patch
        self.use_qk_norm = bool(getattr(vc, "use_qk_norm", False))
        self.final_ln = not bool(getattr(vc, "use_mean_pooling", False))

    def load_hf_state_dict(self, sd: Mapping[str, Any]) -> Dict[str, Any]:
        dev, dt = self.device, self.dtype

        def a(n, d=None):
            return torch.as_tensor(sd[n]).to(device=dev, dtype=d or dt)

        def lin(n):
            out = {"weight": a(n + ".weight").t().contiguous()}
            if n + ".bias" in sd:
                out["bias"] = a(n + ".bias")
            return out

        def layer(i):
            p = f"encoder.layer.{i}."
            out = {
                "ln1_w": a(p + "layernorm_before.weight"),
                "ln1_b": a(p + "layernorm_before.bias"),
                "ln2_w": a(p + "layernorm_after.weight"),
                "ln2_b": a(p + "layernorm_after.bias"),
                "q": lin(p + "attention.q_proj"),
                "k": lin(p + "attention.k_proj"),
                "v": lin(p + "attention.v_proj"),
                "o": lin(p + "attention.projection_layer"),
                "fc1": lin(p + "mlp.fc1"),
                "fc2": lin(p + "mlp.fc2"),
                "l1": a(p + "lambda_1", torch.float32),
                "l2": a(p + "lambda_2", torch.float32),
            }
            if self.use_qk_norm:
                out["qn"] = a(p + "attention.q_norm.weight")
                out["kn"] = a(p + "attention.k_norm.weight")
            return out

        pe = a("embeddings.patch_embeddings.projection.weight")
        params = {
            "patch_w": pe.permute(2, 3, 1, 0).reshape(-1, self.D)
            .contiguous(),
            "patch_b": a("embeddings.patch_embeddings.projection.bias"),
            "cls": a("embeddings.cls_token"),
            "pos": a("embeddings.position_embeddings"),
            "layers": [layer(i) for i in range(self.layers)],
        }
        if self.final_ln:
            params["fln_w"] = a("layernorm.weight")
            params["fln_b"] = a("layernorm.bias")
        return params

    @torch.no_grad()
    def __call__(self, params: Dict[str, Any],
                 pixel_values: torch.Tensor) -> torch.Tensor:
        B = pixel_values.shape[0]
        Pz, D, hp, dt = self.patch, self.D, self.grid, self.dtype
        nh, hd = self.heads, self.hd
        x = pixel_values.to(device=self.device, dtype=dt)
        x = x.reshape(B, 3, hp, Pz, hp, Pz).permute(0, 2, 4, 3, 5, 1) \
            .reshape(B, hp * hp, Pz * Pz * 3)
        h = x @ params["patch_w"] + params["patch_b"]
        h = torch.cat([params["cls"][0].expand(B, 1, D), h], dim=1)
        h = h + params["pos"][0][None, :h.shape[1]]

        def rms(u, w):
            # over the whole projection, before the head split (as
            # transformers applies q_norm / k_norm)
            uf = u.reshape(B, u.shape[1], -1).float()
            var = uf.pow(2).mean(-1, keepdim=True)
            return (uf * torch.rsqrt(var + self.eps) * w.float()) \
                .reshape(u.shape).to(u.dtype)

        for blk in params["layers"]:
            T = h.shape[1]
            x = layer_norm_f32(h, blk["ln1_w"], blk["ln1_b"], self.eps)
            q, k, v = (linear(blk[n], x).view(B, T, nh, hd) for n in "qkv")
            if self.use_qk_norm:
                q, k = rms(q, blk["qn"]), rms(k, blk["kn"])
            attn = attend(q, k, v, 1.0 / math.sqrt(hd)).to(dt)
            h = h + blk["l1"].to(dt) * linear(blk["o"], attn)
            x = layer_norm_f32(h, blk["ln2_w"], blk["ln2_b"], self.eps)
            f = F.gelu(linear(blk["fc1"], x).float()).to(dt)
            h = h + blk["l2"].to(dt) * linear(blk["fc2"], f)
        if self.final_ln:
            h = layer_norm_f32(h, params["fln_w"], params["fln_b"], self.eps)
        return h


@register_model("internvl")
class InternVLForConditionalGeneration(VisionLanguageModel):
    architectures = ("InternVLForConditionalGeneration",)
    processor_type = "internvl"
    hf_class = "InternVLForConditionalGeneration"

    def __init__(self, model_config: ModelConfig):
        super().__init__(model_config)
        self.image_token_id = self.vlm_config.image_token_id
        self.downsample = self.vlm_config.downsample_ratio
        self.tower = InternVLVisionTower(self.vlm_config.vision_config,
                                         self.dtype, self.device)
        self.vision_tokens_per_image = int(
            (self.tower.grid * self.downsample) ** 2)

    def load_vision(self, vis: Mapping, pj: Mapping) -> None:
        self.vision_params = self.tower.load_hf_state_dict(vis)
        self.projector = {
            "ln_w": self.tensor(pj["layer_norm.weight"]),
            "ln_b": self.tensor(pj["layer_norm.bias"]),
            "l1": self.proj_linear(pj, "linear_1"),
            "l2": self.proj_linear(pj, "linear_2")}

    @torch.no_grad()
    def encode_images(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """[B, 3, H, W] -> float32 [B, tokens_per_image, H_text]."""
        g, ds, dt, pj = self.tower.grid, self.downsample, self.dtype, \
            self.projector
        h = self.tower(self.vision_params, pixel_values)[:, 1:]
        B, C = h.shape[0], h.shape[-1]
        # pixel shuffle (transformers' two permutes)
        f = h.reshape(B, g, int(g * ds), int(C / ds)).transpose(1, 2) \
            .reshape(B, int(g * ds), int(g * ds), int(C / (ds * ds))) \
            .transpose(1, 2).reshape(B, -1, int(C / (ds * ds)))
        f = layer_norm_f32(f, pj["ln_w"], pj["ln_b"], 1e-5)
        f = F.gelu(linear_f32(f, pj["l1"]["weight"]) + pj["l1"]["bias"])
        return linear_f32(f.to(dt), pj["l2"]["weight"]) + pj["l2"]["bias"]


@register_input_processor("internvl")
class InternVLInputProcessor:
    def __init__(self, model):
        self.model = model
        self.image_token = model.image_token_id
        self.tokens_per_image = model.vision_tokens_per_image

    def __call__(self, token_ids: List[int], mm_data: Dict[str, Any]
                 ) -> Tuple[List[int], torch.Tensor, str]:
        images = image_list(mm_data)
        out_ids = expand(token_ids, self.image_token,
                         [self.tokens_per_image] * len(images))
        dev = self.model.device
        feats = self.model.encode_images(
            torch.stack([pixels(im, dev) for im in images]))
        return (out_ids, splice(out_ids, self.image_token,
                                feats.reshape(-1, feats.shape[-1])),
                mm_hash([host_array(i) for i in images]))
