"""Vision encoders: the CLIP and SigLIP ViT towers.

Port of ``tensorrt_llm_tpu/multimodal/encoders.py`` (``VisionTower``): the
vision half of the LLaVA-style models. The patch "convolution" is an
unfold and a matmul (its stride is its kernel, so it is one linear map of
each patch); the layers are a Python loop over per-layer parameter dicts.
The JAX package leaves the tower to XLA (no Pallas kernel), so it stays
plain PyTorch: projections in the model's type, attention scores and
softmax in float32 over every patch (bidirectional), LayerNorm with its
weight in float32 (``ops.norm.layer_norm_f32``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import torch
import torch.nn.functional as F

from ..ops.linear import dot_f32
from ..ops.norm import layer_norm_f32


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def linear(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """x @ weight [in, out], then the bias when the layer has one."""
    out = x @ p["weight"]
    return out + p["bias"] if "bias" in p else out


def linear_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w [in, out] summed and returned in float32 (the JAX ``jnp.dot(
    ..., preferred_element_type=float32)`` without a cast back)."""
    out = dot_f32(x.reshape(-1, x.shape[-1]), w.t())
    return out.reshape(*x.shape[:-1], w.shape[1])


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           scale: float, keep: torch.Tensor = None) -> torch.Tensor:
    """Bidirectional attention of [B, T, heads, hd] in float32 (``keep``
    [.., T, T] masks keys out), returned [B, T, heads * hd] float32."""
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if keep is not None:
        scores = scores.masked_fill(~keep, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, -1)
    out = torch.einsum("bhts,bshd->bthd", probs, v.float())
    return out.reshape(out.shape[0], out.shape[1], -1)


class VisionTower:
    """The CLIP / SigLIP ViT body. The flavours differ in data: CLIP
    prepends a class token, takes quick_gelu and a pre-LayerNorm; SigLIP
    has a biased patch projection, tanh GELU and no class token."""

    def __init__(self, hf_config, *, flavor: str,
                 dtype: torch.dtype = torch.float32, device="cpu"):
        self.hf = hf_config
        self.flavor = flavor                      # "clip" | "siglip"
        self.dtype = dtype
        self.device = torch.device(device)
        self.D = hf_config.hidden_size
        self.heads = hf_config.num_attention_heads
        self.layers = hf_config.num_hidden_layers
        self.patch = hf_config.patch_size
        self.image_size = hf_config.image_size
        self.eps = getattr(hf_config, "layer_norm_eps", 1e-5)
        self.num_patches = (self.image_size // self.patch) ** 2
        self.num_pos = self.num_patches + (1 if flavor == "clip" else 0)
        self.act = quick_gelu if getattr(
            hf_config, "hidden_act", "quick_gelu") == "quick_gelu" \
            else (lambda x: F.gelu(x, approximate="tanh"))

    # -- weights ---------------------------------------------------------
    def load_hf_state_dict(self, sd: Mapping[str, Any],
                           prefix: str = "vision_model.") -> Dict[str, Any]:
        dev, dt, D = self.device, self.dtype, self.D

        def g(name):
            return torch.as_tensor(sd[prefix + name]).to(device=dev,
                                                         dtype=dt)

        def lin(name):
            out = {"weight": g(name + ".weight").t().contiguous()}
            if prefix + name + ".bias" in sd:
                out["bias"] = g(name + ".bias")
            return out

        pe = g("embeddings.patch_embedding.weight")       # [D, 3, P, P]
        params: Dict[str, Any] = {
            "patch": {"weight": pe.permute(2, 3, 1, 0).reshape(-1, D)
                      .contiguous()},                     # [P*P*3, D]
            "pos": g("embeddings.position_embedding.weight"),
        }
        if prefix + "embeddings.patch_embedding.bias" in sd:
            params["patch"]["bias"] = g("embeddings.patch_embedding.bias")
        if self.flavor == "clip":
            params["cls"] = g("embeddings.class_embedding")
            params["pre_ln"] = {"w": g("pre_layrnorm.weight"),
                                "b": g("pre_layrnorm.bias")}

        def layer(i):
            p = f"encoder.layers.{i}."
            return {
                "ln1_w": g(p + "layer_norm1.weight"),
                "ln1_b": g(p + "layer_norm1.bias"),
                "ln2_w": g(p + "layer_norm2.weight"),
                "ln2_b": g(p + "layer_norm2.bias"),
                "q": lin(p + "self_attn.q_proj"),
                "k": lin(p + "self_attn.k_proj"),
                "v": lin(p + "self_attn.v_proj"),
                "o": lin(p + "self_attn.out_proj"),
                "fc1": lin(p + "mlp.fc1"),
                "fc2": lin(p + "mlp.fc2"),
            }
        params["layers"] = [layer(i) for i in range(self.layers)]
        params["post_ln"] = {"w": g("post_layernorm.weight"),
                             "b": g("post_layernorm.bias")}
        return params

    # -- forward ---------------------------------------------------------
    @torch.no_grad()
    def __call__(self, params: Dict[str, Any], pixel_values: torch.Tensor,
                 feature_layer: int = -1,
                 apply_post_ln: bool = False) -> torch.Tensor:
        """pixel_values [B, 3, H, W] -> hidden states [B, tokens, D]
        after ``feature_layer`` encoder layers (-2: LLaVA's penultimate
        features); the post-LayerNorm only with ``apply_post_ln`` at
        ``feature_layer`` -1, as transformers' hidden states have it."""
        B = pixel_values.shape[0]
        P, D, dt = self.patch, self.D, self.dtype
        hp = self.image_size // P
        x = pixel_values.to(device=self.device, dtype=dt)
        x = x.reshape(B, 3, hp, P, hp, P).permute(0, 2, 4, 3, 5, 1) \
            .reshape(B, hp * hp, P * P * 3)
        h = linear(params["patch"], x)
        if self.flavor == "clip":
            cls = params["cls"].expand(B, 1, D)
            h = torch.cat([cls, h], dim=1)
        h = h + params["pos"][None, :h.shape[1]]
        if self.flavor == "clip":
            h = layer_norm_f32(h, params["pre_ln"]["w"], params["pre_ln"]["b"],
                               self.eps)
        heads = self.heads
        hd = D // heads
        n_run = self.layers + 1 + feature_layer if feature_layer < 0 \
            else feature_layer
        for layer in params["layers"][:n_run]:
            x = layer_norm_f32(h, layer["ln1_w"], layer["ln1_b"], self.eps)
            T = x.shape[1]
            q, k, v = (linear(layer[n], x).view(B, T, heads, hd)
                       for n in "qkv")
            attn = attend(q, k, v, 1.0 / math.sqrt(hd)).to(dt)
            h = h + linear(layer["o"], attn)
            x = layer_norm_f32(h, layer["ln2_w"], layer["ln2_b"], self.eps)
            x = self.act(linear(layer["fc1"], x).float())
            h = h + linear(layer["fc2"], x.to(dt))
        if apply_post_ln and feature_layer == -1:
            h = layer_norm_f32(h, params["post_ln"]["w"],
                               params["post_ln"]["b"], self.eps)
        return h
