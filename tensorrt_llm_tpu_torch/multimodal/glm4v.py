"""GLM-4.1V / GLM-4.5V (glm4v): the GLM-4 trunk with chunked M-RoPE.

Port of ``tensorrt_llm_tpu/multimodal/glm4v.py`` (``grid_sample_bicubic``,
``Glm4vVisionTower``, ``Glm4vForConditionalGeneration``,
``Glm4vInputProcessor``). The tower: the patch projection and an RMSNorm
after it, learned position embeddings bicubically grid-sampled to each
grid (numpy on the host, torch ``grid_sample``'s a = -0.75, border
padding, align_corners False), 2D-rotary RMSNorm blocks with SiLU-gated
MLPs and attention within each frame, a post-RMSNorm, the 2x2 downsample
(a convolution whose stride is its kernel: one linear map of each merge
block) and the merger: projection, LayerNorm, GELU, a SiLU-gated MLP. The
text trunk is GLM-4 (sandwich norms, partial interleaved rotary,
models/glm.py) whose rotary half takes the M-RoPE sections
(ops/rope.py ``mrope_cos_sin``). Placeholders and positions are
Qwen2-VL's (multimodal/qwen2_vl.py).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from ..models.glm import Glm4ForCausalLM
from ..models.modeling_utils import register_model
from ..ops.norm import rms_norm
from .encoders import linear_f32
from .processor import register_input_processor, to_device
from .qwen2_vl import (MropeVisionModel, Qwen2VLInputProcessor,
                       masked_attention, patch_matrix, rot_pos_ids,
                       rotary_angles, rotary_tables, rotate_half_2d,
                       same_segment, tower_tensor)


def _cubic_w(x, a=-0.75):
    ax = np.abs(x)
    return np.where(
        ax <= 1, (a + 2) * ax ** 3 - (a + 3) * ax ** 2 + 1,
        np.where(ax < 2, a * (ax ** 3 - 5 * ax ** 2 + 8 * ax - 4), 0.0))


def grid_sample_bicubic(img: np.ndarray, xs: np.ndarray,
                        ys: np.ndarray) -> np.ndarray:
    """torch ``grid_sample(mode="bicubic", padding_mode="border",
    align_corners=False)`` of img [H, W, C] at float pixel coordinates
    (already unnormalized): float32 [n, C]."""
    H, W, C = img.shape
    x0 = np.floor(xs).astype(int)
    y0 = np.floor(ys).astype(int)
    out = np.zeros((xs.shape[0], C), np.float32)
    for dy in range(-1, 3):
        wy = _cubic_w(ys - (y0 + dy))
        yy = np.clip(y0 + dy, 0, H - 1)
        for dx in range(-1, 3):
            wx = _cubic_w(xs - (x0 + dx))
            xx = np.clip(x0 + dx, 0, W - 1)
            out += (wy * wx)[:, None] * img[yy, xx]
    return out


class Glm4vVisionTower:
    def __init__(self, vc, dtype: torch.dtype, device):
        self.vc = vc
        self.dtype = dtype
        self.device = torch.device(device)
        self.depth = vc.depth
        self.D = vc.hidden_size
        self.heads = vc.num_heads
        self.hd = self.D // self.heads
        self.merge = vc.spatial_merge_size
        self.patch = vc.patch_size
        self.tpatch = vc.temporal_patch_size
        self.out_dim = vc.out_hidden_size
        self.eps = getattr(vc, "rms_norm_eps", 1e-5)

    def _w(self, sd, name, transpose=False):
        return tower_tensor(sd, name, self.device, self.dtype, transpose)

    def load_hf_state_dict(self, sd: Mapping[str, Any]) -> Dict[str, Any]:
        def block(i):
            p = f"blocks.{i}."
            out = {
                "n1": self._w(sd, p + "norm1.weight"),
                "n2": self._w(sd, p + "norm2.weight"),
                "qkv_w": self._w(sd, p + "attn.qkv.weight", True),
                "proj_w": self._w(sd, p + "attn.proj.weight", True),
                "gate": self._w(sd, p + "mlp.gate_proj.weight", True),
                "up": self._w(sd, p + "mlp.up_proj.weight", True),
                "down": self._w(sd, p + "mlp.down_proj.weight", True),
            }
            if p + "attn.qkv.bias" in sd:           # attention_bias=True
                out["qkv_b"] = self._w(sd, p + "attn.qkv.bias")
            return out

        dw = self._w(sd, "downsample.weight")          # [out, D, m, m]
        return {
            "patch_w": patch_matrix(sd, self.device, self.dtype),
            "patch_b": self._w(sd, "patch_embed.proj.bias"),
            "post_conv_ln": self._w(sd, "post_conv_layernorm.weight"),
            # float32 on the host: the bicubic sampler's input (the JAX
            # tower keeps it so)
            "pos": torch.as_tensor(
                sd["embeddings.position_embedding.weight"]).float()
            .cpu().numpy(),
            "blocks": [block(i) for i in range(self.depth)],
            "post_ln": self._w(sd, "post_layernorm.weight"),
            # the stride-m convolution as a linear map of the (d, ky, kx)
            # flattened block
            "down_w": dw.reshape(dw.shape[0], -1).t().contiguous(),
            "down_b": self._w(sd, "downsample.bias"),
            "m_proj": self._w(sd, "merger.proj.weight", True),
            "m_ln_w": self._w(sd, "merger.post_projection_norm.weight"),
            "m_ln_b": self._w(sd, "merger.post_projection_norm.bias"),
            "m_gate": self._w(sd, "merger.gate_proj.weight", True),
            "m_up": self._w(sd, "merger.up_proj.weight", True),
            "m_down": self._w(sd, "merger.down_proj.weight", True),
        }

    def _swiglu(self, x, gate, up, down):
        dt = self.dtype
        g = linear_f32(x, gate)
        u = linear_f32(x, up).to(dt)
        return linear_f32(F.silu(g).to(dt) * u, down).to(dt)

    @torch.no_grad()
    def forward(self, params, patches, pos_rows, cos, sin, keep):
        dt, eps, L = self.dtype, self.eps, patches.shape[0]
        x = linear_f32(patches.to(dt), params["patch_w"]).to(dt) \
            + params["patch_b"]
        x = rms_norm(x, params["post_conv_ln"], eps)
        x = x + pos_rows.to(dt)
        for blk in params["blocks"]:
            h = rms_norm(x, blk["n1"], eps)
            qkv = linear_f32(h, blk["qkv_w"]).to(dt)
            if "qkv_b" in blk:
                qkv = qkv + blk["qkv_b"]
            q, k, v = qkv.view(L, 3, self.heads, self.hd).unbind(1)
            o = masked_attention(rotate_half_2d(q, cos, sin),
                                 rotate_half_2d(k, cos, sin), v, keep)
            x = x + linear_f32(o.to(dt), blk["proj_w"]).to(dt)
            h = rms_norm(x, blk["n2"], eps)
            x = x + self._swiglu(h, blk["gate"], blk["up"], blk["down"])
        x = rms_norm(x, params["post_ln"], eps)
        # the downsample over each merge block: rows are merger-block
        # ordered, so a block's (ky, kx) pairs are consecutive; the
        # convolution flattens (d, ky, kx) d-major
        m = self.merge
        blkx = x.reshape(-1, m * m, self.D).transpose(1, 2) \
            .reshape(-1, self.D * m * m)
        y = (linear_f32(blkx, params["down_w"]) + params["down_b"]).to(dt)
        y = linear_f32(y, params["m_proj"]).to(dt)
        yf = y.float()
        mu = yf.mean(-1, keepdim=True)
        var = ((yf - mu) ** 2).mean(-1, keepdim=True)
        yn = (yf - mu) * torch.rsqrt(var + 1e-5) * \
            params["m_ln_w"].float() + params["m_ln_b"].float()
        y = F.gelu(yn).to(dt)
        return self._swiglu(y, params["m_gate"], params["m_up"],
                            params["m_down"])

    def encode(self, params, pixel_values: torch.Tensor, grid_thw
               ) -> torch.Tensor:
        """Flattened patches float32 [L, C*t*p*p] on the device + grids
        -> merged features [L / merge^2, out_dim] in the model's type."""
        pos = rot_pos_ids(grid_thw, self.merge)            # [L, 2] (h, w)
        tab = params["pos"]
        side = int(tab.shape[0] ** 0.5)
        img = tab.reshape(side, side, -1)
        th = np.concatenate([np.full(int(t * h * w), h, np.float32)
                             for t, h, w in grid_thw])
        tw = np.concatenate([np.full(int(t * h * w), w, np.float32)
                             for t, h, w in grid_thw])
        xs = (pos[:, 1] + 0.5) / tw * side - 0.5
        ys = (pos[:, 0] + 0.5) / th * side - 0.5
        pos_rows = grid_sample_bicubic(img, xs, ys)
        emb = rotary_angles(pos, self.hd)
        # attention stays within each frame: h*w patches, t times
        seg = np.zeros(pos.shape[0], np.int32)
        off = sid = 0
        for t, h, w in grid_thw:
            for _ in range(int(t)):
                seg[off:off + int(h * w)] = sid
                off += int(h * w)
                sid += 1
        dev = self.device
        return self.forward(params, pixel_values,
                            to_device(pos_rows, dev, torch.float32),
                            *rotary_tables(emb, dev), same_segment(seg, dev))


@register_model("glm4v")
class Glm4vForConditionalGeneration(MropeVisionModel, Glm4ForCausalLM):
    architectures = ("Glm4vForConditionalGeneration",)
    processor_type = "glm4v"
    hf_class = "Glm4vForConditionalGeneration"
    tower_cls = Glm4vVisionTower
    default_sections = (8, 12, 12)


@register_input_processor("glm4v")
class Glm4vInputProcessor(Qwen2VLInputProcessor):
    """Qwen2-VL's placeholder expansion and positions (chunked
    sections)."""
