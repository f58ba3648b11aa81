"""Rotary position embeddings.

Port of ``tensorrt_llm_tpu/ops/rope.py`` (``RopeConfig``,
``compute_inv_freq``, ``rope_cos_sin``, ``apply_rope``, ``mrope_cos_sin``)
and of Qwen3-VL's interleaved M-RoPE tables. The inverse frequency table
and the angles are float32, as in the JAX version.

Scaling families: none, linear, llama3 (low/high-frequency wavelength
bands) and yarn; gpt-neox (rotate halves) and gpt-j (interleaved) styles.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class RopeConfig:
    head_dim: int
    rope_theta: float = 10000.0
    max_position_embeddings: int = 8192
    scaling_type: str = "none"       # none|linear|llama3|yarn|dynamic
    scaling_factor: float = 1.0
    # llama3
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192
    # yarn
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0
    # style
    is_neox: bool = True
    partial_rotary_factor: float = 1.0

    @classmethod
    def from_hf_config(cls, cfg, head_dim: Optional[int] = None,
                       layer_type: str = "full_attention") -> "RopeConfig":
        """The rotary table of ``cfg``'s layers of ``layer_type``
        ("full_attention" or "sliding_attention": models whose two kinds
        of layers rotate by different bases, as Gemma 3's do)."""
        head_dim = head_dim or getattr(cfg, "head_dim", None) or \
            cfg.hidden_size // cfg.num_attention_heads
        # transformers 5 keeps theta and the scaling in rope_parameters,
        # keyed by layer type where the layer types differ; earlier
        # versions in rope_theta and rope_scaling
        def of_layer(d):
            d = d or {}
            if any(isinstance(d.get(k), dict)
                   for k in ("full_attention", "sliding_attention")):
                return d.get(layer_type) or d.get("full_attention") or {}
            return d
        rp = of_layer(getattr(cfg, "rope_parameters", None))
        rs = of_layer(getattr(cfg, "rope_scaling", None)) or rp
        stype = rs.get("rope_type", rs.get("type", "none")) if rs else "none"
        if stype == "default":
            stype = "none"
        theta = rp.get("rope_theta") or getattr(cfg, "rope_theta", None)
        return cls(
            head_dim=head_dim,
            rope_theta=theta or 10000.0,
            max_position_embeddings=getattr(cfg, "max_position_embeddings",
                                            8192),
            scaling_type=stype,
            scaling_factor=rs.get("factor", 1.0),
            low_freq_factor=rs.get("low_freq_factor", 1.0),
            high_freq_factor=rs.get("high_freq_factor", 4.0),
            original_max_position_embeddings=rs.get(
                "original_max_position_embeddings",
                getattr(cfg, "max_position_embeddings", 8192)),
            beta_fast=rs.get("beta_fast", 32.0),
            beta_slow=rs.get("beta_slow", 1.0),
            mscale=rs.get("mscale", 1.0),
            mscale_all_dim=rs.get("mscale_all_dim", 0.0),
            partial_rotary_factor=getattr(cfg, "partial_rotary_factor", None)
            or rp.get("partial_rotary_factor", 1.0),
        )


def compute_inv_freq(cfg: RopeConfig,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    """Per-dimension inverse frequencies (float32) with scaling applied."""
    rotary_dim = int(cfg.head_dim * cfg.partial_rotary_factor)
    exponent = torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                            device=device) / rotary_dim
    inv_freq = 1.0 / (cfg.rope_theta ** exponent)
    if cfg.scaling_type == "linear":
        inv_freq = inv_freq / cfg.scaling_factor
    elif cfg.scaling_type == "llama3":
        orig = cfg.original_max_position_embeddings
        low_wl = orig / cfg.low_freq_factor
        high_wl = orig / cfg.high_freq_factor
        wavelen = 2 * math.pi / inv_freq
        smooth = (orig / wavelen - cfg.low_freq_factor) \
            / (cfg.high_freq_factor - cfg.low_freq_factor)
        smooth = torch.clamp(smooth, 0.0, 1.0)
        scaled = inv_freq / cfg.scaling_factor
        smoothed = (1 - smooth) * scaled + smooth * inv_freq
        inv_freq = torch.where(wavelen > low_wl, scaled,
                               torch.where(wavelen < high_wl, inv_freq,
                                           smoothed))
    elif cfg.scaling_type == "yarn":
        rot = rotary_dim

        def find_dim(num_rot):
            return (rot * math.log(cfg.original_max_position_embeddings /
                                   (num_rot * 2 * math.pi))) / \
                (2 * math.log(cfg.rope_theta))
        low = max(math.floor(find_dim(cfg.beta_fast)), 0)
        high = min(math.ceil(find_dim(cfg.beta_slow)), rot // 2 - 1)
        ramp = (torch.arange(rot // 2, dtype=torch.float32, device=device)
                - low) / max(high - low, 1)
        mask = 1.0 - torch.clamp(ramp, 0.0, 1.0)
        inv_freq = inv_freq / cfg.scaling_factor * (1 - mask) \
            + inv_freq * mask
    return inv_freq


def rope_cos_sin(cfg: RopeConfig, positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables at the given positions: ([T, rot/2], [T, rot/2])."""
    inv_freq = compute_inv_freq(cfg, positions.device)
    angles = positions.float()[:, None] * inv_freq[None, :]
    attn_scale = 1.0
    if cfg.scaling_type == "yarn":
        # transformers' yarn attention factor: the ratio of the two
        # magnitudes when the config sets both, else the factor's own
        def yarn_mscale(scale, m=1.0):
            return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0
        f = cfg.scaling_factor
        attn_scale = yarn_mscale(f, cfg.mscale) / \
            yarn_mscale(f, cfg.mscale_all_dim) \
            if cfg.mscale and cfg.mscale_all_dim else yarn_mscale(f)
    return torch.cos(angles) * attn_scale, torch.sin(angles) * attn_scale


def mrope_section(cfg, default: tuple) -> tuple:
    """A text config's M-RoPE sections (``mrope_section``, from
    ``rope_scaling`` or transformers 5's ``rope_parameters``), or
    ``default``."""
    for name in ("rope_scaling", "rope_parameters"):
        d = getattr(cfg, name, None) or {}
        if d.get("mrope_section"):
            return tuple(d["mrope_section"])
    return tuple(default)


def _angles3(cfg: RopeConfig, positions3: torch.Tensor) -> torch.Tensor:
    """float32 [3, T, rot/2]: each axis's positions times the inverse
    frequencies."""
    inv_freq = compute_inv_freq(cfg, positions3.device)
    return positions3.float()[:, :, None] * inv_freq[None, None, :]


def mrope_cos_sin(cfg: RopeConfig, positions3: torch.Tensor,
                  sections: tuple) -> Tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE tables (Qwen2-VL, Qwen2.5-VL, GLM-4.1V; the JAX
    ``mrope_cos_sin``, ops/rope.py:149): ``positions3`` i32[3, T] holds
    the temporal, height and width positions; the rot/2 frequency dims
    are cut into ``sections`` and section j takes its angles from axis
    j % 3. Where the three axes agree, these are ``rope_cos_sin``'s
    tables at that position (the decode windows rely on it)."""
    angles3 = _angles3(cfg, positions3)
    parts, off = [], 0
    for j, s in enumerate(sections):
        parts.append(angles3[j % 3, :, off:off + s])
        off += s
    angles = torch.cat(parts, dim=-1)
    return torch.cos(angles), torch.sin(angles)


def mrope_cos_sin_interleaved(cfg: RopeConfig, positions3: torch.Tensor,
                              sections: tuple
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen3-VL's interleaved M-RoPE (the JAX
    ``mrope_cos_sin_interleaved``, multimodal/qwen3_vl.py:35): the
    temporal angles, with the height axis's at dims 1, 4, ..., 3 *
    sections[1] - 2 and the width axis's at dims 2, 5, ..., 3 *
    sections[2] - 1."""
    angles3 = _angles3(cfg, positions3)
    angles = angles3[0].clone()
    rot = angles.shape[-1]
    for dim, offset in ((1, 1), (2, 2)):
        # a strided slice, not an index tensor: no host copy, so a CUDA
        # graph can capture it
        end = min(sections[dim] * 3, rot)
        angles[:, offset:end:3] = angles3[dim][:, offset:end:3]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               is_neox: bool = True) -> torch.Tensor:
    """Apply RoPE to ``x`` of shape [T, heads, head_dim] (math in f32).

    neox style rotates (first, second) halves; gpt-j style rotates (even,
    odd) interleaved pairs."""
    rot = cos.shape[-1] * 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    xf = x_rot.float()
    c = cos[:, None, :]
    s = sin[:, None, :]
    if is_neox:
        x1, x2 = xf[..., :rot // 2], xf[..., rot // 2:]
        out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    else:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                          dim=-1).reshape(xf.shape)
    out = out.to(x.dtype)
    if x_pass.shape[-1]:
        out = torch.cat([out, x_pass], dim=-1)
    return out
