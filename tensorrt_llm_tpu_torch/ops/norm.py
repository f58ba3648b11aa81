"""Normalization ops.

Port of ``tensorrt_llm_tpu/ops/norm.py`` (``rms_norm``,
``rms_norm_residual``, ``layer_norm``, ``layer_norm_residual``): the
statistics are taken in float32 and the result cast back to the input's
type before the weight multiply (and bias add), as the JAX version does.
XLA fuses these on the TPU; no Pallas kernel computes them. ``gemma_rms_norm`` is Gemma's variant
(``tensorrt_llm_tpu/models/gemma.py:26``): ``x * rsqrt(mean x^2 + eps)
* (1 + w)`` all in float32, cast back only at the end, and
``layer_norm_f32`` the encoders' LayerNorm (BERT, the vision towers),
whose weight and bias are applied in float32 too.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight
    if bias is not None:
        out = out + bias
    return out


def rms_norm_residual(x: torch.Tensor, residual: torch.Tensor,
                      weight: torch.Tensor, eps: float = 1e-6
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual add + RMSNorm: returns (normed, new_residual)."""
    resid = x + residual
    return rms_norm(resid, weight, eps), resid


def gemma_rms_norm(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Gemma's RMS norm: the weight is an offset from 1, and the product
    is taken in float32 before the cast back to ``x``'s type."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + weight.float())
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with the population variance, in float32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    d = xf - mean
    var = (d * d).mean(dim=-1, keepdim=True)
    out = (d / torch.sqrt(var + eps)).to(x.dtype) * weight
    if bias is not None:
        out = out + bias
    return out


def layer_norm_f32(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with the statistics, the weight and the bias in float32,
    cast back to ``x``'s type at the end (the JAX package's BERT and
    vision-tower ``_ln``, models/bert.py:22, multimodal/encoders.py:21)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    d = xf - mean
    var = (d * d).mean(dim=-1, keepdim=True)
    return (d * torch.rsqrt(var + eps) * weight.float()
            + bias.float()).to(x.dtype)


def layer_norm_residual(x: torch.Tensor, residual: torch.Tensor,
                        weight: torch.Tensor, bias: Optional[torch.Tensor],
                        eps: float = 1e-5
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual add + LayerNorm: returns (normed, new_residual)."""
    resid = x + residual
    return layer_norm(resid, weight, bias, eps), resid
