"""Normalization ops.

Port of ``tensorrt_llm_tpu/ops/norm.py`` (``rms_norm``,
``rms_norm_residual``): the statistics are taken in float32 and the
result cast back to the input's type before the weight multiply, as the
JAX version does.
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
