"""Linear layer method (unquantized only).

Port of the unquantized ``LinearMethod`` of
``tensorrt_llm_tpu/ops/linear.py``. Weights keep PyTorch's [out, in]
layout, so ``apply`` is ``F.linear``; a bf16 product accumulates in
float32 inside cuBLAS, as the JAX version asks with
``preferred_element_type=float32``. Quantized methods (and the groupwise
dequant-matmul kernel they use) are not ported yet.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


class LinearMethod:
    """Unquantized matmul."""
    name = "unquantized"

    def quantize_weights(self, w: torch.Tensor,
                         dtype: torch.dtype = torch.bfloat16
                         ) -> Dict[str, torch.Tensor]:
        return {"weight": w.to(dtype)}

    def apply(self, params: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, params["weight"], params.get("bias"))
