"""Parameter conversion from the JAX package's Llama layout.

``from_jax_params`` takes the JAX ``LlamaForCausalLM`` parameter tree as
numpy arrays — stacked layers with a leading L axis, [in, out] matrices
under ``{"weight": ...}`` — and returns this package's parameters
([out, in] matrices, fused qkv and gate_up, a list of per-layer dicts), so
that both packages compute the same function from the same numbers.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def from_jax_params(params_np: Dict[str, Any], device="cpu",
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """JAX Llama params (numpy) -> port params (tensors on ``device``).
    ``dtype`` defaults to the type of the arrays."""

    def t(a) -> torch.Tensor:
        out = torch.from_numpy(np.array(a))          # a writable copy
        return out.to(device=device, dtype=dtype or out.dtype)

    def w(a) -> torch.Tensor:            # [in, out] -> [out, in]
        return t(np.asarray(a).T)

    lay = params_np["layers"]
    num_layers = lay["input_norm"].shape[0]
    layers = []
    for i in range(num_layers):
        layers.append({
            "input_norm": t(lay["input_norm"][i]),
            "post_norm": t(lay["post_norm"][i]),
            "qkv": {"weight": torch.cat([w(lay[n]["weight"][i])
                                         for n in ("q", "k", "v")])},
            "o": {"weight": w(lay["o"]["weight"][i])},
            "gate_up": {"weight": torch.cat([w(lay[n]["weight"][i])
                                             for n in ("gate", "up")])},
            "down": {"weight": w(lay["down"]["weight"][i])},
        })
    return {"embed": t(params_np["embed"]["weight"]),
            "layers": layers,
            "final_norm": t(params_np["final_norm"]),
            "lm_head": {"weight": w(params_np["lm_head"]["weight"])}}
