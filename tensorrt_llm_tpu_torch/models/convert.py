"""Parameter conversion from the JAX package's Llama and MoE layouts.

``from_jax_params`` takes the parameter tree of the JAX
``LlamaForCausalLM`` (Qwen2/Qwen3 and Gemma 2/3 included) or
``MixtralForCausalLM``
(Qwen2-MoE, Qwen3-MoE, OLMoE included) as numpy arrays — stacked layers
with a leading L axis, one dict per projection — and returns this
package's parameters (a list of per-layer dicts, fused qkv and gate_up),
so that both packages compute the same function from the same numbers.
An unquantized projection (``{"weight": [in, out]}``) becomes
``{"weight": [out, in]}``; a weight-only quantized one keeps its [K, N]
integers (packed int4 included), ``weight_scale``, ``weight_zero`` and
``bias`` as they are. The MoE parts: ``router`` [L, H, E] becomes [E, H];
the experts ``w_gate`` / ``w_up`` [L, E, H, I] become one ``w_gate_up``
[E, H, 2I] and ``w_down`` [L, E, I, H] stays [E, I, H] (ops/moe.py's
layout); the shared expert's ``se_gate`` / ``se_up`` projections fuse into
``se_gate_up``, and its gate ``se_gate_w`` [L, H, 1] becomes [1, H].
``q_norm`` / ``k_norm`` are carried as they are, and so are the four
norms of the JAX Gemma models (``post_attn_norm``, ``pre_ffn_norm``,
``post_ffn_norm`` beside ``input_norm``); their ``is_sliding`` flags are
static config here (``Gemma2ForCausalLM.layer_specs``) and are dropped.
With ``kv_scales`` (a model on a quantized KV cache), the JAX Llama's
per-layer ``kv_scale`` [L] (float32) becomes each layer's 0-dim float32
``kv_scale``, so that both packages quantize with the same scales.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..ops.linear import fuse_params


# a layer's norm weights: the Llama trunk's two, or Gemma's four
_NORMS = ("input_norm", "post_norm", "post_attn_norm", "pre_ffn_norm",
          "post_ffn_norm")


def from_jax_params(params_np: Dict[str, Any], device="cpu",
                    dtype: Optional[torch.dtype] = None,
                    kv_scales: bool = False) -> Dict[str, Any]:
    """JAX Llama params (numpy) -> port params (tensors on ``device``).
    ``dtype`` (default: the arrays' own) applies to the float weights,
    norms and biases; integers and float32 scales keep their types.
    ``kv_scales``: carry the layers' ``kv_scale`` (a quantized KV
    cache)."""

    def t(a, dt=dtype) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype.kind not in "fiub":    # ml_dtypes int4: widen to int8
            a = a.astype(np.int8)
        out = torch.from_numpy(np.array(a))          # a writable copy
        return out.to(device=device, dtype=dt or out.dtype)

    def proj(p: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One projection ({name: array}, layer axis already indexed)."""
        if "weight_scale" not in p:
            out = {"weight": t(np.asarray(p["weight"]).T)}
        else:
            out = {k: t(p[k], None) for k in p if k != "bias"}
        if "bias" in p:
            out["bias"] = t(p["bias"])
        return out

    def fused(parts):
        """q, k, v (or gate, up) as one projection when they are of one
        kind, else None."""
        kinds = {frozenset(p) for p in parts}
        if len(kinds) != 1:
            return None
        return fuse_params(
            parts, weight_dim=-1 if "weight_scale" in parts[0] else 0)

    lay = params_np["layers"]
    num_layers = lay["input_norm"].shape[0]
    layers = []
    for i in range(num_layers):
        def at(name):
            return proj({k: v[i] for k, v in lay[name].items()})
        layer = {name: t(lay[name][i]) for name in _NORMS if name in lay}
        layer["o"] = at("o")
        for name in ("q_norm", "k_norm"):
            if name in lay:
                layer[name] = t(lay[name][i])
        if "router" in lay:
            layer["router"] = t(np.asarray(lay["router"][i]).T)
            layer["w_gate_up"] = t(np.concatenate(
                [lay["w_gate"][i], lay["w_up"][i]], axis=-1))
            layer["w_down"] = t(lay["w_down"][i])
        else:
            layer.update(down=at("down"),
                         gate_up=fused([at("gate"), at("up")]))
        if "se_gate" in lay:
            layer.update(se_down=at("se_down"),
                         se_gate_up=fused([at("se_gate"), at("se_up")]))
            layer["se_gate_w"] = t(np.asarray(lay["se_gate_w"][i]).T)
        qkv = [at("q"), at("k"), at("v")]
        one = fused(qkv)
        layer.update({"qkv": one} if one is not None
                     else zip(("q", "k", "v"), qkv))
        if kv_scales and "kv_scale" in lay:
            layer["kv_scale"] = t(np.asarray(lay["kv_scale"][i],
                                             np.float32), torch.float32)
        layers.append(layer)
    return {"embed": t(params_np["embed"]["weight"]),
            "layers": layers,
            "final_norm": t(params_np["final_norm"]),
            "lm_head": proj(params_np["lm_head"])}
