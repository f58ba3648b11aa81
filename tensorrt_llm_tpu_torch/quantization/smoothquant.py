"""SmoothQuant calibration: migrate activation outliers into weights.

Port of ``tensorrt_llm_tpu/quantization/smoothquant.py`` (both functions
are torch and numpy there already; this package keeps its own copy). Per
input channel j of every ``nn.Linear``, s_j = max|X_j|^alpha /
max|W_j|^(1 - alpha), clipped to [1e-2, 1e4]: activations divide by s and
the weight's input rows multiply by s (models/modeling_utils.
quantize_linear), so y = (x / s)(s W) is exact in floating point while
the int8 error moves off the activation's outlier channels. The maxima
come from forward hooks on a ``transformers`` module run on calibration
prompts, on the module's own device and in its own type.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def calibrate_smooth_scales(torch_model, sample_ids: Sequence[Sequence[int]],
                            alpha: float = 0.5,
                            clip: tuple = (1e-2, 1e4)
                            ) -> Dict[str, np.ndarray]:
    """Run the calibration prompts through ``torch_model`` (on its device),
    collect per-input-channel |x| maxima on every Linear, and return
    {module name + ".weight": s [K] float32}."""
    import torch
    import torch.nn as nn

    act_max: Dict[str, torch.Tensor] = {}
    handles = []

    def make_hook(name):
        def hook(mod, inputs, output):
            x = inputs[0]
            m = x.detach().abs().reshape(-1, x.shape[-1]).max(dim=0).values
            if name in act_max:
                act_max[name] = torch.maximum(act_max[name], m)
            else:
                act_max[name] = m
        return hook

    linear_mods = {}
    for name, mod in torch_model.named_modules():
        if isinstance(mod, nn.Linear):
            handles.append(mod.register_forward_hook(make_hook(name)))
            linear_mods[name] = mod
    device = next(torch_model.parameters()).device
    try:
        with torch.no_grad():
            for ids in sample_ids:
                torch_model(torch.tensor([list(ids)], dtype=torch.long,
                                         device=device))
    finally:
        for h in handles:
            h.remove()

    scales: Dict[str, np.ndarray] = {}
    for name, mod in linear_mods.items():
        if name not in act_max:
            continue
        a = act_max[name].float().clamp(min=1e-5)
        w = mod.weight.detach().abs().max(dim=0).values.float() \
            .clamp(min=1e-5)
        s = (a ** alpha) / (w ** (1.0 - alpha))
        s = s.clamp(*clip)
        scales[name + ".weight"] = s.cpu().numpy()
    return scales


def default_calibration_ids(vocab_size: int, n_prompts: int = 4,
                            length: int = 64) -> List[List[int]]:
    """Deterministic pseudo-random calibration prompts (seed 1234), the
    JAX package's default when the user supplies none."""
    rng = np.random.default_rng(1234)
    return [rng.integers(1, max(2, vocab_size - 1), length).tolist()
            for _ in range(n_prompts)]
