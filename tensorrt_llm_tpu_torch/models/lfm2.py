"""Apertus (``tensorrt_llm_tpu/models/lfm2.py:239-372``).

The Llama trunk with per-head q/k RMS norms (before the rotary
embedding), the layer norms named ``attention_layernorm`` /
``feedforward_layernorm``, and a GATELESS MLP: ``down(xIELU(up(x)))``,
where xIELU (transformers' ``XIELUActivation._xielu_python``, the JAX
lfm2.py:325-360) has learnable ``alpha_p`` / ``alpha_n`` and fixed
``beta`` / ``eps``, each a per-layer scalar held as a 0-dim float32
device tensor, and runs in float32 on the up projection's output. The
LFM2 model of the same JAX file keeps a recurrent state and is not
ported here.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

from .llama import LlamaForCausalLM
from .modeling_utils import register_model

_XIELU = ("alpha_p", "alpha_n", "act_beta", "act_eps")


def xielu(x: torch.Tensor, alpha_p: torch.Tensor, alpha_n: torch.Tensor,
          beta: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """xIELU on float32 ``x``: ``softplus(alpha_p) x^2 + beta x`` for x >
    0, else ``(expm1(min(x, eps)) - x) (beta + softplus(alpha_n)) + beta
    x``."""
    ap = F.softplus(alpha_p)
    an = beta + F.softplus(alpha_n)
    return torch.where(x > 0, ap * x * x + beta * x,
                       (torch.expm1(torch.minimum(x, eps)) - x) * an
                       + beta * x)


@register_model("apertus")
class ApertusForCausalLM(LlamaForCausalLM):
    architectures = ("ApertusForCausalLM",)
    _NORM_NAMES = ("attention_layernorm", "feedforward_layernorm")

    def __init__(self, model_config):
        super().__init__(model_config)
        self.use_qk_norm = True

    def act_width_per_token(self) -> int:
        """4 hidden-wide tensors and the up projection with its float32
        activation (2 intermediate-wide)."""
        return 4 * self.hidden_size + 2 * self.intermediate_size

    def _init_mlp(self, mat: Callable[..., torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """Random up / down weights and transformers' initial xIELU
        parameters (alpha_p 0.8, alpha_n 0.8, beta 0.5, eps -1e-6)."""
        H, I = self.hidden_size, self.intermediate_size
        ap = torch.log(torch.expm1(torch.tensor(0.8)))
        an = torch.log(torch.expm1(torch.tensor(0.8 - 0.5)))
        return {"up": mat(I, H), "down": mat(H, I), "alpha_p": ap,
                "alpha_n": an, "act_beta": torch.tensor(0.5),
                "act_eps": torch.tensor(-1e-6)}

    def _mlp_params(self, weight, bias, smooth=lambda name: None
                    ) -> Dict[str, Any]:
        m = self.m_mlp
        out = {n: self._lin(m, weight(n), bias(n), smooth(n))
               for n in ("up", "down")}
        for n in _XIELU:
            out[n] = torch.as_tensor(weight(n)).to(
                device=self.device, dtype=torch.float32).reshape(())
        return out

    def _hf_weight(self, sd, prefix: str, name: str):
        if name in _XIELU:
            return sd[prefix + "mlp.act_fn." + name.replace("act_", "")]
        return super()._hf_weight(sd, prefix, name)

    def _mlp(self, layer: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        m = self.m_mlp
        u = m.apply(layer["up"], x).float()
        a = xielu(u, *(layer[n] for n in _XIELU))
        return m.apply(layer["down"], a.to(self.dtype))
