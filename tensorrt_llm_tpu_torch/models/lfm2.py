"""LFM2 and Apertus (``tensorrt_llm_tpu/models/lfm2.py``).

LFM2 (Liquid): ``conv`` layers and GQA attention layers, each followed
by a SwiGLU MLP (w1, w3, w2) under its own pre-norm. A conv layer's
in_proj gives B, C and x; the depthwise causal conv (ops/ssm.py
``causal_conv1d``, a window of ``conv_L_cache - 1`` inputs per slot) runs
over B * x, and C times its output goes through out_proj. The attention
layers norm q and k per head before the rotary embedding and go through
``attention_block`` (K1/K2 on CUDA). The final norm is
``embedding_norm``. Layer parameters: norm, ff_norm, w13 (w1 and w3
joined), w2, and in_proj / conv_w / conv_b / out_proj or qkv (or q/k/v),
o, q_norm, k_norm.

Apertus:
The Llama trunk with per-head q/k RMS norms (before the rotary
embedding), the layer norms named ``attention_layernorm`` /
``feedforward_layernorm``, and a GATELESS MLP: ``down(xIELU(up(x)))``,
where xIELU (transformers' ``XIELUActivation._xielu_python``, the JAX
lfm2.py:325-360) has learnable ``alpha_p`` / ``alpha_n`` and fixed
``beta`` / ``eps``, each a per-layer scalar held as a 0-dim float32
device tensor, and runs in float32 on the up projection's output.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

from ..ops.norm import rms_norm
from ..ops.rope import RopeConfig
from ..ops.ssm import causal_conv1d
from .llama import LlamaForCausalLM
from .modeling_utils import AttentionSpec, register_model
from .recurrent import RecurrentModel

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


@register_model("lfm2")
class Lfm2ForCausalLM(RecurrentModel):
    architectures = ("Lfm2ForCausalLM",)
    hf_class = "Lfm2ForCausalLM"

    def __init__(self, model_config):
        super().__init__(model_config)
        hf = self.hf
        self.num_heads = hf.num_attention_heads
        self.eps = getattr(hf, "norm_eps", getattr(hf, "rms_norm_eps",
                                                   1e-5))
        self.conv_k = hf.conv_L_cache
        self._set_blocks(["conv" if bt == "conv" else self.ATTENTION
                          for bt in hf.layer_types])
        self.attn_spec = AttentionSpec(
            num_heads=self.num_heads, num_kv_heads=self.num_kv_heads,
            head_dim=self.head_dim, sm_scale=1.0 / math.sqrt(self.head_dim),
            rope=RopeConfig.from_hf_config(hf, self.head_dim))

    def state_shapes(self):
        return {"conv_state": (self.n_state, (self.hidden_size,
                                              self.conv_k - 1))}

    def _widest(self) -> int:
        return max(3 * self.hidden_size, 2 * self.hf.intermediate_size)

    def load_hf_state_dict(self, sd) -> Dict[str, Any]:
        f32 = torch.float32
        layers = []
        for i, bt in enumerate(self.block_types):
            p = f"model.layers.{i}."
            if bt == "conv":
                c = p + "conv."
                conv_w = self._t(sd[c + "conv.weight"], f32)[:, 0, :]
                layer = {
                    "in_proj": self._lin(sd[c + "in_proj.weight"],
                                         sd.get(c + "in_proj.bias")),
                    "conv_w": conv_w.contiguous(),
                    "conv_b": self._t(sd[c + "conv.bias"], f32)
                    if c + "conv.bias" in sd else
                    torch.zeros(self.hidden_size, device=self.device),
                    "out_proj": self._lin(sd[c + "out_proj.weight"],
                                          sd.get(c + "out_proj.bias"))}
            else:
                a = p + "self_attn."
                layer = {**self._pair("qkv", ("q", "k", "v"), [
                    sd[a + n + "_proj.weight"] for n in "qkv"]),
                    "o": self._lin(sd[a + "out_proj.weight"]),
                    "q_norm": self._t(sd[a + "q_layernorm.weight"]),
                    "k_norm": self._t(sd[a + "k_layernorm.weight"])}
            f = p + "feed_forward."
            layer.update(self._pair("w13", ("w1", "w3"), [
                sd[f + "w1.weight"], sd[f + "w3.weight"]]))
            layer["w2"] = self._lin(sd[f + "w2.weight"])
            layer["norm"] = self._t(sd[p + "operator_norm.weight"])
            layer["ff_norm"] = self._t(sd[p + "ffn_norm.weight"])
            layers.append(layer)
        return {"layers": layers, **self._head(
            sd, "model.embed_tokens.weight", "model.embedding_norm.weight")}

    def _conv(self, layer, x, kv_pages, metadata, i):
        H = self.hidden_size
        m = self._method("mlp")
        bcx = m.apply(layer["in_proj"], x)
        b, c, u = bcx[:, :H], bcx[:, H:2 * H], bcx[:, 2 * H:]
        bx = (b.float() * u.float()).to(self.dtype)
        y = causal_conv1d(bx, layer["conv_w"], layer["conv_b"],
                          self._state(kv_pages, "conv_state", i), metadata)
        return m.apply(layer["out_proj"], (c.float() * y).to(self.dtype))

    def forward(self, params, token_ids, kv_pages, metadata,
                collect_hidden: bool = False, collect_kv_stats: bool = False):
        self._check_slots(metadata)
        eps = self.eps

        def qk_norm(name):
            return lambda layer, u: rms_norm(u, layer[name], eps)
        h = params["embed"][token_ids].to(self.dtype)
        for i, layer in enumerate(params["layers"]):
            x = rms_norm(h, layer["norm"], eps)
            if self.block_types[i] == "conv":
                h = h + self._conv(layer, x, kv_pages, metadata, i)
            else:
                h = h + self._attention(
                    layer, x, kv_pages, metadata, i, self.attn_spec,
                    q_norm=qk_norm("q_norm"), k_norm=qk_norm("k_norm"))
            h = h + self._gated_mlp(layer, rms_norm(h, layer["ff_norm"], eps),
                                    fused="w13", down="w2")
        return self._finish(h, params, metadata, collect_hidden, kv_pages,
                            eps)
