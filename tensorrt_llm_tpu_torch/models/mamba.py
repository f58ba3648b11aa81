"""Mamba (S6) and FalconMamba decoders, and the Mamba-1 mixer Jamba
shares.

Port of ``tensorrt_llm_tpu/models/mamba.py``: pre-norm residual layers
of in_proj -> (x, z), a depthwise causal conv over x with a slot-indexed
window, x_proj -> (dt rank, B, C), dt_proj and softplus, the selective
scan (ops/ssm.py: blocks of tokens over long segments, one step in
decode), times silu(z), out_proj. FalconMamba puts a weightless RMS norm
(``mixer_rms_eps``) on dt, B and C; Jamba (models/jamba.py) a weighted
one (``dt_ln``, ``b_ln``, ``c_ln``).

A mixer layer's parameters: in_proj, x_proj, dt_proj (with its bias),
out_proj (projection dicts, [out, in]), conv_w [I, k], conv_b, A_log
[I, N] and D [I] (float32), and Mamba's layer norm ``norm``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.norm import rms_norm
from ..ops.ssm import causal_conv1d, selective_scan
from .modeling_utils import embed_tokens, register_model
from .recurrent import RecurrentModel


def _weightless_rms(v: torch.Tensor, eps: float) -> torch.Tensor:
    vf = v.float()
    return (vf * torch.rsqrt(vf.square().mean(-1, keepdim=True) + eps)
            ).to(v.dtype)


def mamba_mixer(layer, normed, conv_state, ssm_state, metadata, inner: int,
                dt_rank: int, state_size: int, m_lin, dtype,
                bcdt_rms_eps: Optional[float] = None,
                bcdt_norm_eps: Optional[float] = None) -> torch.Tensor:
    """One Mamba-1 mixer pass over the ragged batch; the layer's conv and
    SSM states are updated in place. ``bcdt_rms_eps``: FalconMamba's
    weightless RMS norm on dt, B and C; ``bcdt_norm_eps``: Jamba's
    weighted one (layer keys dt_ln, b_ln, c_ln)."""
    I, R, N = inner, dt_rank, state_size
    xz = m_lin.apply(layer["in_proj"], normed)
    x, z = xz[:, :I], xz[:, I:]
    x = causal_conv1d(x, layer["conv_w"], layer["conv_b"], conv_state,
                      metadata)
    x = F.silu(x).to(dtype)
    dbc = m_lin.apply(layer["x_proj"], x)
    dt_r, B, C = dbc[:, :R], dbc[:, R:R + N], dbc[:, R + N:]
    if bcdt_rms_eps is not None:
        dt_r, B, C = (_weightless_rms(v, bcdt_rms_eps) for v in (dt_r, B, C))
    if bcdt_norm_eps is not None:
        dt_r = rms_norm(dt_r, layer["dt_ln"], bcdt_norm_eps)
        B = rms_norm(B, layer["b_ln"], bcdt_norm_eps)
        C = rms_norm(C, layer["c_ln"], bcdt_norm_eps)
    dt = F.softplus(m_lin.apply(layer["dt_proj"], dt_r).float())
    A = -torch.exp(layer["A_log"].float())
    y = selective_scan(x, dt, A, B, C, layer["D"], ssm_state, metadata)
    y = y.float() * F.silu(z.float())
    return m_lin.apply(layer["out_proj"], y.to(dtype))


def load_mamba_layer(model: RecurrentModel, sd, m: str) -> Dict[str, Any]:
    """One transformers Mamba-1 mixer at ``{m}.`` (A_log and D may carry
    a ``.weight`` suffix)."""
    f32 = torch.float32

    def g(name):
        return sd[name] if name in sd else sd[name + ".weight"]
    conv_w = model._t(sd[m + "conv1d.weight"], f32)[:, 0, :].contiguous()
    conv_b = sd.get(m + "conv1d.bias")
    return {
        "in_proj": model._lin(sd[m + "in_proj.weight"]),
        "conv_w": conv_w,
        "conv_b": torch.zeros(conv_w.shape[0], device=model.device)
        if conv_b is None else model._t(conv_b, f32),
        "x_proj": model._lin(sd[m + "x_proj.weight"]),
        "dt_proj": model._lin(sd[m + "dt_proj.weight"],
                              sd.get(m + "dt_proj.bias")),
        "out_proj": model._lin(sd[m + "out_proj.weight"]),
        "A_log": model._t(g(m + "A_log"), f32),
        "D": model._t(g(m + "D"), f32),
    }


@register_model("mamba")
class MambaForCausalLM(RecurrentModel):
    architectures = ("MambaForCausalLM",)
    hf_class = "MambaForCausalLM"

    def __init__(self, model_config):
        super().__init__(model_config)
        hf = self.hf
        self.inner = getattr(hf, "intermediate_size", None) or \
            hf.expand * hf.hidden_size
        self.state_size = hf.state_size
        self.conv_kernel = hf.conv_kernel
        self.dt_rank = getattr(hf, "time_step_rank", None) or \
            -(-hf.hidden_size // 16)
        self.eps = getattr(hf, "layer_norm_epsilon", 1e-5)
        # FalconMamba: weightless RMS on dt/B/C
        self.bcdt_rms_eps = None
        self._set_blocks(["mamba"] * hf.num_hidden_layers)

    @property
    def num_kv_heads(self) -> int:
        return 1

    @property
    def head_dim(self) -> int:
        return 1

    def state_shapes(self):
        return {"conv_state": (self.n_state, (self.inner,
                                              self.conv_kernel - 1)),
                "ssm_state": (self.n_state, (self.inner, self.state_size))}

    def _widest(self) -> int:
        return 2 * self.inner

    def load_hf_state_dict(self, sd) -> Dict[str, Any]:
        layers = []
        for i in range(self.num_layers):
            p = f"backbone.layers.{i}."
            layer = load_mamba_layer(self, sd, p + "mixer.")
            layer["norm"] = self._t(sd[p + "norm.weight"])
            layers.append(layer)
        return {"layers": layers, **self._head(
            sd, "backbone.embeddings.weight", "backbone.norm_f.weight")}

    def forward(self, params, token_ids, kv_pages, metadata,
                collect_hidden: bool = False, collect_kv_stats: bool = False,
                input_embeds=None):
        self._check_slots(metadata)
        m = self._method("mlp")
        h = embed_tokens(params["embed"], token_ids, input_embeds, self.dtype)
        for i, layer in enumerate(params["layers"]):
            h = h + mamba_mixer(
                layer, rms_norm(h, layer["norm"], self.eps),
                self._state(kv_pages, "conv_state", i),
                self._state(kv_pages, "ssm_state", i), metadata,
                self.inner, self.dt_rank, self.state_size, m, self.dtype,
                bcdt_rms_eps=self.bcdt_rms_eps)
        return self._finish(h, params, metadata, collect_hidden, kv_pages,
                            self.eps)


@register_model("falcon_mamba")
class FalconMambaForCausalLM(MambaForCausalLM):
    """FalconMamba: Mamba-1 with a weightless RMS norm on dt, B and C
    after x_proj (``mixer_rms_eps``)."""
    architectures = ("FalconMambaForCausalLM",)
    hf_class = "FalconMambaForCausalLM"

    def __init__(self, model_config):
        super().__init__(model_config)
        self.bcdt_rms_eps = getattr(self.hf, "mixer_rms_eps", 1e-6)
