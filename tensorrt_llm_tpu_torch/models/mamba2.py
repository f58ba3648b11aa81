"""Mamba2 (SSD) decoder and the Mamba2 mixer the hybrids share.

Port of ``tensorrt_llm_tpu/models/mamba2.py`` (``Mamba2Geom``,
``mamba2_mixer``, ``load_mamba2_layer``, ``Mamba2ForCausalLM``): per-head
scalar decay, B and C shared by groups of heads, a depthwise conv over
[x; B; C] with a slot-indexed window (ops/ssm.py ``causal_conv1d``), the
SSD scan (``ssd_scan``: chunked over long segments, one step in decode)
and a gated RMSNorm before out_proj. The norm is taken over groups of
``norm_group`` channels: the whole inner width for Mamba2, Bamba and
Granite-4.0-H (transformers' ``MambaRMSNormGated``), a width over
``mamba_ngroups`` for Zamba2 (``Zamba2RMSNormGated``), where the JAX
model normalises the whole width (the two agree at one group).

A mixer layer's parameters: in_proj and out_proj (projection dicts,
[out, in]), conv_w [conv_dim, k], conv_b, dt_bias, A_log and D (float32),
gate_norm [inner].
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..ops.norm import rms_norm
from ..ops.ssm import causal_conv1d, ssd_scan
from .modeling_utils import embed_tokens, register_model
from .recurrent import RecurrentModel


@dataclass(frozen=True)
class Mamba2Geom:
    intermediate: int
    num_heads: int
    head_dim: int
    n_groups: int
    state_size: int
    conv_kernel: int
    dt_min: float
    dt_max: float
    eps: float
    chunk: int = 256
    norm_group: int = 0          # 0: the whole inner width

    @property
    def conv_dim(self) -> int:
        return self.intermediate + 2 * self.n_groups * self.state_size

    @property
    def in_width(self) -> int:
        return self.intermediate + self.conv_dim + self.num_heads

    def state_shapes(self, layers: int) -> Dict[str, Any]:
        return {"conv_state": (layers, (self.conv_dim,
                                        self.conv_kernel - 1)),
                "ssm_state": (layers, (self.num_heads, self.head_dim,
                                       self.state_size))}


def mamba2_mixer(layer, normed, conv_state, ssm_state, metadata,
                 geom: Mamba2Geom, m_lin, dtype) -> torch.Tensor:
    """One Mamba2 mixer pass over the ragged batch; the layer's conv and
    SSM states are updated in place."""
    I, nh, hd = geom.intermediate, geom.num_heads, geom.head_dim
    G, N = geom.n_groups, geom.state_size
    T = normed.shape[0]
    zxbcdt = m_lin.apply(layer["in_proj"], normed)
    z = zxbcdt[:, :I]
    xbc = zxbcdt[:, I:I + geom.conv_dim]
    dt = zxbcdt[:, I + geom.conv_dim:]
    xbc = causal_conv1d(xbc, layer["conv_w"], layer["conv_b"], conv_state,
                        metadata)
    xbc = F.silu(xbc).to(dtype)
    x = xbc[:, :I]
    B = xbc[:, I:I + G * N]
    C = xbc[:, I + G * N:]
    dt = F.softplus(dt.float() + layer["dt_bias"].float())
    dt = dt.clamp(geom.dt_min, geom.dt_max)
    A = -torch.exp(layer["A_log"].float())
    y = ssd_scan(x.reshape(T, nh, hd), dt, A, B.reshape(T, G, N),
                 C.reshape(T, G, N), layer["D"], ssm_state, metadata,
                 chunk=geom.chunk)
    y = y.reshape(T, I).float() * F.silu(z.float())
    grp = geom.norm_group or I
    yg = y.view(T, I // grp, grp)
    var = yg.square().mean(-1, keepdim=True)
    y = (yg * torch.rsqrt(var + geom.eps)).view(T, I) * \
        layer["gate_norm"].float()
    return m_lin.apply(layer["out_proj"], y.to(dtype))


def load_mamba2_layer(model: RecurrentModel, sd, prefix: str
                      ) -> Dict[str, Any]:
    """One transformers Mamba2 mixer at ``{prefix}.`` (e.g.
    ``backbone.layers.0.mixer``)."""
    f32 = torch.float32

    def opt(name):
        return sd[name] if name in sd else None
    conv_w = model._t(sd[f"{prefix}.conv1d.weight"], f32)[:, 0, :]
    conv_b = opt(f"{prefix}.conv1d.bias")
    return {
        "in_proj": model._lin(sd[f"{prefix}.in_proj.weight"],
                              opt(f"{prefix}.in_proj.bias")),
        "conv_w": conv_w.contiguous(),
        "conv_b": torch.zeros(conv_w.shape[0], device=model.device)
        if conv_b is None else model._t(conv_b, f32),
        "dt_bias": model._t(sd[f"{prefix}.dt_bias"], f32),
        "A_log": model._t(sd[f"{prefix}.A_log"], f32),
        "D": model._t(sd[f"{prefix}.D"], f32),
        "gate_norm": model._t(sd[f"{prefix}.norm.weight"]),
        "out_proj": model._lin(sd[f"{prefix}.out_proj.weight"],
                               opt(f"{prefix}.out_proj.bias")),
    }


def mamba2_geom(hf, inner: int, num_heads: int, head_dim: int,
                n_groups: int, state_size: int, conv_kernel: int,
                eps: float, norm_group: int = 0) -> Mamba2Geom:
    lim = getattr(hf, "time_step_limit", None) or (0.0, float("inf"))
    return Mamba2Geom(
        intermediate=inner, num_heads=num_heads, head_dim=head_dim,
        n_groups=n_groups, state_size=state_size, conv_kernel=conv_kernel,
        dt_min=lim[0], dt_max=lim[1], eps=eps,
        chunk=getattr(hf, "mamba_chunk_size", None)
        or getattr(hf, "chunk_size", None) or 256, norm_group=norm_group)


@register_model("mamba2")
class Mamba2ForCausalLM(RecurrentModel):
    architectures = ("Mamba2ForCausalLM",)
    hf_class = "Mamba2ForCausalLM"

    def __init__(self, model_config):
        super().__init__(model_config)
        hf = self.hf
        self.eps = getattr(hf, "layer_norm_epsilon", 1e-5)
        self.geom = mamba2_geom(
            hf, int(hf.expand * hf.hidden_size), hf.num_heads, hf.head_dim,
            hf.n_groups, hf.state_size, hf.conv_kernel, self.eps)
        self._set_blocks(["mamba"] * hf.num_hidden_layers)

    @property
    def num_kv_heads(self) -> int:
        return 1

    @property
    def head_dim(self) -> int:
        return 1

    def state_shapes(self):
        return self.geom.state_shapes(self.n_state)

    def _widest(self) -> int:
        return self.geom.in_width

    def load_hf_state_dict(self, sd) -> Dict[str, Any]:
        layers = []
        for i in range(self.num_layers):
            layer = load_mamba2_layer(self, sd, f"backbone.layers.{i}.mixer")
            layer["norm"] = self._t(sd[f"backbone.layers.{i}.norm.weight"])
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
            h = h + mamba2_mixer(
                layer, rms_norm(h, layer["norm"], self.eps),
                self._state(kv_pages, "conv_state", i),
                self._state(kv_pages, "ssm_state", i), metadata, self.geom,
                m, self.dtype)
        return self._finish(h, params, metadata, collect_hidden, kv_pages,
                            self.eps)
