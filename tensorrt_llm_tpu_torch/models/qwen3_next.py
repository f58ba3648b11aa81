"""Qwen3-Next: gated DeltaNet linear attention and gated full attention,
with an MoE and a sigmoid-gated shared expert after each.

Port of ``tensorrt_llm_tpu/models/qwen3_next.py``:

- ``linear_attention`` layers: the packed, per-key-head interleaved
  qkvz / ba projections are de-interleaved at load into plain blocks
  (``w_qkv``, ``w_z``, ``w_b``, ``w_a``, [out, in], applied with float32
  accumulation as the JAX model's ``jnp.dot``); a causal conv over
  [q; k; v] (ops/ssm.py ``causal_conv1d``), l2-normalised q and k,
  per-value-head decay g = -exp(A_log) softplus(a + dt_bias) and mixing
  beta = sigmoid(b), the gated delta rule (``gated_delta_scan``: a loop
  over the segments' positions, one step in decode), a gated RMSNorm
  over dv with silu(z), out.
- ``full_attention`` layers: per-head q/k norms, partial rotary, and an
  output gate attn * sigmoid(x gate) before o (``attention_block``'s
  ``pre_o``), through K1/K2 on CUDA.
- every layer: a softmax top-k renormalised MoE and a shared expert
  gated by sigmoid(x se_gate_w).

The zero-centred norms (``output * (1 + weight)``) take the +1 at load,
as the JAX loader does; the DeltaNet's gated norm is plain.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..ops.linear import dot_f32
from ..ops.moe import moe_mlp
from ..ops.norm import rms_norm
from ..ops.rope import RopeConfig
from ..ops.ssm import causal_conv1d, gated_delta_scan
from .modeling_utils import AttentionSpec, register_model
from .recurrent import RecurrentModel, stack_experts


@register_model("qwen3_next")
class Qwen3NextForCausalLM(RecurrentModel):
    architectures = ("Qwen3NextForCausalLM",)
    hf_class = "Qwen3NextForCausalLM"
    ATTENTION = "full_attention"

    def __init__(self, model_config):
        super().__init__(model_config)
        hf = self.hf
        self.num_heads = hf.num_attention_heads
        self.eps = getattr(hf, "rms_norm_eps", 1e-6)
        self.num_experts = hf.num_experts
        self.top_k = hf.num_experts_per_tok
        self.vh = hf.linear_num_value_heads
        self.kh = hf.linear_num_key_heads
        self.dk = hf.linear_key_head_dim
        self.dv = hf.linear_value_head_dim
        self.conv_k = hf.linear_conv_kernel_dim
        self.key_dim = self.kh * self.dk
        self.value_dim = self.vh * self.dv
        self.conv_dim = 2 * self.key_dim + self.value_dim
        self._set_blocks(list(hf.layer_types))
        self.attn_spec = AttentionSpec(
            num_heads=self.num_heads, num_kv_heads=self.num_kv_heads,
            head_dim=self.head_dim, sm_scale=1.0 / math.sqrt(self.head_dim),
            rope=RopeConfig.from_hf_config(hf, self.head_dim))

    def state_shapes(self):
        return {"conv_state": (self.n_state, (self.conv_dim,
                                              self.conv_k - 1)),
                "ssm_state": (self.n_state, (self.vh, self.dk, self.dv))}

    def _widest(self) -> int:
        return max(self.conv_dim + self.value_dim,
                   2 * self.hf.moe_intermediate_size * self.top_k,
                   2 * self.num_heads * self.head_dim)

    # ------------------------------------------------------------------ #
    def load_hf_state_dict(self, sd) -> Dict[str, Any]:
        kh, dk, vh, dv = self.kh, self.dk, self.vh, self.dv
        rep = vh // kh
        H = self.hidden_size

        def zc(name):
            return self._t(torch.as_tensor(sd[name]).float() + 1.0)

        layers = []
        for i, bt in enumerate(self.block_types):
            p = f"model.layers.{i}."
            if bt == self.ATTENTION:
                a = p + "self_attn."
                nh, hd = self.num_heads, self.head_dim
                wq = torch.as_tensor(sd[a + "q_proj.weight"]).view(
                    nh, 2 * hd, H)
                layer = {**self._pair("qkv", ("q", "k", "v"), [
                    wq[:, :hd].reshape(nh * hd, H),
                    sd[a + "k_proj.weight"], sd[a + "v_proj.weight"]]),
                    "gate": self._t(wq[:, hd:].reshape(nh * hd, H)),
                    "o": self._lin(sd[a + "o_proj.weight"]),
                    "q_norm": zc(a + "q_norm.weight"),
                    "k_norm": zc(a + "k_norm.weight")}
            else:
                la = p + "linear_attn."
                g = 2 * dk + 2 * rep * dv
                w = torch.as_tensor(sd[la + "in_proj_qkvz.weight"]).view(
                    kh, g, H)
                wq = w[:, :dk].reshape(kh * dk, H)
                wk = w[:, dk:2 * dk].reshape(kh * dk, H)
                wv = w[:, 2 * dk:2 * dk + rep * dv].reshape(vh * dv, H)
                wz = w[:, 2 * dk + rep * dv:].reshape(vh * dv, H)
                ba = torch.as_tensor(sd[la + "in_proj_ba.weight"]).view(
                    kh, 2 * rep, H)
                f32 = torch.float32
                layer = {
                    "w_qkv": self._t(torch.cat([wq, wk, wv])),
                    "w_z": self._t(wz),
                    "w_b": self._t(ba[:, :rep].reshape(vh, H)),
                    "w_a": self._t(ba[:, rep:].reshape(vh, H)),
                    "conv_w": self._t(sd[la + "conv1d.weight"],
                                      f32)[:, 0, :].contiguous(),
                    "conv_b": self._t(sd[la + "conv1d.bias"], f32)
                    if la + "conv1d.bias" in sd else
                    torch.zeros(self.conv_dim, device=self.device),
                    "A_log": self._t(sd[la + "A_log"], f32),
                    "dt_bias": self._t(sd[la + "dt_bias"], f32),
                    "gate_norm": self._t(sd[la + "norm.weight"]),
                    "out": self._lin(sd[la + "out_proj.weight"])}
            layer["norm"] = zc(p + "input_layernorm.weight")
            layer["ff_norm"] = zc(p + "post_attention_layernorm.weight")
            layer.update(self._moe_params(sd, p + "mlp."))
            layers.append(layer)
        head = self._head(sd, "model.embed_tokens.weight",
                          "model.norm.weight")
        head["final_norm"] = zc("model.norm.weight")
        return {"layers": layers, **head}

    def _moe_params(self, sd, p: str) -> Dict[str, Any]:
        w_gu, w_d = stack_experts(self, sd, p + "experts.", self.num_experts)
        return {
            "router": self._t(sd[p + "gate.weight"]),
            "w_gate_up": w_gu, "w_down": w_d,
            **self._pair("se_gate_up", ("se_gate", "se_up"), [
                sd[p + "shared_expert.gate_proj.weight"],
                sd[p + "shared_expert.up_proj.weight"]]),
            "se_down": self._lin(sd[p + "shared_expert.down_proj.weight"]),
            "se_gate_w": self._t(sd[p + "shared_expert_gate.weight"]),
        }

    # ------------------------------------------------------------------ #
    def _ff(self, layer, x):
        out = moe_mlp(x, layer["w_gate_up"], layer["w_down"],
                      layer["router"], self.top_k, renormalize=True)
        se = self._gated_mlp(layer, x, fused="se_gate_up", down="se_down")
        gate = torch.sigmoid(dot_f32(x, layer["se_gate_w"]))
        return out, gate.to(self.dtype) * se

    def _deltanet(self, layer, x, kv_pages, metadata, i):
        T = x.shape[0]
        kh, dk, vh, dv = self.kh, self.dk, self.vh, self.dv
        qkv = dot_f32(x, layer["w_qkv"]).to(self.dtype)
        z = dot_f32(x, layer["w_z"]).view(T, vh, dv)
        b = dot_f32(x, layer["w_b"])
        a = dot_f32(x, layer["w_a"])
        qkv = F.silu(causal_conv1d(qkv, layer["conv_w"], layer["conv_b"],
                                   self._state(kv_pages, "conv_state", i),
                                   metadata))
        kd = self.key_dim
        q = qkv[:, :kd].reshape(T, kh, dk)
        k = qkv[:, kd:2 * kd].reshape(T, kh, dk)
        v = qkv[:, 2 * kd:].reshape(T, vh, dv)

        def l2n(u):
            return u * torch.rsqrt(u.square().sum(-1, keepdim=True) + 1e-6)
        q = l2n(q) / math.sqrt(dk)
        k = l2n(k)
        rep = vh // kh
        if rep > 1:
            q = q.repeat_interleave(rep, dim=1)
            k = k.repeat_interleave(rep, dim=1)
        beta = torch.sigmoid(b)
        g = -torch.exp(layer["A_log"])[None, :] * F.softplus(
            a + layer["dt_bias"][None, :])
        y = gated_delta_scan(q, k, v, g, beta,
                             self._state(kv_pages, "ssm_state", i),
                             metadata).float()
        y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + self.eps) \
            * layer["gate_norm"].float()
        y = y * F.silu(z)
        return self._method("o_proj").apply(
            layer["out"], y.reshape(T, vh * dv).to(self.dtype))

    def forward(self, params, token_ids, kv_pages, metadata,
                collect_hidden: bool = False, collect_kv_stats: bool = False):
        self._check_slots(metadata)
        eps = self.eps

        def qk_norm(name):
            return lambda layer, u: rms_norm(u, layer[name], eps)

        def pre_o(layer, x, attn):
            return attn * torch.sigmoid(dot_f32(x, layer["gate"])).to(
                attn.dtype)
        h = params["embed"][token_ids].to(self.dtype)
        for i, layer in enumerate(params["layers"]):
            x = rms_norm(h, layer["norm"], eps)
            if self.block_types[i] == self.ATTENTION:
                h = h + self._attention(
                    layer, x, kv_pages, metadata, i, self.attn_spec,
                    q_norm=qk_norm("q_norm"), k_norm=qk_norm("k_norm"),
                    pre_o=pre_o)
            else:
                h = h + self._deltanet(layer, x, kv_pages, metadata, i)
            out, se = self._ff(layer, rms_norm(h, layer["ff_norm"], eps))
            h = h + out + se
        return self._finish(h, params, metadata, collect_hidden, kv_pages,
                            eps)
