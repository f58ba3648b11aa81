"""MiniMax-Text-01: lightning (decayed linear) attention and full
attention layers, each followed by an MoE, with post-norm residual
mixing.

Port of ``tensorrt_llm_tpu/models/minimax.py``:

- ``linear_attention`` layers: q, k, v = silu(x W) per head (``w_q``,
  ``w_k``, ``w_v`` de-interleaved from qkv_proj at load, [out, in]); the
  recurrence S_t = exp(-slope_h) S_{t-1} + k_t (x) v_t, y_t = q_t . S_t
  is the SSD scan with dt = 1, A = -slope, B = k, C = q, D = 0
  (ops/ssm.py ``ssd_scan``, chunked over long segments, one step in
  decode; the JAX minimax.py:210); then an RMSNorm (eps 1e-6, as
  transformers builds it), a sigmoid output gate on the layer's input,
  out.
- ``full_attention`` layers: GQA with rotary, through ``attention_block``
  (K1/K2 on CUDA).
- the residual is the NORMED stream: h = norm(h) alpha + sublayer beta,
  for the attention (linear or full) and for the MoE (a softmax top-k
  renormalised router over w1 / w3 / w2 experts).
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
from ..ops.ssm import ssd_scan
from .modeling_utils import AttentionSpec, embed_tokens, register_model
from .recurrent import RecurrentModel, stack_experts


@register_model("minimax")
class MiniMaxForCausalLM(RecurrentModel):
    architectures = ("MiniMaxForCausalLM",)
    hf_class = "MiniMaxForCausalLM"
    ATTENTION = "full_attention"

    def __init__(self, model_config):
        super().__init__(model_config)
        hf = self.hf
        self.num_heads = hf.num_attention_heads
        self.eps = getattr(hf, "rms_norm_eps", 1e-5)
        self.num_experts = hf.num_local_experts
        self.top_k = hf.num_experts_per_tok
        g = lambda n: getattr(hf, n, 1.0)
        self.lin_ab = (g("linear_attn_alpha_factor"),
                       g("linear_attn_beta_factor"))
        self.full_ab = (g("full_attn_alpha_factor"),
                        g("full_attn_beta_factor"))
        self.mlp_ab = (g("mlp_alpha_factor"), g("mlp_beta_factor"))
        self._set_blocks(list(hf.layer_types))
        self.attn_spec = AttentionSpec(
            num_heads=self.num_heads, num_kv_heads=self.num_kv_heads,
            head_dim=self.head_dim, sm_scale=1.0 / math.sqrt(self.head_dim),
            rope=RopeConfig.from_hf_config(hf, self.head_dim))

    def state_shapes(self):
        hd = self.head_dim
        return {"ssm_state": (self.n_state, (self.num_heads, hd, hd))}

    def _widest(self) -> int:
        return max(3 * self.num_heads * self.head_dim,
                   2 * self.hf.intermediate_size * self.top_k)

    def load_hf_state_dict(self, sd) -> Dict[str, Any]:
        nh, hd, H = self.num_heads, self.head_dim, self.hidden_size
        E = self.num_experts
        layers = []
        for i, bt in enumerate(self.block_types):
            p = f"model.layers.{i}."
            a = p + "self_attn."
            if bt == self.ATTENTION:
                layer = {**self._pair("qkv", ("q", "k", "v"), [
                    sd[a + n + "_proj.weight"] for n in "qkv"]),
                    "o": self._lin(sd[a + "o_proj.weight"])}
            else:
                w = torch.as_tensor(sd[a + "qkv_proj.weight"]).view(
                    nh, 3 * hd, H)
                layer = {
                    "w_q": self._t(w[:, :hd].reshape(nh * hd, H)),
                    "w_k": self._t(w[:, hd:2 * hd].reshape(nh * hd, H)),
                    "w_v": self._t(w[:, 2 * hd:].reshape(nh * hd, H)),
                    "slope": self._t(sd[a + "slope_rate"],
                                     torch.float32).reshape(nh),
                    "attn_norm": self._t(sd[a + "norm.weight"]),
                    "w_gate_out": self._t(sd[a + "output_gate.weight"]),
                    "out": self._lin(sd[a + "out_proj.weight"])}
            # the checkpoints' MoE; transformers 5's live modules call it
            # "mlp" and fuse the experts (``stack_experts`` reads both)
            m = p + ("block_sparse_moe." if p + "block_sparse_moe.gate.weight"
                     in sd else "mlp.")
            layer["router"] = self._t(sd[m + "gate.weight"])
            layer["w_gate_up"], layer["w_down"] = stack_experts(
                self, sd, m + "experts.", E, ("w1", "w3", "w2"))
            layer["norm"] = self._t(sd[p + "input_layernorm.weight"])
            layer["ff_norm"] = self._t(
                sd[p + "post_attention_layernorm.weight"])
            layers.append(layer)
        return {"layers": layers, **self._head(
            sd, "model.embed_tokens.weight", "model.norm.weight")}

    def _lightning(self, layer, x, kv_pages, metadata, i):
        T = x.shape[0]
        nh, hd = self.num_heads, self.head_dim

        def proj(name):
            return F.silu(dot_f32(x, layer[name])).view(T, nh, hd)
        q, k, v = proj("w_q"), proj("w_k"), proj("w_v")
        y = ssd_scan(v, torch.ones(T, nh, device=x.device), -layer["slope"],
                     k, q, torch.zeros(nh, device=x.device),
                     self._state(kv_pages, "ssm_state", i), metadata)
        y = rms_norm(y.reshape(T, nh * hd).to(self.dtype),
                     layer["attn_norm"], 1e-6)
        y = y * torch.sigmoid(dot_f32(x, layer["w_gate_out"])).to(self.dtype)
        return self._method("o_proj").apply(layer["out"], y)

    def forward(self, params, token_ids, kv_pages, metadata,
                collect_hidden: bool = False, collect_kv_stats: bool = False,
                input_embeds=None):
        self._check_slots(metadata)
        eps = self.eps
        h = embed_tokens(params["embed"], token_ids, input_embeds, self.dtype)
        for i, layer in enumerate(params["layers"]):
            x = rms_norm(h, layer["norm"], eps)
            if self.block_types[i] == self.ATTENTION:
                out, (al, be) = self._attention(
                    layer, x, kv_pages, metadata, i, self.attn_spec), \
                    self.full_ab
            else:
                out, (al, be) = self._lightning(
                    layer, x, kv_pages, metadata, i), self.lin_ab
            h = x * al + out * be
            h = rms_norm(h, layer["ff_norm"], eps)
            out = moe_mlp(h, layer["w_gate_up"], layer["w_down"],
                          layer["router"], self.top_k, renormalize=True)
            h = h * self.mlp_ab[0] + out * self.mlp_ab[1]
        return self._finish(h, params, metadata, collect_hidden, kv_pages,
                            eps)
