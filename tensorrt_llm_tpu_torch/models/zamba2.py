"""Zamba2: a Mamba2 backbone with shared attention blocks.

Port of ``tensorrt_llm_tpu/models/zamba2.py``. Every layer is a pre-norm
Mamba2 mixer with a residual. A ``hybrid`` layer first runs one of the
``num_mem_blocks`` shared blocks (cycled over the hybrid layers) on
``concat([h, embeddings])``, 2H wide and without inner residuals:
RMSNorm, attention (scale (head_dim / 2)^-0.5, rotary with
``use_mem_rope``) through ``attention_block`` (K1/K2 on CUDA, onto the
hybrid layer's KV layer), RMSNorm, a gated MLP; the block's output goes
through the layer's own ``linear`` [H, H] and is added to h before the
mixer's norm. The layer's LoRA adapters (``mlp_a0`` / ``mlp_a1`` on the
gate|up projection, with ``use_shared_attention_adapter`` also
``q_a0`` / ``q_a1`` ... on q, k and v) add ``x @ a0 @ a1``.

The Mamba2 gated norm is taken per group of ``inner / mamba_ngroups``
channels, as transformers' ``Zamba2RMSNormGated`` does (models/mamba2.py).

Parameters: ``blocks`` (per shared block: input_norm, pre_ff_norm, qkv or
q/k/v, o, gate_up, down; None for a block no layer uses) and ``layers``
(the mixer's, ``norm``; a hybrid layer's ``linear`` and adapters, [in,
out] matrices).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..ops.norm import rms_norm
from ..ops.rope import RopeConfig
from .mamba2 import load_mamba2_layer, mamba2_geom, mamba2_mixer
from .modeling_utils import AttentionSpec, embed_tokens, register_model
from .recurrent import RecurrentModel

_ACTS = {"gelu": lambda x: F.gelu(x),
         "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
         "gelu_new": lambda x: F.gelu(x, approximate="tanh")}


@register_model("zamba2")
class Zamba2ForCausalLM(RecurrentModel):
    architectures = ("Zamba2ForCausalLM",)
    hf_class = "Zamba2ForCausalLM"

    def __init__(self, model_config):
        super().__init__(model_config)
        hf = self.hf
        self.num_heads = hf.num_attention_heads
        self.eps = getattr(hf, "rms_norm_eps", 1e-5)
        self.num_mem_blocks = hf.num_mem_blocks
        self.attn_adapter = getattr(hf, "use_shared_attention_adapter",
                                    False)
        inner = int(hf.mamba_expand * hf.hidden_size)
        groups = getattr(hf, "mamba_ngroups", 1)
        self.geom = mamba2_geom(
            hf, inner, hf.n_mamba_heads, inner // hf.n_mamba_heads, groups,
            hf.mamba_d_state, hf.mamba_d_conv, self.eps,
            norm_group=inner // groups)
        types = list(hf.layers_block_type)
        # every layer has a mixer; the hybrid ones also a KV layer
        self._set_blocks(["mamba"] * len(types))
        self.hybrid = [bt == "hybrid" for bt in types]
        self.kv_ord = []
        a = 0
        for hyb in self.hybrid:
            self.kv_ord.append(a if hyb else -1)
            a += hyb
        self.n_attn = a
        self._attn_hd = hf.attention_head_dim
        rope = RopeConfig(
            head_dim=self._attn_hd,
            rope_theta=getattr(hf, "rope_theta", None) or 10000.0,
            max_position_embeddings=hf.max_position_embeddings) \
            if getattr(hf, "use_mem_rope", False) else None
        self.attn_spec = AttentionSpec(
            num_heads=self.num_heads, num_kv_heads=hf.num_key_value_heads,
            head_dim=self._attn_hd, sm_scale=(self._attn_hd / 2) ** -0.5,
            rope=rope)
        self.act = _ACTS.get(getattr(hf, "hidden_act", "gelu"), F.silu)

    @property
    def num_kv_heads(self) -> int:
        return self.hf.num_key_value_heads

    @property
    def head_dim(self) -> int:
        return self._attn_hd

    def state_shapes(self):
        return self.geom.state_shapes(self.n_state)

    def _widest(self) -> int:
        return max(self.geom.in_width, 2 * self.hf.intermediate_size,
                   3 * self.num_heads * self._attn_hd)

    def act_width_per_token(self) -> int:
        return 8 * self.hidden_size + 3 * self._widest()

    # ------------------------------------------------------------------ #
    def load_hf_state_dict(self, sd) -> Dict[str, Any]:
        hyb_idx = [i for i, h in enumerate(self.hybrid) if h]

        def mat(name):                      # [out, in] -> [in, out]
            return self._t(sd[name]).t().contiguous()

        def adapter(prefix: str, j: int):
            """The (a0, a1) of the adapter list at ``prefix`` for the j-th
            hybrid layer: entry j (transformers 4 keeps every use's
            adapters in the shared block), else the one entry the layer
            holds (transformers 5 numbers them otherwise)."""
            key = f"{prefix}.{j}.0.weight"
            if key not in sd:
                found = [k for k in sd if k.startswith(prefix + ".")
                         and k.endswith(".0.weight")]
                if len(found) != 1:
                    raise KeyError(key)
                key = found[0]
            base = key[:-len("0.weight")]
            return mat(base + "0.weight"), mat(base + "1.weight")

        blocks = []
        for b in range(self.num_mem_blocks):
            users = [j for j in range(len(hyb_idx))
                     if j % self.num_mem_blocks == b]
            if not users:
                blocks.append(None)
                continue
            p = f"model.layers.{hyb_idx[users[0]]}.shared_transformer."
            a = p + "self_attn."
            blocks.append({
                "input_norm": self._t(sd[p + "input_layernorm.weight"]),
                "pre_ff_norm": self._t(sd[p + "pre_ff_layernorm.weight"]),
                **self._pair("qkv", ("q", "k", "v"),
                             [sd[a + n + "_proj.weight"] for n in "qkv"]),
                "o": self._lin(sd[a + "o_proj.weight"]),
                "gate_up": self._lin(
                    sd[p + "feed_forward.gate_up_proj.weight"]),
                "down": self._lin(sd[p + "feed_forward.down_proj.weight"]),
            })
        layers, j = [], 0
        for i, hyb in enumerate(self.hybrid):
            p = f"model.layers.{i}."
            m = p + ("mamba_decoder." if hyb else "")
            layer = load_mamba2_layer(self, sd, m + "mamba")
            layer["norm"] = self._t(sd[m + "input_layernorm.weight"])
            if hyb:
                bp = p + "shared_transformer."
                layer["linear"] = self._lin(sd[p + "linear.weight"])
                layer["mlp_a0"], layer["mlp_a1"] = adapter(
                    bp + "feed_forward.gate_up_proj_adapter_list", j)
                if self.attn_adapter:
                    for n in "qkv":
                        layer[f"{n}_a0"], layer[f"{n}_a1"] = adapter(
                            bp + f"self_attn.linear_{n}_adapter_list", j)
                j += 1
            layers.append(layer)
        return {"blocks": blocks, "layers": layers, **self._head(
            sd, "model.embed_tokens.weight",
            "model.final_layernorm.weight")}

    # ------------------------------------------------------------------ #
    def _memory_block(self, block, layer, x2h, kv_pages, metadata, i):
        """The shared block on the 2H-wide input with layer ``i``'s
        adapters (no inner residuals)."""
        normed = rms_norm(x2h, block["input_norm"], self.eps)
        lora_fn = None
        if self.attn_adapter:
            def lora_fn(n, x, base):
                if n == "o":            # the shared block's o has none
                    return base
                return base + ((x @ layer[f"{n}_a0"]) @ layer[f"{n}_a1"]
                               ).to(base.dtype)
        attn = self._attention(block, normed, kv_pages, metadata, i,
                               self.attn_spec, lora_fn=lora_fn)
        y = rms_norm(attn, block["pre_ff_norm"], self.eps)
        m = self._method("mlp")
        gu = m.apply(block["gate_up"], y)
        gu = gu + ((y @ layer["mlp_a0"]) @ layer["mlp_a1"]).to(gu.dtype)
        g, u = gu.split(gu.shape[-1] // 2, dim=-1)
        return m.apply(block["down"], self.act(g.float()).to(self.dtype) * u)

    def forward(self, params, token_ids, kv_pages, metadata,
                collect_hidden: bool = False, collect_kv_stats: bool = False,
                input_embeds=None):
        self._check_slots(metadata)
        h = embed_tokens(params["embed"], token_ids, input_embeds, self.dtype)
        original = h
        m, j = self._method("mlp"), 0
        for i, layer in enumerate(params["layers"]):
            residual = h
            if self.hybrid[i]:
                block = params["blocks"][j % self.num_mem_blocks]
                t = self._memory_block(block, layer,
                                       torch.cat([h, original], dim=-1),
                                       kv_pages, metadata, i)
                h = h + self._method("o_proj").apply(layer["linear"], t)
                j += 1
            out = mamba2_mixer(layer, rms_norm(h, layer["norm"], self.eps),
                               self._state(kv_pages, "conv_state", i),
                               self._state(kv_pages, "ssm_state", i),
                               metadata, self.geom, m, self.dtype)
            h = residual + out
        return self._finish(h, params, metadata, collect_hidden, kv_pages,
                            self.eps)
