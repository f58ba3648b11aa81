"""DeepSeek-V3 MTP (multi-token prediction) one-model speculation.

Port of ``tensorrt_llm_tpu/speculative/mtp.py`` (``MtpDrafter``;
reference: tensorrt_llm/_torch/speculative/mtp.py MTPWorker and
modeling_deepseekv3.py DeepseekV3MTP). The checkpoint's module at layer
index ``num_hidden_layers`` is a full DeepSeek decoder layer (MLA + MoE)
with ``enorm`` / ``hnorm`` RMSNorms on the token embedding and the
target's pre-norm hidden state, an ``eh_proj`` [H, 2H] fuse, and
``shared_head.norm``; the embedding and lm_head are the target's,
borrowed, not copied (a quantized lm_head dequantized once). The module
at position i takes (hidden_i, embed(token_{i+1})) and its output
predicts token_{i+2}; chained, it drafts K tokens.

The head needs an MLA target (``deepseek_v3``, ``deepseek_v2``): its
attention is the target model's ``_mla_attention`` over a single-layer
paged latent pool [slots * pages, page, kv_lora_rank + qk_rope_head_dim]
(``kv_entry_shape``), absorbed when a pass has one token a sequence
(the chained steps) and decompressed otherwise (the catch-up), and its
MoE the target's routing and experts. It drafts in the fused window
(runtime/spec_window.py, the engine's pool) or on the host path
(speculative/one_model.py, ``max_slots`` > 0, its own pool).

Without a trained module in ``head_state_dict`` the head is the JAX
package's seeded random one (``synth_state_dict``: the same
``np.random.default_rng(11)`` draws in the same order); at full width
those numpy draws are too slow, so a caller passes a ``RandomCheckpoint``
of ``synth_shapes`` (drawn on the device when read) instead, which the
same loader reads.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..ops.attention import AttentionMetadata
from ..ops.linear import dot_f32
from ..ops.norm import rms_norm
from ..ops.rope import rope_cos_sin
from ..runtime.spec_window import HEAD_PAGE_SIZE
from .one_model import OneModelDrafter


def synth_shapes(model, idx: int) -> Dict[str, Tuple[int, ...]]:
    """{checkpoint name: shape} of the MTP module at layer ``idx`` of
    ``model`` (a DeepSeek-V3 / V2 port model), in the order in which the
    JAX ``_synth_state_dict`` draws them."""
    H, nh = model.hidden_size, model.num_heads
    nope, rope_d, vd = model.qk_nope, model.qk_rope, model.v_dim
    lora = model.kv_lora_rank
    E, mi, ns = model.num_experts, model.moe_inter, model.n_shared
    p = f"model.layers.{idx}"
    shapes = {
        f"{p}.self_attn.kv_a_proj_with_mqa.weight": (lora + rope_d, H),
        f"{p}.self_attn.kv_a_layernorm.weight": (lora,),
        f"{p}.self_attn.kv_b_proj.weight": (nh * (nope + vd), lora),
        f"{p}.self_attn.o_proj.weight": (H, nh * vd),
        f"{p}.input_layernorm.weight": (H,),
        f"{p}.post_attention_layernorm.weight": (H,),
        f"{p}.mlp.gate.weight": (E, H),
        f"{p}.mlp.gate.e_score_correction_bias": (E,),
        f"{p}.enorm.weight": (H,),
        f"{p}.hnorm.weight": (H,),
        f"{p}.eh_proj.weight": (H, 2 * H),
        f"{p}.shared_head.norm.weight": (H,),
    }
    if model.q_lora_rank:
        shapes[f"{p}.self_attn.q_a_proj.weight"] = (model.q_lora_rank, H)
        shapes[f"{p}.self_attn.q_a_layernorm.weight"] = (model.q_lora_rank,)
        shapes[f"{p}.self_attn.q_b_proj.weight"] = \
            (nh * (nope + rope_d), model.q_lora_rank)
    else:
        shapes[f"{p}.self_attn.q_proj.weight"] = (nh * (nope + rope_d), H)
    for e in range(E):
        shapes[f"{p}.mlp.experts.{e}.gate_proj.weight"] = (mi, H)
        shapes[f"{p}.mlp.experts.{e}.up_proj.weight"] = (mi, H)
        shapes[f"{p}.mlp.experts.{e}.down_proj.weight"] = (H, mi)
    shapes[f"{p}.mlp.shared_experts.gate_proj.weight"] = (ns * mi, H)
    shapes[f"{p}.mlp.shared_experts.up_proj.weight"] = (ns * mi, H)
    shapes[f"{p}.mlp.shared_experts.down_proj.weight"] = (H, ns * mi)
    return shapes


def synth_state_dict(model, idx: int) -> Dict[str, np.ndarray]:
    """The JAX ``_synth_state_dict`` (mtp.py:79-119): norms ones, the
    correction bias zeros, every matrix normal(0, 0.02) float32 from
    ``np.random.default_rng(11)``, drawn in its order."""
    r = np.random.default_rng(11)
    out = {}
    for name, shape in synth_shapes(model, idx).items():
        if len(shape) == 1:
            out[name] = np.zeros(shape, np.float32) \
                if name.endswith("e_score_correction_bias") \
                else np.ones(shape, np.float32)
        else:
            out[name] = r.standard_normal(shape, np.float32) * 0.02
    return out


class MtpDrafter(OneModelDrafter):
    def __init__(self, target_model, target_params: Dict[str, Any], *,
                 max_draft_len: int = 3, max_slots: int = 0,
                 page_size: int = HEAD_PAGE_SIZE, max_seq_len: int = 2048,
                 head_state_dict: Optional[Mapping[str, Any]] = None,
                 token_buckets=(16, 64, 256)):
        super().__init__(max_draft_len)
        if not hasattr(target_model, "latent_dim"):
            raise NotImplementedError(
                f"MTP speculation with a {target_model.hf.model_type} "
                "target is not supported by this package: the MTP head "
                "needs a DeepSeek-style target with an MLA latent pool "
                "(the JAX package raises ValueError)")
        self.model = target_model
        self.H = target_model.hidden_size
        self.dtype = target_model.dtype
        self.device = target_model.device
        self.kv_entry_shape = (target_model.latent_dim,)
        self.params = self._load_head(head_state_dict)
        self.embed = target_params["embed"]
        self.lm_head = {"weight": target_model.m_lm_head.dequantize(
            target_params["lm_head"], self.dtype).t()}
        self._init_host(max_slots, page_size, max_seq_len, token_buckets)

    def _load_head(self, sd: Optional[Mapping[str, Any]]) -> Dict[str, Any]:
        """The module at ``num_hidden_layers`` through the target's layer
        loader (``hf_layer``: MLA, routed and shared experts), plus
        enorm, hnorm, eh_proj [H, 2H] and shared_head.norm
        ("head_norm")."""
        m = self.model
        idx = m.num_layers
        p = f"model.layers.{idx}."
        if sd is None or p + "eh_proj.weight" not in sd:
            sd = {k: torch.from_numpy(v)
                  for k, v in synth_state_dict(m, idx).items()}
        layer = m.hf_layer(sd, idx)
        for name, hf in (("enorm", "enorm"), ("hnorm", "hnorm"),
                         ("eh_proj", "eh_proj"),
                         ("head_norm", "shared_head.norm")):
            layer[name] = m._vec(sd[p + hf + ".weight"])
        return layer

    def head_forward(self, feats: torch.Tensor, tok_ids: torch.Tensor,
                     kv: torch.Tensor, md: AttentionMetadata
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One MTP-module pass (the JAX ``_head_forward``, mtp.py:
        138-162), writing the latents of ``md.slot_mapping`` into ``kv``
        in place: (raw hidden [T, H], which feeds the next chained step;
        head-normed hidden, which the lm_head reads)."""
        m, p, dt = self.model, self.params, self.dtype
        eps = m.rms_eps
        e = rms_norm(self.embed[tok_ids].to(dt), p["enorm"], eps)
        hs = rms_norm(feats.to(dt), p["hnorm"], eps)
        x = dot_f32(torch.cat([e, hs], dim=-1), p["eh_proj"]).to(dt)
        cos, sin = rope_cos_sin(m.rope_cfg, md.positions)
        T = x.shape[0]
        ctx = m._mla_context(md, T, kv.shape[1],
                             T == md.page_indices.shape[0] and "uk" in p)
        h = x + m._mla_attention(p, rms_norm(x, p["input_norm"], eps), kv,
                                 md, ctx, cos, sin)
        h = h + m._mlp(p, rms_norm(h, p["post_norm"], eps))
        return h, rms_norm(h, p["head_norm"], eps)
