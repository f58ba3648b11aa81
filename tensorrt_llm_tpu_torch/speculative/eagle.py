"""EAGLE3 one-model speculative head.

Port of ``tensorrt_llm_tpu/speculative/eagle.py`` (``Eagle3Drafter``):
the head's parameters (``_load_head``), its forward (``head_forward``),
the embedding and lm_head it borrows from the target, and the acceptance
statistics. A single trained decoder layer predicts the target's next
hidden feature from (current feature, next token embedding); draft
tokens come from applying the target's lm_head to predicted features,
autoregressively (reference: tensorrt_llm/_torch/speculative/eagle3.py).
The head runs inside the fused window (runtime/spec_window.py) on the
engine's head KV pool, or with ``max_slots`` > 0 on the host path
(speculative/one_model.py, a linear chain, on its own pool). The tree
and DFLASH block proposals are not ported.

Parameters (``{"weight": [out, in]}`` per projection, as the port's
unquantized linear method keeps them): fuse [H, 2H], input_norm [H],
post_norm [H], qkv [(nq+2nkv)*hd, H], o [H, nq*hd], gate_up [2I, H],
down [H, I]. ``head_params_from_jax`` builds them from the JAX head's
``params`` ([in, out] per projection, q/k/v and gate/up apart), and
``_load_head`` reads a checkpoint by the JAX names into that layout
first, with the same seeded random fill for missing tensors, so a random
head is the same head in both packages.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.modeling_utils import (AttentionMethods, AttentionSpec,
                                     attention_block)
from ..ops.attention import AttentionMetadata
from ..ops.linear import LinearMethod, dot_f32
from ..ops.norm import rms_norm
from ..ops.rope import RopeConfig
from ..runtime.spec_window import HEAD_PAGE_SIZE
from .one_model import OneModelDrafter

HEAD_EPS = 1e-6       # the head's RMSNorm epsilon (fixed, not the target's)


def head_params_from_jax(params_np: Mapping[str, Any], dtype: torch.dtype,
                         device="cpu") -> Dict[str, Any]:
    """The JAX head's parameters (numpy, [in, out] per projection) ->
    this package's head parameters."""
    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(
            device=device, dtype=dtype)

    def lin(*names) -> Dict[str, torch.Tensor]:
        return {"weight": torch.cat(
            [t(np.asarray(params_np[n]["weight"]).T) for n in names])
            .contiguous()}

    return {"fuse": lin("fuse"), "input_norm": t(params_np["input_norm"]),
            "post_norm": t(params_np["post_norm"]),
            "qkv": lin("q", "k", "v"), "o": lin("o"),
            "gate_up": lin("gate", "up"), "down": lin("down")}


class Eagle3Drafter(OneModelDrafter):
    def __init__(self, target_model, target_params: Dict[str, Any], *,
                 max_draft_len: int = 4, max_slots: int = 0,
                 page_size: int = HEAD_PAGE_SIZE, max_seq_len: int = 2048,
                 head_state_dict: Optional[Mapping[str, Any]] = None,
                 token_buckets=(16, 64, 256)):
        super().__init__(max_draft_len)
        self.model = target_model
        self.H = target_model.hidden_size
        self.nq = target_model.num_heads
        self.nkv = target_model.num_kv_heads
        self.hd = target_model.head_dim
        self.I = getattr(target_model.hf, "intermediate_size", 4 * self.H)
        self.dtype = target_model.dtype
        self.device = target_model.device
        # one entry of the head's single-layer paged KV pool
        self.kv_entry_shape = (2 * self.nkv, self.hd)
        self.attn_spec = AttentionSpec(
            num_heads=self.nq, num_kv_heads=self.nkv, head_dim=self.hd,
            sm_scale=1.0 / math.sqrt(self.hd),
            rope=RopeConfig(head_dim=self.hd,
                            max_position_embeddings=max_seq_len))
        self.methods = AttentionMethods(LinearMethod(), LinearMethod(),
                                        LinearMethod())
        self.params = self._load_head(head_state_dict)
        # borrowed from the target (standard EAGLE): the embedding, and
        # the lm_head as [V, H] floats (a quantized target's is
        # dequantized once here)
        self.embed = target_params["embed"]
        self.lm_head = {"weight": target_model.m_lm_head.dequantize(
            target_params["lm_head"], self.dtype).t()}
        self._init_host(max_slots, page_size, max_seq_len, token_buckets)

    # ------------------------------------------------------------------ #
    def _load_head(self, sd: Optional[Mapping[str, Any]]) -> Dict[str, Any]:
        """Head params: fuse [2H, H] + one llama-style decoder layer, read
        by the public EAGLE checkpoint naming (fc.weight, layers.0.* /
        midlayer.*); missing tensors fall back to the JAX package's
        seeded random fill, drawn in its order, so the mechanism runs
        without a trained head."""
        H, nq, nkv, hd, I = self.H, self.nq, self.nkv, self.hd, self.I
        r = np.random.default_rng(7)

        def mat(shape):
            return (r.standard_normal(shape, np.float32) * 0.02) \
                .astype(np.float32)

        def get(*names, shape, transpose=True):
            for n in names:
                if sd is not None and n in sd:
                    w = np.asarray(torch.as_tensor(sd[n]).float().numpy())
                    return w.T if transpose else w
            return mat(shape)

        pre = ("layers.0.", "midlayer.")

        def layer_w(suffix, shape):
            return {"weight": get(*[p + suffix for p in pre], shape=shape)}

        jax_layout = {
            "fuse": {"weight": get("fc.weight", shape=(2 * H, H))},
            "input_norm": get(
                *[p + "input_layernorm.weight" for p in pre],
                "hidden_norm.weight", shape=(H,), transpose=False),
            "post_norm": get(
                *[p + "post_attention_layernorm.weight" for p in pre],
                shape=(H,), transpose=False),
            "q": layer_w("self_attn.q_proj.weight", (H, nq * hd)),
            "k": layer_w("self_attn.k_proj.weight", (H, nkv * hd)),
            "v": layer_w("self_attn.v_proj.weight", (H, nkv * hd)),
            "o": layer_w("self_attn.o_proj.weight", (nq * hd, H)),
            "gate": layer_w("mlp.gate_proj.weight", (H, I)),
            "up": layer_w("mlp.up_proj.weight", (H, I)),
            "down": layer_w("mlp.down_proj.weight", (I, H)),
        }
        return head_params_from_jax(jax_layout, self.dtype, self.device)

    # ------------------------------------------------------------------ #
    def head_forward(self, feats: torch.Tensor, tok_ids: torch.Tensor,
                     kv: torch.Tensor, md: AttentionMetadata
                     ) -> torch.Tensor:
        """One decoder-layer pass over fused [feature; embed] inputs,
        appending to the head pool ``kv`` in place. feats [T, H], tok_ids
        [T] -> new features [T, H]. The fuse, attention and MLP products
        accumulate in float32; the gate stays float32 through the SiLU."""
        p, dt = self.params, self.dtype
        e = self.embed[tok_ids].to(dt)
        x = F.linear(torch.cat([feats.to(dt), e], dim=-1),
                     p["fuse"]["weight"])
        normed = rms_norm(x, p["input_norm"], HEAD_EPS)
        h = x + attention_block(p, normed, kv, md, self.attn_spec,
                                self.methods)
        normed = rms_norm(h, p["post_norm"], HEAD_EPS)
        g, u = dot_f32(normed, p["gate_up"]["weight"]).split(self.I, -1)
        a = F.silu(g).to(dt) * u.to(dt)
        return h + F.linear(a, p["down"]["weight"])
