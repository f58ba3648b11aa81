"""EAGLE3 one-model speculative head, for the fused device window.

Port of ``tensorrt_llm_tpu/speculative/eagle.py`` (``Eagle3Drafter``)
for the device window only (runtime/spec_window.py): the head's
parameters (``_load_head``), its forward (``head_forward``), the
embedding and lm_head it borrows from the target, and the acceptance
statistics. A single trained decoder layer predicts the target's next
hidden feature from (current feature, next token embedding); draft
tokens come from applying the target's lm_head to predicted features,
autoregressively (reference: tensorrt_llm/_torch/speculative/eagle3.py).
The host-orchestrated proposal functions are not ported: the head runs
inside the window, on the engine's head KV pool.

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
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.modeling_utils import (AttentionMethods, AttentionSpec,
                                     attention_block)
from ..ops.attention import AttentionMetadata
from ..ops.linear import LinearMethod, dot_f32
from ..ops.norm import rms_norm
from ..ops.rope import RopeConfig
from ..runtime.request import LlmRequest
from ..runtime.spec_window import HEAD_PAGE_SIZE
from .interface import Drafter

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


class Eagle3Drafter(Drafter):
    wants_hidden_states = True

    def __init__(self, target_model, target_params: Dict[str, Any], *,
                 max_draft_len: int = 4, page_size: int = HEAD_PAGE_SIZE,
                 max_seq_len: int = 2048,
                 head_state_dict: Optional[Mapping[str, Any]] = None):
        super().__init__(max_draft_len)
        self.model = target_model
        self.H = target_model.hidden_size
        self.nq = target_model.num_heads
        self.nkv = target_model.num_kv_heads
        self.hd = target_model.head_dim
        self.I = getattr(target_model.hf, "intermediate_size", 4 * self.H)
        self.dtype = target_model.dtype
        self.device = target_model.device
        self.page_size = page_size
        self.max_seq_len = max_seq_len
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
        self.acceptance_window: List[int] = []  # accepted-per-step stats
        # every step since build: drafts accepted, steps
        self.accepted_total = 0
        self.steps_total = 0

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

    def draft_argmax(self, f: torch.Tensor) -> torch.Tensor:
        """The draft token of each feature row: argmax of ``f @ lm_head``
        taken in float32."""
        return torch.argmax(dot_f32(f, self.lm_head["weight"]), dim=-1)

    # ------------------------------------------------------------------ #
    def update(self, request: LlmRequest, accepted: List[int]) -> None:
        self.acceptance_window.append(len(accepted))
        if len(self.acceptance_window) > 512:
            self.acceptance_window.pop(0)
        self.accepted_total += len(accepted)
        self.steps_total += 1
