"""GPT-2.

Port of ``tensorrt_llm_tpu/models/gpt2.py`` (``GPT2LMHeadModel``, :26):
learned absolute positions, pre-LayerNorm blocks with biases, a tanh-GELU
MLP and a head tied to the embedding. It is the LayerNorm family's
sequential block (models/gpt_family.py) with GPT-2's checkpoint names:
its Conv1D weights are stored [in, out], so the loader transposes them to
the family's [out, in] and splits the fused c_attn into q, k and v
(which then join again where their methods let them).
"""
from __future__ import annotations

import torch

from ..ops.linear import LinearMethod
from ..quantization.lazy_state_dict import strip_prefix
from .gpt_family import LnFamilyModel
from .modeling_utils import register_model


@register_model("gpt2")
class GPT2LMHeadModel(LnFamilyModel):
    architectures = ("GPT2LMHeadModel",)
    act_name = "gelu_new"

    @property
    def num_layers(self) -> int:
        return self.hf.n_layer

    @property
    def num_kv_heads(self) -> int:
        return self.hf.n_head

    @property
    def head_dim(self) -> int:
        return self.hf.n_embd // self.hf.n_head

    def _inner_size(self) -> int:
        return getattr(self.hf, "n_inner", None) or 4 * self.hf.n_embd

    def _ln_eps(self) -> float:
        return getattr(self.hf, "layer_norm_epsilon", 1e-5)

    def _rope_config(self):
        return None

    def init_params(self, seed: int = 0):
        """``LnFamilyModel.init_params`` with the head tied to the
        embedding (shared, as the JAX model's lm_head is wte.T) and the
        learned positions."""
        params = super().init_params(seed)
        if type(self.m_lm_head) is LinearMethod:
            params["lm_head"] = {"weight": params["embed"]}
        return params

    def _init_extra(self, mat, norm):
        return {"wpe": mat(self.hf.n_positions, self.hidden_size)}

    def _prepare(self, sd):
        """HF prefixes the trunk with "transformer." (a view: nothing is
        read here)."""
        return strip_prefix(sd, "transformer.")

    def _hf_layer(self, sd, i):
        H = self.hidden_size
        pre = f"h.{i}."

        def conv(name):      # Conv1D [in, out] -> [out, in]
            return torch.as_tensor(sd[pre + name + ".weight"]).t(), \
                sd[pre + name + ".bias"]
        w, b = conv("attn.c_attn")
        b = torch.as_tensor(b)
        projs = {n: (w[j * H:(j + 1) * H], b[j * H:(j + 1) * H])
                 for j, n in enumerate("qkv")}
        projs.update(o=conv("attn.c_proj"), fc=conv("mlp.c_fc"),
                     proj=conv("mlp.c_proj"))
        return ({"ln1": self._pair(sd, pre + "ln_1"),
                 "ln2": self._pair(sd, pre + "ln_2")}, projs)

    def _hf_top(self, sd):
        wte = sd["wte.weight"]
        return {"embed": wte, "wpe": sd["wpe.weight"],
                "final_norm": self._pair(sd, "ln_f"),
                "lm_head": (wte,)}
