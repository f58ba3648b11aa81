"""Shared base of the recurrent families (Mamba, Mamba2, Bamba, Jamba,
Zamba2, Granite-4.0-H, LFM2, Qwen3-Next, MiniMax).

What the JAX package spreads over each recurrent model
(``has_recurrent_state``, ``make_kv_pages`` returning a dict, the runs of
same-type layers; e.g. ``tensorrt_llm_tpu/models/bamba.py:52-94``) in
one place:

- The cache is a dict: ``"kv"``, the paged KV pool of the attention
  layers ``[max(attention layers, 1), pages, page, 2 kv heads, head
  dim]`` in the KV type (one layer of it for a model without attention,
  which the engine's page bookkeeping then leaves unread), and the state
  pools, float32 ``[state layers, slots, ...]`` named by
  ``state_shapes`` (``"conv_state"``, ``"ssm_state"``). The engine makes
  them with ``slots = max_batch_size + 1``: the last row is the trash
  slot (ops/ssm.py). Every layer writes its pools in place.
- ``block_types`` names each layer's kind; a layer of kind ``"attention"``
  reads KV layer ``kv_ord[i]``, the others state layer ``state_ord[i]``.
- Random weights (``init_params``, ``load_format="dummy"``) come from
  ``RandomCheckpoint``: the transformers model's parameter names and
  shapes, read off a model built on the ``meta`` device, each drawn on
  the target device when the loader reads it, so that a full-width model
  never holds more than its parameters and one tensor.

Refused by name: an 8-bit KV cache (the JAX models keep the config's
default scale on their attention layers, uncalibrated) and quantized
weights (the JAX mixers' projections would take the linear methods,
which no test of either package holds for these families).
"""
from __future__ import annotations

import hashlib
import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.attention import AttentionMetadata, layer_metadata
from ..ops.norm import rms_norm
from ..quantization.mode import QuantAlgo
from .modeling_utils import (AttentionMethods, AttentionSpec,
                             DecoderModelForCausalLM, attention_block,
                             fuse_projections, hf_transpose, quantize_linear)


class RandomCheckpoint(Mapping):
    """A transformers checkpoint of seeded random tensors, drawn on
    ``device`` in ``dtype`` when read: norms and ``D`` ones, ``A_log``
    log(1..n) along its last axis, ``dt_bias`` the inverse softplus of
    0.01 to 0.1, biases zero (a router's ``e_score_correction_bias``
    too, as transformers initialises it: drawn at 0.02 it would outweigh
    a 768-way softmax's scores and send every token to the same
    experts), MiniMax's ``slope_rate`` 2^-(1..nh)/2, everything else
    normal(0, 0.02). ``shapes``: {name: shape}."""

    def __init__(self, shapes: Dict[str, Tuple[int, ...]], device,
                 dtype: torch.dtype, seed: int = 0):
        self.shapes = shapes
        self.device = torch.device(device)
        self.dtype = dtype
        self.seed = seed

    def __len__(self):
        return len(self.shapes)

    def __iter__(self):
        return iter(self.shapes)

    def __getitem__(self, name: str) -> torch.Tensor:
        shape = self.shapes[name]
        kw = dict(device=self.device, dtype=torch.float32)
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "A_log" or name.endswith("A_log.weight"):
            n = shape[-1]
            out = torch.log(torch.arange(1, n + 1, **kw)).expand(shape)
        elif leaf == "D" or name.endswith("D.weight"):
            out = torch.ones(shape, **kw)
        elif leaf == "dt_bias":
            dt = torch.linspace(0.01, 0.1, math.prod(shape), **kw)
            out = (dt + torch.log(-torch.expm1(-dt))).view(shape)
        elif leaf == "slope_rate":
            nh = math.prod(shape)
            out = (0.5 * 2.0 ** -torch.arange(1, nh + 1, **kw)).view(shape)
        elif leaf in ("bias", "e_score_correction_bias"):
            out = torch.zeros(shape, **kw)
        elif "norm" in name and len(shape) == 1:
            out = torch.ones(shape, **kw)
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.seed + int(hashlib.sha1(
                name.encode()).hexdigest()[:8], 16))
            out = torch.randn(shape, generator=gen, **kw) * 0.02
        return out.to(self.dtype)


def meta_shapes(hf_cls, hf_config) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} of the transformers model ``hf_cls(hf_config)``'s
    state dict, built on the meta device (no memory)."""
    with torch.device("meta"):
        m = hf_cls(hf_config)
    return {k: tuple(v.shape) for k, v in m.state_dict().items()}


def stack_experts(model, sd, p: str, E: int,
                  names=("gate_proj", "up_proj", "down_proj")):
    """(w_gate_up [E, H, 2I], w_down [E, I, H]) of the experts at prefix
    ``p`` (``...experts.``) in ops/moe.py's layout: from per-expert [out,
    in] weights named ``p{e}.{name}.weight``, or from the fused 3D
    ``gate_up_proj`` / ``down_proj`` that transformers 5 keeps in its live
    modules, in either orientation (told apart by the hidden width)."""
    H = model.hidden_size
    g, u, d = names
    if f"{p}0.{g}.weight" in sd:
        w_gu = torch.stack([torch.cat([
            model._t(sd[f"{p}{e}.{g}.weight"]).t(),
            model._t(sd[f"{p}{e}.{u}.weight"]).t()], dim=-1)
            for e in range(E)])
        w_d = torch.stack([model._t(sd[f"{p}{e}.{d}.weight"]).t()
                           for e in range(E)])
        return w_gu, w_d.contiguous()
    w_gu = model._t(sd[p + "gate_up_proj"])
    w_d = model._t(sd[p + "down_proj"])
    if w_gu.shape[1] != H:
        w_gu = w_gu.transpose(1, 2)
    if w_d.shape[1] == H:
        w_d = w_d.transpose(1, 2)
    return w_gu.contiguous(), w_d.contiguous()


class RecurrentModel(DecoderModelForCausalLM):
    """Base of the recurrent families (module docstring). Subclasses set
    ``block_types``, ``state_shapes`` and, with attention layers,
    ``attn_spec``, and implement ``load_hf_state_dict`` and ``forward``;
    ``hf_class`` names the transformers class whose parameter shapes
    ``init_params`` draws."""
    has_recurrent_state = True
    hf_class = ""
    # the kind of an attention layer in ``block_types`` (Qwen3-Next's and
    # MiniMax's configs call theirs "full_attention")
    ATTENTION = "attention"

    def __init__(self, model_config):
        super().__init__(model_config)
        mt = self.hf.model_type
        if model_config.uses_kv_quant:
            raise NotImplementedError(
                f"an 8-bit KV cache on a {mt} model is not supported by "
                "this package (the JAX package keeps the config's default "
                "scale on the hybrids' attention layers, uncalibrated)")
        algo = getattr(model_config.quant_config, "quant_algo",
                       QuantAlgo.NO_QUANT)
        if algo not in (None, QuantAlgo.NO_QUANT):
            raise NotImplementedError(
                f"quantized weights ({algo.value}) of a {mt} model are not "
                "supported by this package (the recurrent families are "
                "served in the model's type)")
        self.hidden_size = self.hf.hidden_size
        self.block_types: List[str] = []

    # ------------------------------------------------------------------ #
    # Layers and pools
    # ------------------------------------------------------------------ #
    def _set_blocks(self, block_types: List[str]) -> None:
        """Each layer's kind and its ordinal in the KV pool (attention)
        or in the state pools (every other kind)."""
        self.block_types = list(block_types)
        self.kv_ord: List[int] = []
        self.state_ord: List[int] = []
        a = s = 0
        for bt in self.block_types:
            if bt == self.ATTENTION:
                self.kv_ord.append(a)
                self.state_ord.append(-1)
                a += 1
            else:
                self.kv_ord.append(-1)
                self.state_ord.append(s)
                s += 1
        self.n_attn, self.n_state = a, s

    @property
    def num_layers(self) -> int:
        return len(self.block_types)

    @property
    def kv_layers(self) -> int:
        return max(self.n_attn, 1)

    def state_shapes(self) -> Dict[str, Tuple[int, Tuple[int, ...]]]:
        """{pool name: (layers, per-slot shape)} of the state pools."""
        raise NotImplementedError

    def kv_pool_shape(self, num_pages: int, page_size: int) -> tuple:
        return (self.kv_layers, num_pages, page_size,
                2 * self.num_kv_heads, self.head_dim)

    def make_kv_pages(self, num_pages: int, page_size: int,
                      num_slots: int = 2) -> Dict[str, torch.Tensor]:
        """The KV pool and the state pools of ``num_slots`` slots (the
        engine's: max_batch_size + 1, the trash slot last)."""
        out = {"kv": torch.zeros(self.kv_pool_shape(num_pages, page_size),
                                 dtype=self.config.kv_cache_dtype,
                                 device=self.device)}
        for name, (layers, shape) in self.state_shapes().items():
            out[name] = torch.zeros((layers, num_slots) + tuple(shape),
                                    dtype=torch.float32, device=self.device)
        return out

    def state_bytes(self, num_slots: int) -> int:
        """Device bytes of the state pools at ``num_slots`` slots."""
        return sum(4 * layers * num_slots * math.prod(shape)
                   for layers, shape in self.state_shapes().values())

    def attention_windows(self) -> tuple:
        """One global window when the model has attention layers, none
        (no K1 launch to split) without."""
        return (None,) if self.n_attn else ()

    def act_width_per_token(self) -> int:
        """Activation elements per token of one layer (the graph pool's
        estimate): 4 hidden-wide tensors and 3 of the widest projection's
        output (a mixer's in_proj, an MLP's gate|up)."""
        return 4 * self.hidden_size + 3 * self._widest()

    def _widest(self) -> int:
        return 2 * getattr(self.hf, "intermediate_size", 0) or \
            4 * self.hidden_size

    def attn_scratch_bytes(self, seqs: int, tokens: int,
                           positions: int) -> int:
        """A decode step's scan scratch in one layer: the one-step update
        gathers each token's slot state and makes three more of its size
        (the decayed state, the input term, the new state), float32."""
        per_slot = max((4 * math.prod(shape) for _, shape in
                        self.state_shapes().values()), default=0)
        return 4 * tokens * per_slot

    # ------------------------------------------------------------------ #
    # Weights
    # ------------------------------------------------------------------ #
    def init_params(self, seed: int = 0) -> Dict[str, Any]:
        """Random weights (``RandomCheckpoint``) through the loader."""
        import transformers
        shapes = meta_shapes(getattr(transformers, self.hf_class), self.hf)
        return self.load_hf_state_dict(RandomCheckpoint(
            shapes, self.device, self.dtype, seed))

    def _t(self, a, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """A checkpoint tensor on the model's device (``dtype``, default
        the model's)."""
        return torch.as_tensor(a).to(device=self.device,
                                     dtype=dtype or self.dtype)

    def _lin(self, w, bias=None) -> Dict[str, torch.Tensor]:
        """One [out, in] projection through the unquantized method."""
        return quantize_linear(self._method("mlp"), hf_transpose(w),
                               bias=bias, dtype=self.dtype,
                               device=self.device)

    def _pair(self, fused: str, names, ws) -> Dict[str, Any]:
        """Projections of one input joined under ``fused``."""
        m = self._method("mlp")
        return fuse_projections(fused, names, [m] * len(names),
                                [self._lin(w) for w in ws])

    def _head(self, sd, embed_name: str, norm_name: str
              ) -> Dict[str, Any]:
        """embed, final_norm and lm_head (the embedding when tied or
        absent)."""
        embed = self._t(sd[embed_name])
        lm = sd["lm_head.weight"] if "lm_head.weight" in sd and not \
            getattr(self.hf, "tie_word_embeddings", False) else None
        return {"embed": embed, "final_norm": self._t(sd[norm_name]),
                "lm_head": {"weight": embed} if lm is None
                else {"weight": self._t(lm)}}

    # ------------------------------------------------------------------ #
    # Forward helpers
    # ------------------------------------------------------------------ #
    @staticmethod
    def _check_slots(metadata: AttentionMetadata) -> None:
        if metadata.seq_slots is None:
            raise ValueError("a recurrent model's step needs "
                             "AttentionMetadata.seq_slots")

    def _kv_flat(self, kv_pages: Dict[str, torch.Tensor]):
        kv = kv_pages["kv"]
        L, P, ps = kv.shape[:3]
        return kv.view((L * P,) + tuple(kv.shape[2:])), P, ps, L

    def _attention(self, layer, x, kv_pages, metadata, i: int,
                   spec: AttentionSpec, **kw) -> torch.Tensor:
        """Layer ``i``'s attention over its KV layer (K1/K2 on CUDA)."""
        flat, P, ps, L = self._kv_flat(kv_pages)
        md = layer_metadata(metadata, self.kv_ord[i], P, ps, L)
        m = self._method("q_proj")
        methods = AttentionMethods(m, m, self._method("o_proj"))
        return attention_block(layer, x, flat, md, spec, methods,
                               kv_scale=self.kv_scale, **kw)

    def _state(self, kv_pages, name: str, i: int) -> torch.Tensor:
        """Layer ``i``'s view of state pool ``name`` ([slots, ...])."""
        return kv_pages[name][self.state_ord[i]]

    def _gated_mlp(self, layer, x, fused: str = "gate_up",
                   down: str = "down") -> torch.Tensor:
        """down(silu(gate) * up) with gate|up fused under ``fused``."""
        m = self._method("mlp")
        w = layer[fused]["weight"].shape[0] // 2
        gate, up = m.apply(layer[fused], x).split(w, dim=-1)
        return m.apply(layer[down], F.silu(gate.float()).to(self.dtype) * up)

    def _finish(self, h, params, metadata, collect_hidden: bool, kv_pages,
                eps: float, logits_scaling: float = 1.0):
        """Final norm at the logits rows, lm_head, float32 logits."""
        rows = h[metadata.logits_indices]
        last = rms_norm(rows, params["final_norm"], eps)
        logits = self._method("lm_head").apply(params["lm_head"],
                                               last).float()
        if logits_scaling != 1.0:
            logits = logits / logits_scaling
        if collect_hidden:
            return logits, kv_pages, rows
        return logits, kv_pages
