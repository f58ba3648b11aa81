"""Multi-adapter LoRA serving.

Port of ``tensorrt_llm_tpu/lora/lora_manager.py``: adapters live in a host
cache keyed by ``lora_task_id``; the active ones sit in device slots, and
each token picks its slot (-1: none). ``LoraLayerWeights`` holds one
(layer, module) pair, A [K, r] and B [r, N] in the x @ A @ B layout, padded
to the config's ``max_lora_rank`` when the slots are stacked.

The engine keeps one stack per module, written in place (CUDA graphs read
it by address): ``LoraModuleStack`` holds every layer's slots side by
side, A [L, K, n·r] and B [L, n·r, N] with slot s in columns
[s·r, (s+1)·r), the slots' scales [n + 1] (float32, 0 in the last entry,
the zero adapter of tokens without one) and the DoRA column scales
[L, n + 1, N] (ones where an adapter has none).

``apply_lora`` computes the JAX function, out = mag[slot] * (out +
scale[slot] * ((x @ A[slot]) @ B[slot])), without gathering each token's
adapter: h = x @ A_cat, the columns of other slots zeroed, then h @ B_cat.
Its transient is [T, n·r] and one [T, N], where the JAX per-token gather
holds [T, K, r] and [T, r, N] (3.8 GB for the gate projection of an
8,192-token Llama-3-8B step at rank 16). ``apply_lora_gather`` is that
gather, the plain reference the tests hold the main form against.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

# checkpoint module names (below ``model.layers.{i}.``) of each target
HF_MODULES = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
              "v": "self_attn.v_proj", "o": "self_attn.o_proj",
              "gate": "mlp.gate_proj", "up": "mlp.up_proj",
              "down": "mlp.down_proj"}


@dataclasses.dataclass
class LoraConfig:
    max_lora_rank: int = 16
    max_loras: int = 8             # device slots
    max_cpu_loras: int = 64        # host cache entries
    lora_target_modules: Optional[List[str]] = None


@dataclasses.dataclass
class LoraRequest:
    lora_name: str
    lora_int_id: int
    lora_path: str


@dataclasses.dataclass
class LoraLayerWeights:
    """One (layer, module) pair: A [K, r], B [r, N] (x @ A @ B layout),
    scale = alpha / r. ``mag`` is the DoRA column scale m / ||W +
    scale·B@A||_col once normalized (``LoraAdapter.normalize_dora``), the
    raw magnitude m while ``mag_is_raw``; None for plain LoRA."""
    a: np.ndarray
    b: np.ndarray
    scale: float
    mag: Optional[np.ndarray] = None
    mag_is_raw: bool = False


class LoraAdapter:
    def __init__(self, task_id: int, rank: int,
                 weights: Dict[str, Dict[int, LoraLayerWeights]]):
        self.task_id = task_id
        self.rank = rank
        self.weights = weights      # module -> layer -> weights

    @classmethod
    def from_hf_dir(cls, task_id: int, path: str,
                    base_sd: Optional[Dict[str, np.ndarray]] = None
                    ) -> "LoraAdapter":
        """Load a PEFT checkpoint (``adapter_config.json`` +
        ``adapter_model.safetensors``; scale alpha / r, or alpha / sqrt(r)
        with ``use_rslora``). A DoRA checkpoint (``use_dora``) carries a
        ``lora_magnitude_vector`` per module: pass ``base_sd`` (the base
        model's checkpoint state dict) to normalize it here, or call
        ``normalize_dora`` later. The tensors are read with
        ``safetensors.torch`` and kept as float32 numpy arrays."""
        from safetensors.torch import load_file
        p = Path(path)
        cfg = json.loads((p / "adapter_config.json").read_text())
        rank = cfg["r"]
        alpha = cfg.get("lora_alpha", rank)
        scale = alpha / math.sqrt(rank) if cfg.get("use_rslora") \
            else alpha / rank
        sd = load_file(str(p / "adapter_model.safetensors"))
        mod_map = {"q_proj": "q", "k_proj": "k", "v_proj": "v",
                   "o_proj": "o", "gate_proj": "gate", "up_proj": "up",
                   "down_proj": "down"}
        weights: Dict[str, Dict[int, LoraLayerWeights]] = {}
        for key, val in sd.items():
            # e.g. base_model.model.model.layers.3.self_attn.q_proj.lora_A.weight
            parts = key.split(".")
            is_mag = "lora_magnitude_vector" in parts
            if "lora_A" not in parts and "lora_B" not in parts \
                    and not is_mag:
                continue
            layer_idx = int(parts[parts.index("layers") + 1])
            proj = next((mod_map[m] for m in mod_map if m in parts), None)
            if proj is None:
                continue
            entry = weights.setdefault(proj, {}).setdefault(
                layer_idx, LoraLayerWeights(None, None, scale))
            arr = val.float().numpy()
            if is_mag:
                entry.mag = arr.reshape(-1)
                entry.mag_is_raw = True
            elif "lora_A" in parts:
                entry.a = np.ascontiguousarray(arr.T)   # [K, r]
            else:
                entry.b = np.ascontiguousarray(arr.T)   # [r, N]
        adapter = cls(task_id, rank, weights)
        if base_sd is not None:
            adapter.normalize_dora(base_sd)
        return adapter

    def normalize_dora(self, base_sd: Dict[str, np.ndarray]) -> None:
        """Raw DoRA magnitudes to runtime column scales: mag <- m / ||W +
        scale·B@A||_col (the norm over the input dim, peft's weight norm
        of W [out, in] over dim 1), in float32."""
        for mod, per_layer in self.weights.items():
            for layer, w in per_layer.items():
                if w.mag is None or not w.mag_is_raw:
                    continue
                key = f"model.layers.{layer}.{HF_MODULES[mod]}.weight"
                base = np.asarray(base_sd[key], np.float32)   # [N, K]
                delta = (w.a.astype(np.float32)
                         @ w.b.astype(np.float32)) * w.scale   # [K, N]
                norm = np.linalg.norm(base.T + delta, axis=0)   # [N]
                w.mag = w.mag / np.maximum(norm, 1e-12)
                w.mag_is_raw = False

    @property
    def has_dora(self) -> bool:
        return any(w.mag is not None for per in self.weights.values()
                   for w in per.values())


class LoraModuleStack(NamedTuple):
    """One module's adapters in every layer and slot (module docstring):
    a [L, K, n·r], b [L, n·r, N], scale f32[n + 1], mag [L, n + 1, N]."""
    a: torch.Tensor
    b: torch.Tensor
    scale: torch.Tensor
    mag: torch.Tensor

    @classmethod
    def empty(cls, L: int, K: int, N: int, n: int, r: int,
              dtype: torch.dtype, device) -> "LoraModuleStack":
        """Every slot empty: A and B zero, the scales 0, the DoRA scales
        ones."""
        return cls(torch.zeros(L, K, n * r, dtype=dtype, device=device),
                   torch.zeros(L, n * r, N, dtype=dtype, device=device),
                   torch.zeros(n + 1, dtype=torch.float32, device=device),
                   torch.ones(L, n + 1, N, dtype=dtype, device=device))


class LoraManager:
    """Host cache and device slots (the reference's PeftCacheManager
    role)."""

    def __init__(self, config: LoraConfig, num_layers: int):
        self.config = config
        self.num_layers = num_layers
        self._host_cache: Dict[int, LoraAdapter] = {}
        self._slot_of: Dict[int, int] = {}
        self._slots: List[Optional[int]] = [None] * config.max_loras

    def add_adapter(self, adapter: LoraAdapter) -> None:
        if len(self._host_cache) >= self.config.max_cpu_loras:
            # evict an unreferenced adapter (FIFO)
            for tid in list(self._host_cache):
                if tid not in self._slot_of:
                    del self._host_cache[tid]
                    break
        self._host_cache[adapter.task_id] = adapter

    def load_from_path(self, task_id: int, path: str) -> None:
        self.add_adapter(LoraAdapter.from_hf_dir(task_id, path))

    def activate(self, task_id: int) -> int:
        """Pin an adapter to a device slot; returns the slot id."""
        if task_id in self._slot_of:
            return self._slot_of[task_id]
        if task_id not in self._host_cache:
            raise KeyError(f"unknown lora_task_id {task_id}")
        ad = self._host_cache[task_id]
        if any(w.mag_is_raw for per in ad.weights.values()
               for w in per.values()):
            raise ValueError(
                f"DoRA adapter {task_id} has unnormalized magnitudes: "
                "call adapter.normalize_dora(base_state_dict) first (the "
                "runtime applies pre-normalized column scales)")
        try:
            slot = self._slots.index(None)
        except ValueError:
            raise RuntimeError("no free LoRA device slots") from None
        self._slots[slot] = task_id
        self._slot_of[task_id] = slot
        return slot

    def deactivate(self, task_id: int) -> None:
        slot = self._slot_of.pop(task_id, None)
        if slot is not None:
            self._slots[slot] = None

    def slot_for(self, task_id: Optional[int]) -> int:
        """-1 = no adapter."""
        if task_id is None:
            return -1
        return self._slot_of.get(task_id, -1)

    @property
    def has_dora(self) -> bool:
        """Whether an active adapter carries DoRA column scales."""
        return any(self._host_cache[tid].has_dora
                   for tid in self._slots if tid is not None)

    def adapter_in(self, slot: int) -> Optional[LoraAdapter]:
        """The adapter that slot ``slot`` holds (None: empty)."""
        tid = self._slots[slot]
        return None if tid is None else self._host_cache[tid]

    def write_slot(self, stack: LoraModuleStack, mod: str,
                   slot: int) -> None:
        """Write slot ``slot``'s adapter of module ``mod`` (zeros when the
        slot is empty) into ``stack`` in place: its columns of A, its rows
        of B, its scale and its DoRA scales. Built in float32 on the host,
        cast to the stack's type."""
        r, L = self.config.max_lora_rank, self.num_layers
        K, N = stack.a.shape[1], stack.b.shape[2]
        A = np.zeros((L, K, r), np.float32)
        B = np.zeros((L, r, N), np.float32)
        mag = np.ones((L, N), np.float32)
        scale = 0.0
        ad = self.adapter_in(slot)
        per_layer = {} if ad is None else ad.weights.get(mod, {})
        for layer, w in per_layer.items():
            if w.a is None or w.b is None:
                continue
            rr = w.a.shape[1]
            A[layer, :, :rr] = w.a
            B[layer, :rr, :] = w.b
            if w.mag is not None:
                mag[layer] = w.mag
        if per_layer:
            scale = next(iter(per_layer.values())).scale
        cols = slice(slot * r, (slot + 1) * r)
        dt = stack.a.dtype
        stack.a[:, :, cols].copy_(torch.from_numpy(A).to(dt))
        stack.b[:, cols].copy_(torch.from_numpy(B).to(dt))
        stack.scale[slot] = scale
        stack.mag[:, slot].copy_(torch.from_numpy(mag).to(dt))

    def device_stacks(self, module_shapes: Dict[str, tuple],
                      dtype: torch.dtype, device) -> Dict[str,
                                                          LoraModuleStack]:
        """Every module's stacks (``LoraModuleStack``) of the active slots,
        built anew on ``device`` in ``dtype`` (the scales float32). The
        engine keeps its own stacks and rewrites only the slots that
        changed (``ModelEngine.refresh_lora``)."""
        n, r = self.config.max_loras, self.config.max_lora_rank
        out = {}
        for m, (K, N) in module_shapes.items():
            st = LoraModuleStack.empty(self.num_layers, K, N, n, r, dtype,
                                       device)
            for slot in range(n):
                self.write_slot(st, m, slot)
            out[m] = st
        return out


def apply_lora(x: torch.Tensor, base_out: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, scales: torch.Tensor,
               slot_ids: torch.Tensor,
               mag: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One layer's adapters on one projection's output, each token through
    its slot's (``slot_ids`` i32[T], -1 none): a [K, n·r] and b [n·r, N]
    are the layer's concatenated slots, ``scales`` f32[n + 1], ``mag``
    [n + 1, N] the DoRA column scales (None: no DoRA adapter active).

        out = mag[slot] * (out + scale[slot] * ((x @ A[slot]) @ B[slot]))

    with the JAX roundings: h in x's type, the float32 scale applied to
    the delta before its cast to the output's type (the JAX
    ``apply_lora``, lora/lora_manager.py:242-267)."""
    n = scales.shape[0] - 1
    r = a.shape[1] // n
    sid = torch.where(slot_ids >= 0, slot_ids, n).long()
    h = x.to(a.dtype) @ a                                  # [T, n·r]
    col = torch.arange(n * r, device=x.device) // r
    h = torch.where(col[None, :] == sid[:, None], h, torch.zeros_like(h))
    delta = h @ b                                          # [T, N]
    out = base_out + (delta * scales[sid][:, None]).to(base_out.dtype)
    if mag is not None:
        out = out * mag[sid].to(out.dtype)
    return out


def apply_lora_gather(x: torch.Tensor, base_out: torch.Tensor,
                      a: torch.Tensor, b: torch.Tensor, scales: torch.Tensor,
                      slot_ids: torch.Tensor,
                      mag: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``apply_lora`` as the JAX package computes it: each token's
    adapter gathered, A [T, K, r] and B [T, r, N], and two batched
    products. The plain reference of the tests (its transient grows with
    T·K·r and T·r·N)."""
    n = scales.shape[0] - 1
    K, N = a.shape[0], b.shape[1]
    r = a.shape[1] // n
    a_s = torch.cat([a.view(K, n, r).permute(1, 0, 2),
                     a.new_zeros(1, K, r)])                # [n + 1, K, r]
    b_s = torch.cat([b.view(n, r, N), b.new_zeros(1, r, N)])
    sid = torch.where(slot_ids >= 0, slot_ids, n).long()
    h = torch.einsum("tk,tkr->tr", x.to(a.dtype), a_s[sid])
    delta = torch.einsum("tr,trn->tn", h, b_s[sid])
    out = base_out + (delta * scales[sid][:, None]).to(base_out.dtype)
    if mag is not None:
        out = out * mag[sid].to(out.dtype)
    return out


class LoraStep(NamedTuple):
    """A step's adapters, as the model's forward takes them (``lora=``):
    the engine's stacks by module, each token's slot (i32[T], -1 none),
    and whether the DoRA column scales apply."""
    stacks: Dict[str, LoraModuleStack]
    slots: torch.Tensor
    dora: bool

    def layer_fn(self, layer: int) -> Callable[[str, torch.Tensor,
                                                torch.Tensor],
                                               torch.Tensor]:
        """``lora_fn(name, x, out)`` of layer ``layer`` (the hooks of
        models/modeling_utils.attention_block and the Llama trunk's
        MLP): ``out`` with module ``name``'s adapters added, or ``out``
        where the module has none."""
        def f(name: str, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
            st = self.stacks.get(name)
            if st is None:
                return out
            return apply_lora(x, out, st.a[layer], st.b[layer], st.scale,
                              self.slots,
                              st.mag[layer] if self.dora else None)
        return f
