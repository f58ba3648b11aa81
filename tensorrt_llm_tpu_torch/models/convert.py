"""Parameter conversion from the JAX package's Llama and MoE layouts.

``from_jax_params`` takes the parameter tree of the JAX
``LlamaForCausalLM`` (Qwen2/Qwen3 and Gemma 2/3 included) or
``MixtralForCausalLM``
(Qwen2-MoE, Qwen3-MoE, OLMoE included) as numpy arrays — stacked layers
with a leading L axis, one dict per projection — and returns this
package's parameters (a list of per-layer dicts, fused qkv and gate_up),
so that both packages compute the same function from the same numbers.
An unquantized projection (``{"weight": [in, out]}``) becomes
``{"weight": [out, in]}``; a quantized one keeps its [K, N] integers
(packed int4 included) or float8 e4m3 bytes (viewed as bytes, so that no
value is converted), ``weight_scale``, ``weight_zero``, ``smooth`` and
``bias`` as they are; a W4A8 one's int4-grid weight and group scales
are folded into the int8 weight the port stores beside its
``channel_scale`` (ops/quant.fold_w4a8). q/k/v and gate/up join where
``ops.linear.can_fuse`` lets them (not under SmoothQuant's per-projection
smoothing vectors, nor FP8 block scales over part-blocks). The MoE parts: ``router`` [L, H, E] becomes [E, H];
the experts ``w_gate`` / ``w_up`` [L, E, H, I] become one ``w_gate_up``
[E, H, 2I] and ``w_down`` [L, E, I, H] stays [E, I, H] (ops/moe.py's
layout); the shared expert's ``se_gate`` / ``se_up`` projections fuse into
``se_gate_up``, and its gate ``se_gate_w`` [L, H, 1] becomes [1, H].
``q_norm`` / ``k_norm`` are carried as they are, and so are GLM-4's
sandwich norms (``post_attn_extra``, ``post_mlp_extra``), the four
norms of the JAX Gemma models (``post_attn_norm``, ``pre_ffn_norm``,
``post_ffn_norm`` beside ``input_norm``); their ``is_sliding`` flags are
static config here (``layer_specs``) and are dropped, as are EXAONE 4's
``is_sliding`` and SmolLM3's ``use_rope``.
The LayerNorm GPT families' trees (``LnFamilyModel``: per-layer "ln1" /
"ln2" {"w", "b"}, q/k/v/o, "fc", "fc2", "proj"; "wpe", "embed_ln",
``final_norm`` {"w", "b"}) and GPT-2's (``ln1_w`` / ``ln1_b`` ...,
``lnf_w`` / ``lnf_b``) become the port's family layout
(models/gpt_family.py: q/k/v joined into "qkv", a gated MLP's fc/fc2 into
"fc_pair"); Cohere2's ``is_sliding`` is static config here. GPT-OSS's
layers add "sinks", ``router_bias`` and the experts' ``b_gate`` /
``b_up`` (joined into ``b_gate_up`` [E, 2I]) and ``b_down``, all float32,
and drop ``is_sliding`` (``layer_specs``).
LongCat-Flash's ``pairs`` tree (each pair's MLA + dense sublayers under
keys ending in 0 and 1, its router [H, E+Z], ``router_bias`` and
experts) becomes the flat sublayers 2i + s and one ``pairs`` entry a
pair (models/deepseek.py ``LongcatFlashForCausalLM``).
The DeepSeek-style trees (``dense_layers`` and ``moe_layers``, each
stacked: DeepSeek's MLA ``q`` or ``q_a`` / ``q_a_norm`` / ``q_b``,
``kv_a``, ``kv_a_norm``, ``kv_b``, ``uk``, ``uv``; GLM-4.5's and ERNIE
4.5's q/k/v and q/k norms; the MoE layers' ``router`` [H, E] (-> [E, H]),
``router_bias`` (float32), stacked experts and shared experts ``s_gate``
/ ``s_up`` / ``s_down``) become one list of layers in layer order, the
shared experts under the Mixtral names ``se_gate_up`` / ``se_down``. An
ungated shared expert (HunYuan-MoE) has no ``se_gate_w``. Apertus's
layers (``norm`` / ``ff_norm``, a gateless ``up`` / ``down`` and the
xIELU scalars) keep their names, the norms as ``input_norm`` /
``post_norm``, the scalars as 0-dim float32 tensors.
The recurrent families' trees (``from_jax_params(..., model=m)`` with
the port model ``m``, whose layer kinds order them): ``layers`` stacked
(Mamba, Mamba2), ``runs`` of stacked same-kind layers (Bamba,
Granite-4.0-H, LFM2, Qwen3-Next, MiniMax), Zamba2's per-layer ``layers``
and shared ``blocks``, or Jamba's ``mamba_dense`` / ``mamba_moe`` /
``attn`` stacked by period, become one list of layers in layer order.
Projections are carried as above and joined (q/k/v into qkv, gate/up
into gate_up, LFM2's w1/w3 into w13, the shared MLPs' s_gate/s_up and
se_gate/se_up); the experts ``moe_gate`` / ``moe_up`` or ``w_gate`` /
``w_up`` [E, H, I] become ``w_gate_up`` and the routers [H, E] become
[E, H]; the [in, out] matrices the JAX models apply with ``jnp.dot``
(Qwen3-Next's ``w_qkv``, ``w_z``, ``w_b``, ``w_a``, its attention's
``gate`` and ``se_gate_w``; MiniMax's ``w_q``, ``w_k``, ``w_v``,
``w_gate_out``) become [out, in]; Zamba2's adapters stay [in, out]; the
mixers' conv_w, conv_b, A_log, D, dt_bias and MiniMax's slope stay
float32.
The M-RoPE vision-language models (qwen2_vl, qwen2_5_vl, qwen3_vl,
qwen3_vl_moe, glm4v): the trunk's tree goes through its family's path
above, and with ``vision=`` the JAX model's ``_vision_params`` (its
tower's tree: stacked ``blocks``, matrices [in, out]) become the port
model's ``vision_params`` (``from_jax_vision``): the blocks unstacked into
a list, every name and orientation kept, Qwen2.5-VL's ``is_full`` flags
dropped (the port's tower holds ``fullatt_block_indexes`` as config).
The image-group and cross-attention models (gemma3, paligemma, mllama):
the trunk's tree as above (Mllama's self-attention layers are its
``layers``; its stacked ``cross`` layers become a list of per-layer
dicts, projections [out, in] and the MLP's gate and up fused), the
tower's tree with ``vision=`` (SigLIP's stacked ``layers``, Mllama's
``local`` and ``global``, unstacked) and ``projector=`` (the JAX model's
``_projector``: the same names, as tensors).
With ``kv_scales`` (a model on a quantized KV cache), the JAX Llama's
per-layer ``kv_scale`` [L] (float32) becomes each layer's 0-dim float32
``kv_scale``, so that both packages quantize with the same scales.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..ops.linear import can_fuse, fuse_params
from ..ops.quant import fold_w4a8


# a layer's norm weights: the Llama trunk's two, GLM-4's sandwich norms,
# or Gemma's four
_NORMS = ("input_norm", "post_norm", "post_attn_extra", "post_mlp_extra",
          "post_attn_norm", "pre_ffn_norm", "post_ffn_norm")


def carry_array(a, device="cpu", dtype: Optional[torch.dtype] = None
                ) -> torch.Tensor:
    """One numpy array as a tensor on ``device`` (of ``dtype``, default
    its own): float8 e4m3 by its bytes, ml_dtypes int4 widened to int8."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn).to(device)
    if a.dtype.kind not in "fiub":
        a = a.astype(np.int8)
    out = torch.from_numpy(np.array(a))          # a writable copy
    return out.to(device=device, dtype=dtype or out.dtype)


def carry_projection(p: Dict[str, Any], device="cpu",
                     dtype: Optional[torch.dtype] = None
                     ) -> Dict[str, torch.Tensor]:
    """One JAX projection ({name: array}, layer axis already indexed) in
    the port's form; ``dtype`` applies to float weights and the bias."""
    if "weight_scale" not in p:
        out = {"weight": carry_array(np.asarray(p["weight"]).T, device,
                                     dtype)}
    else:
        out = {k: carry_array(p[k], device) for k in p if k != "bias"}
    if "channel_scale" in out:             # W4A8: the port's folded form
        out["weight"] = fold_w4a8(out["weight"], out.pop("weight_scale"))
    if "bias" in p:
        out["bias"] = carry_array(p["bias"], device, dtype)
    return out


def from_jax_params(params_np: Dict[str, Any], device="cpu",
                    dtype: Optional[torch.dtype] = None,
                    kv_scales: bool = False, model=None,
                    vision=None, projector=None) -> Dict[str, Any]:
    """JAX Llama params (numpy) -> port params (tensors on ``device``).
    ``dtype`` (default: the arrays' own) applies to the float weights,
    norms and biases; integers and float32 scales keep their types.
    ``kv_scales``: carry the layers' ``kv_scale`` (a quantized KV
    cache). ``model``: the port model, which a recurrent family's tree
    needs for its layer order, and whose ``vision_params`` a
    vision-language model's tower tree ``vision`` (numpy) becomes, and
    its ``projector`` the tree ``projector``."""
    if vision is not None:
        model.vision_params = from_jax_vision(vision, device, dtype)
    if projector is not None:
        model.projector = {k: carry_array(v, device, dtype)
                           for k, v in projector.items()}

    def t(a, dt=dtype) -> torch.Tensor:
        return carry_array(a, device, dt)

    def proj(p: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return carry_projection(p, device, dtype)

    def fused(at, name, names):
        """{name: one projection} of the projections ``at(n)`` of
        ``names`` where they join (``can_fuse``), else each under its own
        name."""
        parts = [at(n) for n in names]
        if not can_fuse(parts):
            return dict(zip(names, parts))
        plain = set(parts[0]) <= {"weight", "bias"}    # [out, in]
        return {name: fuse_params(parts, weight_dim=0 if plain else -1)}

    if getattr(model, "has_recurrent_state", False):
        return _from_jax_recurrent(params_np, model, t, proj, fused)
    if "pairs" in params_np:
        return _from_jax_pairs(params_np, t, proj, fused)
    if "layers" not in params_np:
        return _from_jax_split_layers(params_np, t, proj, fused)
    lay = params_np["layers"]
    if "ln1" in lay or "ln1_w" in lay:
        return _from_jax_ln_family(params_np, t, proj, fused)
    if "ff_norm" in lay:
        return _from_jax_apertus(params_np, t, proj, fused)
    num_layers = lay["input_norm"].shape[0]
    layers = []
    for i in range(num_layers):
        def at(name):
            return proj({k: v[i] for k, v in lay[name].items()})
        layer = {name: t(lay[name][i]) for name in _NORMS if name in lay}
        layer["o"] = at("o")
        for name in ("q_norm", "k_norm"):
            if name in lay:
                layer[name] = t(lay[name][i])
        if "router" in lay:
            layer["router"] = t(np.asarray(lay["router"][i]).T)
            layer["w_gate_up"] = t(np.concatenate(
                [lay["w_gate"][i], lay["w_up"][i]], axis=-1))
            layer["w_down"] = t(lay["w_down"][i])
            if "b_gate" in lay:                  # GPT-OSS
                layer["b_gate_up"] = t(np.concatenate(
                    [lay["b_gate"][i], lay["b_up"][i]], axis=-1),
                    torch.float32)
                for name in ("b_down", "router_bias", "sinks"):
                    layer[name] = t(lay[name][i], torch.float32)
        else:
            layer["down"] = at("down")
            layer.update(fused(at, "gate_up", ("gate", "up")))
        if "se_gate" in lay:
            layer["se_down"] = at("se_down")
            layer.update(fused(at, "se_gate_up", ("se_gate", "se_up")))
            if "se_gate_w" in lay:
                layer["se_gate_w"] = t(np.asarray(lay["se_gate_w"][i]).T)
        layer.update(fused(at, "qkv", ("q", "k", "v")))
        if kv_scales and "kv_scale" in lay:
            layer["kv_scale"] = t(np.asarray(lay["kv_scale"][i],
                                             np.float32), torch.float32)
        layers.append(layer)
    out = {"embed": t(params_np["embed"]["weight"]),
           "layers": layers,
           "final_norm": t(params_np["final_norm"]),
           "lm_head": proj(params_np["lm_head"])}
    if "cross" in params_np:                      # Mllama
        out["cross"] = _from_jax_cross(params_np["cross"], t, proj, fused)
    return out


def _from_jax_cross(cross, t, proj, fused) -> list:
    """Mllama's stacked cross-attention layers -> a list of the port's
    per-layer dicts (multimodal/mllama.py ``_cross_layer``)."""
    layers = []
    for i in range(np.asarray(cross["norm"]).shape[0]):
        def at(name):
            return proj({k: v[i] for k, v in cross[name].items()})
        layer = {n: t(cross[n][i]) for n in ("norm", "post_norm", "q_norm",
                                              "k_norm")}
        for n in ("gate_attn", "gate_mlp"):
            layer[n] = t(np.asarray(cross[n][i], np.float32), torch.float32)
        for n in ("q", "k", "v", "o", "down"):
            layer[n] = at(n)
        layer.update(fused(at, "gate_up", ("gate", "up")))
        layers.append(layer)
    return layers


# the JAX towers' stacked per-layer trees: the M-RoPE towers' blocks,
# SigLIP's layers, Mllama's local and global transformers
_STACKED = ("blocks", "layers", "local", "global")


def from_jax_vision(tree: Dict[str, Any], device="cpu",
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """A vision-language model's JAX tower tree (numpy) in the port's
    layout (multimodal/qwen2_vl.py, encoders.py, mllama.py): the stacked
    trees (``_STACKED``) as lists of per-layer dicts (nested dicts kept)
    without Qwen2.5-VL's ``is_full``; every other leaf, and the other
    dicts, as tensors of the same names. GLM-4.1V's position table stays a
    float32 host array (its bicubic sampler's input), and Qwen3-VL's gets
    that host copy beside it (``pos_host``)."""
    def t(a):
        return carry_array(a, device, dtype)

    def layer(v, i):
        return {k: layer(x, i) if isinstance(x, dict) else t(x[i])
                for k, x in v.items() if k != "is_full"}
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if k in _STACKED:
            first = next(iter(v.values()))
            while isinstance(first, dict):
                first = next(iter(first.values()))
            out[k] = [layer(v, i) for i in range(len(first))]
        elif isinstance(v, dict):
            out[k] = {kk: t(vv) for kk, vv in v.items()}
        elif k == "pos" and "post_conv_ln" in tree:      # GLM-4.1V
            out[k] = np.asarray(v, np.float32)
        else:
            out[k] = t(v)
    if isinstance(out.get("pos"), torch.Tensor) and "blocks" in tree:
        # Qwen3-VL
        out["pos_host"] = out["pos"].float().cpu().numpy()
    return out


def _from_jax_ln_family(params_np, t, proj, fused) -> Dict[str, Any]:
    """``from_jax_params`` for the LayerNorm GPT families and GPT-2."""
    lay = params_np["layers"]
    gpt2 = "ln1_w" in lay

    def norm(at):
        return {k: t(v) for k, v in at.items()}

    layers = []
    for i in range(np.asarray(lay["q"]["weight"]).shape[0]):
        def at(name):
            return proj({k: v[i] for k, v in lay[name].items()})
        if gpt2:
            layer = {n: {"w": t(lay[n + "_w"][i]), "b": t(lay[n + "_b"][i])}
                     for n in ("ln1", "ln2")}
        else:
            layer = {n: norm({k: v[i] for k, v in lay[n].items()})
                     for n in ("ln1", "ln2") if n in lay}
        layer.update(fused(at, "qkv", ("q", "k", "v")))
        layer["o"] = at("o")
        if "fc2" in lay:
            layer.update(fused(at, "fc_pair", ("fc", "fc2")))
        else:
            layer["fc"] = at("fc")
        layer["proj"] = at("proj")
        layers.append(layer)
    out = {"embed": t(params_np["embed"]["weight"]), "layers": layers,
           "lm_head": proj(params_np["lm_head"])}
    if gpt2:
        out["final_norm"] = {"w": t(params_np["lnf_w"]),
                             "b": t(params_np["lnf_b"])}
    else:
        out["final_norm"] = norm(params_np["final_norm"])
    if "wpe" in params_np:
        out["wpe"] = t(params_np["wpe"])
    if "embed_ln" in params_np:
        out["embed_ln"] = norm(params_np["embed_ln"])
    return out


_SPLIT_VECTORS = ("input_norm", "post_norm", "q_norm", "k_norm",
                  "kv_a_norm", "q_a_norm", "uk", "uv")


def _from_jax_pairs(params_np, t, proj, fused) -> Dict[str, Any]:
    """``from_jax_params`` for LongCat-Flash's ``pairs`` tree: each pair's
    sublayer s (keys ending in s) becomes flat layer 2i + s, its router,
    correction bias and experts one entry of ``pairs``."""
    lay = params_np["pairs"]
    layers, pairs = [], []
    for i in range(np.asarray(lay["router_bias"]).shape[0]):
        for s in "01":
            sub = {k[:-1]: v for k, v in lay.items() if k.endswith(s)}

            def at(name):
                return proj({k: v[i] for k, v in sub[name].items()})
            layer = {n: t(sub[n][i]) for n in _SPLIT_VECTORS if n in sub}
            for n in ("o", "kv_a", "kv_b", "q_a", "q_b", "q", "down"):
                if n in sub:
                    layer[n] = at(n)
            layer.update(fused(at, "gate_up", ("gate", "up")))
            layers.append(layer)
        pairs.append({
            "router": t(np.asarray(lay["router"][i]).T),
            "router_bias": t(lay["router_bias"][i], torch.float32),
            "w_gate_up": t(np.concatenate([lay["w_gate"][i],
                                           lay["w_up"][i]], axis=-1)),
            "w_down": t(lay["w_down"][i])})
    return {"embed": t(params_np["embed"]["weight"]), "layers": layers,
            "pairs": pairs, "final_norm": t(params_np["final_norm"]),
            "lm_head": proj(params_np["lm_head"])}


def _from_jax_split_layers(params_np, t, proj, fused) -> Dict[str, Any]:
    """``from_jax_params`` for the trees with ``dense_layers`` and
    ``moe_layers`` (DeepSeek-V2/V3, GLM-4.5, ERNIE 4.5 MoE)."""
    layers = []
    for group in ("dense_layers", "moe_layers"):
        lay = params_np.get(group)
        if lay is None:
            continue
        for i in range(np.asarray(lay["input_norm"]).shape[0]):
            def at(name):
                return proj({k: v[i] for k, v in lay[name].items()})
            layer = {n: t(lay[n][i]) for n in _SPLIT_VECTORS if n in lay}
            for n in ("o", "kv_a", "kv_b", "q_a", "q_b"):
                if n in lay:
                    layer[n] = at(n)
            if "k" in lay:
                layer.update(fused(at, "qkv", ("q", "k", "v")))
            elif "q" in lay:
                layer["q"] = at("q")
            if "router" in lay:
                layer["router"] = t(np.asarray(lay["router"][i]).T)
                layer["router_bias"] = t(lay["router_bias"][i],
                                         torch.float32)
                layer["w_gate_up"] = t(np.concatenate(
                    [lay["w_gate"][i], lay["w_up"][i]], axis=-1))
                layer["w_down"] = t(lay["w_down"][i])
                if "s_gate" in lay:
                    def shared(name):
                        return at("s_" + name[3:])
                    layer.update(fused(shared, "se_gate_up",
                                       ("se_gate", "se_up")))
                    layer["se_down"] = at("s_down")
            else:
                layer.update(fused(at, "gate_up", ("gate", "up")))
                layer["down"] = at("down")
            layers.append(layer)
    return {"embed": t(params_np["embed"]["weight"]), "layers": layers,
            "final_norm": t(params_np["final_norm"]),
            "lm_head": proj(params_np["lm_head"])}


def _from_jax_apertus(params_np, t, proj, fused) -> Dict[str, Any]:
    """``from_jax_params`` for Apertus."""
    lay = params_np["layers"]
    layers = []
    for i in range(np.asarray(lay["norm"]).shape[0]):
        def at(name):
            return proj({k: v[i] for k, v in lay[name].items()})
        layer = {"input_norm": t(lay["norm"][i]),
                 "post_norm": t(lay["ff_norm"][i]),
                 "q_norm": t(lay["q_norm"][i]),
                 "k_norm": t(lay["k_norm"][i]),
                 "o": at("o"), "up": at("up"), "down": at("down")}
        layer.update(fused(at, "qkv", ("q", "k", "v")))
        for n in ("alpha_p", "alpha_n", "act_beta", "act_eps"):
            layer[n] = t(np.asarray(lay[n][i], np.float32), torch.float32)
        layers.append(layer)
    return {"embed": t(params_np["embed"]["weight"]), "layers": layers,
            "final_norm": t(params_np["final_norm"]),
            "lm_head": proj(params_np["lm_head"])}


# the recurrent trees' [in, out] matrices applied with jnp.dot, carried
# as [out, in]; their float32 mixer parameters
_RAW_TRANSPOSED = ("w_qkv", "w_z", "w_b", "w_a", "gate", "se_gate_w",
                   "w_q", "w_k", "w_v", "w_gate_out")
_FLOAT32 = ("conv_w", "conv_b", "A_log", "D", "dt_bias", "slope")
# projections joined in the port's layers: (fused name, parts)
_JOINED = (("qkv", ("q", "k", "v")), ("gate_up", ("gate", "up")),
           ("w13", ("w1", "w3")), ("s_gate_up", ("s_gate", "s_up")),
           ("se_gate_up", ("se_gate", "se_up")))


def _unstack(tree, i):
    """Entry ``i`` along the leading axis of every array of ``tree``."""
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _recurrent_layers(params_np, model) -> list:
    """The JAX tree's per-layer dicts (numpy), in layer order."""
    if "mamba_dense" in params_np:                  # Jamba, by period
        per = model.hf.attn_layer_period
        out = []
        for i, bt in enumerate(model.block_types):
            g = i // per
            if i % per == 0:
                n = {"mamba_dense": 0, "mamba_moe": 0}
            if bt == model.ATTENTION:
                out.append(_unstack(params_np["attn"], g))
                continue
            group = "mamba_moe" if model.is_moe[i] else "mamba_dense"
            out.append(_unstack(_unstack(params_np[group], g), n[group]))
            n[group] += 1
        return out
    if "runs" in params_np:
        out = []
        for run in params_np["runs"]:
            n = len(np.asarray(next(iter(_leaves(run)))))
            out.extend(_unstack(run, j) for j in range(n))
        return out
    lay = params_np["layers"]
    if isinstance(lay, (tuple, list)):              # Zamba2: per layer
        return list(lay)
    n = len(np.asarray(next(iter(_leaves(lay)))))
    return [_unstack(lay, i) for i in range(n)]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _recurrent_layer(lay, t, proj, fused) -> Dict[str, Any]:
    """One JAX recurrent-family layer (numpy) in the port's form."""
    out: Dict[str, Any] = {}
    joined = {n for _, parts in _JOINED if all(p in lay for p in parts)
              for n in parts}
    for k, v in lay.items():
        if k in joined:
            continue
        if isinstance(v, dict):
            out[k] = proj(v)
        elif k in ("moe_router", "router"):
            out["router"] = t(np.asarray(v).T)
        elif k in ("moe_gate", "w_gate"):
            up = lay["moe_up" if k == "moe_gate" else "w_up"]
            out["w_gate_up"] = t(np.concatenate([v, up], axis=-1))
        elif k in ("moe_up", "w_up"):
            continue
        elif k in ("moe_down", "w_down"):
            out["w_down"] = t(v)
        elif k in _RAW_TRANSPOSED:
            out[k] = t(np.ascontiguousarray(np.asarray(v).T))
        elif k in _FLOAT32:
            out[k] = t(np.asarray(v, np.float32), torch.float32)
        else:
            out[k] = t(v)
    for name, parts in _JOINED:
        if all(p in lay for p in parts):
            out.update(fused(lambda n: proj(lay[n]), name, parts))
    return out


def _from_jax_recurrent(params_np, model, t, proj, fused) -> Dict[str, Any]:
    """``from_jax_params`` for the recurrent families."""
    out = {"layers": [_recurrent_layer(lay, t, proj, fused)
                      for lay in _recurrent_layers(params_np, model)],
           "embed": t(params_np["embed"]["weight"]),
           "final_norm": t(params_np["final_norm"]),
           "lm_head": proj(params_np["lm_head"])}
    if "blocks" in params_np:                       # Zamba2's shared blocks
        out["blocks"] = [None if b is None else
                         _recurrent_layer(b, t, proj, fused)
                         for b in params_np["blocks"]]
    return out
