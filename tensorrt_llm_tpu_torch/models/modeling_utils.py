"""Model-layer foundation: config, registry, shared attention block.

Port of ``tensorrt_llm_tpu/models/modeling_utils.py`` (``ModelConfig``,
``AttentionSpec``, ``attention_block``, ``DecoderModelForCausalLM``)
without ring/Ulysses context parallelism, LoRA, sparse or star attention
and tensor parallelism.

Models are functions over a dict of parameter tensors; a model object
holds only static config. The KV pool is owned by the engine and passed
in: ``forward(params, token_ids[T], kv_pages[L, P, ps, 2kvh, hd],
metadata) -> (logits[S, V], kv_pages)``, where the pool is updated in
place. Q, K and V come from one fused projection (and the MLP's gate and
up from another) whenever they share a linear method: one matmul launch
each instead of three and two. Projections whose methods differ (an
``exclude_modules`` entry that names only some of them) stay apart.

A quantized KV cache (``QuantConfig(kv_cache_quant_algo=INT8 | FP8 |
NVFP4)``) sets ``ModelConfig.kv_cache_dtype`` to int8 or float8 e4m3 and a
default per-tensor scale; ``attention_block`` quantizes the fresh K/V by
the layer's scale into the pool and attention dequantizes them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from ..ops import rope as rope_ops
from ..ops.attention import (KV_DTYPES, AttentionMetadata,
                             ragged_paged_attention, write_kv)
from ..ops.linear import LinearMethod, can_fuse, make_linear_method
from ..ops.quant import pack_int4
from ..quantization.checkpoint import PrequantizedWeight
from ..quantization.mode import KvCacheQuantAlgo

MODEL_REGISTRY: Dict[str, type] = {}


def register_model(*model_types: str):
    """Register a model class under HF ``model_type`` names."""
    def deco(cls):
        for t in model_types:
            MODEL_REGISTRY[t] = cls
        return cls
    return deco


# model types the JAX package registers that this package does not serve
# yet, each with its reason (the splice-only VLMs, llava, llava_next,
# mistral3 and internvl, are served: tensorrt_llm_tpu_torch/multimodal)
_MROPE = ("a multimodal model whose text positions are M-RoPE's "
          "(temporal, height, width) sections, which the engine does not "
          "carry")
_IMAGE_GROUPS = ("a multimodal model whose image tokens attend "
                 "bidirectionally within their group, which the paged "
                 "kernels' causal mask does not express")
NOT_PORTED_MODEL_TYPES: Dict[str, str] = {
    **{t: _MROPE for t in ("glm4v", "qwen2_vl", "qwen2_5_vl", "qwen3_vl",
                           "qwen3_vl_moe")},
    **{t: _IMAGE_GROUPS for t in ("gemma3", "gemma3_vl", "paligemma")},
    "mllama": ("a multimodal model whose text layers cross-attend to the "
               "image states, which the engine does not keep"),
}


def get_model_class(model_type: str) -> type:
    if model_type in NOT_PORTED_MODEL_TYPES:
        raise NotImplementedError(
            f"model_type '{model_type}' is not supported by this package "
            f"yet ({NOT_PORTED_MODEL_TYPES[model_type]})")
    if model_type not in MODEL_REGISTRY:
        raise ValueError(
            f"unsupported model_type '{model_type}'; "
            f"registered: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[model_type]


@dataclasses.dataclass
class ModelConfig:
    """Engine-side model description."""
    hf_config: Any                        # transformers PretrainedConfig
    dtype: torch.dtype = torch.bfloat16
    device: torch.device = torch.device("cuda")
    kv_cache_dtype: Optional[torch.dtype] = None   # None -> dtype
    # llmapi.llm_args.QuantConfig (or anything with quant_algo,
    # group_size and exclude_modules, and optionally kv_cache_quant_algo);
    # None -> unquantized
    quant_config: Any = None
    kv_scale: float = 1.0                 # per-tensor KV quant scale
    # NVFP4 KV cache: appended K/V round to the e2m1 grid and are stored
    # in the e4m3 pool (every grid value times the scale is exact there)
    kv_fp4_grid: bool = False

    def __post_init__(self):
        """The KV pool's type and default scale from
        ``quant_config.kv_cache_quant_algo``, as the JAX ``ModelConfig``
        (models/modeling_utils.py:80-95): INT8 -> int8, scale 0.05; FP8
        -> e4m3, 1.0; NVFP4 -> e4m3 on the e2m1 grid, 1/6 (the grid tops
        out at 6)."""
        self.device = torch.device(self.device)
        if self.kv_cache_dtype is None:
            algo = getattr(self.quant_config, "kv_cache_quant_algo",
                           KvCacheQuantAlgo.NO_QUANT)
            if algo == KvCacheQuantAlgo.INT8:
                self.kv_cache_dtype = torch.int8
                self.kv_scale = 0.05
            elif algo == KvCacheQuantAlgo.FP8:
                self.kv_cache_dtype = torch.float8_e4m3fn
            elif algo == KvCacheQuantAlgo.NVFP4:
                self.kv_cache_dtype = torch.float8_e4m3fn
                self.kv_fp4_grid = True
                self.kv_scale = 1.0 / 6.0
            else:
                self.kv_cache_dtype = self.dtype

    @property
    def uses_kv_quant(self) -> bool:
        return self.kv_cache_dtype in KV_DTYPES


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    """Static attention geometry for one layer."""
    num_heads: int
    num_kv_heads: int
    head_dim: int
    sm_scale: float
    rope: Optional[rope_ops.RopeConfig] = None
    sliding_window: Optional[int] = None
    soft_cap: Optional[float] = None
    is_neox: bool = True
    # ALiBi: per-q-head slopes (static tuple)
    alibi_slopes: Optional[tuple] = None
    # attention sinks: layer params carry a per-q-head "sinks" tensor
    use_sinks: bool = False
    # NVFP4 KV cache: round appended K/V to the e2m1 grid (stamped by the
    # engine from ModelConfig.kv_fp4_grid)
    kv_fp4: bool = False
    # the q/k norms after the rotary embedding instead of before it
    # (HunYuan, as transformers applies them)
    qk_norm_after_rope: bool = False


def alibi_slopes(num_heads: int) -> tuple:
    """The ALiBi slope of each head (Press et al.; HF ``build_alibi``):
    powers of 2^(-8/n) for the nearest power-of-two head count n, with
    the interleaved extras for other counts (the JAX package's
    ``alibi_slopes``, models/modeling_utils.py:124)."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    n2 = 2 ** int(math.floor(math.log2(num_heads)))
    slopes = pow2_slopes(n2)
    if n2 != num_heads:
        slopes += pow2_slopes(2 * n2)[0::2][: num_heads - n2]
    return tuple(slopes)


def embed_tokens(embed: torch.Tensor, token_ids: torch.Tensor,
                 input_embeds: Optional[torch.Tensor],
                 dtype: torch.dtype) -> torch.Tensor:
    """The token embedding lookup, in ``dtype``, with the per-token
    override of the prompt-embedding path (multimodal features, prompt
    tables, ``prompt_embeds``): each row of ``input_embeds`` [T, H] whose
    first value is not NaN replaces its token's row, cast to ``dtype``
    (the JAX ``DecoderModelForCausalLM._embed``, models/modeling_utils.py:
    382-394). Every family's forward looks its tokens up through this."""
    h = embed[token_ids].to(dtype)
    if input_embeds is None:
        return h
    override = ~torch.isnan(input_embeds[:, :1])
    return torch.where(override, torch.nan_to_num(input_embeds).to(dtype), h)


class AttentionMethods(NamedTuple):
    """Linear methods of one attention block: q, k and v (shared), o."""
    q: LinearMethod
    kv: LinearMethod
    o: LinearMethod


def attention_block(params: Dict[str, Any],
                    x: torch.Tensor,                 # [T, hidden]
                    kv_pages: torch.Tensor,          # [pages, ps, 2kvh, hd]
                    metadata: AttentionMetadata,
                    spec: AttentionSpec,
                    methods: AttentionMethods,
                    rope_cos_sin: Optional[Tuple[torch.Tensor,
                                                 torch.Tensor]] = None,
                    q_norm: Optional[Callable] = None,
                    k_norm: Optional[Callable] = None,
                    kv_scale=None,
                    collect_kv_stats: bool = False,
                    alibi_slopes: Optional[torch.Tensor] = None,
                    lora_fn: Optional[Callable] = None,
                    pre_o: Optional[Callable] = None):
    """QKV projection (``params["qkv"]`` fused, or "q", "k", "v" apart),
    the q/k norms (``q_norm(params, q [T, nq, hd])``, likewise k: Qwen3's
    per-head RMS norm, OLMoE's over the whole projection; after RoPE with
    ``spec.qk_norm_after_rope``), RoPE, KV append
    (in place) and paged attention, then the output projection.

    An 8-bit pool (int8, e4m3) is written and read with ``kv_scale`` (the
    layer's 0-dim float32 device tensor, or a float), rounded to the e2m1
    grid with ``spec.kv_fp4``. ``collect_kv_stats`` returns (out, the
    absmax of the fresh K and V before quantizing, a float32 scalar): the
    calibration pass's statistic. ``alibi_slopes``: the spec's slopes as
    a float32 device tensor, made once at build, and the only form the
    kernels are given (a tuple would be copied to the device at every
    call, which a graph capture refuses); required when the spec has
    slopes. ``lora_fn(name, x, out)`` adds an adapter's term to the q, k
    and v projections' outputs (Zamba2's per-use adapters), ``pre_o(params,
    x, attn [T, nq * hd])`` rewrites the attention output before the
    output projection (Qwen3-Next's output gate): the JAX hooks of the
    same names."""
    if (spec.alibi_slopes is None) != (alibi_slopes is None):
        raise ValueError(
            "attention_block takes ALiBi slopes as a device tensor exactly "
            "when the spec has slopes")
    T = x.shape[0]
    nq, nkv, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    if "qkv" in params:
        qkv = methods.q.apply(params["qkv"], x)
        q, k, v = qkv.split([nq * hd, nkv * hd, nkv * hd], dim=-1)
    else:
        q = methods.q.apply(params["q"], x)
        k = methods.kv.apply(params["k"], x)
        v = methods.kv.apply(params["v"], x)
    if lora_fn is not None:
        q, k, v = (lora_fn(n, x, u) for n, u in zip("qkv", (q, k, v)))
    q = q.reshape(T, nq, hd)
    k = k.reshape(T, nkv, hd)
    v = v.reshape(T, nkv, hd)
    late = spec.qk_norm_after_rope
    if q_norm is not None and not late:
        q = q_norm(params, q)
    if k_norm is not None and not late:
        k = k_norm(params, k)
    if spec.rope is not None:
        cos, sin = rope_cos_sin if rope_cos_sin is not None else \
            rope_ops.rope_cos_sin(spec.rope, metadata.positions)
        q = rope_ops.apply_rope(q, cos, sin, spec.is_neox)
        k = rope_ops.apply_rope(k, cos, sin, spec.is_neox)
    if q_norm is not None and late:
        q = q_norm(params, q)
    if k_norm is not None and late:
        k = k_norm(params, k)
    quant = kv_pages.dtype in KV_DTYPES
    ks = kv_scale if quant else None
    write_kv(kv_pages, k, v, metadata.slot_mapping, k_scale=ks, v_scale=ks,
             fp4_grid=spec.kv_fp4 and quant)
    # the dequant-matmul kernel returns bf16 whatever the model's type:
    # attention runs in the pool's type and hands q's type back; under an
    # 8-bit pool it runs in the model's type (that of the normed input x)
    dt = x.dtype if quant else kv_pages.dtype
    attn = ragged_paged_attention(
        q.to(dt).contiguous(), kv_pages, metadata,
        sm_scale=spec.sm_scale,
        sliding_window=spec.sliding_window, soft_cap=spec.soft_cap,
        alibi_slopes=alibi_slopes,
        sinks=params["sinks"] if spec.use_sinks else None,
        k_scale=ks, v_scale=ks).to(q.dtype)
    attn = attn.reshape(T, nq * hd)
    if pre_o is not None:
        attn = pre_o(params, x, attn)
    out = methods.o.apply(params["o"], attn)
    if collect_kv_stats:
        return out, torch.maximum(k.float().abs().amax(),
                                  v.float().abs().amax())
    return out


# --------------------------------------------------------------------- #
# Load-time conversion of projections
# --------------------------------------------------------------------- #
def hf_transpose(w):
    """HF checkpoints store [out, in]; the linear methods quantize
    [in, out]. A ``PrequantizedWeight`` (AWQ/GPTQ ingestion) already is
    [in, out] and passes through."""
    if isinstance(w, PrequantizedWeight):
        return w
    return torch.as_tensor(w).t()


def quantize_linear(method: LinearMethod, w, bias=None,
                    dtype: torch.dtype = torch.bfloat16,
                    device="cpu", smooth=None) -> Dict[str, torch.Tensor]:
    """One [K, N] weight through its method, onto ``device``. The float
    weight is moved first and quantized there, so only one tensor's float
    copy is alive at a time. A ``PrequantizedWeight`` keeps the
    checkpoint's own integers, scales and zero points; a symmetric int4
    one is packed for the dequant-matmul kernel. ``smooth`` (SmoothQuant,
    [K]): the weight's input rows are multiplied by it in float32 before
    quantizing, and the projection keeps it as ``params["smooth"]``
    (float32), by which ``apply`` divides x: the JAX ``quantize_linear``'s
    fold."""
    if isinstance(w, PrequantizedWeight):
        if type(method) is LinearMethod:
            raise ValueError("a prequantized projection is excluded from "
                             "quantization (exclude_modules)")
        q = torch.from_numpy(np.ascontiguousarray(w.weight)).to(device)
        params = {"weight": q, "weight_scale": torch.from_numpy(
            np.ascontiguousarray(w.weight_scale)).to(device)}
        if w.weight_zero is not None:
            params["weight_zero"] = torch.from_numpy(
                np.ascontiguousarray(w.weight_zero)).to(device)
        elif w.bits == 4:
            params["weight"] = pack_int4(q)
    else:
        # w is a transposed view of an [out, in] tensor: the quantizers'
        # elementwise results inherit its strides
        w = torch.as_tensor(w).to(device)
        if smooth is not None:
            smooth = torch.as_tensor(smooth).to(device=device,
                                                dtype=torch.float32)
            w = w.float() * smooth[:, None]
        params = {k: v.contiguous() for k, v in method.quantize_weights(
            w, dtype=dtype).items()}
        if smooth is not None:
            params["smooth"] = smooth
    if bias is not None:
        params["bias"] = torch.as_tensor(bias).to(device=device, dtype=dtype)
    return params


def fuse_projections(fused: str, names: Sequence[str],
                     methods: Sequence[LinearMethod],
                     parts: List[Dict[str, torch.Tensor]]
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{fused: one projection}`` when every part shares one method and
    the parts can be joined (``ops.linear.can_fuse``: scales are per
    output column, or a per-tensor scale is expanded over its part's
    columns, so joining separately quantized parts along the output axis
    is exact — for packed int4 too, since packing runs along K; a
    SmoothQuant projection keeps its own smoothing vector, and FP8 block
    scales need whole blocks); otherwise the parts under their own
    names."""
    if all(m.same_as(methods[0]) for m in methods[1:]) and can_fuse(parts):
        return {fused: methods[0].fuse(parts)}
    return dict(zip(names, parts))


def apply_pair(method: LinearMethod, params: Dict[str, Any], fused: str,
               names: Sequence[str], x: torch.Tensor, width: int):
    """The two outputs of a pair of projections (gate and up) that
    ``fuse_projections`` joined under ``fused`` (each ``width`` wide) or
    kept apart under ``names``."""
    if fused in params:
        return method.apply(params[fused], x).split(width, -1)
    return tuple(method.apply(params[n], x) for n in names)


class DecoderModelForCausalLM:
    """Base for decoder-only CausalLM models (subclasses implement
    ``init_params``, ``load_hf_state_dict`` and ``forward``)."""
    architectures: tuple = ()

    def __init__(self, model_config: ModelConfig):
        self.config = model_config
        self.hf = model_config.hf_config
        self.dtype = model_config.dtype
        self.device = model_config.device
        # the config's KV scale as a device scalar: the scale of every
        # layer without one of its own (the kernels read it by pointer)
        self.kv_scale = torch.full((), model_config.kv_scale,
                                   dtype=torch.float32, device=self.device)

    @property
    def num_layers(self) -> int:
        return self.hf.num_hidden_layers

    @property
    def num_kv_heads(self) -> int:
        return getattr(self.hf, "num_key_value_heads", None) or \
            self.hf.num_attention_heads

    @property
    def head_dim(self) -> int:
        return getattr(self.hf, "head_dim", None) or \
            self.hf.hidden_size // self.hf.num_attention_heads

    @property
    def vocab_size(self) -> int:
        return self.hf.vocab_size

    def _method(self, name: str) -> LinearMethod:
        """The linear method of the projection called ``name``."""
        return make_linear_method(self.config.quant_config, name)

    def kv_pool_shape(self, num_pages: int, page_size: int) -> tuple:
        return (self.num_layers, num_pages, page_size,
                2 * self.num_kv_heads, self.head_dim)

    def graph_bound_key(self, bound: int, splits) -> Any:
        """What a decode graph's key holds for the step's KV ``bound``:
        the decode kernel's split counts, ``splits(bound)``, which are all
        that the bound changes in a step of K1 layers. A model that sizes
        its own KV gather by the bound (MLA, models/deepseek.py) keys by
        the bound itself."""
        return splits(bound)

    def make_kv_pages(self, num_pages: int, page_size: int) -> torch.Tensor:
        return torch.zeros(self.kv_pool_shape(num_pages, page_size),
                           dtype=self.config.kv_cache_dtype,
                           device=self.device)

    def attn_scratch_bytes(self, seqs: int, tokens: int,
                           positions: int) -> int:
        """Peak device bytes of one layer's attention scratch that grow
        with the KV positions, in a step of ``seqs`` sequences and
        ``tokens`` query tokens over ``positions`` (the graph pool's
        estimate, beside ``act_width_per_token``): none for the paged
        kernels; MLA's dense gather holds some (models/deepseek.py)."""
        return 0

    def init_params(self, seed: int = 0) -> Dict[str, Any]:
        raise NotImplementedError

    def load_hf_state_dict(self, state_dict) -> Dict[str, Any]:
        raise NotImplementedError

    def forward(self, params, token_ids, kv_pages, metadata,
                input_embeds=None):
        raise NotImplementedError
