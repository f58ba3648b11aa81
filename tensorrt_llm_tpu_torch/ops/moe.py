"""Mixture-of-experts MLP on one device.

Port of the single-device half of ``tensorrt_llm_tpu/ops/moe.py``:
``topk_routing``, ``moe_mlp_ragged`` (the (token, expert) pairs sorted by
expert, grouped products, a weighted combine), ``moe_mlp_dense`` and the
single-device branch of ``moe_mlp``, with router logits in float32. The
multi-device paths (``moe_mlp_ep``, ``moe_mlp_adp``, ``moe_mlp_wide_ep``)
are not ported.

Expert layout, fixed at load time: ``w_gate_up`` [E, H, 2I] (gate
columns, then up) and ``w_down`` [E, I, H], so an expert's product is
``x @ w[e]`` as in the JAX package's [E, H, I] stacks; gate and up are
joined so that one grouped product computes both.

Routes, chosen by ``moe_route(dtype, device)`` and never by catching an
error (no route gives way to another):

- ``grouped`` (bf16 on CUDA): ``torch._grouped_mm`` over the sorted
  pairs with int32 cumulative group offsets computed on the device. The
  JAX package computes this product with ``jax.lax.ragged_dot``, which XLA
  lowers outside any Pallas kernel, so this is a library call, not a
  ported kernel. Model build probes it at the model's widths
  (``check_grouped``) and raises if it is missing or refuses them.
- ``dense`` (float32 on CUDA): the JAX package's ``moe_mlp_dense``, a
  product over every expert weighted by a one-hot combine matrix.
  ``torch._grouped_mm`` in float32 is a fallback that copies the group
  offsets to the host and runs one product per group, so no CUDA graph
  could capture it (``chip_smoke.py`` moe_block shows the sync).
- ``plain`` (the CPU): the sort and one product per expert over its
  rows, with group sizes read on the host. The tests' reference.

GPT-OSS's experts (``moe_mlp_swiglu``, the JAX ``GptOssForCausalLM._moe``,
models/gpt_oss.py:152-182) take the same three routes with two options:
the router's logits get a bias and the top k of them are softmaxed
(``topk_softmax_routing``); each expert's gate|up and down products get
their float32 biases, and the activation is the clamped SwiGLU
``clamp(gate, max=lim) * sigmoid(1.702 * gate) * (clamp(up, +-lim) + 1)``
in float32 (``swiglu_limit``). The combine then sums float32 outputs.

The DeepSeek-style families choose and weigh their experts themselves
and hand the routes the weights and indices (``moe_mlp_routed``, the JAX
``moe_mlp_ragged`` called with the caller's routing): sigmoid scores
chosen with a correction bias (``sigmoid_bias_routing``: DeepSeek-V3,
GLM-4.5; the JAX models/deepseek.py:345-356, glm4_moe.py:143-153),
DeepSeek-V2's softmax scores (``softmax_group_routing``,
deepseek.py:336-343) and ERNIE 4.5's softmax scores chosen with a bias
and renormalised over a clamped sum (``softmax_bias_routing``,
glm4_moe.py:260-276); ``group_limit`` keeps the top ``topk_group``
expert groups and masks the others with 0.0, as transformers does.

Every shape on the CUDA routes is a function of the token count T and k
(a graph bucket fixes both), and nothing reads a device value on the
host: expert counts come from a fixed-size ``scatter_add_`` of length E.
The combine inverts the sort into [T, k, H] and sums over k in a fixed
order, so a graph replay equals the eager run bit for bit (a scatter-add
combine would add with atomics). Padding rows of a bucket are routed
like any token; a row's output depends on its own pairs only.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .linear import dot_f32

ROUTES = ("grouped", "dense", "plain")


def topk_routing(router_logits: torch.Tensor, top_k: int,
                 renormalize: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(probs float32 [T, k], expert_idx int32 [T, k]): a float32 softmax,
    its top k, then (``renormalize``) the k weights scaled to sum to 1."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    top_p, top_i = torch.topk(probs, top_k, dim=-1)
    if renormalize:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return top_p, top_i.to(torch.int32)


def topk_softmax_routing(router_logits: torch.Tensor, top_k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(probs float32 [T, k], expert_idx int32 [T, k]) as GPT-OSS routes:
    the top k of the float32 logits, then a softmax over those k."""
    top_v, top_i = torch.topk(router_logits.float(), top_k, dim=-1)
    return torch.softmax(top_v, dim=-1), top_i.to(torch.int32)


SWIGLU_ALPHA = 1.702      # GPT-OSS's sigmoid slope


def clamped_swiglu(gate: torch.Tensor, up: torch.Tensor,
                   limit: float) -> torch.Tensor:
    """GPT-OSS's activation on float32 gate and up."""
    g = gate.clamp(max=limit)
    return (up.clamp(-limit, limit) + 1.0) * (g * torch.sigmoid(
        SWIGLU_ALPHA * g))


def _activate(gu: torch.Tensor, inter: int, dtype: torch.dtype,
              bias=None, limit: Optional[float] = None) -> torch.Tensor:
    """The experts' activation of a gate|up product [.., 2I], in the
    model's type: SiLU(gate) in float32 times up, or with ``limit`` (GPT-
    OSS) the float32 ``bias`` rows added and the clamped SwiGLU."""
    if limit is None:
        gate, up = gu.split(inter, dim=-1)
        return F.silu(gate.float()).to(dtype) * up
    gu = gu.float() + bias
    return clamped_swiglu(gu[..., :inter], gu[..., inter:], limit).to(dtype)


def moe_route(dtype: torch.dtype, device: torch.device) -> str:
    """The MoE block's route for experts of ``dtype`` on ``device``."""
    device = torch.device(device)
    if device.type == "cpu":
        return "plain"
    if device.type == "cuda" and dtype == torch.bfloat16:
        return "grouped"
    if device.type == "cuda" and dtype == torch.float32:
        return "dense"
    raise NotImplementedError(
        f"MoE experts in {dtype} on {device.type} are not supported by "
        "this package (bf16 or float32 on CUDA, any type on the CPU)")


def check_grouped(hidden: int, inter: int, device: torch.device,
                  dropped: bool = False) -> None:
    """Model build on the ``grouped`` route: ``torch._grouped_mm`` must
    exist and take bf16 products of the model's widths (H -> 2I, I -> H)
    with an empty group among them, and (``dropped``: zero-expert picks,
    ``moe_mlp_zero_experts``) with rows past the last group. Raises
    otherwise."""
    if not hasattr(torch, "_grouped_mm"):
        raise RuntimeError(
            f"torch {torch.__version__} has no torch._grouped_mm: the "
            "bf16 MoE route on CUDA needs it (torch >= 2.8)")
    x = torch.zeros((4, hidden), dtype=torch.bfloat16, device=device)
    wgu = torch.zeros((3, hidden, 2 * inter), dtype=torch.bfloat16,
                      device=device)
    wd = torch.zeros((3, inter, hidden), dtype=torch.bfloat16,
                     device=device)
    try:
        for ends in ([1, 1, 4], [1, 1, 3]) if dropped else ([1, 1, 4],):
            offs = torch.tensor(ends, dtype=torch.int32, device=device)
            h = torch._grouped_mm(x, wgu, offs=offs)[:, :inter].contiguous()
            torch._grouped_mm(h, wd, offs=offs)
    except RuntimeError as e:
        raise RuntimeError(
            f"torch._grouped_mm refuses the MoE widths (hidden {hidden}, "
            f"moe intermediate {inter}) on {device}: {e}") from e


def _sort_pairs(expert_idx: torch.Tensor, num_experts: int):
    """(order, token of each sorted pair, tokens per expert int32 [E]):
    the T*k (token, expert) pairs, pair p = t*k + j, stably sorted by
    expert. A pair of index E (dropped, ``moe_mlp_zero_experts``) sorts
    after every expert's and belongs to no group."""
    k = expert_idx.shape[1]
    flat = expert_idx.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(num_experts + 1, dtype=torch.int32,
                         device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))
    return order, order // k, counts[:num_experts]


def _zero_dropped(y: torch.Tensor, offs_end: torch.Tensor) -> torch.Tensor:
    """Sorted pair outputs with the rows past the last group (dropped
    pairs, which no product wrote) set to 0."""
    live = torch.arange(y.shape[0], device=y.device) < offs_end
    return torch.where(live[:, None], y, torch.zeros((), dtype=y.dtype,
                                                     device=y.device))


def _combine(y: torch.Tensor, order: torch.Tensor,
             probs: torch.Tensor) -> torch.Tensor:
    """Sorted pair outputs y [T*k, H] -> [T, H]: back to pair order, each
    scaled by its routing weight in y's type, summed over k."""
    T, k = probs.shape
    pairs = torch.empty_like(y).index_copy_(0, order, y)
    return (pairs.view(T, k, -1) * probs.to(y.dtype)[:, :, None]).sum(1)


def moe_mlp_grouped(x: torch.Tensor, w_gate_up: torch.Tensor,
                    w_down: torch.Tensor, probs: torch.Tensor,
                    expert_idx: torch.Tensor, b_gate_up=None, b_down=None,
                    swiglu_limit: Optional[float] = None,
                    drop: bool = False) -> torch.Tensor:
    """The ``grouped`` route: two ``torch._grouped_mm`` over the sorted
    pairs (bf16); with ``swiglu_limit`` GPT-OSS's biases (float32 [E, 2I]
    and [E, H]) and clamped SwiGLU; with ``drop``, pairs of index E are in
    no group and contribute 0."""
    E, inter = w_gate_up.shape[0], w_down.shape[1]
    order, tok_of, counts = _sort_pairs(expert_idx, E)
    offs = torch.cumsum(counts, 0, dtype=torch.int32)
    gu = torch._grouped_mm(x[tok_of], w_gate_up, offs=offs)
    if swiglu_limit is None:
        y = torch._grouped_mm(_activate(gu, inter, x.dtype), w_down,
                              offs=offs)
    else:
        se = expert_idx.reshape(-1).long()[order]   # each sorted pair's expert
        h = _activate(gu, inter, x.dtype, b_gate_up[se], swiglu_limit)
        y = torch._grouped_mm(h, w_down, offs=offs).float() + b_down[se]
    if drop:
        y = _zero_dropped(y, offs[-1])
    return _combine(y, order, probs).to(x.dtype)


def moe_mlp_plain(x: torch.Tensor, w_gate_up: torch.Tensor,
                  w_down: torch.Tensor, probs: torch.Tensor,
                  expert_idx: torch.Tensor, b_gate_up=None, b_down=None,
                  swiglu_limit: Optional[float] = None,
                  drop: bool = False) -> torch.Tensor:
    """The ``plain`` route (CPU): ``moe_mlp_ragged`` with one product per
    expert over its rows of the sorted pairs (GPT-OSS's options and
    ``drop`` as in ``moe_mlp_grouped``)."""
    E, inter = w_gate_up.shape[0], w_down.shape[1]
    order, tok_of, counts = _sort_pairs(expert_idx, E)
    xs = x[tok_of]
    y = (torch.zeros if drop else torch.empty)((xs.shape[0], w_down.shape[2]),
                    dtype=x.dtype if b_down is None else torch.float32,
                    device=x.device)
    start = 0
    for e, n in enumerate(counts.tolist()):
        if n:
            h = _activate(xs[start:start + n] @ w_gate_up[e], inter, x.dtype,
                          None if b_gate_up is None else b_gate_up[e],
                          swiglu_limit)
            out = h @ w_down[e]
            y[start:start + n] = out if b_down is None else \
                out.float() + b_down[e]
        start += n
    return _combine(y, order, probs).to(x.dtype)


def moe_mlp_dense(x: torch.Tensor, w_gate_up: torch.Tensor,
                  w_down: torch.Tensor, probs: torch.Tensor,
                  expert_idx: torch.Tensor, b_gate_up=None, b_down=None,
                  swiglu_limit: Optional[float] = None,
                  drop: bool = False) -> torch.Tensor:
    """The ``dense`` route: every expert on every token, products
    accumulated in float32, weighted by a [T, E] combine matrix (GPT-OSS's
    options and ``drop`` as in ``moe_mlp_grouped``)."""
    T, E, inter = x.shape[0], w_gate_up.shape[0], w_down.shape[1]
    combine = torch.zeros((T, E + 1), dtype=torch.float32,
                          device=x.device).scatter_add_(
        1, expert_idx.long(), probs.float())[:, :E]
    gu = torch.einsum("th,ehi->tei", x.float(), w_gate_up.float())
    if swiglu_limit is None:
        gate, up = gu.split(inter, dim=-1)
        h = (F.silu(gate) * up).to(x.dtype)
    else:
        h = _activate(gu, inter, x.dtype, b_gate_up[None], swiglu_limit)
    y = torch.einsum("tei,eih->teh", h.float(), w_down.float())
    if b_down is not None:
        y = y + b_down[None]
    return torch.einsum("teh,te->th", y, combine).to(x.dtype)


_ROUTE_FNS = {"grouped": moe_mlp_grouped, "dense": moe_mlp_dense,
              "plain": moe_mlp_plain}


def moe_mlp(x: torch.Tensor, w_gate_up: torch.Tensor, w_down: torch.Tensor,
            router: torch.Tensor, top_k: int, renormalize: bool = True
            ) -> torch.Tensor:
    """The MoE block: float32 router logits (``router`` [E, H]), top-k
    routing, the experts on the route of their type and device, the
    weighted combine. ``renormalize=False`` keeps the raw softmax weights
    of the chosen experts (Qwen2-MoE's ``norm_topk_prob=False``)."""
    probs, idx = topk_routing(dot_f32(x, router), top_k, renormalize)
    route = moe_route(w_gate_up.dtype, x.device)
    return _ROUTE_FNS[route](x.to(w_gate_up.dtype), w_gate_up, w_down,
                             probs, idx)


def moe_mlp_swiglu(x: torch.Tensor, router: torch.Tensor,
                   router_bias: torch.Tensor, w_gate_up: torch.Tensor,
                   b_gate_up: torch.Tensor, w_down: torch.Tensor,
                   b_down: torch.Tensor, top_k: int,
                   swiglu_limit: float) -> torch.Tensor:
    """GPT-OSS's MoE block (the JAX ``GptOssForCausalLM._moe``): float32
    router logits plus their bias, ``topk_softmax_routing``, the experts
    on the route of their type and device with their float32 biases and
    the clamped SwiGLU, the float32 combine."""
    probs, idx = topk_softmax_routing(
        dot_f32(x, router) + router_bias, top_k)
    route = moe_route(w_gate_up.dtype, x.device)
    return _ROUTE_FNS[route](x.to(w_gate_up.dtype), w_gate_up, w_down,
                             probs, idx, b_gate_up, b_down, swiglu_limit)


def moe_mlp_routed(x: torch.Tensor, w_gate_up: torch.Tensor,
                   w_down: torch.Tensor, probs: torch.Tensor,
                   expert_idx: torch.Tensor) -> torch.Tensor:
    """The experts on given routing (``probs`` float32 [T, k],
    ``expert_idx`` [T, k]), on the route of their type and device: the
    JAX ``moe_mlp_ragged`` as the DeepSeek-style families call it."""
    route = moe_route(w_gate_up.dtype, x.device)
    return _ROUTE_FNS[route](x.to(w_gate_up.dtype), w_gate_up, w_down,
                             probs, expert_idx.to(torch.int32))


def moe_mlp_zero_experts(x: torch.Tensor, w_gate_up: torch.Tensor,
                         w_down: torch.Tensor, probs: torch.Tensor,
                         expert_idx: torch.Tensor) -> torch.Tensor:
    """LongCat-Flash's experts (the JAX ``_sc_moe``'s products): an index
    >= E picks a zero-computation expert, which adds its weight times x.
    The JAX model sends such picks to expert 0 with weight 0 (a third of
    all picks at LongCat-Flash's 256 zero experts of 768); here they are
    left out of the sort's groups and the products (``drop``) and their
    w * x is added directly, the same function."""
    E = w_gate_up.shape[0]
    zero = expert_idx >= E
    idx = torch.where(zero, E, expert_idx).to(torch.int32)
    real_w = torch.where(zero, 0.0, probs)
    route = moe_route(w_gate_up.dtype, x.device)
    routed = _ROUTE_FNS[route](x.to(w_gate_up.dtype), w_gate_up, w_down,
                               real_w, idx, drop=True)
    zero_w = torch.where(zero, probs, 0.0).sum(-1, keepdim=True)
    return routed + (zero_w * x.float()).to(routed.dtype)


def group_limit(choice: torch.Tensor, n_group: int, topk_group: int,
                group_score: str) -> torch.Tensor:
    """``choice`` [T, E] with the experts outside the ``topk_group`` best
    of ``n_group`` equal groups set to 0.0 (not -inf, as transformers
    masks them). A group scores the sum of its top two (``"top2"``,
    DeepSeek-V3 / GLM-4.5) or its maximum (``"max"``, DeepSeek-V2)."""
    if n_group <= 1 or topk_group >= n_group:
        return choice
    T, E = choice.shape
    grouped = choice.view(T, n_group, E // n_group)
    if group_score == "top2":
        gscore = grouped.topk(2, dim=-1)[0].sum(dim=-1)
    else:
        gscore = grouped.amax(dim=-1)
    gidx = torch.topk(gscore, topk_group, dim=-1)[1]
    keep = torch.zeros_like(gscore).scatter_(1, gidx, 1.0) > 0
    keep = keep[:, :, None].expand(T, n_group, E // n_group).reshape(T, E)
    return torch.where(keep, choice, torch.zeros_like(choice))


def sigmoid_bias_routing(logits: torch.Tensor, bias: torch.Tensor,
                         top_k: int, renormalize: bool, scale: float,
                         n_group: int = 1, topk_group: int = 1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights float32 [T, k], expert_idx int32 [T, k]) of DeepSeek-V3
    and GLM-4.5: sigmoid scores; the experts chosen by the scores plus
    the correction ``bias`` (group-limited, top-2 group scores) and
    weighed by the raw scores, renormalised (``+ 1e-20``) with
    ``renormalize``, then times ``scale`` (``routed_scaling_factor``)."""
    scores = torch.sigmoid(logits.float())
    choice = group_limit(scores + bias[None, :].float(), n_group,
                         topk_group, "top2")
    idx = torch.topk(choice, top_k, dim=-1)[1]
    w = torch.gather(scores, 1, idx)
    if renormalize:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return w * scale, idx.to(torch.int32)


def softmax_group_routing(logits: torch.Tensor, top_k: int, scale: float,
                          n_group: int = 1, topk_group: int = 1
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek-V2's gate: softmax scores, their top k (within the
    ``topk_group`` best groups by maximum when grouped), times ``scale``;
    never renormalised (transformers stores ``norm_topk_prob`` and never
    applies it)."""
    scores = torch.softmax(logits.float(), dim=-1)
    choice = group_limit(scores, n_group, topk_group, "max")
    w, idx = torch.topk(choice, top_k, dim=-1)
    return w * scale, idx.to(torch.int32)


def softmax_bias_routing(logits: torch.Tensor, bias: torch.Tensor,
                         top_k: int, norm_min: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ERNIE 4.5's gate: softmax scores; the experts chosen by the scores
    plus ``bias`` and weighed by the raw scores over their sum clamped
    below at ``norm_min``."""
    scores = torch.softmax(logits.float(), dim=-1)
    idx = torch.topk(scores + bias[None, :].float(), top_k, dim=-1)[1]
    w = torch.gather(scores, 1, idx)
    w = w / w.sum(dim=-1, keepdim=True).clamp(min=norm_min)
    return w, idx.to(torch.int32)
