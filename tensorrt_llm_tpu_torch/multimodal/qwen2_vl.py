"""Qwen2-VL and Qwen2.5-VL: the M-RoPE vision-language models.

Port of ``tensorrt_llm_tpu/multimodal/qwen2_vl.py`` (``Qwen2VisionTower``,
``Qwen25VisionTower``, ``qwen2vl_rope_index``, ``Qwen2VLInputProcessor``
and the two models). Three pieces:

  * the language model: the Qwen2 trunk (models/qwen.py) over the
    config's ``text_config``, whose rotary tables are M-RoPE's
    (ops/rope.py ``mrope_cos_sin``): the rot/2 frequency dims are cut into
    ``mrope_section`` (temporal, height, width), text tokens hold one
    position on all three axes, image tokens their (t, h, w) grid
    coordinates. A step carries them in ``AttentionMetadata.
    positions_mrope``; past the prompt all three axes advance together
    from the request's ``mrope_delta``, where M-RoPE is plain RoPE at
    pos + delta: the decode windows rotate by ``rope_offset`` alone
    (runtime/model_engine.py);
  * the vision tower: a ViT over flattened patches (the patch
    "convolution" is one linear map of each patch), a 2D rotary
    embedding from each patch's (h, w), attention within each image (and
    in Qwen2.5-VL within each window of ``get_window_index``'s
    window-major order, except at ``fullatt_block_indexes``), and the 2x2
    patch merger into the language model's width;
  * the input processor: expands each image placeholder to the image's
    merged-patch count, runs the tower, and returns the feature rows
    (NaN where the token lookup stands), the image hash, and the extras
    ``{"mrope_positions": i32[3, T], "mrope_delta": int}`` (transformers'
    ``get_rope_index``), which the ``LLM`` sets on the request.

The tower, the merger and the rope index are what the JAX package leaves
to XLA and numpy: plain PyTorch here (numpy for the host-side index
helpers, copied), on the trunk's device, with the JAX tower's float32
scores, softmax and accumulations. Parameters keep the JAX tower's names,
one dict per block, matrices [in, out] in the model's type.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.modeling_utils import ModelConfig, register_model
from ..models.qwen import Qwen2ForCausalLM
from ..ops.norm import layer_norm_f32
from ..ops.rope import mrope_cos_sin, mrope_section
from ..quantization.lazy_state_dict import RenamedStateDict
from .encoders import linear_f32
from .processor import (expand, host_array, image_list, mm_hash,
                        register_input_processor, splice, to_device)


# --------------------------------------------------------------------- #
# Host-side index helpers (numpy, copies of the JAX package's)
# --------------------------------------------------------------------- #
def rot_pos_ids(grid_thw, merge: int) -> np.ndarray:
    """Each patch's (h, w) rotary position in merger-block order
    (transformers' ``rot_pos_emb``): int [L, 2]."""
    out = []
    m = merge
    for t, h, w in grid_thw:
        hp = np.broadcast_to(np.arange(h)[:, None], (h, w))
        hp = hp.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3) \
            .reshape(-1)
        wp = np.broadcast_to(np.arange(w)[None, :], (h, w))
        wp = wp.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3) \
            .reshape(-1)
        pos = np.stack([hp, wp], axis=-1)
        out.append(np.tile(pos, (t, 1)))
    return np.concatenate(out, axis=0)


def rotary_angles(pos: np.ndarray, hd: int) -> np.ndarray:
    """The towers' 2D rotary angles [L, hd/2] of (h, w) positions [L, 2]:
    h takes the first hd/4 frequencies' slots, w the next (the JAX
    ``encode``'s float arithmetic, so both packages round alike)."""
    inv = 1.0 / (10000.0 ** (np.arange(0, hd // 2, 2, dtype=np.float32)
                             / (hd // 2)))
    return (pos[:, :, None] * inv[None, None, :]).reshape(pos.shape[0], -1)


def rotary_tables(emb: np.ndarray, device) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(cos, sin) of the angles ``emb`` as float32 tensors on
    ``device``."""
    return (to_device(np.cos(emb), device, torch.float32),
            to_device(np.sin(emb), device, torch.float32))


def same_segment(seg: np.ndarray, device) -> torch.Tensor:
    """bool [L, L] on ``device``: patch pairs in one segment."""
    s = to_device(seg, device)
    return s[:, None] == s[None, :]


def image_segments(grid_thw) -> np.ndarray:
    """int32 [L]: each patch's image index (attention stays within it)."""
    return np.concatenate([np.full(int(t * h * w), i, np.int32)
                           for i, (t, h, w) in enumerate(grid_thw)])


def get_window_index(grid_thw, window: int, merge: int, patch: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Qwen2.5-VL's window-major permutation of the merge groups and each
    window's cumulative patch count (transformers' ``get_window_index``;
    the JAX ``Qwen25VisionTower.get_window_index``)."""
    m = merge
    vmw = window // m // patch
    unit = m * m
    win_idx, cu = [], [0]
    base = 0
    for t, h, w in grid_thw:
        gh, gw = h // m, w // m
        idx = np.arange(t * gh * gw).reshape(t, gh, gw)
        ph = (-gh) % vmw
        pw = (-gw) % vmw
        idxp = np.full((t, gh + ph, gw + pw), -100, np.int64)
        idxp[:, :gh, :gw] = idx
        nh, nw = (gh + ph) // vmw, (gw + pw) // vmw
        idxp = idxp.reshape(t, nh, vmw, nw, vmw) \
            .transpose(0, 1, 3, 2, 4).reshape(t, nh * nw, vmw, vmw)
        seqlens = (idxp != -100).sum((2, 3)).reshape(-1)
        flat = idxp.reshape(-1)
        keep = flat[flat != -100]
        win_idx.append(keep + base)
        cu.extend((np.cumsum(seqlens) * unit + cu[-1]).tolist())
        base += t * gh * gw
    cu = np.asarray(cu, np.int64)
    cu = cu[np.concatenate([[True], np.diff(cu) != 0])]
    return np.concatenate(win_idx), cu


def qwen2vl_rope_index(token_ids: Sequence[int], image_token_id: int,
                       grids: List[Tuple[int, int, int]], merge: int
                       ) -> Tuple[np.ndarray, int]:
    """transformers' ``Qwen2VLModel.get_rope_index`` for one sequence
    whose image placeholders are expanded: (int32 [3, T] positions,
    delta), where delta = max position + 1 - T moves every position past
    the prompt."""
    T = len(token_ids)
    pos = np.zeros((3, T), np.int64)
    st = 0
    st_idx = 0
    img_i = 0
    toks = list(token_ids)
    while img_i < len(grids):
        try:
            ed = toks.index(image_token_id, st)
        except ValueError:
            break
        t, h, w = grids[img_i]
        gh, gw = h // merge, w // merge
        text_len = ed - st
        for j in range(3):
            pos[j, st:ed] = np.arange(text_len) + st_idx
        ti = np.repeat(np.arange(t), gh * gw)
        hi = np.tile(np.repeat(np.arange(gh), gw), t)
        wi = np.tile(np.arange(gw), t * gh)
        n = t * gh * gw
        pos[0, ed:ed + n] = ti + text_len + st_idx
        pos[1, ed:ed + n] = hi + text_len + st_idx
        pos[2, ed:ed + n] = wi + text_len + st_idx
        st_idx = int(pos[:, st:ed + n].max()) + 1 if ed + n > st else st_idx
        st = ed + n
        img_i += 1
    if st < T:
        text_len = T - st
        for j in range(3):
            pos[j, st:] = np.arange(text_len) + st_idx
    delta = int(pos.max()) + 1 - T
    return pos.astype(np.int32), delta


# --------------------------------------------------------------------- #
# Shared pieces of the M-RoPE towers
# --------------------------------------------------------------------- #
def rotate_half_2d(u: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor) -> torch.Tensor:
    """The towers' rotary embedding of [L, heads, hd] in float32 (halves
    rotated; ``cos`` / ``sin`` [L, hd/2])."""
    uf = u.float()
    hd = uf.shape[-1]
    u1, u2 = uf[..., :hd // 2], uf[..., hd // 2:]
    c, s = cos[:, None], sin[:, None]
    return torch.cat([u1 * c - u2 * s, u2 * c + u1 * s], -1)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     keep: torch.Tensor) -> torch.Tensor:
    """Attention of float32 [L, heads, hd] over the keys ``keep`` [L, L]
    allows, scores / sqrt(hd) and softmax in float32 (the JAX towers'):
    float32 [L, heads * hd]."""
    L, _, hd = q.shape
    scores = torch.einsum("thd,shd->hts", q, k) / math.sqrt(hd)
    scores = scores.masked_fill(~keep[None], torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, -1)
    return torch.einsum("hts,shd->thd", probs, v.float()).reshape(L, -1)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     idx: torch.Tensor, valid: torch.Tensor,
                     sel: torch.Tensor) -> torch.Tensor:
    """``masked_attention`` where each row's keys are its window's, the
    windows contiguous runs of rows: gathered into [windows, W] by
    ``idx`` (``valid`` marks the real rows of each padded window, ``sel``
    their flat positions, in row order), each window attended alone.
    The keys the full mask removes contribute exact zeros there, so the
    two agree to float32 rounding; this one computes windows x W^2
    scores instead of L^2 (Qwen2.5-VL-7B at 2,304 patches: 36 windows of
    64)."""
    L, nh, hd = q.shape
    qw, kw, vw = q[idx], k[idx], v[idx].float()          # [n, W, nh, hd]
    scores = torch.einsum("nthd,nshd->nhts", qw, kw) / math.sqrt(hd)
    scores = scores.masked_fill(~valid[:, None, None, :],
                                torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, -1)
    out = torch.einsum("nhts,nshd->nthd", probs, vw)
    return out.reshape(-1, nh * hd)[sel]


def tower_tensor(sd: Mapping[str, Any], name: str, device,
                 dtype: torch.dtype, transpose: bool = False) -> torch.Tensor:
    """Checkpoint tensor ``name`` on ``device`` in ``dtype``; with
    ``transpose`` an [out, in] matrix as [in, out]."""
    x = torch.as_tensor(sd[name]).to(device=device, dtype=dtype)
    return x.t().contiguous() if transpose else x


def patch_matrix(sd: Mapping[str, Any], device, dtype) -> torch.Tensor:
    """The patch "convolution" [E, C, t, p, p] as a matrix [C*t*p*p, E]."""
    pe = tower_tensor(sd, "patch_embed.proj.weight", device, dtype)
    return pe.reshape(pe.shape[0], -1).t().contiguous()


class Qwen2VisionTower:
    """Qwen2-VL's ViT: LayerNorm blocks with a quick-GELU MLP, attention
    within each image, and the LayerNorm + two-layer GELU merger."""

    def __init__(self, vc, dtype: torch.dtype, device):
        self.vc = vc
        self.dtype = dtype
        self.device = torch.device(device)
        self.depth = vc.depth
        self.embed = getattr(vc, "embed_dim", None) or vc.hidden_size
        self.heads = vc.num_heads
        self.hd = self.embed // self.heads
        self.merge = vc.spatial_merge_size
        self.patch = vc.patch_size
        self.tpatch = vc.temporal_patch_size
        self.out_dim = vc.hidden_size

    def _w(self, sd, name, transpose=False):
        return tower_tensor(sd, name, self.device, self.dtype, transpose)

    def load_hf_state_dict(self, sd: Mapping[str, Any]) -> Dict[str, Any]:
        def block(i):
            p = f"blocks.{i}."
            return {
                "ln1_w": self._w(sd, p + "norm1.weight"),
                "ln1_b": self._w(sd, p + "norm1.bias"),
                "ln2_w": self._w(sd, p + "norm2.weight"),
                "ln2_b": self._w(sd, p + "norm2.bias"),
                "qkv_w": self._w(sd, p + "attn.qkv.weight", True),
                "qkv_b": self._w(sd, p + "attn.qkv.bias"),
                "proj_w": self._w(sd, p + "attn.proj.weight", True),
                "proj_b": self._w(sd, p + "attn.proj.bias"),
                "fc1_w": self._w(sd, p + "mlp.fc1.weight", True),
                "fc1_b": self._w(sd, p + "mlp.fc1.bias"),
                "fc2_w": self._w(sd, p + "mlp.fc2.weight", True),
                "fc2_b": self._w(sd, p + "mlp.fc2.bias"),
            }
        return {
            "patch_w": patch_matrix(sd, self.device, self.dtype),
            "blocks": [block(i) for i in range(self.depth)],
            "ln_q_w": self._w(sd, "merger.ln_q.weight"),
            "ln_q_b": self._w(sd, "merger.ln_q.bias"),
            "m0_w": self._w(sd, "merger.mlp.0.weight", True),
            "m0_b": self._w(sd, "merger.mlp.0.bias"),
            "m2_w": self._w(sd, "merger.mlp.2.weight", True),
            "m2_b": self._w(sd, "merger.mlp.2.bias"),
        }

    # the norm before attention / the MLP and the merger's (LayerNorm here,
    # RMSNorm in Qwen2.5-VL)
    def _norm(self, x, blk, name):
        return layer_norm_f32(x, blk[name + "_w"], blk[name + "_b"], 1e-6)

    def _attention(self, blk, x, cos, sin, attend):
        dt, L = self.dtype, x.shape[0]
        h = self._norm(x, blk, "ln1")
        qkv = linear_f32(h, blk["qkv_w"]).to(dt) + blk["qkv_b"]
        q, k, v = qkv.view(L, 3, self.heads, self.hd).unbind(1)
        o = attend(rotate_half_2d(q, cos, sin), rotate_half_2d(k, cos, sin),
                   v)
        return linear_f32(o.to(dt), blk["proj_w"]).to(dt) + blk["proj_b"]

    def _mlp(self, blk, h):
        dt = self.dtype
        f = linear_f32(h, blk["fc1_w"]) + blk["fc1_b"]
        f = f * torch.sigmoid(1.702 * f)               # quick GELU
        return linear_f32(f.to(dt), blk["fc2_w"]).to(dt) + blk["fc2_b"]

    def _merger(self, params, x):
        dt = self.dtype
        x = self._norm(x, params, "ln_q").reshape(
            -1, self.merge * self.merge * self.embed)
        x = linear_f32(x, params["m0_w"]) + params["m0_b"]
        x = F.gelu(x)
        x = linear_f32(x.to(dt), params["m2_w"]) + params["m2_b"]
        return x.to(dt)

    @torch.no_grad()
    def forward(self, params, patches, cos, sin, attends):
        """``attends``: each block's attention, a function of float32 q, k
        and v [L, heads, hd]."""
        dt = self.dtype
        x = linear_f32(patches.to(dt), params["patch_w"]).to(dt)
        for blk, attend in zip(params["blocks"], attends):
            x = x + self._attention(blk, x, cos, sin, attend)
            x = x + self._mlp(blk, self._norm(x, blk, "ln2"))
        return self._merger(params, x)

    def _tables(self, grid_thw, perm=None):
        """(cos, sin) float32 [L, hd/2] on the device, rows permuted by
        ``perm`` when given."""
        emb = rotary_angles(rot_pos_ids(grid_thw, self.merge), self.hd)
        if perm is not None:
            emb = emb[perm]
        return rotary_tables(emb, self.device)

    def _within(self, seg: np.ndarray):
        """Attention within each segment of ``seg`` (``masked_attention``
        over their same-segment mask)."""
        keep = same_segment(seg, self.device)
        return lambda q, k, v: masked_attention(q, k, v, keep)

    def encode(self, params, pixel_values: torch.Tensor, grid_thw
               ) -> torch.Tensor:
        """pixel_values float32 [L, C*t*p*p] on the device + grids ->
        merged features [L / merge^2, out_dim] in the model's type."""
        cos, sin = self._tables(grid_thw)
        return self.forward(params, pixel_values, cos, sin,
                            [self._within(image_segments(grid_thw))]
                            * self.depth)


class Qwen25VisionTower(Qwen2VisionTower):
    """Qwen2.5-VL's ViT: RMSNorm blocks with a SiLU-gated MLP, attention
    within each window of the window-major order except at the full
    attention blocks, whose attention stays within each image."""

    def __init__(self, vc, dtype: torch.dtype, device):
        super().__init__(vc, dtype, device)
        self.embed = vc.hidden_size               # 2.5 renames the width
        self.hd = self.embed // self.heads
        self.out_dim = vc.out_hidden_size
        self.window = vc.window_size
        self.full_idx = set(vc.fullatt_block_indexes)

    def load_hf_state_dict(self, sd: Mapping[str, Any]) -> Dict[str, Any]:
        def block(i):
            p = f"blocks.{i}."
            out = {
                "ln1_w": self._w(sd, p + "norm1.weight"),
                "ln2_w": self._w(sd, p + "norm2.weight"),
                "qkv_w": self._w(sd, p + "attn.qkv.weight", True),
                "qkv_b": self._w(sd, p + "attn.qkv.bias"),
                "proj_w": self._w(sd, p + "attn.proj.weight", True),
                "proj_b": self._w(sd, p + "attn.proj.bias"),
            }
            for n in ("gate", "up", "down"):
                out[n + "_w"] = self._w(sd, p + f"mlp.{n}_proj.weight", True)
                out[n + "_b"] = self._w(sd, p + f"mlp.{n}_proj.bias")
            return out
        return {
            "patch_w": patch_matrix(sd, self.device, self.dtype),
            "blocks": [block(i) for i in range(self.depth)],
            "ln_q_w": self._w(sd, "merger.ln_q.weight"),
            "m0_w": self._w(sd, "merger.mlp.0.weight", True),
            "m0_b": self._w(sd, "merger.mlp.0.bias"),
            "m2_w": self._w(sd, "merger.mlp.2.weight", True),
            "m2_b": self._w(sd, "merger.mlp.2.bias"),
        }

    def _norm(self, x, blk, name):
        """The JAX tower's ``_rms``: the weight applied in float32."""
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + 1e-6) *
                blk[name + "_w"].float()).to(x.dtype)

    def _mlp(self, blk, h):
        dt = self.dtype
        g = linear_f32(h, blk["gate_w"]) + blk["gate_b"]
        u = (linear_f32(h, blk["up_w"]) + blk["up_b"]).to(dt)
        f = F.silu(g).to(dt) * u
        return linear_f32(f, blk["down_w"]).to(dt) + blk["down_b"]

    def _windows(self, cu_win: np.ndarray):
        """Attention within each window, the rows [cu_win[i], cu_win[i +
        1]) of the window-major order (``window_attention``)."""
        lens = np.diff(cu_win)
        W = int(lens.max())
        idx = np.zeros((len(lens), W), np.int64)
        valid = np.zeros((len(lens), W), bool)
        for i, (a, n) in enumerate(zip(cu_win[:-1], lens)):
            idx[i, :n] = np.arange(a, a + n)
            valid[i, :n] = True
        dev = self.device
        win = (to_device(idx, dev), to_device(valid, dev),
               to_device(np.flatnonzero(valid), dev))
        return lambda q, k, v: window_attention(q, k, v, *win)

    def encode(self, params, pixel_values: torch.Tensor, grid_thw
               ) -> torch.Tensor:
        unit = self.merge * self.merge
        win_idx, cu_win = get_window_index(grid_thw, self.window,
                                           self.merge, self.patch)
        # the merge groups in window-major order, and back at the end
        perm = (win_idx[:, None] * unit + np.arange(unit)[None, :]) \
            .reshape(-1)
        cos, sin = self._tables(grid_thw, perm)
        full = self._within(image_segments(grid_thw)[perm])
        windowed = self._windows(cu_win)
        dev = self.device
        out = self.forward(
            params, pixel_values[to_device(perm, dev)], cos, sin,
            [full if i in self.full_idx else windowed
             for i in range(self.depth)])
        return out[to_device(np.argsort(win_idx), dev)]


# --------------------------------------------------------------------- #
# The models
# --------------------------------------------------------------------- #
def split_visual(sd: Mapping[str, Any]) -> Tuple[Mapping, Mapping]:
    """(trunk, tower) views of a checkpoint: the trunk's under the Llama
    names (``model.layers...``, ``lm_head.weight``), the tower's below
    ``visual.`` (transformers' ``model.`` prefix stripped)."""
    lm, vis = {}, {}
    for k in sd:
        k2 = k[len("model."):] if k.startswith("model.") else k
        if k2.startswith("language_model."):
            lm["model." + k2[len("language_model."):]] = k
        elif k2.startswith("visual."):
            vis[k2[len("visual."):]] = k
        elif k2 == "lm_head.weight":
            lm["lm_head.weight"] = k
    return RenamedStateDict(sd, lm), RenamedStateDict(sd, vis)


class MropeVisionModel:
    """The M-RoPE models' glue over a text trunk (mixed in before the
    trunk's class): the trunk over ``text_config``, the tower beside it,
    the rotary tables from ``positions_mrope`` when a step carries them,
    and seeded random weights by the ``transformers`` model's shapes."""
    uses_mrope = True
    tower_cls: Any = None
    # the transformers class whose meta-device shapes ``init_params`` draws
    hf_class = ""
    default_sections: tuple = ()

    def __init__(self, model_config: ModelConfig):
        self.vlm_config = model_config.hf_config
        text = model_config.hf_config.text_config
        super().__init__(dataclasses.replace(model_config, hf_config=text))
        self.mrope_section = mrope_section(
            text, self.default_sections or (self.head_dim // 2,))
        self.image_token_id = self.vlm_config.image_token_id
        self.tower = self.tower_cls(self.vlm_config.vision_config,
                                    self.dtype, self.device)
        self.vision_params: Dict[str, Any] = {}

    def mrope_tables(self, rope, positions3: torch.Tensor):
        return mrope_cos_sin(rope, positions3, self.mrope_section)

    def _base_cos_sin(self, rope, metadata):
        if metadata.positions_mrope is not None:
            return self.mrope_tables(rope, metadata.positions_mrope)
        return super()._base_cos_sin(rope, metadata)

    def load_hf_state_dict(self, sd: Mapping[str, Any]) -> Dict[str, Any]:
        lm, vis = split_visual(sd)
        self.vision_params = self.tower.load_hf_state_dict(vis)
        return super().load_hf_state_dict(lm)

    def init_params(self, seed: int = 0) -> Dict[str, Any]:
        """Seeded random weights by the ``transformers`` model's shapes
        (``models.recurrent.RandomCheckpoint``), drawn on the device as
        they are read (the JAX package refuses to serve these types
        without weights)."""
        import transformers
        from ..models.recurrent import RandomCheckpoint, meta_shapes
        shapes = meta_shapes(getattr(transformers, self.hf_class),
                             self.vlm_config)
        return self.load_hf_state_dict(RandomCheckpoint(
            shapes, self.device, self.dtype, seed=seed))

    def encode_images(self, pixel_values: torch.Tensor, grid_thw):
        return self.tower.encode(self.vision_params, pixel_values, grid_thw)


@register_model("qwen2_vl")
class Qwen2VLForConditionalGeneration(MropeVisionModel, Qwen2ForCausalLM):
    architectures = ("Qwen2VLForConditionalGeneration",)
    processor_type = "qwen2_vl"
    hf_class = "Qwen2VLForConditionalGeneration"
    tower_cls = Qwen2VisionTower


@register_model("qwen2_5_vl")
class Qwen25VLForConditionalGeneration(Qwen2VLForConditionalGeneration):
    architectures = ("Qwen2_5_VLForConditionalGeneration",)
    hf_class = "Qwen2_5_VLForConditionalGeneration"
    tower_cls = Qwen25VisionTower


# --------------------------------------------------------------------- #
# The input processor
# --------------------------------------------------------------------- #
def patch_rows(image, device) -> torch.Tensor:
    """One image's flattened patches as float32 [L, C*t*p*p] on
    ``device``."""
    return to_device(image, device, torch.float32)


@register_input_processor("qwen2_vl")
class Qwen2VLInputProcessor:
    """``image`` = flattened-patch arrays [n_patches, C*t*p*p];
    ``image_grid_thw`` = [(t, h, w), ...] (transformers' image processor
    gives both). Returns (ids, rows, salt, extras)."""

    def __init__(self, model):
        self.model = model
        self.image_token = model.image_token_id
        self.merge = model.tower.merge

    def _grids(self, mm_data):
        return [tuple(int(x) for x in g) for g in mm_data["image_grid_thw"]]

    def _expand(self, token_ids, grids):
        m2 = self.merge ** 2
        return expand(token_ids, self.image_token,
                      [int(t * h * w) // m2 for t, h, w in grids])

    def _extras(self, out_ids, grids) -> Dict[str, Any]:
        mp, delta = qwen2vl_rope_index(out_ids, self.image_token, grids,
                                       self.merge)
        return {"mrope_positions": mp, "mrope_delta": delta}

    def __call__(self, token_ids: List[int], mm_data: Dict[str, Any]
                 ) -> Tuple[List[int], torch.Tensor, str, Dict[str, Any]]:
        images = image_list(mm_data)
        grids = self._grids(mm_data)
        out_ids = self._expand(token_ids, grids)
        dev = self.model.device
        feats = torch.cat([self.model.encode_images(patch_rows(px, dev), [g])
                           for px, g in zip(images, grids)])
        return (out_ids, splice(out_ids, self.image_token, feats),
                mm_hash([host_array(i) for i in images]),
                self._extras(out_ids, grids))
