"""Qwen3-VL and Qwen3-VL-MoE: interleaved M-RoPE and deepstack features.

Port of ``tensorrt_llm_tpu/multimodal/qwen3_vl.py``
(``mrope_cos_sin_interleaved``, in ops/rope.py here; ``Qwen3VisionTower``,
``_Qwen3VLGlue``, ``Qwen3VLInputProcessor`` and the two models). Against
Qwen2-VL (multimodal/qwen2_vl.py):

  * the tower adds a learned position table, bilinearly interpolated to
    each grid (transformers' ``fast_pos_embed_interpolate``, numpy on the
    host as in the JAX package), has LayerNorm blocks with a tanh-GELU
    MLP, and besides the main merger a deepstack merger at each of
    ``deepstack_visual_indexes``, whose features are added to the
    language model's hidden rows after its first layers;
  * the text trunk is Qwen3 (or Qwen3-MoE) with interleaved M-RoPE: the
    frequency dims laid out T H W T H W ... instead of in sections.

The deepstack features ride extra columns of the prompt-embedding rows
(``prompt_embeds_width`` = H * (1 + n_deepstack); zeros on text rows, the
additive identity), which ``forward`` splits off into the trunk's
``deepstack`` input (models/llama.py, shared by the MoE trunk).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.qwen import Qwen3ForCausalLM
from ..models.qwen_moe import Qwen3MoeForCausalLM
from ..models.modeling_utils import register_model
from ..models.recurrent import stack_experts
from ..ops.norm import layer_norm_f32
from ..ops.rope import mrope_cos_sin_interleaved
from .encoders import linear_f32
from .processor import (host_array, image_list, mm_hash,
                        register_input_processor, to_device)
from .qwen2_vl import (MropeVisionModel, Qwen2VLInputProcessor,
                       image_segments, masked_attention, patch_matrix,
                       patch_rows, rot_pos_ids, rotary_angles,
                       rotary_tables, rotate_half_2d, same_segment,
                       tower_tensor)


class Qwen3VisionTower:
    def __init__(self, vc, dtype: torch.dtype, device):
        self.vc = vc
        self.dtype = dtype
        self.device = torch.device(device)
        self.depth = vc.depth
        self.embed = vc.hidden_size
        self.heads = vc.num_heads
        self.hd = self.embed // self.heads
        self.merge = vc.spatial_merge_size
        self.patch = vc.patch_size
        self.tpatch = vc.temporal_patch_size
        self.out_dim = vc.out_hidden_size
        self.grid_side = int(vc.num_position_embeddings ** 0.5)
        self.ds_idx = list(vc.deepstack_visual_indexes)

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
                "fc1_w": self._w(sd, p + "mlp.linear_fc1.weight", True),
                "fc1_b": self._w(sd, p + "mlp.linear_fc1.bias"),
                "fc2_w": self._w(sd, p + "mlp.linear_fc2.weight", True),
                "fc2_b": self._w(sd, p + "mlp.linear_fc2.bias"),
            }

        def merger(pfx):
            return {
                "n_w": self._w(sd, pfx + ".norm.weight"),
                "n_b": self._w(sd, pfx + ".norm.bias"),
                "fc1_w": self._w(sd, pfx + ".linear_fc1.weight", True),
                "fc1_b": self._w(sd, pfx + ".linear_fc1.bias"),
                "fc2_w": self._w(sd, pfx + ".linear_fc2.weight", True),
                "fc2_b": self._w(sd, pfx + ".linear_fc2.bias"),
            }

        pos = self._w(sd, "pos_embed.weight")
        out = {
            "patch_w": patch_matrix(sd, self.device, self.dtype),
            "patch_b": self._w(sd, "patch_embed.proj.bias"),
            "pos": pos,
            # the table as the host's interpolation reads it (float32 of
            # the model's type, as the JAX tower's np.asarray)
            "pos_host": pos.float().cpu().numpy(),
            "blocks": [block(i) for i in range(self.depth)],
            "merger": merger("merger"),
        }
        for j in range(len(self.ds_idx)):
            out[f"ds_merger{j}"] = merger(f"deepstack_merger_list.{j}")
        return out

    def _ln(self, x, w, b):
        return layer_norm_f32(x, w, b, 1e-6)

    def _merge(self, m, x, post: bool):
        """Patch merger: the norm (after the 2x2 shuffle for the deepstack
        mergers, before it for the main one), fc1, GELU, fc2."""
        u = self.merge * self.merge
        if post:
            x = self._ln(x.reshape(-1, u * self.embed), m["n_w"], m["n_b"])
        else:
            x = self._ln(x, m["n_w"], m["n_b"]).reshape(-1, u * self.embed)
        x = F.gelu(linear_f32(x, m["fc1_w"]) + m["fc1_b"])
        x = linear_f32(x.to(self.dtype), m["fc2_w"]) + m["fc2_b"]
        return x.to(self.dtype)

    def pos_embed_rows(self, params, grid_thw) -> np.ndarray:
        """The position table bilinearly interpolated to each grid, in
        merger-block order (numpy, the JAX ``pos_embed_rows``)."""
        tab = params["pos_host"]
        side = self.grid_side
        m = self.merge
        rows = []
        for t, h, w in grid_thw:
            hi = np.linspace(0, side - 1, h)
            wi = np.linspace(0, side - 1, w)
            hf, wf = hi.astype(int), wi.astype(int)
            hc = np.clip(hf + 1, None, side - 1)
            wc = np.clip(wf + 1, None, side - 1)
            dh, dw = hi - hf, wi - wf
            pe = (tab[(hf[:, None] * side + wf[None, :])] *
                  ((1 - dh)[:, None, None] * (1 - dw)[None, :, None]) +
                  tab[(hf[:, None] * side + wc[None, :])] *
                  ((1 - dh)[:, None, None] * dw[None, :, None]) +
                  tab[(hc[:, None] * side + wf[None, :])] *
                  (dh[:, None, None] * (1 - dw)[None, :, None]) +
                  tab[(hc[:, None] * side + wc[None, :])] *
                  (dh[:, None, None] * dw[None, :, None]))
            pe = np.tile(pe.reshape(h * w, -1), (t, 1))
            pe = pe.reshape(t, h // m, m, w // m, m, -1) \
                .transpose(0, 1, 3, 2, 4, 5).reshape(t * h * w, -1)
            rows.append(pe)
        return np.concatenate(rows, axis=0)

    @torch.no_grad()
    def forward(self, params, patches, pos_rows, cos, sin, keep):
        dt, L = self.dtype, patches.shape[0]
        x = linear_f32(patches.to(dt), params["patch_w"]).to(dt) \
            + params["patch_b"]
        x = x + pos_rows.to(dt)
        ds_feats = []
        for i, blk in enumerate(params["blocks"]):
            h = self._ln(x, blk["ln1_w"], blk["ln1_b"])
            qkv = linear_f32(h, blk["qkv_w"]).to(dt) + blk["qkv_b"]
            q, k, v = qkv.view(L, 3, self.heads, self.hd).unbind(1)
            o = masked_attention(rotate_half_2d(q, cos, sin),
                                 rotate_half_2d(k, cos, sin), v, keep)
            x = x + (linear_f32(o.to(dt), blk["proj_w"]).to(dt)
                     + blk["proj_b"])
            h = self._ln(x, blk["ln2_w"], blk["ln2_b"])
            f = F.gelu(linear_f32(h, blk["fc1_w"]) + blk["fc1_b"],
                       approximate="tanh")
            x = x + (linear_f32(f.to(dt), blk["fc2_w"]).to(dt)
                     + blk["fc2_b"])
            if i in self.ds_idx:
                j = self.ds_idx.index(i)
                ds_feats.append(self._merge(params[f"ds_merger{j}"], x,
                                            post=True))
        return self._merge(params["merger"], x, post=False), ds_feats

    def encode(self, params, pixel_values: torch.Tensor, grid_thw
               ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(main features [n, out_dim], the deepstack features, one [n,
        out_dim] per index) in the model's type."""
        dev = self.device
        pos_rows = to_device(self.pos_embed_rows(params, grid_thw), dev,
                             torch.float32)
        emb = rotary_angles(rot_pos_ids(grid_thw, self.merge), self.hd)
        return self.forward(params, pixel_values, pos_rows,
                            *rotary_tables(emb, dev),
                            same_segment(image_segments(grid_thw), dev))


class Qwen3VLGlue(MropeVisionModel):
    """The vision and M-RoPE glue the dense and MoE Qwen3-VL share (the
    JAX ``_Qwen3VLGlue``)."""
    processor_type = "qwen3_vl"
    tower_cls = Qwen3VisionTower
    default_sections = (24, 20, 20)

    def __init__(self, model_config):
        super().__init__(model_config)
        self.n_deepstack = len(self.tower.ds_idx)
        self.prompt_embeds_width = self.hidden_size * (1 + self.n_deepstack)

    def mrope_tables(self, rope, positions3: torch.Tensor):
        return mrope_cos_sin_interleaved(rope, positions3,
                                         self.mrope_section)

    def forward(self, params, token_ids, kv_pages, metadata,
                input_embeds=None, **kw):
        """Rows wider than H carry the deepstack features beside the
        spliced ones: [T, H] go in as the embeddings, the rest as the
        trunk's ``deepstack`` [n, T, H] (NaN, the rows of a request
        without them, read as 0)."""
        ds = None
        H = self.hidden_size
        if input_embeds is not None and input_embeds.shape[-1] > H:
            wide = input_embeds
            input_embeds = wide[:, :H]
            ds = torch.nan_to_num(wide[:, H:]).reshape(
                wide.shape[0], self.n_deepstack, H).transpose(0, 1)
        return super().forward(params, token_ids, kv_pages, metadata,
                               input_embeds=input_embeds, deepstack=ds,
                               **kw)


@register_model("qwen3_vl")
class Qwen3VLForConditionalGeneration(Qwen3VLGlue, Qwen3ForCausalLM):
    architectures = ("Qwen3VLForConditionalGeneration",)
    hf_class = "Qwen3VLForConditionalGeneration"


@register_model("qwen3_vl_moe")
class Qwen3VLMoeForConditionalGeneration(Qwen3VLGlue, Qwen3MoeForCausalLM):
    """The Qwen3-VL glue over the Qwen3-MoE trunk. The checkpoint stores
    each layer's experts fused (``mlp.experts.gate_up_proj`` [E, H, 2I],
    gate then up, and ``down_proj`` [E, I, H]), which is ops/moe.py's
    layout already (transformers 5 may keep the transposes: told apart by
    the hidden width, as ``models.recurrent.stack_experts`` does)."""
    architectures = ("Qwen3VLMoeForConditionalGeneration",)
    hf_class = "Qwen3VLMoeForConditionalGeneration"

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(device=self.device, dtype=self.dtype)

    def _stack_experts(self, sd: Mapping[str, Any], prefix: str,
                       name: str) -> torch.Tensor:
        p = prefix + "mlp.experts."
        if p + "gate_up_proj" not in sd:
            return super()._stack_experts(sd, prefix, name)
        w_gu, w_d = stack_experts(self, sd, p, self.num_experts)
        return w_gu if name == "w_gate_up" else w_d


@register_input_processor("qwen3_vl")
class Qwen3VLInputProcessor(Qwen2VLInputProcessor):
    """Qwen2-VL's placeholders and positions; the rows are H * (1 +
    n_deepstack) wide: the main features (NaN at text rows) and beside
    them each deepstack merger's (zeros at text rows)."""

    def __call__(self, token_ids: List[int], mm_data: Dict[str, Any]
                 ) -> Tuple[List[int], torch.Tensor, str, Dict[str, Any]]:
        images = image_list(mm_data)
        grids = self._grids(mm_data)
        out_ids = self._expand(token_ids, grids)
        dev = self.model.device
        feats, ds_all = [], []
        for px, g in zip(images, grids):
            main, ds = self.model.encode_images(patch_rows(px, dev), [g])
            feats.append(main)
            ds_all.append(torch.stack(ds, dim=1))        # [n, n_ds, H]
        allfeat = torch.cat(feats).float()
        allds = torch.cat(ds_all).float()
        n, H = allfeat.shape
        pos = [i for i, t in enumerate(out_ids) if t == self.image_token]
        if len(pos) != n:
            raise ValueError(f"prompt has {len(pos)} image tokens, images "
                             f"supply {n} feature rows")
        embeds = torch.zeros((len(out_ids), H * (1 + allds.shape[1])),
                             dtype=torch.float32, device=dev)
        embeds[:, :H] = float("nan")
        idx = to_device(pos, dev, torch.long)
        embeds[idx, :H] = allfeat
        embeds[idx, H:] = allds.reshape(n, -1)
        return (out_ids, embeds, mm_hash([host_array(i) for i in images]),
                self._extras(out_ids, grids))
