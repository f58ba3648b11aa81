"""Mllama (Llama 3.2 Vision): the cross-attention vision-language model.

Port of ``tensorrt_llm_tpu/multimodal/mllama.py``, in plain PyTorch (the
JAX package leaves the tower and the cross-attention to XLA):

- the vision tower (``MllamaVisionTower``): per-tile patches and the class
  token, gated aspect-ratio tile embeddings and gated position
  embeddings, the pad to a multiple of 8, the local transformer (plain
  residuals) over all tiles together, the post-LayerNorm and post-tile
  embedding, the global transformer (tanh-gated residuals); out: the
  final states joined to the selected intermediate states, then the
  linear projector to the text width;
- the text model: the Llama trunk's layers (models/llama.py; K2 on prompt
  steps, K1 on decode rows) with cross-attention layers at
  ``cross_attention_layers``: q through its own per-head RMS norm, scores
  and softmax in float32 against the request's vision K/V, tanh gates on
  the attention and on the MLP; a row whose slot holds no vision state
  (``cross_len`` 0: a text-only request) passes through unchanged.

The vision K/V of each cross layer are computed once per request at
admission (``compute_cross_kv``; the engine's ``set_cross_state``) into a
slot-indexed cache, the dict {"kv": the self-attention layers' pool,
"cross_k" / "cross_v": [n_cross, slots, kv_heads, Lv, hd], "cross_len":
i32[slots]} (heads before positions, so that a row's keys of one head are
one [Lv, hd] matrix); the last slot is a trash slot with length 0 that
padding and finished rows read. The JAX forward gathers every query
row's vision K/V (``ck[slot_of]``: [T, Lv, kvh, hd] in float32, about
107 GB for a 4,096-token prompt step at Llama-3.2-11B-Vision's 6,404
vision positions); here a prompt step's rows attend sequence by sequence
to their own slot's K/V, in tiles of query rows, and a decode-shaped step
(one row a sequence: the windows, the decode graphs) gathers one [kvh,
Lv, hd] per row. Products take the model's type in and give float32 out
(``_bmm_f32``; the probabilities enter P.V in the model's type, as in the
attention kernels).

Not modelled, as in the JAX package: the processor's per-token
``cross_attention_mask`` (every text row attends all of its request's
vision positions).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.llama import LlamaForCausalLM
from ..models.modeling_utils import (ModelConfig, attention_block,
                                     embed_tokens, register_model)
from ..ops.attention import AttentionMetadata, layer_metadata
from ..ops.norm import layer_norm_f32, rms_norm
from ..quantization.lazy_state_dict import RenamedStateDict
from .encoders import linear_f32
from .llava import split_checkpoint
from .processor import (host_array, mm_hash, register_input_processor,
                        to_device)

# query rows a prompt step's cross-attention scores at a time
CROSS_Q_TILE = 1024


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` with a float32 result: float32 in and out, or on
    CUDA the model's type in with float32 accumulation and output."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


class MllamaVisionTower:
    """The tiled, gated CLIP-style tower of Mllama (the JAX
    ``MllamaVisionTower``)."""

    def __init__(self, vc, dtype: torch.dtype, device):
        self.vc = vc
        self.dtype = dtype
        self.device = torch.device(device)
        self.D = vc.hidden_size
        self.heads = getattr(vc, "attention_heads", None) or \
            vc.num_attention_heads
        self.hd = self.D // self.heads
        self.patch = vc.patch_size
        self.num_patches = (vc.image_size // vc.patch_size) ** 2 + 1
        self.max_tiles = vc.max_num_tiles
        self.inter_idx = list(vc.intermediate_layers_indices)
        self.n_local = vc.num_hidden_layers
        self.n_global = vc.num_global_layers
        self.eps = getattr(vc, "norm_eps", 1e-5)

    def load_hf_state_dict(self, sd: Mapping[str, Any]) -> Dict[str, Any]:
        dev, dt, D = self.device, self.dtype, self.D

        def a(name, dtype=None):
            return torch.as_tensor(sd[name]).to(device=dev,
                                                dtype=dtype or dt)

        def t(name):                                 # [in, out]
            return a(name + ".weight").t().contiguous()

        def layer(pfx, i, gated):
            p = f"{pfx}.layers.{i}."
            out = {"ln1_w": a(p + "input_layernorm.weight"),
                   "ln1_b": a(p + "input_layernorm.bias"),
                   "ln2_w": a(p + "post_attention_layernorm.weight"),
                   "ln2_b": a(p + "post_attention_layernorm.bias"),
                   "q": t(p + "self_attn.q_proj"),
                   "k": t(p + "self_attn.k_proj"),
                   "v": t(p + "self_attn.v_proj"),
                   "o": t(p + "self_attn.o_proj"),
                   "fc1_w": t(p + "mlp.fc1"),
                   "fc1_b": a(p + "mlp.fc1.bias"),
                   "fc2_w": t(p + "mlp.fc2"),
                   "fc2_b": a(p + "mlp.fc2.bias")}
            if gated:
                out["gate_attn"] = a(p + "gate_attn", torch.float32)
                out["gate_ffn"] = a(p + "gate_ffn", torch.float32)
            return out

        pe = a("patch_embedding.weight")                 # [D, 3, P, P]
        f32 = torch.float32
        return {
            "patch_w": pe.permute(2, 3, 1, 0).reshape(-1, D).contiguous(),
            "cls": a("class_embedding"),
            "pos_emb": a("gated_positional_embedding.embedding"),
            "pos_gate": a("gated_positional_embedding.gate", f32),
            "pos_tile": a("gated_positional_embedding.tile_embedding"
                          ".weight"),
            "pre_tile_emb": a("pre_tile_positional_embedding.embedding"
                              ".weight"),
            "pre_tile_gate": a("pre_tile_positional_embedding.gate", f32),
            "post_tile_emb": a("post_tile_positional_embedding.embedding"
                               ".weight"),
            "post_tile_gate": a("post_tile_positional_embedding.gate", f32),
            "ln_pre_w": a("layernorm_pre.weight"),
            "ln_pre_b": a("layernorm_pre.bias"),
            "ln_post_w": a("layernorm_post.weight"),
            "ln_post_b": a("layernorm_post.bias"),
            "local": [layer("transformer", i, False)
                      for i in range(self.n_local)],
            "global": [layer("global_transformer", i, True)
                       for i in range(self.n_global)],
        }

    def _attn(self, blk, x: torch.Tensor, keep: torch.Tensor,
              any_keep: torch.Tensor) -> torch.Tensor:
        """Self-attention over the tiles' positions [L, D]: float32
        projections and scores, ``keep`` [L, L] the valid pairs; a row
        with none attends nothing (zeros)."""
        L = x.shape[0]
        h = layer_norm_f32(x, blk["ln1_w"], blk["ln1_b"], self.eps)
        q, k, v = (linear_f32(h, blk[n]).view(L, self.heads, self.hd)
                   for n in "qkv")
        scores = torch.einsum("thd,shd->hts", q, k) / math.sqrt(self.hd)
        scores = scores.masked_fill(~keep, torch.finfo(torch.float32).min)
        probs = torch.softmax(scores, -1) * any_keep[None, :, None]
        o = torch.einsum("hts,shd->thd", probs, v).reshape(L, self.D)
        return linear_f32(o.to(self.dtype), blk["o"]).to(self.dtype)

    def _mlp(self, blk, x: torch.Tensor) -> torch.Tensor:
        h = layer_norm_f32(x, blk["ln2_w"], blk["ln2_b"], self.eps)
        f = linear_f32(h, blk["fc1_w"]) + blk["fc1_b"].float()
        f = F.gelu(f).to(self.dtype)
        return linear_f32(f, blk["fc2_w"]).to(self.dtype) + blk["fc2_b"]

    @torch.no_grad()
    def encode(self, params, pixel_values: torch.Tensor,
               aspect_ratio_id: int, aspect_ratio_mask) -> torch.Tensor:
        """One image: pixel_values [tiles, 3, H, W], its aspect-ratio id and
        tile mask [tiles] -> features [tiles, patches + 1, D * (1 +
        len(intermediate_layers_indices))] in the model's type."""
        dt, D, Pz = self.dtype, self.D, self.patch
        px = pixel_values.to(device=self.device, dtype=torch.float32)
        nt = px.shape[0]
        hp = self.vc.image_size // Pz
        x = px.reshape(nt, 3, hp, Pz, hp, Pz).permute(0, 2, 4, 3, 5, 1) \
            .reshape(nt, hp * hp, Pz * Pz * 3)
        h = linear_f32(x.to(dt), params["patch_w"]).to(dt)

        def gated(gate, emb):
            return (torch.tanh(gate) * emb.float()).to(dt)

        pre = params["pre_tile_emb"][aspect_ratio_id] \
            .reshape(self.max_tiles, 1, D)[:nt]
        h = h + gated(params["pre_tile_gate"], pre)
        h = torch.cat([params["cls"].expand(nt, 1, D).to(dt), h], dim=1)
        npat = h.shape[1]
        gate = params["pos_gate"]
        h = h + ((1 - torch.tanh(gate)) * params["pos_emb"].float()
                 ).to(dt)[None]
        tile_pos = params["pos_tile"][aspect_ratio_id].reshape(
            self.max_tiles, self.num_patches, D)[:nt]
        h = h + gated(gate, tile_pos)
        h = layer_norm_f32(h, params["ln_pre_w"], params["ln_pre_b"],
                           self.eps)
        # positions padded to a multiple of 8, the tiles flattened
        pad = (-npat) % 8
        h = F.pad(h, (0, 0, 0, pad))
        tl = npat + pad
        h = h.reshape(nt * tl, D)
        tmask = torch.as_tensor(np.asarray(host_array(aspect_ratio_mask),
                                           bool), device=self.device)
        valid = tmask.repeat_interleave(tl) & (torch.arange(
            tl, device=self.device) < npat).repeat(nt)
        # transformers' mask (an outer product of inverted masks): a pair
        # is blocked only when both positions are invalid
        keep = valid[:, None] | valid[None, :]
        any_keep = keep.any(-1).float()
        inters = []
        for i, blk in enumerate(params["local"]):
            h = h + self._attn(blk, h, keep, any_keep)
            h = h + self._mlp(blk, h)
            if i in self.inter_idx:
                inters.append(h)
        h = layer_norm_f32(h, params["ln_post_w"], params["ln_post_b"],
                           self.eps)
        post = params["post_tile_emb"][aspect_ratio_id] \
            .reshape(self.max_tiles, 1, D)[:nt]
        h = (h.reshape(nt, tl, D) + gated(params["post_tile_gate"], post)
             ).reshape(nt * tl, D)
        for blk in params["global"]:
            h = h + gated(blk["gate_attn"], self._attn(blk, h, keep,
                                                       any_keep))
            h = h + gated(blk["gate_ffn"], self._mlp(blk, h))
        out = [h.reshape(nt, tl, D)[:, :npat]]
        out += [x.reshape(nt, tl, D)[:, :npat] for x in inters]
        if len(out) == 1:
            return out[0]
        # the final states, then the intermediate ones interleaved per
        # channel, as the JAX stack(..., -1).reshape does
        inter = torch.stack(out[1:], dim=-1).reshape(nt, npat, -1)
        return torch.cat([out[0], inter], dim=-1)


@register_model("mllama")
class MllamaForConditionalGeneration(LlamaForCausalLM):
    architectures = ("MllamaForConditionalGeneration",)
    processor_type = "mllama"
    hf_class = "MllamaForConditionalGeneration"
    # the engine keeps the slot-indexed cross cache and fills it at
    # admission (runtime/model_engine.py ``set_cross_state``)
    has_cross_states = True

    def __init__(self, model_config: ModelConfig):
        self.vlm_config = model_config.hf_config
        text = self.vlm_config.text_config
        self.text_layers = text.num_hidden_layers
        self.cross_layers = list(text.cross_attention_layers)
        self.self_layers = [i for i in range(self.text_layers)
                            if i not in self.cross_layers]
        super().__init__(dataclasses.replace(model_config, hf_config=text))
        self.image_token_index = self.vlm_config.image_token_index
        vc = self.vlm_config.vision_config
        self.tower = MllamaVisionTower(vc, self.dtype, self.device)
        self.max_vision_tokens = vc.max_num_tiles * self.tower.num_patches
        self.vision_params: Dict[str, Any] = {}
        self.projector: Dict[str, torch.Tensor] = {}

    @property
    def num_layers(self) -> int:
        """The self-attention layers: the KV pool's and the trunk's."""
        return len(self.self_layers)

    # -- cache ----------------------------------------------------------
    def make_kv_pages(self, num_pages: int, page_size: int,
                      num_slots: int = 1):
        """The self layers' KV pool and the cross cache of ``num_slots``
        slots (the last one the trash slot)."""
        shape = (len(self.cross_layers), num_slots, self.num_kv_heads,
                 self.max_vision_tokens, self.head_dim)
        dev = self.device
        return {"kv": super().make_kv_pages(num_pages, page_size),
                "cross_k": torch.zeros(shape, dtype=self.dtype, device=dev),
                "cross_v": torch.zeros(shape, dtype=self.dtype, device=dev),
                "cross_len": torch.zeros(num_slots, dtype=torch.int32,
                                         device=dev)}

    def cross_state_bytes(self, num_slots: int) -> int:
        """Device bytes of the cross cache at ``num_slots`` slots."""
        el = torch.empty((), dtype=self.dtype).element_size()
        return 2 * len(self.cross_layers) * num_slots * self.num_kv_heads \
            * self.max_vision_tokens * self.head_dim * el + 4 * num_slots

    def attn_scratch_bytes(self, seqs: int, tokens: int,
                           positions: int) -> int:
        """A decode-shaped step's cross-attention gather: K and V of every
        row's slot in the model's type, the float32 scores and
        probabilities."""
        el = torch.empty((), dtype=self.dtype).element_size()
        Lv = self.max_vision_tokens
        return seqs * Lv * (2 * self.num_kv_heads * self.head_dim * el
                            + 3 * self.num_heads * 4)

    # -- weights --------------------------------------------------------
    def load_hf_state_dict(self, sd: Mapping[str, Any]) -> Dict[str, Any]:
        lm, vis, pj = split_checkpoint(sd, "vision_model.")
        self.vision_params = self.tower.load_hf_state_dict(vis)
        self.projector = {
            "w": torch.as_tensor(pj["weight"]).to(
                device=self.device, dtype=self.dtype).t().contiguous(),
            "b": torch.as_tensor(pj["bias"]).to(device=self.device,
                                                dtype=self.dtype)}
        cross = [self._cross_layer(lm, i) for i in self.cross_layers]
        # the self-attention layers renumbered densely for the trunk
        names = {}
        for k in lm:
            parts = k.split(".")
            if k.startswith("model.layers."):
                li = int(parts[2])
                if li in self.cross_layers:
                    continue
                parts[2] = str(self.self_layers.index(li))
            names[".".join(parts)] = k
        params = super().load_hf_state_dict(RenamedStateDict(lm, names))
        params["cross"] = cross
        return params

    def _cross_layer(self, lm: Mapping[str, Any], i: int) -> Dict[str, Any]:
        p = f"model.layers.{i}."
        c = p + "cross_attn."
        dev, dt = self.device, self.dtype

        def t(name, dtype=dt):
            return torch.as_tensor(lm[name]).to(device=dev, dtype=dtype)

        layer = {"norm": t(p + "input_layernorm.weight"),
                 "post_norm": t(p + "post_attention_layernorm.weight"),
                 "q_norm": t(c + "q_norm.weight"),
                 "k_norm": t(c + "k_norm.weight"),
                 "gate_attn": t(p + "cross_attn_attn_gate", torch.float32),
                 "gate_mlp": t(p + "cross_attn_mlp_gate", torch.float32),
                 "o": self._lin(self.m_o, lm[c + "o_proj.weight"])}
        for n in "qkv":       # q, k and v by q's method, as the JAX model
            layer[n] = self._lin(self.m_q, lm[c + n + "_proj.weight"])
        layer.update(self._mlp_params(
            lambda n: lm[p + self._hf_module(n) + ".weight"],
            lambda n: None))
        return layer

    def init_params(self, seed: int = 0) -> Dict[str, Any]:
        """Seeded random weights by the ``transformers`` model's shapes
        (``models.recurrent.RandomCheckpoint``; the JAX package refuses
        to serve mllama without weights)."""
        import transformers
        from ..models.recurrent import RandomCheckpoint, meta_shapes
        shapes = meta_shapes(getattr(transformers, self.hf_class),
                             self.vlm_config)
        return self.load_hf_state_dict(RandomCheckpoint(
            shapes, self.device, self.dtype, seed=seed))

    # -- vision ---------------------------------------------------------
    @torch.no_grad()
    def encode_images(self, pixel_values, aspect_ratio_ids,
                      aspect_ratio_mask) -> torch.Tensor:
        """Images [n, tiles, 3, H, W] with their aspect-ratio ids [n] and
        tile masks [n, tiles] -> projected cross states float32 [n *
        tiles * (patches + 1), text hidden] on the model's device."""
        outs = []
        for px, aid, am in zip(pixel_values, aspect_ratio_ids,
                               aspect_ratio_mask):
            f = self.tower.encode(self.vision_params,
                                  to_device(px, self.device, torch.float32),
                                  int(aid), am)
            f = f.reshape(-1, f.shape[-1])
            outs.append(linear_f32(f, self.projector["w"])
                        + self.projector["b"].float())
        return torch.cat(outs)

    @torch.no_grad()
    def compute_cross_kv(self, params: Dict[str, Any],
                         cross_states: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each cross layer's vision K (through its k-norm) and V from the
        projected states [n, H]: ([n_cross, kvh, n, hd], same)."""
        kvh, hd = self.num_kv_heads, self.head_dim
        x = torch.as_tensor(cross_states).to(device=self.device,
                                             dtype=self.dtype)
        n = x.shape[0]
        ks, vs = [], []
        for layer in params["cross"]:
            k = self.m_q.apply(layer["k"], x).reshape(n, kvh, hd)
            ks.append(rms_norm(k, layer["k_norm"], self.rms_eps)
                      .transpose(0, 1))
            vs.append(self.m_q.apply(layer["v"], x).reshape(n, kvh, hd)
                      .transpose(0, 1))
        return torch.stack(ks), torch.stack(vs)

    # -- forward --------------------------------------------------------
    def _attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                length: torch.Tensor) -> torch.Tensor:
        """q [B, kvh, m, hd] (m = rows x group) against k, v [B, kvh, Lv,
        hd] whose first ``length`` [B] positions are valid -> float32
        [B, kvh, m, hd]; a batch entry with length 0 gives zeros."""
        B, kvh, m, hd = q.shape
        Lv = k.shape[2]
        scores = _bmm_f32(q.reshape(B * kvh, m, hd),
                          k.reshape(B * kvh, Lv, hd).transpose(1, 2))
        scores = scores.view(B, kvh, m, Lv) / math.sqrt(hd)
        ok = torch.arange(Lv, device=q.device)[None, :] < length[:, None]
        scores = scores.masked_fill(~ok[:, None, None, :],
                                    torch.finfo(torch.float32).min)
        probs = torch.softmax(scores, -1) * (length > 0).float()[
            :, None, None, None]
        out = _bmm_f32(probs.to(v.dtype).reshape(B * kvh, m, Lv),
                       v.reshape(B * kvh, Lv, hd))
        return out.view(B, kvh, m, hd)

    def _cross_rows(self, metadata: AttentionMetadata, T: int, trash: int):
        """The step's rows by cross slot: for a decode-shaped step (one
        row a sequence) each row's slot [T] (the trash slot for padding
        and rows without a sequence); else the host list of (first row,
        end row, slot) of each sequence, from ``cross_segments`` or read
        from the device (a sync) where the caller gives none."""
        slots = metadata.seq_slots
        if metadata.max_q_len == 1:
            if slots is None:
                return torch.full((T,), trash, dtype=torch.long,
                                  device=self.device)
            m = min(T, slots.shape[0])
            s = torch.where(slots[:m] >= 0, slots[:m], trash).long()
            if m < T:
                s = torch.cat([s, torch.full((T - m,), trash,
                                             dtype=torch.long,
                                             device=s.device)])
            return s
        if metadata.cross_segments is not None:
            return metadata.cross_segments
        if slots is None:
            return []
        n = int(metadata.num_seqs[0])
        cu = metadata.cu_q_lens[:n + 1].tolist()
        sl = slots[:n].tolist()
        return [(cu[i], cu[i + 1], sl[i]) for i in range(n)
                if cu[i + 1] > cu[i]]

    def _cross_block(self, layer: Dict[str, Any], h: torch.Tensor,
                     ck: torch.Tensor, cv: torch.Tensor,
                     clen: torch.Tensor, rows, trash: int) -> torch.Tensor:
        """One cross-attention layer (the JAX ``_cross_attn_block``) over
        the hidden rows [T, H]; ``rows``: ``_cross_rows``."""
        T = h.shape[0]
        nq, kvh, hd = self.num_heads, self.num_kv_heads, self.head_dim
        g = nq // kvh
        eps = self.rms_eps
        normed = rms_norm(h, layer["norm"], eps)
        q = self.m_q.apply(layer["q"], normed).reshape(T, nq, hd)
        q = rms_norm(q, layer["q_norm"], eps).to(ck.dtype)
        if isinstance(rows, torch.Tensor):
            # decode-shaped: each row its slot's K/V
            qb = q.view(T, kvh, g, hd)
            attn = self._attend(qb, ck[rows], cv[rows], clen[rows])
            attn = attn.reshape(T, nq * hd)
            slot_of = rows
        else:
            attn = torch.zeros(T, nq * hd, dtype=torch.float32,
                               device=h.device)
            slot_of = torch.full((T,), trash, dtype=torch.long,
                                 device=h.device)
            for a, b, slot in rows:
                if slot < 0:
                    continue
                slot_of[a:b] = slot
                for t0 in range(a, b, CROSS_Q_TILE):
                    t1 = min(b, t0 + CROSS_Q_TILE)
                    qs = q[t0:t1].view(t1 - t0, kvh, g, hd) \
                        .permute(1, 0, 2, 3).reshape(1, kvh, -1, hd)
                    o = self._attend(qs, ck[slot][None], cv[slot][None],
                                     clen[slot:slot + 1])
                    attn[t0:t1] = o.view(kvh, t1 - t0, g, hd) \
                        .permute(1, 0, 2, 3).reshape(t1 - t0, nq * hd)
        attn = self.m_o.apply(layer["o"], attn.to(self.dtype))
        has = (clen[slot_of] > 0)[:, None]
        zero = torch.zeros((), dtype=h.dtype, device=h.device)
        h = h + torch.where(has, (torch.tanh(layer["gate_attn"]) *
                                  attn.float()).to(h.dtype), zero)
        m = self._mlp(layer, rms_norm(h, layer["post_norm"], eps))
        return h + torch.where(has, (torch.tanh(layer["gate_mlp"]) *
                                     m.float()).to(h.dtype), zero)

    def forward(self, params: Dict[str, Any], token_ids: torch.Tensor,
                kv_pages, metadata: AttentionMetadata,
                collect_hidden: bool = False, collect_kv_stats: bool = False,
                input_embeds=None):
        """(logits [S, V] float32 at ``logits_indices``, kv_pages): the
        layers in their published order, self-attention ones over the KV
        pool (layer i of the pool is the i-th self layer), cross ones over
        the cross cache by the rows' slots (``metadata.seq_slots``)."""
        if collect_hidden:
            raise NotImplementedError(
                "the Mllama forward collects no hidden rows (no EAGLE3 "
                "draft head for an mllama target)")
        eps = self.rms_eps
        h = embed_tokens(params["embed"], token_ids, input_embeds, self.dtype)
        kv = kv_pages["kv"]
        ck, cv, clen = (kv_pages[n] for n in ("cross_k", "cross_v",
                                              "cross_len"))
        trash = clen.shape[0] - 1
        rows = self._cross_rows(metadata, h.shape[0], trash)
        L, P, ps = kv.shape[:3]
        kv_flat = kv.view((L * P,) + tuple(kv.shape[2:]))
        spec = self.attn_spec
        cos_sin = self._base_cos_sin(spec.rope, metadata)
        cross_at = {li: ci for ci, li in enumerate(self.cross_layers)}
        stats = []
        si = 0
        for li in range(self.text_layers):
            if li in cross_at:
                ci = cross_at[li]
                h = self._cross_block(params["cross"][ci], h, ck[ci], cv[ci],
                                      clen, rows, trash)
                continue
            layer = params["layers"][si]
            md_l = layer_metadata(metadata, si, P, ps, L)
            a = attention_block(layer, rms_norm(h, layer["input_norm"], eps),
                                kv_flat, md_l, spec, self.attn_methods,
                                rope_cos_sin=cos_sin,
                                kv_scale=layer.get("kv_scale", self.kv_scale),
                                collect_kv_stats=collect_kv_stats)
            if collect_kv_stats:
                a, stat = a
                stats.append(stat)
            h = h + a
            h = h + self._mlp(layer, rms_norm(h, layer["post_norm"], eps))
            si += 1
        last = rms_norm(h[metadata.logits_indices], params["final_norm"], eps)
        logits = self.m_lm_head.apply(params["lm_head"], last).float()
        if collect_kv_stats:
            return logits, kv_pages, torch.stack(stats)
        return logits, kv_pages


@register_input_processor("mllama")
class MllamaInputProcessor:
    """``pixel_values`` [n, tiles, 3, H, W], ``aspect_ratio_ids`` [n],
    ``aspect_ratio_mask`` [n, tiles] (transformers' MllamaImageProcessor
    outputs, one batch entry). The prompt stays text; the projected
    states ride the request to its admission (``cross_states``; JAX
    mllama.py:496-514)."""

    def __init__(self, model):
        self.model = model

    def __call__(self, token_ids: List[int], mm_data: Dict[str, Any]
                 ) -> Tuple[List[int], None, str, Dict[str, Any]]:
        px = mm_data["pixel_values"]
        states = self.model.encode_images(px, mm_data["aspect_ratio_ids"],
                                          mm_data["aspect_ratio_mask"])
        return list(token_ids), None, mm_hash(list(px)), \
            {"cross_states": states}
