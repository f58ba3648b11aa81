"""BERT encoder for sequence classification and reranking.

Port of ``tensorrt_llm_tpu/models/bert.py``
(``BertForSequenceClassification``): one bidirectional pass over a padded [B, L] batch, L the smallest length
bucket (32, 128, 512) that holds the longest row, outside the decoder
executor (no KV pool, no sampling, no CUDA graphs); ``LLM.classify``
drives it. The arithmetic is the JAX model's: each projection in the
model's type with the bias added after the product, attention scores and
softmax in float32 over the unpadded keys, exact GELU in float32,
LayerNorm with its weight and bias in float32 (``ops.norm.
layer_norm_f32``), the pooler's tanh and the classifier's logits in
float32. The JAX package leaves this attention to XLA and has no kernel
for it, so it stays plain PyTorch here (a [B, heads, L, L] float32 score
tensor a layer: 2.1 GB at B = 128, L = 512, 16 heads).

Parameters: wte [V, H], wpe [P, H], wtt [types, H], eln_w / eln_b,
layers[l] = {q_w, q_b, k_w, k_b, v_w, v_b, ao_w, ao_b, aln_w, aln_b, i_w,
i_b, o_w, o_b, oln_w, oln_b} with every weight [in, out], pool_w /
pool_b, cls_w [H, num_labels] / cls_b.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.norm import layer_norm_f32
from ..quantization.mode import KvCacheQuantAlgo, QuantAlgo
from .modeling_utils import ModelConfig, register_model

# the padded lengths a batch is run at (the JAX classify's buckets)
LENGTH_BUCKETS = (32, 128, 512)


@register_model("bert")
class BertForSequenceClassification:
    """Not a decoder: no paged KV, no sampling. The ``LLM`` sees
    ``is_encoder_only`` and serves ``classify`` instead of ``generate``."""
    architectures = ("BertForSequenceClassification",)
    is_encoder_only = True

    def __init__(self, model_config: ModelConfig):
        qc = model_config.quant_config
        if qc is not None and (
                getattr(qc, "quant_algo", QuantAlgo.NO_QUANT)
                != QuantAlgo.NO_QUANT or
                getattr(qc, "kv_cache_quant_algo", KvCacheQuantAlgo.NO_QUANT)
                != KvCacheQuantAlgo.NO_QUANT):
            raise NotImplementedError(
                "quant_config on a bert model is not supported by this "
                "package (the JAX package's BERT ignores it)")
        self.config = model_config
        self.hf = hf = model_config.hf_config
        self.dtype = model_config.dtype
        self.device = model_config.device
        self.hidden_size = hf.hidden_size
        self.num_heads = hf.num_attention_heads
        self.head_dim = self.hidden_size // self.num_heads
        self.num_layers = hf.num_hidden_layers
        self.intermediate_size = hf.intermediate_size
        self.eps = getattr(hf, "layer_norm_eps", 1e-12)
        self.num_labels = getattr(hf, "num_labels", 2)

    @property
    def vocab_size(self) -> int:
        return self.hf.vocab_size

    # ------------------------------------------------------------------ #
    # Parameters
    # ------------------------------------------------------------------ #
    def init_params(self, seed: int = 0) -> Dict[str, Any]:
        """Random weights (``load_format="dummy"`` or a bare config):
        normal(0, 0.02) matrices and embeddings, unit LayerNorm weights,
        zero biases, drawn on the model's device from a seeded
        ``torch.Generator`` (the JAX package draws a ``transformers``
        model under ``torch.manual_seed(0)`` instead)."""
        H, I, hf = self.hidden_size, self.intermediate_size, self.hf
        dev, dt = self.device, self.dtype
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def mat(*shape):
            return (torch.randn(shape, generator=gen, device=dev,
                                dtype=torch.float32) * 0.02).to(dt)

        def vec(n, fill=0.0):
            return torch.full((n,), fill, device=dev, dtype=dt)

        def layer():
            return {"q_w": mat(H, H), "q_b": vec(H), "k_w": mat(H, H),
                    "k_b": vec(H), "v_w": mat(H, H), "v_b": vec(H),
                    "ao_w": mat(H, H), "ao_b": vec(H),
                    "aln_w": vec(H, 1.0), "aln_b": vec(H),
                    "i_w": mat(H, I), "i_b": vec(I), "o_w": mat(I, H),
                    "o_b": vec(H), "oln_w": vec(H, 1.0), "oln_b": vec(H)}

        return {"wte": mat(hf.vocab_size, H),
                "wpe": mat(hf.max_position_embeddings, H),
                "wtt": mat(getattr(hf, "type_vocab_size", 2), H),
                "eln_w": vec(H, 1.0), "eln_b": vec(H),
                "layers": [layer() for _ in range(self.num_layers)],
                "pool_w": mat(H, H), "pool_b": vec(H),
                "cls_w": mat(H, self.num_labels),
                "cls_b": vec(self.num_labels)}

    def load_hf_state_dict(self, sd: Mapping[str, Any]) -> Dict[str, Any]:
        """HF ``BertForSequenceClassification`` names -> parameters on the
        model's device in its type; projections transposed to [in, out]."""
        dev, dt = self.device, self.dtype

        def a(name):
            return torch.as_tensor(sd[name]).to(device=dev, dtype=dt)

        def t(name):
            return a(name).t().contiguous()

        def layer(i):
            p = f"bert.encoder.layer.{i}."
            return {
                "q_w": t(p + "attention.self.query.weight"),
                "q_b": a(p + "attention.self.query.bias"),
                "k_w": t(p + "attention.self.key.weight"),
                "k_b": a(p + "attention.self.key.bias"),
                "v_w": t(p + "attention.self.value.weight"),
                "v_b": a(p + "attention.self.value.bias"),
                "ao_w": t(p + "attention.output.dense.weight"),
                "ao_b": a(p + "attention.output.dense.bias"),
                "aln_w": a(p + "attention.output.LayerNorm.weight"),
                "aln_b": a(p + "attention.output.LayerNorm.bias"),
                "i_w": t(p + "intermediate.dense.weight"),
                "i_b": a(p + "intermediate.dense.bias"),
                "o_w": t(p + "output.dense.weight"),
                "o_b": a(p + "output.dense.bias"),
                "oln_w": a(p + "output.LayerNorm.weight"),
                "oln_b": a(p + "output.LayerNorm.bias"),
            }

        return {
            "wte": a("bert.embeddings.word_embeddings.weight"),
            "wpe": a("bert.embeddings.position_embeddings.weight"),
            "wtt": a("bert.embeddings.token_type_embeddings.weight"),
            "eln_w": a("bert.embeddings.LayerNorm.weight"),
            "eln_b": a("bert.embeddings.LayerNorm.bias"),
            "layers": [layer(i) for i in range(self.num_layers)],
            "pool_w": t("bert.pooler.dense.weight"),
            "pool_b": a("bert.pooler.dense.bias"),
            "cls_w": t("classifier.weight"),
            "cls_b": a("classifier.bias"),
        }

    # ------------------------------------------------------------------ #
    # Forward
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def forward(self, params: Dict[str, Any], token_ids: torch.Tensor,
                mask: torch.Tensor, token_type: torch.Tensor
                ) -> torch.Tensor:
        """token_ids, mask (1 on real tokens), token_type: [B, L] ->
        float32 logits [B, num_labels]."""
        B, L = token_ids.shape
        nh, hd, dt, eps = self.num_heads, self.head_dim, self.dtype, self.eps
        h = params["wte"][token_ids] + params["wpe"][None, :L] + \
            params["wtt"][token_type]
        h = layer_norm_f32(h, params["eln_w"], params["eln_b"], eps)
        keep = (mask > 0)[:, None, None, :]
        floor = torch.finfo(torch.float32).min

        def lin(x, w, b):
            return x @ w + b

        for blk in params["layers"]:
            q = lin(h, blk["q_w"], blk["q_b"]).view(B, L, nh, hd)
            k = lin(h, blk["k_w"], blk["k_b"]).view(B, L, nh, hd)
            v = lin(h, blk["v_w"], blk["v_b"]).view(B, L, nh, hd)
            scores = torch.einsum("bthd,bshd->bhts", q.float(),
                                  k.float()) / math.sqrt(hd)
            probs = torch.softmax(scores.masked_fill(~keep, floor), -1)
            del scores
            o = torch.einsum("bhts,bshd->bthd", probs, v.float())
            o = lin(o.reshape(B, L, nh * hd).to(dt), blk["ao_w"],
                    blk["ao_b"])
            h = layer_norm_f32(h + o, blk["aln_w"], blk["aln_b"], eps)
            f = F.gelu(lin(h, blk["i_w"], blk["i_b"]).float()).to(dt)
            f = lin(f, blk["o_w"], blk["o_b"])
            h = layer_norm_f32(h + f, blk["oln_w"], blk["oln_b"], eps)
        pooled = torch.tanh((h[:, 0] @ params["pool_w"]).float()
                            + params["pool_b"].float())
        logits = (pooled.to(dt) @ params["cls_w"]).float() + \
            params["cls_b"].float()
        return logits

    def classify(self, params: Dict[str, Any],
                 batch_token_ids: Sequence[Sequence[int]],
                 token_type_ids: Optional[Sequence[Sequence[int]]] = None,
                 buckets: Tuple[int, ...] = LENGTH_BUCKETS) -> np.ndarray:
        """Pad every row to the batch's length bucket and run one pass:
        float32 [B, num_labels] on the host."""
        ids, mask, tt = self.pad_batch(batch_token_ids, token_type_ids,
                                       buckets)
        dev = self.device
        out = self.forward(params, *(torch.from_numpy(x).to(dev)
                                     for x in (ids, mask, tt)))
        return out.cpu().numpy()

    @staticmethod
    def pad_batch(batch_token_ids: Sequence[Sequence[int]],
                  token_type_ids: Optional[Sequence[Sequence[int]]] = None,
                  buckets: Tuple[int, ...] = LENGTH_BUCKETS
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(ids, mask, token types), int64 [B, L], L the first bucket that
        holds the longest row (the row's own length past the last)."""
        B = len(batch_token_ids)
        maxlen = max(len(x) for x in batch_token_ids)
        L = next((b for b in buckets if b >= maxlen), maxlen)
        ids = np.zeros((B, L), np.int64)
        mask = np.zeros((B, L), np.int64)
        tt = np.zeros((B, L), np.int64)
        for i, row in enumerate(batch_token_ids):
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
            if token_type_ids is not None:
                tt[i, :len(row)] = token_type_ids[i]
        return ids, mask, tt
