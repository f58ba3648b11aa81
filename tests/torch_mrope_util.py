"""Shared pieces of the M-RoPE parity tests (tests/test_torch_qwen2_vl.py,
test_torch_qwen3_vl.py, test_torch_glm4v.py): the tiny seeded
``transformers`` models of the five types (the JAX package's own test
configs: tests/test_qwen2_vl.py, test_qwen3_vl.py, test_glm4v.py), both
packages' models loaded from one state dict, seeded images, prefill
metadata for both packages, both ``LLM``s and transformers' greedy
loop."""
import numpy as np
import torch

import tensorrt_llm_tpu as J
import tensorrt_llm_tpu_torch as T

IMAGE, VIDEO, V_START, V_END = 151, 152, 153, 154
PROMPT = [1, 2, V_START, IMAGE, V_END, 3, 4]
KV = dict(tokens_per_block=16, max_tokens=1024)
LLM_KW = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
              max_input_len=96, max_seq_len=160, max_num_tokens=256)


def _text(**kw):
    base = dict(vocab_size=160, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=512,
                rope_theta=10000.0)
    base.update(kw)
    return base


def _patches(**kw):
    base = dict(patch_size=4, temporal_patch_size=2, spatial_merge_size=2,
                in_channels=3)
    base.update(kw)
    return base


def config(name: str):
    """The tiny config of model type ``name``."""
    import transformers as tf
    ids = dict(image_token_id=IMAGE, video_token_id=VIDEO,
               vision_start_token_id=V_START)
    if name == "qwen2_vl":
        return tf.Qwen2VLConfig(
            text_config=_text(rope_scaling={"rope_type": "default",
                                            "mrope_section": [2, 3, 3]}),
            vision_config=_patches(depth=2, embed_dim=32, num_heads=4,
                                   hidden_size=64, mlp_ratio=2),
            vision_end_token_id=V_END, **ids)
    if name == "qwen2_5_vl":
        return tf.Qwen2_5_VLConfig(
            text_config=_text(rope_scaling={"rope_type": "default",
                                            "mrope_section": [2, 3, 3]}),
            vision_config=_patches(depth=2, hidden_size=32,
                                   out_hidden_size=64, num_heads=4,
                                   intermediate_size=48, window_size=16,
                                   fullatt_block_indexes=[1]),
            vision_end_token_id=V_END, **ids)
    rs3 = {"rope_type": "default", "mrope_section": [3, 3, 2],
           "mrope_interleaved": True}
    vis3 = _patches(depth=3, hidden_size=32, out_hidden_size=64,
                    num_heads=4, intermediate_size=48,
                    deepstack_visual_indexes=[0, 1],
                    num_position_embeddings=16)
    if name == "qwen3_vl":
        return tf.Qwen3VLConfig(
            text_config=_text(num_hidden_layers=3, head_dim=16,
                              rope_scaling=rs3),
            vision_config=vis3, **ids)
    if name == "qwen3_vl_moe":
        # experts of 48 (2I = 96 is not H = 64, so the fused experts'
        # orientation is not ambiguous)
        return tf.Qwen3VLMoeConfig(
            text_config=_text(num_hidden_layers=3, head_dim=16,
                              moe_intermediate_size=48, num_experts=4,
                              num_experts_per_tok=2, decoder_sparse_step=1,
                              norm_topk_prob=True, rope_scaling=rs3),
            vision_config=vis3, **ids)
    if name == "glm4v":
        return tf.Glm4vConfig(
            text_config=_text(partial_rotary_factor=0.5,
                              rope_scaling={"rope_type": "default",
                                            "mrope_section": [2, 1, 1]}),
            vision_config=_patches(depth=2, hidden_size=32,
                                   out_hidden_size=64, num_heads=4,
                                   intermediate_size=48, image_size=16,
                                   attention_bias=True),
            image_token_id=IMAGE, video_token_id=VIDEO,
            image_start_token_id=V_START, image_end_token_id=V_END)
    raise ValueError(name)


def hf_model(name: str, seed: int = 0):
    """The seeded ``transformers`` model of type ``name`` (the class the
    port model names in ``hf_class``)."""
    import transformers
    from tensorrt_llm_tpu_torch.models import get_model_class
    torch.manual_seed(seed)
    return getattr(transformers, get_model_class(name).hf_class)(
        config(name)).eval()


def sharpen(hf, scale: float = 8.0):
    """Scale the text trunk's q and k projections by ``scale``, in place:
    the seeded model's attention is near uniform, so that a rotation at
    the wrong position seldom moves its argmax; at 8x it does (the JAX
    window fault then shows on every image the tests draw)."""
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if "language_model" in name and ("q_proj" in name
                                             or "k_proj" in name):
                p.mul_(scale)
    return hf


def models(hf):
    """(JAX model, its params, port model, its params) from ``hf``'s
    float32 state dict."""
    import jax.numpy as jnp
    from tensorrt_llm_tpu.models import ModelConfig as JConfig
    from tensorrt_llm_tpu.models import get_model_class as jget
    from tensorrt_llm_tpu_torch.models import ModelConfig, get_model_class
    name = hf.config.model_type
    sd = {k: v.detach().float() for k, v in hf.state_dict().items()}
    jm = jget(name)(JConfig(hf_config=hf.config, dtype=jnp.float32))
    jp = jm.load_hf_state_dict({k: v.numpy() for k, v in sd.items()})
    tm = get_model_class(name)(ModelConfig(
        hf_config=hf.config, dtype=torch.float32, device="cpu"))
    tp = tm.load_hf_state_dict(sd)
    return jm, jp, tm, tp


def port_from_jax(hf, jm, jp):
    """The port model of ``hf``'s type with the JAX model's trunk and tower
    carried over (``from_jax_params(..., vision=...)``)."""
    import jax
    from tensorrt_llm_tpu_torch.models import (ModelConfig,
                                               from_jax_params,
                                               get_model_class)
    tm = get_model_class(hf.config.model_type)(ModelConfig(
        hf_config=hf.config, dtype=torch.float32, device="cpu"))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), model=tm,
                         vision=jax.tree.map(np.asarray, jm._vision_params))
    return tm, tp


def image(grid, seed: int) -> np.ndarray:
    """Flattened patches [t*h*w, 3*2*4*4] of a (t, h, w) grid."""
    t, h, w = grid
    return np.random.default_rng(seed).standard_normal(
        (t * h * w, 3 * 2 * 4 * 4)).astype(np.float32)


def mm(grid, seed: int) -> dict:
    return {"image": [image(grid, seed)], "image_grid_thw": [grid]}


def metadata(mod, tensor, T: int, positions_mrope=None, start: int = 0):
    """One sequence's step of T tokens from ``start`` on pages 0..7 of
    16 (either package's ``AttentionMetadata``)."""
    pos = np.arange(start, start + T, dtype=np.int32)
    pages = np.zeros((2, 8), np.int32)
    pages[0] = np.arange(8)
    kw = {} if positions_mrope is None else {
        "positions_mrope": tensor(np.asarray(positions_mrope, np.int32))}
    return mod.AttentionMetadata(
        kv_lens=tensor(np.asarray([start + T, 0], np.int32)),
        page_indices=tensor(pages),
        cu_q_lens=tensor(np.asarray([0, T, T], np.int32)),
        num_seqs=tensor(np.asarray([1], np.int32)),
        slot_mapping=tensor(pos), positions=tensor(pos),
        logits_indices=tensor(np.asarray([T - 1, 0], np.int32)), **kw)


def port_llm(hf, **kw):
    return T.LLM(hf, device="cpu", kv_cache_config=T.KvCacheConfig(**KV),
                 **{**LLM_KW, **kw})


def jax_llm(hf, **kw):
    return J.LLM(model=hf, enable_warmup=False,
                 kv_cache_config=J.KvCacheConfig(**KV), **{**LLM_KW, **kw})


def greedy(llm, mod, prompt, n: int, **sp) -> list:
    """One prompt's greedy tokens through ``llm`` (either package)."""
    out = llm.generate(prompt, mod.SamplingParams(max_tokens=n, top_k=1,
                                                  end_id=-1, **sp))
    return out.outputs[0].token_ids


def hf_greedy(hf, ids, data, n: int) -> list:
    """transformers' greedy loop over the expanded prompt ``ids``."""
    px = torch.from_numpy(np.concatenate(data["image"]))
    grid = torch.tensor(data["image_grid_thw"])
    cur = torch.tensor([ids])
    out = []
    with torch.no_grad():
        for _ in range(n):
            logits = hf(input_ids=cur, pixel_values=px,
                        image_grid_thw=grid).logits[0, -1]
            nxt = int(torch.argmax(logits))
            out.append(nxt)
            cur = torch.cat([cur, torch.tensor([[nxt]])], dim=1)
    return out
