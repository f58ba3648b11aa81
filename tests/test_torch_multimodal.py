"""The port's splice-only vision-language models (tensorrt_llm_tpu_torch/
multimodal/: llava, llava_next, mistral3, internvl) against the JAX
package on the CPU, float32, tiny seeded ``transformers`` models:

- the CLIP and SigLIP towers against the JAX ``VisionTower`` (2e-4, as
  tests/test_multimodal.py holds the JAX tower against transformers);
- each family's input processor: the same expanded ids, the same salt,
  feature rows to 2e-4 and NaN at the same rows;
- each family served through the port's ``LLM`` with a dict prompt
  (``prompt_token_ids`` + ``multi_modal_data``): greedy tokens equal to
  the JAX ``LLM``'s;
- a prompt chunked so that its last chunk is one image token (the step
  must still take the embedding, not replay a decode graph without it);
- the image hash in the reuse key: equal text beside different images
  shares no block, equal text and image do;
- ``n = 2``: the port's samples are equal; the JAX ``LLM`` submits its
  sibling without the image (llm.py:844-866), so its second sample is the
  no-image stream;
- the refusals: speculation, beam search and prompt logprobs with an
  image prompt.
"""
import numpy as np
import pytest
import torch

import tensorrt_llm_tpu as J
import tensorrt_llm_tpu_torch as T

IMAGE_TOKEN = 120
KV = dict(tokens_per_block=16, max_tokens=1024)
LLM_KW = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
              max_input_len=64, max_seq_len=128, max_num_tokens=256)


def _clip_cfg(**kw):
    from transformers import CLIPVisionConfig
    return CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=4,
                            image_size=16, patch_size=8, **kw)


def _text_cfg(**kw):
    from transformers import LlamaConfig
    base = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=256)
    base.update(kw)
    return LlamaConfig(**base)


def _llava():
    from transformers import LlavaConfig, LlavaForConditionalGeneration
    torch.manual_seed(0)
    cfg = LlavaConfig(vision_config=_clip_cfg(), text_config=_text_cfg(
        pad_token_id=0, eos_token_id=1, bos_token_id=2),
        image_token_index=IMAGE_TOKEN, vision_feature_layer=-2,
        vision_feature_select_strategy="default", pad_token_id=0)
    return LlavaForConditionalGeneration(cfg).eval()


def _llava_next():
    from transformers import (LlavaNextConfig,
                              LlavaNextForConditionalGeneration)
    torch.manual_seed(0)
    cfg = LlavaNextConfig(
        vision_config=_clip_cfg(projection_dim=32).to_dict(),
        text_config=_text_cfg().to_dict(), image_token_index=IMAGE_TOKEN,
        image_grid_pinpoints=[[16, 32], [32, 16], [32, 32]],
        vision_feature_layer=-2, vision_feature_select_strategy="default")
    return LlavaNextForConditionalGeneration(cfg).eval()


def _mistral3():
    from transformers import Mistral3Config, Mistral3ForConditionalGeneration
    torch.manual_seed(0)
    cfg = Mistral3Config(
        vision_config=dict(hidden_size=32, intermediate_size=64,
                           num_hidden_layers=2, num_attention_heads=4,
                           image_size=32, patch_size=8, num_channels=3,
                           head_dim=8, rope_theta=10000.0),
        text_config=_text_cfg().to_dict(), image_token_index=IMAGE_TOKEN,
        spatial_merge_size=2, vision_feature_layer=-1,
        multimodal_projector_bias=False)
    return Mistral3ForConditionalGeneration(cfg).eval()


def _internvl():
    from transformers import InternVLConfig, InternVLForConditionalGeneration
    torch.manual_seed(0)
    text = _text_cfg().to_dict()
    text["model_type"] = "qwen2"
    cfg = InternVLConfig(
        text_config=text,
        vision_config=dict(hidden_size=32, intermediate_size=64,
                           num_hidden_layers=2, num_attention_heads=4,
                           image_size=[16, 16], patch_size=[4, 4],
                           use_qk_norm=True),
        image_token_id=IMAGE_TOKEN, downsample_ratio=0.5,
        vision_feature_layer=-1, vision_feature_select_strategy="default")
    return InternVLForConditionalGeneration(cfg).eval()


def _mm_data(family, seed):
    """One image of the family's input form, from a seeded numpy rng."""
    rng = np.random.default_rng(seed)
    if family == "llava_next":
        # (20, 28) picks the 2x2 grid: a base view and four tiles, whose
        # features are unpadded to 20 x 28's aspect ratio
        tiles = rng.standard_normal((5, 3, 16, 16)).astype(np.float32)
        return {"image": [tiles], "image_sizes": [(20, 28)]}
    if family == "mistral3":
        return {"image": [rng.standard_normal((3, 32, 16))
                          .astype(np.float32)]}
    return {"image": [rng.standard_normal((3, 16, 16)).astype(np.float32)]}


FAMILIES = {"llava": _llava, "llava_next": _llava_next,
            "mistral3": _mistral3, "internvl": _internvl}


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    return request.param, FAMILIES[request.param]()


def _port(hf, **kw):
    return T.LLM(hf, device="cpu", kv_cache_config=T.KvCacheConfig(**KV),
                 **{**LLM_KW, **kw})


def _jax(hf, **kw):
    return J.LLM(model=hf, enable_warmup=False,
                 kv_cache_config=J.KvCacheConfig(**KV), **{**LLM_KW, **kw})


PROMPT = [5, 9, IMAGE_TOKEN, 23, 44, 17]


# --------------------------------------------------------------------- #
# towers
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("flavor", ["clip", "siglip"])
def test_vision_tower_matches_jax(flavor):
    """Both flavours against the JAX tower on the same weights: the last
    layer with and without the post-LayerNorm, and the penultimate one."""
    from tensorrt_llm_tpu.multimodal.encoders import VisionTower as JTower
    from tensorrt_llm_tpu_torch.multimodal.encoders import VisionTower
    if flavor == "clip":
        from transformers import CLIPVisionModel as Model
        cfg = _clip_cfg()
    else:
        from transformers import SiglipVisionConfig
        from transformers import SiglipVisionModel as Model
        cfg = SiglipVisionConfig(hidden_size=32, intermediate_size=64,
                                 num_hidden_layers=2, num_attention_heads=4,
                                 image_size=16, patch_size=8)
    torch.manual_seed(0)
    hf = Model(cfg).eval()
    sd = {"vision_model." + k: v for k, v in
          hf.vision_model.state_dict().items()}
    mine = VisionTower(cfg, flavor=flavor)
    params = mine.load_hf_state_dict(sd)
    jt = JTower(cfg, flavor=flavor)
    jparams = jt.load_hf_state_dict({k: v.numpy() for k, v in sd.items()})
    px = np.random.default_rng(0).standard_normal(
        (2, 3, 16, 16)).astype(np.float32)
    for layer, post in ((-1, False), (-1, True), (-2, False)):
        got = mine(params, torch.from_numpy(px), feature_layer=layer,
                   apply_post_ln=post).numpy()
        want = np.asarray(jt(jparams, px, feature_layer=layer,
                             apply_post_ln=post))
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    with torch.no_grad():
        ref = hf(torch.from_numpy(px), output_hidden_states=True)
    np.testing.assert_allclose(
        mine(params, torch.from_numpy(px), feature_layer=-2).numpy(),
        ref.hidden_states[-2].numpy(), rtol=2e-4, atol=2e-4)


# --------------------------------------------------------------------- #
# processors and serving, per family
# --------------------------------------------------------------------- #
def test_processor_rows_match_jax(family):
    """The processor's expanded ids, salt and rows: float32 features to
    2e-4, NaN (the token lookup) at the same rows."""
    from tensorrt_llm_tpu.models import ModelConfig as JConfig
    from tensorrt_llm_tpu.models import get_model_class as jget
    from tensorrt_llm_tpu.multimodal import create_input_processor as jproc
    from tensorrt_llm_tpu_torch.models import ModelConfig, get_model_class
    from tensorrt_llm_tpu_torch.multimodal import create_input_processor
    import jax.numpy as jnp
    name, hf = family
    sd = {k: v.detach().float() for k, v in hf.state_dict().items()}
    mine = get_model_class(name)(ModelConfig(
        hf_config=hf.config, dtype=torch.float32, device="cpu"))
    mine.load_hf_state_dict(sd)
    jm = jget(name)(JConfig(hf_config=hf.config, dtype=jnp.float32))
    jm.load_hf_state_dict({k: v.numpy() for k, v in sd.items()})
    mm = _mm_data(name, 3)
    ids, rows, salt = create_input_processor(mine)(PROMPT, mm)
    jids, jrows, jsalt = jproc(jm)(PROMPT, mm)[:3]
    assert ids == list(jids) and salt == jsalt
    rows = rows.numpy()
    np.testing.assert_array_equal(np.isnan(rows), np.isnan(jrows))
    np.testing.assert_allclose(rows, jrows, rtol=2e-4, atol=2e-4)


def test_llm_greedy_matches_jax_llm(family):
    """A dict prompt with one image through both ``LLM``s (float32,
    greedy): equal tokens, and the prompt expanded alike."""
    name, hf = family
    prompt = {"prompt_token_ids": PROMPT,
              "multi_modal_data": _mm_data(name, 4)}
    j = _jax(hf)
    try:
        want = j.generate(prompt, J.SamplingParams(max_tokens=8, top_k=1,
                                                   end_id=-1))
    finally:
        j.shutdown()
    llm = _port(hf)
    try:
        got = llm.generate(prompt, T.SamplingParams(max_tokens=8, top_k=1,
                                                    end_id=-1))
    finally:
        llm.shutdown()
    assert got.prompt_token_ids == list(want.prompt_token_ids)
    assert got.outputs[0].token_ids == want.outputs[0].token_ids
    assert len(got.outputs[0].token_ids) == 8


# --------------------------------------------------------------------- #
# the engine's embedding rows
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def llava():
    return _llava()


def test_one_token_image_chunk_takes_its_embedding(llava):
    """Chunks of 16 over a 17-token prompt whose last token is an image
    token: the second chunk is one token, which must run with its
    embedding row (an eager step) and not replay a decode step without
    it. Tokens equal the unchunked run's and the JAX ``LLM``'s."""
    image = _mm_data("llava", 5)
    ids = list(range(3, 16)) + [IMAGE_TOKEN]      # 13 text + 4 image = 17
    prompt = {"prompt_token_ids": ids, "multi_modal_data": image}
    sp = T.SamplingParams(max_tokens=6, top_k=1, end_id=-1)
    whole = _port(llava)
    try:
        want = whole.generate(prompt, sp).outputs[0].token_ids
    finally:
        whole.shutdown()
    chunked = _port(llava, max_num_tokens=16, enable_chunked_prefill=True)
    try:
        out = chunked.generate(prompt, sp)
        steps = chunked.engine.embed_steps
    finally:
        chunked.shutdown()
    assert len(out.prompt_token_ids) == 17
    assert steps == 2                      # both chunks carried their rows
    assert out.outputs[0].token_ids == want
    j = _jax(llava)
    try:
        jwant = j.generate(prompt, J.SamplingParams(
            max_tokens=6, top_k=1, end_id=-1)).outputs[0].token_ids
    finally:
        j.shutdown()
    assert want == jwant


def test_image_hash_keys_prefix_reuse(llava):
    """Image tokens share one id, so only the salt keeps two images
    apart: equal text beside another image reuses no block; the same text
    and image reuse every full block of the prompt."""
    text = list(range(3, 40))                  # 37 text + 4 image = 41
    a, b = _mm_data("llava", 6), _mm_data("llava", 7)
    sp = T.SamplingParams(max_tokens=2, top_k=1, end_id=-1)
    llm = _port(llava)
    try:
        def hit(mm):
            out = llm.generate({"prompt_token_ids": [IMAGE_TOKEN] + text,
                                "multi_modal_data": mm}, sp)
            return out._result.request.perf.kv_cache_hit_tokens
        assert hit(a) == 0
        assert hit(b) == 0                     # same text, other image
        assert hit(a) == 32                    # both full blocks of 41
    finally:
        llm.shutdown()


def test_n2_samples_carry_the_image(llava):
    """``n = 2`` greedy: the port's samples are equal and equal the single
    image request; the JAX ``LLM``'s second sample is the no-image
    stream (its sibling is submitted without the embeddings)."""
    image = _mm_data("llava", 1)
    prompt = {"prompt_token_ids": PROMPT, "multi_modal_data": image}
    llm = _port(llava)
    try:
        got = llm.generate(prompt, T.SamplingParams(max_tokens=8, top_k=1,
                                                    end_id=-1, n=2))
        single = llm.generate(prompt, T.SamplingParams(
            max_tokens=8, top_k=1, end_id=-1)).outputs[0].token_ids
    finally:
        llm.shutdown()
    toks = [o.token_ids for o in got.outputs]
    assert toks == [single, single]
    j = _jax(llava)
    try:
        jsp = J.SamplingParams(max_tokens=8, top_k=1, end_id=-1)
        jn2 = j.generate(prompt, J.SamplingParams(max_tokens=8, top_k=1,
                                                  end_id=-1, n=2))
        expanded = list(jn2.prompt_token_ids)
        no_image = j.generate(expanded, jsp).outputs[0].token_ids
    finally:
        j.shutdown()
    jt = [o.token_ids for o in jn2.outputs]
    assert jt[0] == single
    assert jt[1] == no_image != single


def test_image_prompts_refuse_what_takes_no_embeddings(llava):
    """prompt_logprobs: the JAX ValueError; beam search and speculation:
    refused by name (a drafter or a beam row would see token ids only)."""
    from tensorrt_llm_tpu_torch.llmapi.llm_args import (SpeculativeConfig,
                                                        check_ported_spec)
    prompt = {"prompt_token_ids": PROMPT,
              "multi_modal_data": _mm_data("llava", 2)}
    llm = _port(llava)
    try:
        with pytest.raises(ValueError, match="prompt_logprobs"):
            llm.generate_async(prompt, T.SamplingParams(max_tokens=2,
                                                        prompt_logprobs=1))
        with pytest.raises(NotImplementedError, match="beam search"):
            llm.generate_async(prompt, T.SamplingParams(
                max_tokens=2, use_beam_search=True, best_of=2, n=2))
    finally:
        llm.shutdown()
    for name in FAMILIES:
        with pytest.raises(NotImplementedError, match=name):
            check_ported_spec(SpeculativeConfig(mode="NGRAM",
                                                max_draft_len=2), name)


def test_the_other_multimodal_types_name_their_missing_piece():
    from tensorrt_llm_tpu_torch.models import get_model_class
    for name, piece in (("qwen2_vl", "M-RoPE"), ("gemma3", "group"),
                        ("mllama", "cross-attend")):
        with pytest.raises(NotImplementedError, match=piece):
            get_model_class(name)


def test_guided_decoding_on_an_image_prompt_matches_jax(llava):
    """Guided decoding (the device backend) takes an image prompt as any
    other: the same constrained greedy tokens as the JAX ``LLM``."""
    prompt = {"prompt_token_ids": PROMPT,
              "multi_modal_data": _mm_data("llava", 8)}
    kw = dict(guided_decoding_backend="dfa", guided_token_bytes="byte")

    def sp(mod):
        return mod.SamplingParams(
            max_tokens=8, top_k=1, end_id=0,
            guided_decoding=mod.GuidedDecodingParams(regex="[a-z]{5}"))
    j = _jax(llava, **kw)
    try:
        want = j.generate(prompt, sp(J)).outputs[0].token_ids
    finally:
        j.shutdown()
    llm = _port(llava, **kw)
    try:
        got = llm.generate(prompt, sp(T)).outputs[0].token_ids
    finally:
        llm.shutdown()
    assert got == want
    assert bytes(got[:5]).decode().isalpha() and len(got) >= 5
