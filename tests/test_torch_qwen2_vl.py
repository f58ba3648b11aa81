"""Qwen2-VL and Qwen2.5-VL in the port (tensorrt_llm_tpu_torch/multimodal/
qwen2_vl.py) against the JAX package on the CPU, float32, tiny seeded
``transformers`` models (tests/torch_mrope_util.py):

- the M-RoPE tables (chunked sections, and GLM-4.1V's over its partial
  rotary half) within 1e-6 of the JAX ``mrope_cos_sin``, and plain RoPE's
  where the three axes agree (what the decode windows rely on);
- ``qwen2vl_rope_index`` and ``get_window_index`` exactly;
- both towers within 1e-4 of the JAX towers, the prefill logits of both
  types within 1e-4 (weights from the state dict and through
  ``from_jax_params``);
- through ``LLM.generate`` on image prompts: greedy tokens equal to the
  JAX ``LLM``'s at ``decode_multi_step=1`` and to transformers' greedy
  loop at the port's default K = 8 windows;
- the JAX window fault: its K = 8 stream parts from its own K = 1 stream
  (the window rotates at pos, not pos + mrope_delta), where the port's
  streams are equal;
- ``n = 2``, a chunked image prompt, a reused image prefix under its
  salt, a text-only prompt equal to the plain Qwen2 trunk;
- refusals by name: speculation on the five M-RoPE types, beam search on
  an image prompt.
"""
import numpy as np
import pytest
import torch

import tensorrt_llm_tpu as J
import tensorrt_llm_tpu_torch as T
import torch_mrope_util as U

GRID = (1, 8, 8)          # 16 merged tokens: mrope_delta = -12


# --------------------------------------------------------------------- #
# tables and host-side indices
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("sections,partial,neox", [
    ((2, 3, 3), 1.0, True), ((16, 24, 24), 1.0, True),
    ((2, 1, 1), 0.5, False), ((8, 12, 12), 0.5, False)])
def test_mrope_tables_match_jax(sections, partial, neox):
    import jax.numpy as jnp
    from tensorrt_llm_tpu.ops import rope as jrope
    from tensorrt_llm_tpu_torch.ops import rope as trope
    hd = int(2 * sum(sections) / partial)
    kw = dict(head_dim=hd, rope_theta=1e6, partial_rotary_factor=partial,
              is_neox=neox)
    rng = np.random.default_rng(0)
    pos3 = rng.integers(0, 3000, size=(3, 37)).astype(np.int32)
    jc, js = jrope.mrope_cos_sin(jrope.RopeConfig(**kw), jnp.asarray(pos3),
                                 sections)
    tc, ts = trope.mrope_cos_sin(trope.RopeConfig(**kw),
                                 torch.from_numpy(pos3), sections)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    # equal axes: plain RoPE's tables at that position
    same = np.repeat(pos3[:1], 3, axis=0)
    mc, ms = trope.mrope_cos_sin(trope.RopeConfig(**kw),
                                 torch.from_numpy(same), sections)
    rc, rs = trope.rope_cos_sin(trope.RopeConfig(**kw),
                                torch.from_numpy(pos3[0]))
    assert torch.equal(mc, rc) and torch.equal(ms, rs)


@pytest.mark.parametrize("grids", [[(1, 8, 8)], [(1, 4, 6), (2, 6, 4)],
                                   [(1, 10, 14)]])
def test_rope_index_and_window_index_match_jax(grids):
    from tensorrt_llm_tpu.multimodal.qwen2_vl import \
        Qwen25VisionTower as JTower
    from tensorrt_llm_tpu.multimodal.qwen2_vl import \
        qwen2vl_rope_index as jindex
    from tensorrt_llm_tpu_torch.multimodal.qwen2_vl import (
        get_window_index, qwen2vl_rope_index)
    ids = [5, 9]
    for t, h, w in grids:
        ids += [U.V_START] + [U.IMAGE] * (t * h * w // 4) + [U.V_END, 7]
    want_mp, want_delta = jindex(ids, U.IMAGE, grids, 2)
    got_mp, got_delta = qwen2vl_rope_index(ids, U.IMAGE, grids, 2)
    assert got_delta == want_delta
    np.testing.assert_array_equal(got_mp, want_mp)
    jt = JTower.__new__(JTower)
    jt.merge, jt.window, jt.patch = 2, 16, 4
    for got, want in zip(get_window_index(grids, 16, 2, 4),
                         jt.get_window_index(grids)):
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------- #
# towers and prefill
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module", params=["qwen2_vl", "qwen2_5_vl"])
def pair(request):
    hf = U.hf_model(request.param)
    return (hf,) + U.models(hf)


@pytest.mark.parametrize("grid", [(1, 8, 8), (2, 4, 12), (1, 10, 14)])
def test_tower_matches_jax(pair, grid):
    """(1, 10, 14): Qwen2.5-VL's windows of 2 x 2 merge groups do not
    tile the 5 x 7 grid, so they come in 4, 2 and 1 groups."""
    hf, jm, _, tm, _ = pair
    px = U.image(grid, 3)
    want = np.asarray(jm.encode_images(px, [grid]))
    got = tm.encode_images(torch.from_numpy(px), [grid]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.abs(want).max() > 1e-2


@pytest.mark.parametrize("load", ["state_dict", "from_jax_params"])
def test_prefill_logits_match_jax(pair, load):
    """The processor's ids, salt, rows and M-RoPE extras, then one
    prefill step over them: logits within 1e-4 of the JAX model's."""
    import jax.numpy as jnp
    from tensorrt_llm_tpu.multimodal.processor import \
        create_input_processor as jproc
    from tensorrt_llm_tpu.ops import attention as jattn
    from tensorrt_llm_tpu_torch.multimodal import create_input_processor
    from tensorrt_llm_tpu_torch.ops import attention as tattn
    hf, jm, jp, tm, tp = pair
    if load == "from_jax_params":
        tm, tp = U.port_from_jax(hf, jm, jp)
    data = U.mm(GRID, 4)
    jids, jrows, jsalt, jex = jproc(jm)(U.PROMPT, data)
    ids, rows, salt, ex = create_input_processor(tm)(U.PROMPT, data)
    assert ids == list(jids) and salt == jsalt
    assert ex["mrope_delta"] == jex["mrope_delta"] == -12
    np.testing.assert_array_equal(ex["mrope_positions"],
                                  jex["mrope_positions"])
    np.testing.assert_array_equal(np.isnan(rows.numpy()), np.isnan(jrows))
    np.testing.assert_allclose(rows.numpy(), jrows, atol=1e-4)
    n = len(ids)
    jl, _ = jm.forward(jp, jnp.asarray(ids, jnp.int32),
                       jm.make_kv_pages(16, 16),
                       U.metadata(jattn, jnp.asarray, n,
                                  jex["mrope_positions"]),
                       input_embeds=jnp.asarray(jrows))
    tl, _ = tm.forward(tp, torch.tensor(ids), tm.make_kv_pages(16, 16),
                       U.metadata(tattn, torch.from_numpy, n,
                                  ex["mrope_positions"]),
                       input_embeds=rows)
    np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0], atol=1e-4)


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module", params=["qwen2_vl", "qwen2_5_vl"])
def sharp(request):
    return U.sharpen(U.hf_model(request.param))


def test_llm_greedy_matches_jax_and_transformers(sharp):
    """Image prompt, 16 greedy tokens: the port at its default K = 8
    windows (two windows after the prefill) equals the JAX ``LLM`` at
    ``decode_multi_step=1`` and transformers' greedy loop."""
    data = U.mm(GRID, 5)
    prompt = {"prompt_token_ids": U.PROMPT, "multi_modal_data": data}
    llm = U.port_llm(sharp)
    try:
        out = llm.generate(prompt, T.SamplingParams(max_tokens=16, top_k=1,
                                                    end_id=-1))
        windows = llm.engine.window_steps
    finally:
        llm.shutdown()
    got = out.outputs[0].token_ids
    assert windows > 0
    j = U.jax_llm(sharp, decode_multi_step=1)
    try:
        want = U.greedy(j, J, prompt, 16)
    finally:
        j.shutdown()
    assert got == want
    assert got == U.hf_greedy(sharp, out.prompt_token_ids, data, 16)


def test_jax_window_drops_the_offset_and_the_port_keeps_it(sharp):
    """The JAX decode window builds its metadata without
    ``positions_mrope`` (runtime/model_engine.py:684-702), so it rotates
    at pos where its single steps rotate at pos + mrope_delta: its K = 8
    stream parts from its K = 1 stream. The port's K = 8 windows rotate
    at pos + delta[slot]: its two streams are equal."""
    prompt = {"prompt_token_ids": U.PROMPT,
              "multi_modal_data": U.mm(GRID, 6)}
    streams = {}
    for K in (1, 8):
        j = U.jax_llm(sharp, decode_multi_step=K)
        try:
            streams["jax", K] = U.greedy(j, J, prompt, 16)
        finally:
            j.shutdown()
        llm = U.port_llm(sharp, decode_multi_step=K)
        try:
            streams["port", K] = U.greedy(llm, T, prompt, 16)
        finally:
            llm.shutdown()
    assert streams["jax", 8] != streams["jax", 1]
    assert streams["port", 8] == streams["port", 1] == streams["jax", 1]


def test_n2_samples_carry_the_image_and_its_positions(sharp):
    """``n = 2`` greedy: both samples equal the single request (each
    sibling carries the rows, ``mrope_positions`` and ``mrope_delta``).
    The JAX ``LLM`` sets the processor's extras on its first request
    only and submits the sibling without the rows (llm.py:834-866): its
    second sample parts from the first."""
    prompt = {"prompt_token_ids": U.PROMPT,
              "multi_modal_data": U.mm(GRID, 7)}
    llm = U.port_llm(sharp)
    try:
        single = U.greedy(llm, T, prompt, 12)
        got = llm.generate(prompt, T.SamplingParams(max_tokens=12, top_k=1,
                                                    end_id=-1, n=2))
    finally:
        llm.shutdown()
    assert [o.token_ids for o in got.outputs] == [single, single]
    j = U.jax_llm(sharp, decode_multi_step=1)
    try:
        jn2 = j.generate(prompt, J.SamplingParams(max_tokens=12, top_k=1,
                                                  end_id=-1, n=2))
    finally:
        j.shutdown()
    jt = [o.token_ids for o in jn2.outputs]
    assert jt[0] == single != jt[1]


def test_chunked_image_prompt_equals_whole(sharp):
    """A 37-token image prompt in chunks of 16: each chunk's positions
    read the prompt's M-RoPE grid at its own offsets."""
    ids = list(range(3, 20)) + [U.V_START, U.IMAGE, U.V_END] + [5, 6]
    prompt = {"prompt_token_ids": ids, "multi_modal_data": U.mm(GRID, 8)}
    whole = U.port_llm(sharp)
    try:
        want = U.greedy(whole, T, prompt, 10)
    finally:
        whole.shutdown()
    chunked = U.port_llm(sharp, max_num_tokens=16,
                         enable_chunked_prefill=True)
    try:
        out = chunked.generate(prompt, T.SamplingParams(
            max_tokens=10, top_k=1, end_id=-1))
        steps = chunked.engine.embed_steps
    finally:
        chunked.shutdown()
    assert len(out.prompt_token_ids) == 37 and steps == 3
    assert out.outputs[0].token_ids == want


def test_reused_image_prefix_under_its_salt(sharp):
    """The same image and text again reuse every full block (their
    positions come from the request's grid, not the cache), another image
    beside the same text reuses none; tokens equal a fresh engine's."""
    text = list(range(3, 30))
    a, b = U.mm(GRID, 9), U.mm(GRID, 10)

    def prompt(data):
        return {"prompt_token_ids": [U.V_START, U.IMAGE, U.V_END] + text,
                "multi_modal_data": data}
    sp = T.SamplingParams(max_tokens=10, top_k=1, end_id=-1)
    llm = U.port_llm(sharp)
    try:
        outs = [llm.generate(prompt(d), sp) for d in (a, b, a)]
    finally:
        llm.shutdown()
    hits = [o._result.request.perf.kv_cache_hit_tokens for o in outs]
    assert hits == [0, 0, 32]                  # 46 tokens: 2 full blocks
    assert outs[2].outputs[0].token_ids == outs[0].outputs[0].token_ids
    fresh = U.port_llm(sharp)
    try:
        assert U.greedy(fresh, T, prompt(b), 10) == \
            outs[1].outputs[0].token_ids
    finally:
        fresh.shutdown()


def test_text_prompt_equals_the_plain_trunk(sharp):
    """A prompt without an image: delta 0, every axis at p, which is
    plain RoPE; the tokens equal the Qwen2 trunk's served alone."""
    from transformers import Qwen2Config, Qwen2ForCausalLM
    tc = sharp.config.text_config
    cfg = Qwen2Config(**{k: getattr(tc, k) for k in (
        "vocab_size", "hidden_size", "intermediate_size",
        "num_hidden_layers", "num_attention_heads", "num_key_value_heads",
        "max_position_embeddings", "rope_theta", "rms_norm_eps")},
        tie_word_embeddings=False)
    trunk = Qwen2ForCausalLM(cfg).eval()
    sd = {}
    for k, v in sharp.state_dict().items():
        if k.startswith("model.language_model."):
            sd["model." + k[len("model.language_model."):]] = v
        elif k == "lm_head.weight":
            sd[k] = v
    trunk.load_state_dict(sd, strict=True)
    ids = list(range(5, 30))
    outs = []
    for hf in (sharp, trunk):
        llm = U.port_llm(hf)
        try:
            outs.append(U.greedy(llm, T, ids, 16))
        finally:
            llm.shutdown()
    assert outs[0] == outs[1]


# --------------------------------------------------------------------- #
# registry and refusals
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["qwen2_vl", "qwen2_5_vl", "qwen3_vl",
                                  "qwen3_vl_moe", "glm4v"])
def test_mrope_types_are_served(name):
    """The five types the port refused by name until now: each a port
    model with M-RoPE and an input processor of its own."""
    from tensorrt_llm_tpu_torch.models import ModelConfig, get_model_class
    from tensorrt_llm_tpu_torch.multimodal import create_input_processor
    m = get_model_class(name)(ModelConfig(hf_config=U.config(name),
                                          dtype=torch.float32, device="cpu"))
    assert m.uses_mrope and type(m).__module__.startswith(
        "tensorrt_llm_tpu_torch.multimodal")
    assert create_input_processor(m) is not None


@pytest.mark.parametrize("name", ["qwen2_vl", "qwen2_5_vl", "qwen3_vl",
                                  "qwen3_vl_moe", "glm4v"])
@pytest.mark.parametrize("mode", ["NGRAM", "EAGLE3"])
def test_speculation_on_mrope_types_refused_by_name(name, mode):
    from tensorrt_llm_tpu_torch.llmapi.llm_args import (SpeculativeConfig,
                                                        check_ported_spec)
    with pytest.raises(NotImplementedError, match=name):
        check_ported_spec(SpeculativeConfig(mode=mode, max_draft_len=2),
                          name)


def test_beam_search_on_an_image_prompt_refused_by_name(pair):
    hf = pair[0]
    llm = U.port_llm(hf)
    try:
        with pytest.raises(NotImplementedError, match="beam search"):
            llm.generate_async(
                {"prompt_token_ids": U.PROMPT,
                 "multi_modal_data": U.mm(GRID, 2)},
                T.SamplingParams(max_tokens=2, use_beam_search=True,
                                 best_of=2, n=2))
    finally:
        llm.shutdown()
