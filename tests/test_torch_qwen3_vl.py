"""Qwen3-VL and Qwen3-VL-MoE in the port (tensorrt_llm_tpu_torch/multimodal/
qwen3_vl.py) against the JAX package on the CPU, float32, tiny seeded
``transformers`` models (tests/torch_mrope_util.py):

- the interleaved M-RoPE tables within 1e-6 of the JAX
  ``mrope_cos_sin_interleaved``, and plain RoPE's where the axes agree;
- the tower (learned positions interpolated to the grid, deepstack
  mergers) within 1e-4 of the JAX tower, on the table's own grid and on
  grids it is interpolated to;
- the prefill logits of both types within 1e-4 (the wide rows' deepstack
  columns added after the first layers; weights from the state dict and
  through ``from_jax_params``);
- through ``LLM.generate``: greedy tokens equal to the JAX ``LLM``'s at
  ``decode_multi_step=1`` and to transformers' greedy loop at the port's
  K = 8 windows; the JAX K = 8 stream parts from its K = 1 stream;
- an image prompt and a text prompt in one step (the text row's missing
  deepstack columns are NaN, read as 0) equal each served alone, and
  ``n = 2`` samples equal the single request.
"""
import numpy as np
import pytest
import torch

import tensorrt_llm_tpu as J
import tensorrt_llm_tpu_torch as T
import torch_mrope_util as U

GRID = (1, 8, 8)


@pytest.mark.parametrize("sections", [(3, 3, 2), (24, 20, 20)])
def test_interleaved_tables_match_jax(sections):
    import jax.numpy as jnp
    from tensorrt_llm_tpu.multimodal.qwen3_vl import \
        mrope_cos_sin_interleaved as jtab
    from tensorrt_llm_tpu.ops import rope as jrope
    from tensorrt_llm_tpu_torch.ops import rope as trope
    hd = 2 * sum(sections)
    rng = np.random.default_rng(1)
    pos3 = rng.integers(0, 5000, size=(3, 29)).astype(np.int32)
    # theta 1e6: at 5e6 the two packages' ``compute_inv_freq`` (XLA's and
    # torch's float32 pow) part by an ulp in one frequency, which moves
    # plain RoPE's tables as much (3e-6 at position 3,000)
    jc, js = jtab(jrope.RopeConfig(head_dim=hd, rope_theta=1e6),
                  jnp.asarray(pos3), sections)
    cfg = trope.RopeConfig(head_dim=hd, rope_theta=1e6)
    tc, ts = trope.mrope_cos_sin_interleaved(cfg, torch.from_numpy(pos3),
                                             sections)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    same = torch.from_numpy(np.repeat(pos3[:1], 3, axis=0))
    mc, ms = trope.mrope_cos_sin_interleaved(cfg, same, sections)
    rc, rs = trope.rope_cos_sin(cfg, torch.from_numpy(pos3[0]))
    assert torch.equal(mc, rc) and torch.equal(ms, rs)


@pytest.fixture(scope="module", params=["qwen3_vl", "qwen3_vl_moe"])
def pair(request):
    hf = U.hf_model(request.param)
    return (hf,) + U.models(hf)


@pytest.mark.parametrize("grid", [(1, 4, 4), (1, 8, 8), (2, 6, 10)])
def test_tower_with_deepstack_matches_jax(pair, grid):
    hf, jm, _, tm, _ = pair
    px = U.image(grid, 11)
    jmain, jds = jm.encode_images(px, [grid])
    main, ds = tm.encode_images(torch.from_numpy(px), [grid])
    np.testing.assert_allclose(main.numpy(), np.asarray(jmain), atol=1e-4)
    assert len(ds) == len(jds) == 2
    for got, want in zip(ds, jds):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("load", ["state_dict", "from_jax_params"])
def test_prefill_logits_match_jax(pair, load):
    import jax.numpy as jnp
    from tensorrt_llm_tpu.multimodal.processor import \
        create_input_processor as jproc
    from tensorrt_llm_tpu.ops import attention as jattn
    from tensorrt_llm_tpu_torch.multimodal import create_input_processor
    from tensorrt_llm_tpu_torch.ops import attention as tattn
    hf, jm, jp, tm, tp = pair
    if load == "from_jax_params":
        tm, tp = U.port_from_jax(hf, jm, jp)
    data = U.mm(GRID, 12)
    jids, jrows, _, jex = jproc(jm)(U.PROMPT, data)
    ids, rows, _, ex = create_input_processor(tm)(U.PROMPT, data)
    assert ids == list(jids) and rows.shape[1] == 64 * 3
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
    # the deepstack columns move the logits (they are not dropped)
    narrow, _ = tm.forward(tp, torch.tensor(ids), tm.make_kv_pages(16, 16),
                           U.metadata(tattn, torch.from_numpy, n,
                                      ex["mrope_positions"]),
                           input_embeds=rows[:, :64])
    assert (narrow - tl).abs().max() > 1e-3


@pytest.fixture(scope="module", params=["qwen3_vl", "qwen3_vl_moe"])
def sharp(request):
    return U.sharpen(U.hf_model(request.param))


def test_llm_greedy_matches_jax_and_transformers(sharp):
    data = U.mm(GRID, 13)
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
    streams = {}
    for K in (1, 8):
        j = U.jax_llm(sharp, decode_multi_step=K)
        try:
            streams[K] = U.greedy(j, J, prompt, 16)
        finally:
            j.shutdown()
    assert got == streams[1]
    assert got == U.hf_greedy(sharp, out.prompt_token_ids, data, 16)
    # the JAX window rotates at pos, not pos + mrope_delta
    assert streams[8] != streams[1]


def test_image_and_text_prompts_in_one_step(sharp):
    """Both prompts in one ``generate``: the text row has no rows of its
    own, so its deepstack columns are NaN-padded (read as 0); each
    stream equals its prompt served alone, and ``n = 2`` samples of the
    image prompt equal it too."""
    image = {"prompt_token_ids": U.PROMPT,
             "multi_modal_data": U.mm(GRID, 14)}
    text = list(range(7, 26))
    sp = T.SamplingParams(max_tokens=10, top_k=1, end_id=-1)
    llm = U.port_llm(sharp)
    try:
        both = llm.generate([image, text], sp)
        steps = llm.engine.embed_steps
        alone = [llm.generate(p, sp).outputs[0].token_ids
                 for p in (image, text)]
        n2 = llm.generate(image, T.SamplingParams(max_tokens=10, top_k=1,
                                                  end_id=-1, n=2))
    finally:
        llm.shutdown()
    assert steps == 1                     # one prefill step took both rows
    assert [o.outputs[0].token_ids for o in both] == alone
    assert [o.token_ids for o in n2.outputs] == [alone[0]] * 2
