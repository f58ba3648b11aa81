"""GLM-4.1V (glm4v) in the port (tensorrt_llm_tpu_torch/multimodal/
glm4v.py) against the JAX package on the CPU, float32, a tiny seeded
``transformers`` model (tests/torch_mrope_util.py):

- the bicubic sampler equal to the JAX copy and within 1e-5 of torch's
  ``grid_sample`` (bicubic, border, align_corners False);
- the tower within 1e-4 of the JAX tower on the table's native 4 x 4 grid
  and on grids it is resampled to;
- the prefill logits within 1e-4 (chunked M-RoPE sections over GLM's
  partial interleaved rotary; weights from the state dict and through
  ``from_jax_params``);
- through ``LLM.generate``: greedy tokens equal to the JAX ``LLM``'s at
  ``decode_multi_step=1`` and to transformers' greedy loop at the port's
  K = 8 windows, where the JAX K = 8 stream parts from its K = 1 one;
  ``n = 2`` samples equal the single request.
"""
import numpy as np
import pytest
import torch

import tensorrt_llm_tpu as J
import tensorrt_llm_tpu_torch as T
import torch_mrope_util as U

GRID = (1, 8, 8)


def test_bicubic_sampler_matches_jax_and_torch():
    import torch.nn.functional as F
    from tensorrt_llm_tpu.multimodal.glm4v import \
        grid_sample_bicubic as jsample
    from tensorrt_llm_tpu_torch.multimodal.glm4v import grid_sample_bicubic
    rng = np.random.default_rng(2)
    img = rng.standard_normal((6, 6, 5)).astype(np.float32)
    xs = rng.uniform(-1.5, 6.5, 40)
    ys = rng.uniform(-1.5, 6.5, 40)
    got = grid_sample_bicubic(img, xs, ys)
    np.testing.assert_array_equal(got, jsample(img, xs, ys))
    # torch's normalized grid (align_corners False): x = ((g + 1) W - 1) / 2
    gx, gy = (2 * xs + 1) / 6 - 1, (2 * ys + 1) / 6 - 1
    grid = torch.tensor(np.stack([gx, gy], -1)[None, None], dtype=torch.float32)
    ref = F.grid_sample(torch.from_numpy(img).permute(2, 0, 1)[None], grid,
                        mode="bicubic", padding_mode="border",
                        align_corners=False)[0, :, 0].T.numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    hf = U.hf_model("glm4v")
    return (hf,) + U.models(hf)


@pytest.mark.parametrize("grid", [(1, 4, 4), (1, 8, 8), (2, 6, 10)])
def test_tower_matches_jax(pair, grid):
    hf, jm, _, tm, _ = pair
    px = U.image(grid, 21)
    want = np.asarray(jm.encode_images(px, [grid]))
    got = tm.encode_images(torch.from_numpy(px), [grid]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


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
    data = U.mm(GRID, 22)
    jids, jrows, jsalt, jex = jproc(jm)(U.PROMPT, data)
    ids, rows, salt, ex = create_input_processor(tm)(U.PROMPT, data)
    assert ids == list(jids) and salt == jsalt
    np.testing.assert_array_equal(ex["mrope_positions"],
                                  jex["mrope_positions"])
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


@pytest.fixture(scope="module")
def sharp():
    return U.sharpen(U.hf_model("glm4v"))


def test_llm_greedy_matches_jax_and_transformers(sharp):
    data = U.mm(GRID, 23)
    prompt = {"prompt_token_ids": U.PROMPT, "multi_modal_data": data}
    llm = U.port_llm(sharp)
    try:
        out = llm.generate(prompt, T.SamplingParams(max_tokens=16, top_k=1,
                                                    end_id=-1))
        n2 = llm.generate(prompt, T.SamplingParams(max_tokens=16, top_k=1,
                                                   end_id=-1, n=2))
    finally:
        llm.shutdown()
    got = out.outputs[0].token_ids
    assert [o.token_ids for o in n2.outputs] == [got, got]
    streams = {}
    for K in (1, 8):
        j = U.jax_llm(sharp, decode_multi_step=K)
        try:
            streams[K] = U.greedy(j, J, prompt, 16)
        finally:
            j.shutdown()
    assert got == streams[1]
    assert got == U.hf_greedy(sharp, out.prompt_token_ids, data, 16)
    assert streams[8] != streams[1]
