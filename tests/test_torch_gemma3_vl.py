"""The port's image-group vision-language models (tensorrt_llm_tpu_torch/
multimodal/gemma3_vl.py, paligemma.py) and the prefill kernel's image-group
or-mask against the JAX package on the CPU, float32, tiny seeded
``transformers`` models (the configs of tests/test_gemma3_vl.py):

- K2's plain version (``ragged_paged_attention`` on the CPU) and the
  port's ``_reference_attention`` with groups against the JAX
  ``_reference_attention`` (1e-5), on a global and a sliding layer, with
  an image cut by the chunk edge and with PaliGemma's whole-prompt group,
  through a layer's view of the flat all-layers pool; a grouped one-token
  step goes to the prefill kernel, not the decode kernel;
- the towers and projectors (2e-5), each model's prefill logits (1e-4)
  against the JAX forward and transformers;
- ``LLM.generate`` greedy tokens against the JAX ``LLM`` and transformers;
- the reference faults (ROADMAP C): the JAX Gemma 3 forward multiplies
  the image rows by sqrt(hidden), transformers does not (the tests' models
  draw the projection, which transformers initialises to zero, so the
  image rows are not zero); a decode window's appends leave the group pool
  as it was in the JAX forward and write -1 in the port's;
- an image cut by a prefill chunk edge: served as the JAX package serves
  it, which transformers' one-pass prefill does not reproduce;
- the weights carried across (``from_jax_params``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorrt_llm_tpu as J
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu.models import ModelConfig as JConfig
from tensorrt_llm_tpu.models import get_model_class as jmodel
from tensorrt_llm_tpu.multimodal.processor import \
    create_input_processor as jproc
from tensorrt_llm_tpu.ops import attention as jattn
from tensorrt_llm_tpu_torch.models import (ModelConfig, from_jax_params,
                                           get_model_class)
from tensorrt_llm_tpu_torch.multimodal import create_input_processor
from tensorrt_llm_tpu_torch.ops import attention as pattn
from tests.test_gemma3_vl import tiny_cfg

IMAGE = 255
KV = dict(tokens_per_block=16, max_tokens=1024)
LLM_KW = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
              max_input_len=96, max_seq_len=128, max_num_tokens=256)


# --------------------------------------------------------------------- #
# the or-mask in K2's plain version and the reference
# --------------------------------------------------------------------- #
def _grouped_case(name):
    """(q_lens, kv_lens, groups of every position of each sequence,
    window): the new tokens are each sequence's last q_len positions."""
    if name == "global":
        seqs = [(9, 9, [-1, -1, 0, 0, 0, 0, -1, -1, -1]),
                (6, 14, [-1] * 3 + [0] * 5 + [-1, 1, 1, 1, -1, -1]),
                (1, 5, [-1, 0, 0, 0, 0])]
        return seqs, None
    if name == "sliding":
        seqs = [(12, 12, [-1, 0, 0, 0, 0, 0, 0, 0, -1, -1, -1, -1]),
                (10, 16, [-1] * 6 + [0] * 7 + [-1] * 3)]
        return seqs, 4
    if name == "chunk_cut":
        # a chunk edge inside the image: the first chunk's image rows end
        # at kv_len (the rest is not written yet), the second chunk's rows
        # see the first chunk's image positions through the pool
        img = [-1, -1] + [0] * 8 + [-1, -1]
        return [(6, 6, img[:6]), (6, 12, img)], 4
    # PaliGemma: the whole prompt in group 0, sliding layer
    return [(11, 11, [0] * 11), (4, 15, [0] * 11 + [-1] * 4)], 4


def _grouped_inputs(name, seed=0):
    seqs, window = _grouped_case(name)
    ps, qh, kvh, hd, L = 4, 4, 2, 16, 2
    P = 16                                   # pages of each layer
    rng = np.random.default_rng(seed)
    S = len(seqs)
    pages = -(-max(kv for _, kv, _ in seqs) // ps)
    page_indices = np.zeros((S, pages), np.int32)
    pool_groups = np.full(P * ps, -1, np.int32)
    free = list(rng.permutation(np.arange(1, P)))
    cu = [0]
    q_groups, slots = [], []
    for s, (q_len, kv_len, groups) in enumerate(seqs):
        for j in range(-(-kv_len // ps)):
            page_indices[s, j] = free.pop()
        for p in range(kv_len):
            slot = page_indices[s, p // ps] * ps + p % ps
            pool_groups[slot] = groups[p]
        for p in range(kv_len - q_len, kv_len):
            q_groups.append(groups[p])
            slots.append(page_indices[s, p // ps] * ps + p % ps)
        cu.append(cu[-1] + q_len)
    Tn = cu[-1]
    q = rng.standard_normal((Tn, qh, hd)).astype(np.float32)
    pool = rng.standard_normal((L * P, ps, 2 * kvh, hd)).astype(np.float32)
    kv_lens = np.asarray([kv for _, kv, _ in seqs], np.int32)
    return dict(q=q, pool=pool, page_indices=page_indices,
                cu=np.asarray(cu, np.int32), kv_lens=kv_lens,
                q_groups=np.asarray(q_groups, np.int32), slots=slots,
                pool_groups=pool_groups, window=window, P=P, ps=ps, L=L,
                max_q=max(q for q, _, _ in seqs))


def _port_md(x, grouped=True):
    i32 = dict(dtype=torch.int32)
    Tn = x["q"].shape[0]
    md = pattn.AttentionMetadata(
        kv_lens=torch.tensor(x["kv_lens"]),
        page_indices=torch.tensor(x["page_indices"]),
        cu_q_lens=torch.tensor(x["cu"]),
        num_seqs=torch.tensor([len(x["kv_lens"])], **i32),
        slot_mapping=torch.tensor(x["slots"], **i32),
        positions=torch.zeros(Tn, **i32),
        logits_indices=torch.zeros(len(x["kv_lens"]), dtype=torch.long),
        max_q_len=x["max_q"], mm_groups_q=torch.tensor(x["q_groups"]),
        mm_group_pool=torch.tensor(x["pool_groups"]), mm_grouped=grouped)
    # layer 1's view of the flat all-layers pool: page ids offset by P
    return pattn.layer_metadata(md, 1, x["P"], x["ps"], x["L"])


@pytest.mark.parametrize("name", ["global", "sliding", "chunk_cut",
                                  "paligemma_prefix"])
def test_k2_plain_with_groups_matches_jax_reference(name):
    """The or-mask: a same-group pair is visible past the diagonal and
    outside the window, never past kv_len, through the modulo of the
    group pool under layer 1's page offset (1e-5, float32)."""
    x = _grouped_inputs(name)
    md = _port_md(x)
    scale = 0.25
    got = pattn.ragged_paged_attention(
        torch.tensor(x["q"]), torch.tensor(x["pool"]), md, sm_scale=scale,
        sliding_window=x["window"])
    ref = pattn._reference_attention(
        torch.tensor(x["q"]), torch.tensor(x["pool"]), md, sm_scale=scale,
        sliding_window=x["window"])
    jmd = jattn.AttentionMetadata(
        kv_lens=jnp.asarray(x["kv_lens"]),
        page_indices=jnp.asarray(md.page_indices.numpy()),
        cu_q_lens=jnp.asarray(x["cu"]),
        num_seqs=jnp.asarray([len(x["kv_lens"])], jnp.int32),
        slot_mapping=jnp.asarray(md.slot_mapping.numpy()),
        positions=jnp.zeros(x["q"].shape[0], jnp.int32),
        logits_indices=jnp.zeros(len(x["kv_lens"]), jnp.int32),
        mm_groups_q=jnp.asarray(x["q_groups"]),
        mm_group_pool=jnp.asarray(x["pool_groups"]))
    want = np.asarray(jattn._reference_attention(
        jnp.asarray(x["q"]), jnp.asarray(x["pool"]), jmd, sm_scale=scale,
        sliding_window=x["window"], soft_cap=None, k_scale=None,
        v_scale=None))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ref.numpy(), want, rtol=1e-5, atol=1e-5)
    # the groups matter: the causal mask alone gives another answer
    causal = pattn.ragged_paged_attention(
        torch.tensor(x["q"]), torch.tensor(x["pool"]),
        dataclasses.replace(md, mm_groups_q=None, mm_group_pool=None,
                            mm_grouped=False),
        sm_scale=scale, sliding_window=x["window"])
    assert np.abs(causal.numpy() - want).max() > 1e-2


def test_one_token_grouped_step_goes_to_the_prefill_kernel(monkeypatch):
    """A decode-shaped step whose one row carries a group (an image's last
    token alone in its chunk, on a sliding layer) takes the prefill
    kernel's or-mask; the same step without the host flag takes the
    decode kernel."""
    x = _grouped_inputs("global")
    # sequence 2 alone: one query row in group 0 at position 4
    x2 = dict(x, cu=np.asarray([0, 0, 0, 1], np.int32), max_q=1)
    x2["q"] = x["q"][-1:]
    x2["q_groups"] = x["q_groups"][-1:]
    x2["slots"] = x["slots"][-1:]
    calls = []
    from tensorrt_llm_tpu_torch.ops import attention as mod
    real = mod.ragged_prefill_attention
    monkeypatch.setattr(mod, "ragged_prefill_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    md = _port_md(x2)
    got = pattn.ragged_paged_attention(torch.tensor(x2["q"]),
                                       torch.tensor(x["pool"]), md,
                                       sm_scale=0.25, sliding_window=2)
    ref = pattn._reference_attention(torch.tensor(x2["q"]),
                                     torch.tensor(x["pool"]), md,
                                     sm_scale=0.25, sliding_window=2)
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    pattn.ragged_paged_attention(
        torch.tensor(x2["q"]), torch.tensor(x["pool"]),
        dataclasses.replace(md, mm_grouped=False), sm_scale=0.25,
        sliding_window=2)
    assert calls == [1]


# --------------------------------------------------------------------- #
# the models
# --------------------------------------------------------------------- #
def _paligemma_cfg():
    from transformers import Gemma2Config, PaliGemmaConfig, SiglipVisionConfig
    vis = SiglipVisionConfig(hidden_size=32, intermediate_size=64,
                             num_hidden_layers=2, num_attention_heads=4,
                             image_size=16, patch_size=4, projection_dim=48)
    txt = Gemma2Config(vocab_size=260, hidden_size=48, intermediate_size=96,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_key_value_heads=2, head_dim=16,
                       query_pre_attn_scalar=16, sliding_window=8,
                       max_position_embeddings=256)
    return PaliGemmaConfig(vision_config=vis.to_dict(),
                           text_config=txt.to_dict(), image_token_index=255,
                           projection_dim=48)


def _hf(name):
    import transformers as tf
    torch.manual_seed(0)
    if name == "gemma3":
        hf = tf.Gemma3ForConditionalGeneration(tiny_cfg()).eval()
        with torch.no_grad():
            # transformers initialises the projection to zero, which would
            # make every image row zero
            hf.model.multi_modal_projector.mm_input_projection_weight \
                .normal_(0, 0.3)
            hf.model.multi_modal_projector.mm_soft_emb_norm.weight \
                .normal_(0, 0.1)
    else:
        hf = tf.PaliGemmaForConditionalGeneration(_paligemma_cfg()).eval()
    return hf


class _Pair:
    def __init__(self, name):
        self.name = name
        self.hf = _hf(name)
        cfg = self.hf.config
        self.sd = {k: v.detach().float().numpy()
                   for k, v in self.hf.state_dict().items()}
        self.jm = jmodel(name)(JConfig(hf_config=cfg, dtype=jnp.float32))
        self.jp = self.jm.load_hf_state_dict(self.sd)
        self.m = get_model_class(name)(ModelConfig(
            hf_config=cfg, dtype=torch.float32, device="cpu"))
        self.p = self.m.load_hf_state_dict(
            {k: torch.tensor(v) for k, v in self.sd.items()})
        self.img = torch.randn(1, 3, 16, 16, generator=torch.Generator()
                               .manual_seed(1))


@pytest.fixture(scope="module")
def gemma3():
    return _Pair("gemma3")


@pytest.fixture(scope="module")
def paligemma():
    return _Pair("paligemma")


@pytest.fixture(scope="module", params=["gemma3", "paligemma"])
def pair(request, gemma3, paligemma):
    return gemma3 if request.param == "gemma3" else paligemma


def _jax_rows(pair, rows):
    """The JAX package's image rows as the port (and transformers) enter
    them: the JAX Gemma 3 forward multiplies them by sqrt(hidden), so they
    go in divided by it (ROADMAP C)."""
    if pair.name == "gemma3":
        return rows / np.sqrt(pair.m.hidden_size)
    return rows


def _hf_logits(pair, ids):
    with torch.no_grad():
        kw = {}
        if pair.name == "gemma3":
            kw["token_type_ids"] = torch.tensor(
                [[1 if t == IMAGE else 0 for t in ids]])
        return pair.hf(input_ids=torch.tensor([ids]), pixel_values=pair.img,
                       **kw).logits[0].numpy()


def _port_prefill(pair, ids, rows, groups, params=None):
    n = len(ids)
    i32 = dict(dtype=torch.int32)
    md = pattn.AttentionMetadata(
        kv_lens=torch.tensor([n], **i32),
        page_indices=torch.arange(8, **i32)[None],
        cu_q_lens=torch.tensor([0, n], **i32),
        num_seqs=torch.tensor([1], **i32),
        slot_mapping=torch.arange(n, **i32), positions=torch.arange(n, **i32),
        logits_indices=torch.arange(n), max_q_len=n,
        mm_groups_q=torch.as_tensor(groups), mm_grouped=True)
    logits, _ = pair.m.forward(params or pair.p, torch.tensor(ids),
                               pair.m.make_kv_pages(8, 16), md,
                               input_embeds=rows)
    return logits.numpy()


PROMPTS = {"gemma3": [2, 5, 253, IMAGE, 254, 7, 9],
           "paligemma": [2, 5, IMAGE, 7, 9]}


def test_processor_and_tower_match_jax(pair):
    """Expanded ids, groups, salt and the image rows (2e-5)."""
    mm = {"image": [pair.img[0].numpy()]}
    ids, rows, salt, extra = create_input_processor(pair.m)(
        PROMPTS[pair.name], mm)
    jids, jrows, jsalt, jextra = jproc(pair.jm)(PROMPTS[pair.name], mm)
    assert ids == list(jids) and salt == jsalt
    np.testing.assert_array_equal(extra["mm_group_ids"],
                                  jextra["mm_group_ids"])
    rows = rows.numpy()
    np.testing.assert_array_equal(np.isnan(rows), np.isnan(jrows))
    np.testing.assert_allclose(rows, jrows, rtol=2e-5, atol=2e-5)
    assert np.abs(np.nan_to_num(rows)).max() > 1e-2


def test_prefill_logits_match_jax_and_transformers(pair):
    """Every prompt position's logits: the port against the JAX forward
    (its image rows divided back for Gemma 3) and transformers (1e-4)."""
    mm = {"image": [pair.img[0].numpy()]}
    ids, rows, _, extra = create_input_processor(pair.m)(
        PROMPTS[pair.name], mm)
    got = _port_prefill(pair, ids, rows, extra["mm_group_ids"])
    from tests.test_models import make_prefill_metadata
    jmd = dataclasses.replace(
        make_prefill_metadata(pair.jm, len(ids)),
        mm_groups_q=jnp.asarray(extra["mm_group_ids"]),
        logits_indices=jnp.arange(len(ids), dtype=jnp.int32))
    jl, _ = pair.jm.forward(pair.jp, jnp.asarray(ids, jnp.int32),
                            pair.jm.make_kv_pages(16, 16), jmd,
                            input_embeds=jnp.asarray(
                                _jax_rows(pair, rows.numpy())))
    np.testing.assert_allclose(got, np.asarray(jl), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, _hf_logits(pair, ids), rtol=1e-4,
                               atol=1e-4)


def test_jax_gemma3_scales_image_rows_where_transformers_does_not(gemma3):
    """Reference fault (ROADMAP C): the JAX Gemma 3 forward multiplies the
    image rows by sqrt(hidden) with the looked-up rows; transformers'
    Gemma3Model splices them after its scaled lookup. The port follows
    transformers."""
    pair = gemma3
    ids, rows, _, extra = create_input_processor(pair.m)(
        PROMPTS["gemma3"], {"image": [pair.img[0].numpy()]})
    from tests.test_models import make_prefill_metadata
    jmd = dataclasses.replace(
        make_prefill_metadata(pair.jm, len(ids)),
        mm_groups_q=jnp.asarray(extra["mm_group_ids"]))
    jl, _ = pair.jm.forward(pair.jp, jnp.asarray(ids, jnp.int32),
                            pair.jm.make_kv_pages(16, 16), jmd,
                            input_embeds=jnp.asarray(rows.numpy()))
    ref = _hf_logits(pair, ids)[-1]
    got = _port_prefill(pair, ids, rows, extra["mm_group_ids"])[-1]
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    assert np.abs(np.asarray(jl)[0] - ref).max() > 1e-2


def _jax_llm(pair, **kw):
    j = J.LLM(model=pair.hf, kv_cache_config=J.KvCacheConfig(**KV),
              **dict(LLM_KW, **kw))
    if pair.name == "gemma3":
        enc = j.model.encode_images
        scale = np.sqrt(pair.m.hidden_size)
        j.model.encode_images = lambda px: np.asarray(enc(px)) / scale
    return j


def _greedy_hf(pair, ids, n):
    out = []
    cur = list(ids)
    for _ in range(n):
        nxt = int(np.argmax(_hf_logits(pair, cur)[-1]))
        out.append(nxt)
        cur.append(nxt)
    return out


def test_llm_greedy_matches_jax_llm_and_transformers(pair):
    """A dict prompt with one image through both ``LLM``s (greedy, 8
    tokens): equal tokens, equal to transformers' greedy continuation
    (which re-runs the whole sequence each step)."""
    prompt = {"prompt_token_ids": PROMPTS[pair.name],
              "multi_modal_data": {"image": [pair.img[0].numpy()]}}
    j = _jax_llm(pair)
    try:
        want = j.generate(prompt, J.SamplingParams(max_tokens=8, top_k=1,
                                                   end_id=-1))
    finally:
        j.shutdown()
    llm = T.LLM(pair.hf, device="cpu", kv_cache_config=T.KvCacheConfig(**KV),
                **LLM_KW)
    try:
        got = llm.generate(prompt, T.SamplingParams(max_tokens=8, top_k=1,
                                                    end_id=-1))
        grouped = llm.engine.grouped_steps
    finally:
        llm.shutdown()
    assert got.prompt_token_ids == list(want.prompt_token_ids)
    assert got.outputs[0].token_ids == want.outputs[0].token_ids
    assert grouped >= 1
    if pair.name == "gemma3":
        # PaliGemma's transformers prefix mask covers the generated tokens
        # too when it re-runs the whole sequence, so only its first token
        # is a like-for-like check (test_prefill_logits_...)
        assert got.outputs[0].token_ids == _greedy_hf(
            pair, got.prompt_token_ids, 8)


def test_image_cut_by_a_chunk_edge_serves_as_jax(gemma3):
    """Chunked prefill (64-token chunks) with the image across the edge:
    the first chunk's image rows cannot see the image's later rows (not
    written yet; kv_len bounds the or-mask), as in the JAX package, whose
    scheduler cuts images too (ROADMAP C). The port and the JAX ``LLM``
    agree; transformers' one-pass prefill sees the whole image, and the
    first token's log-probabilities show the cut."""
    pair = gemma3
    rng = np.random.default_rng(3)
    text = rng.integers(10, 250, 60).tolist()
    ids = [2] + text + [253, IMAGE, 254, 7, 9]        # image at 62..65
    prompt = {"prompt_token_ids": ids,
              "multi_modal_data": {"image": [pair.img[0].numpy()]}}
    sp = dict(max_tokens=4, top_k=1, end_id=-1, logprobs=3)
    runs = {}
    for chunk in (64, 256):
        j = _jax_llm(pair, max_num_tokens=chunk)
        try:
            jo = j.generate(prompt, J.SamplingParams(**sp))
        finally:
            j.shutdown()
        llm = T.LLM(pair.hf, device="cpu",
                    kv_cache_config=T.KvCacheConfig(**KV),
                    **dict(LLM_KW, max_num_tokens=chunk))
        try:
            po = llm.generate(prompt, T.SamplingParams(**sp))
        finally:
            llm.shutdown()
        assert po.outputs[0].token_ids == jo.outputs[0].token_ids
        got = po.outputs[0].logprobs[0]
        want = jo.outputs[0].logprobs[0]
        assert set(got) == set(want)
        for t in got:
            assert abs(got[t] - want[t]) < 1e-4
        runs[chunk] = got
    full = _hf_logits(pair, po.prompt_token_ids)[-1]
    lp = full - np.log(np.exp(full - full.max()).sum()) - full.max()
    for t, v in runs[256].items():
        assert abs(lp[t] - v) < 1e-4                 # one pass: transformers
    assert max(abs(lp[t] - v) for t, v in runs[64].items()) > 1e-3


def test_windows_write_no_group_where_the_jax_forward_keeps_the_old(gemma3):
    """A decode window's appends carry no groups: the port's forward
    writes -1 at their slots, the JAX forward (no ``mm_groups_q``) leaves
    the slots' previous groups, which an image row of a later request
    would read through the or-mask (ROADMAP C)."""
    pair = gemma3
    slots = torch.tensor([3, 17], dtype=torch.int32)
    i32 = dict(dtype=torch.int32)
    md = pattn.AttentionMetadata(
        kv_lens=torch.tensor([4, 2], **i32),
        page_indices=torch.tensor([[0], [1]], **i32),
        cu_q_lens=torch.tensor([0, 1, 2], **i32),
        num_seqs=torch.tensor([2], **i32), slot_mapping=slots,
        positions=torch.tensor([3, 1], **i32),
        logits_indices=torch.arange(2), max_q_len=1)
    cache = pair.m.make_kv_pages(4, 16)
    cache["mm_group"].fill_(0)              # a previous owner's image
    pair.m.forward(pair.p, torch.tensor([5, 7]), cache, md)
    assert cache["mm_group"][slots.long()].tolist() == [-1, -1]
    assert int((cache["mm_group"] == 0).sum()) == 4 * 16 - 2
    jcache = pair.jm.make_kv_pages(4, 16)
    jcache["mm_group"] = jnp.zeros_like(jcache["mm_group"])
    jmd = jattn.AttentionMetadata(
        kv_lens=jnp.asarray([4, 2], jnp.int32),
        page_indices=jnp.asarray([[0], [1]], jnp.int32),
        cu_q_lens=jnp.asarray([0, 1, 2], jnp.int32),
        num_seqs=jnp.asarray([2], jnp.int32),
        slot_mapping=jnp.asarray(slots.numpy()),
        positions=jnp.asarray([3, 1], jnp.int32),
        logits_indices=jnp.arange(2, dtype=jnp.int32))
    _, jcache = pair.jm.forward(pair.jp, jnp.asarray([5, 7], jnp.int32),
                                jcache, jmd)
    assert np.asarray(jcache["mm_group"])[slots.numpy()].tolist() == [0, 0]


def test_vswa_kv8_and_gemma1_text_refused(pair):
    """VSWA and an 8-bit KV cache are refused by name on both types (the
    group pool follows the one pool; the or-mask takes pools of the
    model's type), a Gemma-1 text config on PaliGemma as JAX refuses
    it."""
    from tensorrt_llm_tpu_torch.llmapi.llm_args import QuantConfig
    from tensorrt_llm_tpu_torch.quantization.mode import KvCacheQuantAlgo
    with pytest.raises(NotImplementedError, match="VSWA"):
        pair.m.enable_vswa(8)
    with pytest.raises(NotImplementedError, match="8-bit KV"):
        get_model_class(pair.name)(ModelConfig(
            hf_config=pair.hf.config, dtype=torch.float32, device="cpu",
            quant_config=QuantConfig(
                kv_cache_quant_algo=KvCacheQuantAlgo.FP8)))
    if pair.name == "gemma3":
        return
    from transformers import GemmaConfig
    cfg = _paligemma_cfg()
    cfg.text_config = GemmaConfig(vocab_size=260, hidden_size=48,
                                  intermediate_size=96, num_hidden_layers=1,
                                  num_attention_heads=4,
                                  num_key_value_heads=2, head_dim=16)
    with pytest.raises(NotImplementedError, match="gemma2"):
        get_model_class("paligemma")(ModelConfig(
            hf_config=cfg, dtype=torch.float32, device="cpu"))


def test_weights_carried_across_from_jax(pair):
    """``from_jax_params`` with the tower and projector trees: the same
    logits as the checkpoint-loaded model."""
    m = get_model_class(pair.name)(ModelConfig(
        hf_config=pair.hf.config, dtype=torch.float32, device="cpu"))
    import jax
    np_tree = jax.tree.map(np.asarray, pair.jp)
    params = from_jax_params(
        np_tree, model=m,
        vision=jax.tree.map(np.asarray, pair.jm._vision_params),
        projector=jax.tree.map(np.asarray, pair.jm._projector))
    mm = {"image": [pair.img[0].numpy()]}
    ids, rows, _, extra = create_input_processor(m)(PROMPTS[pair.name], mm)
    want_ids, want_rows, _, _ = create_input_processor(pair.m)(
        PROMPTS[pair.name], mm)
    assert ids == want_ids
    np.testing.assert_allclose(rows.numpy(), want_rows.numpy(), rtol=1e-6,
                               atol=1e-6)
    got = _port_prefill(pair, ids, rows, extra["mm_group_ids"],
                        params=params)
    want = _port_prefill(pair, ids, want_rows, extra["mm_group_ids"])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
