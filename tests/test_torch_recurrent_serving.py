"""Serving a recurrent family with the port's ``LLM`` (CPU): the engine's
slot-indexed state pools, what the ``LLM`` turns off or refuses, and the
surfaces that must carry a recurrent state.

- The engine makes the state pools [layers, max_batch_size + 1, ...]
  (the last slot the trash slot) with the KV pool, counts their bytes,
  and keeps their addresses through serving (the steps write them in
  place, which captured graphs need); chunked prefill, block reuse and
  rider windows are off.
- Speculative decoding of every mode on every recurrent type is refused
  by name. Reference fault: the JAX package's NGRAM on a tiny Mamba parts
  from greedy decoding at a rejected draft (a verify step writes every
  drafted token into the slot's state).
- Beam search copies a forked row's state with its pages: the port's
  beams on a tiny Mamba are plain beam search's on the ``transformers``
  model; ``n > 1`` samples take slots of their own.
- Prompt log-probabilities (evaluate/perplexity.py) run their chunks
  through one slot of their own and equal the ``transformers`` model's.
- An 8-bit KV cache and quantized weights are refused by name.
"""
import numpy as np
import pytest
import torch

from tests import torch_recurrent_util as U

RECURRENT = ["mamba", "falcon_mamba", "mamba2", "bamba", "jamba", "zamba2",
             "granitemoehybrid", "lfm2", "qwen3_next", "minimax"]
MODES = ["NGRAM", "SA", "AUTO", "USER_PROVIDED", "DRAFT_TARGET", "PARD",
         "EAGLE3", "MTP"]


def _mamba(scale=1.0, seed=0):
    from transformers import MambaConfig, MambaForCausalLM
    cfg = MambaConfig(vocab_size=96, hidden_size=64, state_size=8,
                      num_hidden_layers=2, conv_kernel=4, expand=2,
                      time_step_rank=4)
    hf = U.random_hf(cfg, MambaForCausalLM, seed)
    if scale != 1.0:
        with torch.no_grad():
            for n, p in hf.named_parameters():
                if any(k in n for k in ("embeddings", "in_proj",
                                        "out_proj")):
                    p.mul_(scale)
    return hf


def _hf_greedy(hf, prompt, n):
    ids = list(prompt)
    with torch.no_grad():
        for _ in range(n):
            ids.append(int(torch.argmax(hf(torch.tensor([ids])).logits[0,
                                                                    -1])))
    return ids[len(prompt):]


def test_engine_state_pools():
    from tests.test_torch_hybrid import _configs
    cfg, cls = _configs()["jamba"]
    hf = U.random_hf(cfg, cls)
    llm = U.port_llm(hf, max_batch_size=3, mixed_window_ctx=64,
                     enable_chunked_prefill=True)
    try:
        e = llm.engine
        pools = e.kv_pages
        assert set(pools) == {"kv", "conv_state", "ssm_state"}
        # one attention layer of 8; 7 mamba layers of 3 slots + trash
        assert pools["kv"].shape[0] == 1
        assert pools["conv_state"].shape[:2] == (7, 4)
        assert pools["ssm_state"].shape[:2] == (7, 4)
        assert e.recurrent_state_bytes() == sum(
            p.numel() * 4 for k, p in pools.items() if k != "kv")
        assert not e.riders_ok
        assert not llm.args.enable_chunked_prefill
        assert not llm.args.kv_cache_config.enable_block_reuse
        ptrs = [p.data_ptr() for p in pools.values()]
        outs = llm.generate([[3, 4, 5, 6, 7], [9, 8, 7]], U.greedy(4))
        assert [len(o.outputs[0].token_ids) for o in outs] == [4, 4]
        assert [p.data_ptr() for p in e.kv_pages.values()] == ptrs
        assert float(pools["ssm_state"][:, :3].abs().sum()) > 0
    finally:
        llm.shutdown()


@pytest.mark.parametrize("mode", MODES)
def test_speculation_refused_by_name_every_mode(mode):
    from tensorrt_llm_tpu_torch.llmapi.llm_args import (SpeculativeConfig,
                                                        check_ported_spec)
    with pytest.raises(NotImplementedError, match="mamba.*recurrent"):
        check_ported_spec(SpeculativeConfig(mode=mode, max_draft_len=2),
                          "mamba")


@pytest.mark.parametrize("model_type", RECURRENT)
def test_speculation_refused_by_name_every_type(model_type):
    from tensorrt_llm_tpu_torch.llmapi.llm_args import (SpeculativeConfig,
                                                        check_ported_spec)
    from tensorrt_llm_tpu_torch.models import MODEL_REGISTRY
    assert model_type in MODEL_REGISTRY
    with pytest.raises(NotImplementedError, match=model_type):
        check_ported_spec(SpeculativeConfig(mode="NGRAM", max_draft_len=3),
                          model_type)


def test_llm_refuses_speculation_on_a_recurrent_target():
    from tensorrt_llm_tpu_torch import SpeculativeConfig
    with pytest.raises(NotImplementedError, match="mamba"):
        U.port_llm(_mamba(), speculative_config=SpeculativeConfig(
            mode="NGRAM", max_draft_len=3))


def test_jax_ngram_on_mamba_parts_from_greedy():
    """Reference fault (finding of this port): on a tiny Mamba with
    scaled weights, the JAX LLM's NGRAM tokens part from greedy decoding
    (the ``transformers`` model's, and the port's without speculation)
    once a draft is rejected: the verify step left the rejected tokens in
    the slot's state."""
    import tensorrt_llm_tpu as J
    from tensorrt_llm_tpu.llmapi.llm_args import SpeculativeConfig
    hf = _mamba(scale=20.0)
    prompt = [3, 3, 7, 3, 3, 7, 3, 3, 7, 3]
    want = _hf_greedy(hf, prompt, 12)
    llm = U.port_llm(hf)
    try:
        assert llm.generate(prompt, U.greedy(12)).outputs[0].token_ids \
            == want
    finally:
        llm.shutdown()
    jllm = J.LLM(model=hf, skip_tokenizer_init=True, dtype="float32",
                 max_batch_size=4, max_input_len=32, max_seq_len=64,
                 max_num_tokens=128, enable_warmup=False,
                 kv_cache_config=J.KvCacheConfig(tokens_per_block=16,
                                                 max_tokens=512),
                 speculative_config=SpeculativeConfig(mode="NGRAM",
                                                      max_draft_len=3))
    try:
        got = jllm.generate(prompt, J.SamplingParams(
            max_tokens=12, top_k=1, end_id=-1)).outputs[0].token_ids
    finally:
        jllm.shutdown()
    assert got != want
    first = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    assert got[:first] == want[:first]


def _reference_beam(hf, prompt, width, n, steps):
    """Plain beam search on the ``transformers`` model (no EOS, length
    penalty 0)."""
    beams = [([], 0.0)]
    for _ in range(steps):
        cands = []
        for toks, score in beams:
            with torch.no_grad():
                logits = hf(torch.tensor([prompt + toks])).logits[0, -1]
            lp = torch.log_softmax(logits.float(), -1)
            vals, ids = torch.topk(lp, width)
            cands += [(score + float(v), toks + [int(i)])
                      for v, i in zip(vals, ids)]
        cands.sort(key=lambda c: -c[0])
        beams = [(t, s) for s, t in cands[:width]]
    return beams[:n]


@pytest.mark.parametrize("width,n", [(2, 2), (3, 2)])
def test_beam_search_copies_the_state(width, n):
    """The port's beams on a tiny Mamba equal plain beam search on the
    ``transformers`` model: a fork copies the source row's slot state
    (``ModelEngine.copy_slot_states``), and forks happened."""
    from tensorrt_llm_tpu_torch import SamplingParams
    hf = _mamba(scale=3.0, seed=2)
    prompt = [5, 9, 23, 44, 17]
    llm = U.port_llm(hf, max_beam_width=4, max_batch_size=4)
    try:
        out = llm.generate(prompt, SamplingParams(
            max_tokens=6, use_beam_search=True, best_of=width, n=n,
            length_penalty=0.0))
        forks = llm.executor.beam_forks
    finally:
        llm.shutdown()
    want = _reference_beam(hf, prompt, width, n, 6)
    assert [o.token_ids for o in out.outputs] == [w[0] for w in want]
    np.testing.assert_allclose([o.cumulative_logprob for o in out.outputs],
                               [w[1] for w in want], atol=1e-4, rtol=0)
    assert forks > 0


def test_n_samples_take_slots_of_their_own():
    """``n = 3`` greedy samples on two slots: each is the greedy
    stream."""
    from tensorrt_llm_tpu_torch import SamplingParams
    hf = _mamba(seed=4)
    prompt = [11, 12, 13, 14]
    llm = U.port_llm(hf, max_batch_size=2)
    try:
        out = llm.generate(prompt, SamplingParams(max_tokens=5, top_k=1,
                                                  end_id=-1, n=3))
    finally:
        llm.shutdown()
    want = _hf_greedy(hf, prompt, 5)
    assert [o.token_ids for o in out.outputs] == [want] * 3


def test_prompt_logprobs_use_one_slot():
    """Teacher-forced log-probabilities in chunks shorter than the prompt
    (the state carried from chunk to chunk) equal the ``transformers``
    model's."""
    from tensorrt_llm_tpu_torch.evaluate.perplexity import (
        score_token_logprobs)
    hf = _mamba(seed=5)
    llm = U.port_llm(hf)
    try:
        toks = list(range(3, 40))
        got = score_token_logprobs(llm.model, llm.engine.params, toks,
                                   chunk=8)
    finally:
        llm.shutdown()
    with torch.no_grad():
        lp = torch.log_softmax(hf(torch.tensor([toks])).logits[0].float(),
                               -1)
    want = lp[:-1].gather(1, torch.tensor(toks[1:])[:, None])[:, 0]
    np.testing.assert_allclose(got, want.numpy(), atol=2e-4, rtol=0)


@pytest.mark.parametrize("what", ["kv_int8", "weights_w8a16"])
def test_quantization_refused_by_name(what):
    from tensorrt_llm_tpu_torch import QuantConfig
    from tensorrt_llm_tpu_torch.quantization.mode import (KvCacheQuantAlgo,
                                                          QuantAlgo)
    qc = QuantConfig(kv_cache_quant_algo=KvCacheQuantAlgo.INT8) \
        if what == "kv_int8" else QuantConfig(quant_algo=QuantAlgo.W8A16)
    with pytest.raises(NotImplementedError, match="mamba"):
        U.port_llm(_mamba(), quant_config=qc)


@pytest.mark.parametrize("orient", ["per_expert", "fused_out_in",
                                    "fused_in_out"])
def test_stack_experts_reads_every_layout(orient):
    """``stack_experts`` gives ops/moe.py's [E, H, 2I] / [E, I, H] from
    per-expert [out, in] weights and from transformers 5's fused 3D
    experts in either orientation."""
    from types import SimpleNamespace

    from tensorrt_llm_tpu_torch.models.recurrent import stack_experts
    E, H, I = 3, 8, 5
    g = torch.Generator().manual_seed(0)
    gate, up = torch.randn(E, I, H, generator=g), torch.randn(E, I, H,
                                                              generator=g)
    down = torch.randn(E, H, I, generator=g)
    if orient == "per_expert":
        sd = {}
        for e in range(E):
            sd[f"x.{e}.gate_proj.weight"] = gate[e]
            sd[f"x.{e}.up_proj.weight"] = up[e]
            sd[f"x.{e}.down_proj.weight"] = down[e]
    elif orient == "fused_out_in":
        sd = {"x.gate_up_proj": torch.cat([gate, up], 1),
              "x.down_proj": down}
    else:
        sd = {"x.gate_up_proj": torch.cat([gate, up], 1).transpose(1, 2),
              "x.down_proj": down.transpose(1, 2)}
    model = SimpleNamespace(hidden_size=H,
                            _t=lambda a: torch.as_tensor(a).float())
    w_gu, w_d = stack_experts(model, sd, "x.", E)
    torch.testing.assert_close(w_gu, torch.cat([gate, up], 1).transpose(1, 2))
    torch.testing.assert_close(w_d, down.transpose(1, 2))


def test_random_weights_serve():
    """A bare config (``load_format="dummy"``): ``init_params`` draws the
    checkpoint ``RandomCheckpoint`` names from the ``transformers`` model
    built on the meta device, and the ``LLM`` serves it."""
    from tests.test_torch_bamba import _configs
    cfg, _ = _configs()["bamba"]
    llm = U.port_llm(cfg)
    try:
        out = llm.generate([[3, 4, 5, 6]], U.greedy(4))
    finally:
        llm.shutdown()
    toks = out[0].outputs[0].token_ids
    assert len(toks) == 4 and all(0 <= t < cfg.vocab_size for t in toks)
