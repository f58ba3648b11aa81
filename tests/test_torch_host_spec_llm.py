"""Host-orchestrated speculative decoding end to end: the port's
``LLM.generate`` on the CPU (the plain versions of the attention kernels)
against the JAX package's ``LLM`` with the same arguments, float32.

- Every host mode on tests/test_speculative.py's ``repeat_model`` (a
  seeded tiny Llama whose greedy stream repeats itself) and on
  tests/assets/tinycode-llama with code prompts: NGRAM, SA, AUTO (both of
  its branches: SA up to 8 rows, NGram beyond), USER_PROVIDED (a drafter
  proposing a fixed continuation), DRAFT_TARGET with the target as its own
  draft model and with another model, and PARD. Greedy tokens equal the
  JAX package's and the port's own without speculation; the drafts
  accepted per verified row (``Drafter.update``) equal the JAX package's.
  Where a request finishes before another one, the JAX two-model drafter
  reads the wrong slot's KV (speculative/model_drafter.py), so the
  DRAFT_TARGET counts of another model are held on one prompt.
- Seeded sampled rows under DRAFT_TARGET give the stream of the run
  without speculation (position-keyed noise at ``pos_base + g``), port
  against port; unseeded sampled rows give valid tokens.
- Stop ids inside an accepted run (tokens past the stop discarded), a
  MoE target (Qwen3-MoE), a Gemma 2 target with one pool and with VSWA,
  a W4A16 target, prefix reuse across requests: tokens equal the JAX
  package's, or the run without speculation.
- The verify steps take the graph path (``verify`` keys), steps with
  prompt tokens run eagerly; drafts are cut to the step's token budget
  where the JAX engine raises.
"""
from pathlib import Path

import pytest

CKPT = Path(__file__).parent / "assets" / "tinycode-llama"
REPEAT_PROMPTS = [[5, 9, 23, 44, 17], [3, 3, 7, 3, 3, 7, 3, 3], [11] * 12]
CODE_PROMPTS = [
    "def add(a, b):\n    return a + b\n\n\ndef sub(a, b):\n    return ",
    "for i in range(10):\n    print(i)\nfor j in range(10):\n    ",
    "x = [1, 2, 3]\ny = [1, 2, 3]\nz = [",
]


def _save(path, seed, **kw):
    import torch
    from transformers import LlamaConfig, LlamaForCausalLM
    torch.manual_seed(seed)
    cfg = dict(vocab_size=64, hidden_size=64, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, max_position_embeddings=512)
    cfg.update(kw)
    LlamaForCausalLM(LlamaConfig(**cfg)).eval().save_pretrained(
        path, safe_serialization=True)
    return str(path)


@pytest.fixture(scope="module")
def repeat_model(tmp_path_factory):
    """tests/test_speculative.py's ``repeat_model``, saved."""
    return _save(tmp_path_factory.mktemp("repeat"), 3)


@pytest.fixture(scope="module")
def other_draft(tmp_path_factory):
    """tests/test_speculative.py's other (random) draft model, saved."""
    return _save(tmp_path_factory.mktemp("draft"), 99, hidden_size=32,
                 intermediate_size=64, num_hidden_layers=1,
                 num_attention_heads=2)


class FixedDrafter:
    """A user's drafter: proposes the row's last tokens, repeated."""

    def __init__(self):
        self.max_draft_len = 0

    def prepare_draft_tokens(self, requests):
        for r in requests:
            h = r.all_token_ids
            r.draft_tokens = (h[-2:] * 4)[:self.max_draft_len]

    def update(self, request, accepted):
        pass


def _pkg(name):
    if name == "jax":
        import tensorrt_llm_tpu as P
        from tensorrt_llm_tpu.llmapi.llm_args import SpeculativeConfig
    else:
        import tensorrt_llm_tpu_torch as P
        from tensorrt_llm_tpu_torch import SpeculativeConfig
    return P, SpeculativeConfig


def _run(name, model, prompts, sp_kw, spec=None, max_batch_size=8, **kw):
    """(greedy tokens, drafts accepted per verified row, the LLM's
    engine and executor counters) of one ``generate`` call."""
    P, SC = _pkg(name)
    args = dict(model=model, skip_tokenizer_init=True, dtype="float32",
                max_batch_size=max_batch_size, max_input_len=96,
                max_seq_len=192, max_num_tokens=256,
                kv_cache_config=P.KvCacheConfig(tokens_per_block=16,
                                                max_tokens=2048))
    args.update(kw)
    if name == "jax":
        args["enable_warmup"] = False
    else:
        args["device"] = "cpu"
    if spec is not None:
        spec = dict(spec)
        if spec.get("draft_model") == "user":
            spec["draft_model"] = FixedDrafter()
        args["speculative_config"] = SC(**spec)
    llm = P.LLM(**args)
    accepted = []
    try:
        dr = llm.executor.drafter
        if dr is not None:
            orig = dr.update

            def spy(req, acc):
                accepted.append((req.request_id, len(acc)))
                return orig(req, acc)
            dr.update = spy
        outs = llm.generate(prompts, P.SamplingParams(**sp_kw))
        stats = {}
        if name == "torch":
            e, x = llm.engine, llm.executor
            stats = dict(verify=e.verify_steps,
                         verify_prompt=e.verify_steps_with_prompt,
                         verify_graph_runs=sum(
                             1 for k in e.graphs.steps if k[0] == "verify"),
                         rows=x.drafted_rows, proposed=x.drafts_proposed,
                         accepted=x.drafts_accepted)
    finally:
        llm.shutdown()
    # request ids differ between the packages: order counts by request
    ids = sorted({r for r, _ in accepted})
    per_req = [[n for r, n in accepted if r == i] for i in ids]
    return [o.outputs[0].token_ids for o in outs], per_req, stats


MODES = {
    "ngram": dict(mode="NGRAM", max_draft_len=3),
    "sa": dict(mode="SA", max_draft_len=4, sa_threshold=2),
    "auto_sa": dict(mode="AUTO"),
    "auto_ngram": dict(mode="AUTO"),
    "user": dict(mode="USER_PROVIDED", max_draft_len=3, draft_model="user"),
    "draft_target": dict(mode="DRAFT_TARGET", max_draft_len=3),
    "pard": dict(mode="PARD", max_draft_len=3, pard_mask_token_id=0),
}


def _spec(mode, model):
    spec = dict(MODES[mode])
    if mode in ("draft_target", "pard"):
        spec["draft_model"] = model
    return spec


@pytest.fixture(scope="module")
def repeat_base(repeat_model):
    sp = dict(max_tokens=16, top_k=1, ignore_eos=True)
    return {name: _run(name, repeat_model, REPEAT_PROMPTS, sp)[0]
            for name in ("jax", "torch")}


@pytest.mark.parametrize("mode", list(MODES))
def test_repeat_model_equals_jax(repeat_model, repeat_base, mode):
    sp = dict(max_tokens=16, top_k=1, ignore_eos=True)
    mb = 16 if mode == "auto_ngram" else 8
    spec = _spec(mode, repeat_model)
    jt, jacc, _ = _run("jax", repeat_model, REPEAT_PROMPTS, sp, spec,
                       max_batch_size=mb)
    tt, tacc, st = _run("torch", repeat_model, REPEAT_PROMPTS, sp, spec,
                        max_batch_size=mb)
    assert tt == jt == repeat_base["jax"] == repeat_base["torch"]
    assert tacc == jacc
    assert st["rows"] > 0 and st["verify"] > 0
    if mode == "draft_target":        # the target as its own draft model
        assert st["accepted"] == st["proposed"]


@pytest.mark.parametrize("mode", ["ngram", "sa", "draft_target", "pard"])
def test_tinycode_equals_jax(mode):
    """Code prompts on the parity checkpoint. The two-model drafters'
    counts are held on one prompt: with three, the JAX drafter's bucket
    overflow reorders its rows (``test_jax_two_model_drafter_reads_row
    _pages``)."""
    prompts = [list(p.encode()) for p in CODE_PROMPTS]
    sp = dict(max_tokens=24, top_k=1, ignore_eos=True)
    base = _run("torch", str(CKPT), prompts, sp)[0]
    spec = _spec(mode, str(CKPT))
    jt, jacc, _ = _run("jax", str(CKPT), prompts, sp, spec)
    tt, tacc, st = _run("torch", str(CKPT), prompts, sp, spec)
    assert tt == jt == base
    assert st["rows"] > 0
    if mode in ("draft_target", "pard"):
        jacc = _run("jax", str(CKPT), prompts[1:2], sp, spec)[1]
        tacc = _run("torch", str(CKPT), prompts[1:2], sp, spec)[1]
    assert tacc == jacc
    if mode == "draft_target":
        assert st["accepted"] > 0.9 * st["proposed"]


def _drafters(max_seq_len=192):
    """The JAX and the port's two-model drafters over tinycode-llama
    (float32), as their ``LLM``s build them for DRAFT_TARGET."""
    import jax.numpy as jnp
    from safetensors.numpy import load_file
    from transformers import AutoConfig

    import tensorrt_llm_tpu_torch as T
    from tensorrt_llm_tpu.models import ModelConfig as JConfig
    from tensorrt_llm_tpu.models import get_model_class as jget
    from tensorrt_llm_tpu.speculative.model_drafter import \
        TwoModelDrafter as JDrafter
    from tensorrt_llm_tpu_torch.llmapi.llm import LLM
    hf = AutoConfig.from_pretrained(CKPT)
    jm = jget(hf.model_type)(JConfig(hf_config=hf, dtype=jnp.float32))
    jd = JDrafter(jm, jm.load_hf_state_dict(load_file(
        str(CKPT / "model.safetensors"))), max_draft_len=3, max_slots=4,
        max_seq_len=max_seq_len)
    holder = LLM.__new__(LLM)
    holder.args = T.LlmArgs(model="m", dtype="float32",
                            max_batch_size=4, max_seq_len=max_seq_len)
    holder.device = __import__("torch").device("cpu")
    td = holder._build_two_model_drafter(T.SpeculativeConfig(
        mode="DRAFT_TARGET", max_draft_len=3, draft_model=str(CKPT)), 3)
    return jd, td


class _Req:
    def __init__(self, rid, tokens):
        self.request_id = rid
        self.all_token_ids = list(tokens)
        self.draft_tokens = []


def test_jax_two_model_drafter_reads_row_pages():
    """Reference fault (ROADMAP C): the JAX drafter gives work row i the
    pages of slot i. Two requests take slots 0 and 1; their catch-ups
    (61 + 21 tokens) overflow the largest bucket (64 at max_seq_len 192),
    the longer one is dropped, and the other, in slot 1, runs as row 0:
    it attends to slot 0's (empty) pages, and its drafts differ from the
    ones a fresh drafter gives it (slot 0 as row 0). The port's row
    attends to its own slot: the fresh drafter's drafts either way, equal
    to the JAX drafter's there."""
    a = list(CODE_PROMPTS[0].encode())[:61]
    b = list(CODE_PROMPTS[2].encode())[:21]
    got = {}
    for name, dr in zip(("jax", "torch"), _drafters()):
        pair = [_Req(0, a), _Req(1, b)]
        dr.prepare_draft_tokens(pair)
        assert pair[0].draft_tokens == []          # dropped: too long
        got[name] = pair[1].draft_tokens
    for name, dr in zip(("jax_fresh", "torch_fresh"), _drafters()):
        alone = _Req(0, b)
        dr.prepare_draft_tokens([alone])
        got[name] = alone.draft_tokens
    assert got["torch"] == got["torch_fresh"] == got["jax_fresh"]
    assert got["jax"] != got["jax_fresh"]


def test_draft_target_other_model(repeat_model, other_draft, repeat_base):
    """A different, random draft model: little acceptance, still
    lossless; the counts equal the JAX package's on one prompt."""
    sp = dict(max_tokens=16, top_k=1, ignore_eos=True)
    spec = dict(mode="DRAFT_TARGET", max_draft_len=3, draft_model=other_draft)
    tt, _, st = _run("torch", repeat_model, REPEAT_PROMPTS, sp, spec)
    assert tt == repeat_base["torch"]
    assert st["rows"] > 0
    one = REPEAT_PROMPTS[1:2]
    jt, jacc, _ = _run("jax", repeat_model, one, sp, spec)
    tt, tacc, _ = _run("torch", repeat_model, one, sp, spec)
    assert tt == jt and tacc == jacc


def test_seeded_sampled_rows_are_lossless(repeat_model):
    """tests/test_speculative.py:152 on the port: seeded sampled rows
    under DRAFT_TARGET give the stream without speculation, and so under
    NGRAM."""
    sp = dict(max_tokens=14, temperature=0.9, top_k=0, top_p=0.95,
              seed=4242)
    prompts = REPEAT_PROMPTS[:2]
    ref = _run("torch", repeat_model, prompts, sp)[0]
    for spec in (_spec("draft_target", repeat_model), _spec("ngram", None)):
        got, _, st = _run("torch", repeat_model, prompts, sp, spec)
        assert got == ref and st["rows"] > 0


def test_unseeded_sampled_rows_are_valid(repeat_model):
    sp = dict(max_tokens=12, temperature=0.8, top_k=0, ignore_eos=True)
    got, _, st = _run("torch", repeat_model, [[5, 9, 23], [11] * 8], sp,
                      _spec("draft_target", repeat_model))
    assert [len(t) for t in got] == [12, 12]
    assert all(0 <= t < 64 for ids in got for t in ids)
    assert st["rows"] > 0


def test_stop_inside_an_accepted_run(repeat_model, repeat_base):
    """A stop id that the drafts run past: the tokens after it are
    discarded (counted as rejected), as in the JAX package."""
    ref = repeat_base["torch"][1]
    stop = ref[9]
    sp = dict(max_tokens=16, top_k=1, stop_token_ids=[stop])
    spec = _spec("draft_target", repeat_model)
    jt, jacc, _ = _run("jax", repeat_model, [REPEAT_PROMPTS[1]], sp, spec)
    tt, tacc, _ = _run("torch", repeat_model, [REPEAT_PROMPTS[1]], sp, spec)
    assert tt == jt and tacc == jacc
    assert tt[0] == ref[:ref.index(stop) + 1]


def test_verify_steps_take_the_graph_path(repeat_model):
    """Decode steps with drafts and no prompt tokens go through the
    ``verify`` keys of the graph runner (eager on the CPU, replayed on
    CUDA); a verify step beside a prompt's chunk runs eagerly."""
    sp = dict(max_tokens=16, top_k=1, ignore_eos=True)
    _, _, st = _run("torch", repeat_model, REPEAT_PROMPTS, sp,
                    _spec("draft_target", repeat_model))
    assert st["verify_graph_runs"] > 0
    assert st["verify"] > st["verify_prompt"]


def test_drafts_fit_the_step_token_budget(repeat_model):
    """Reference fault (ROADMAP C): the scheduler counts one token per
    decode row, and drafts come after it. With max_num_tokens 65, a
    prompt's 64-token chunk beside one drafted decode row makes 68 tokens:
    the JAX engine raises; the port cuts the drafts to what the largest
    bucket has left, and the stream is the one without speculation."""
    sp = dict(max_tokens=12, top_k=1, ignore_eos=True)
    kw = dict(max_num_tokens=65, max_batch_size=2, max_input_len=128,
              max_seq_len=192)
    prompts = [[3, 3, 7] * 3, [i % 60 + 1 for i in range(120)]]
    spec = _spec("draft_target", repeat_model)
    with pytest.raises(ValueError, match="exceeds max bucket"):
        _run("jax", repeat_model, prompts, sp, spec, **kw)
    base = _run("torch", repeat_model, prompts, sp, **kw)[0]
    got, _, st = _run("torch", repeat_model, prompts, sp, spec, **kw)
    assert got == base and st["rows"] > 0 and st["verify_prompt"] > 0


def test_prefix_reuse_across_speculative_requests(repeat_model):
    """Requests sharing a prefix, one after another under drafts, reuse
    blocks that hold accepted tokens only: the streams equal the run
    without speculation and without reuse."""
    import tensorrt_llm_tpu_torch as T
    prefix = [3, 3, 7] * 6
    prompts = [prefix + [i, 5] for i in range(4)] + [prefix * 2]
    sp = T.SamplingParams(max_tokens=14, top_k=1, ignore_eos=True)

    def serve(spec, reuse):
        llm = T.LLM(repeat_model, device="cpu", skip_tokenizer_init=True,
                    dtype="float32", max_batch_size=4, max_input_len=96,
                    max_seq_len=192, max_num_tokens=256,
                    kv_cache_config=T.KvCacheConfig(
                        tokens_per_block=4, max_tokens=512,
                        enable_block_reuse=reuse),
                    **({} if spec is None else dict(
                        speculative_config=T.SpeculativeConfig(**spec))))
        try:
            out = [llm.generate(p, sp).outputs[0].token_ids
                   for p in prompts]
            hit = llm.kv_cache_manager.get_stats().reused_blocks
        finally:
            llm.shutdown()
        return out, hit
    ref, _ = serve(None, False)
    for spec in (_spec("ngram", None), _spec("draft_target", repeat_model)):
        got, hit = serve(spec, True)
        assert got == ref and hit > 0


# ---- other targets -------------------------------------------------------

def _families_run(name, path, spec, prompts, **kw):
    sp = dict(max_tokens=12, top_k=1, ignore_eos=True)
    return _run(name, str(path), prompts, sp, spec, max_batch_size=4,
                max_input_len=64, max_seq_len=128, max_num_tokens=128, **kw)


def test_moe_target_equals_jax(tmp_path):
    """NGRAM with a Qwen3-MoE target: the JAX package serves host drafting
    for any target (no hidden rows are needed), and so does the port."""
    from tests.test_torch_families import save_random
    save_random(tmp_path, "qwen3_moe", seed=11)
    prompts = [[5, 17, 99, 3, 5, 17, 99, 3, 5], list(range(20, 41))]
    spec = _spec("ngram", None)
    jt, jacc, _ = _families_run("jax", tmp_path, spec, prompts)
    tt, tacc, _ = _families_run("torch", tmp_path, spec, prompts)
    base = _families_run("torch", tmp_path, None, prompts)[0]
    assert tt == jt == base and tacc == jacc


@pytest.mark.parametrize("vswa", [False, True], ids=["single", "vswa"])
def test_gemma2_target_equals_jax(tmp_path, vswa):
    """NGRAM with a Gemma 2 target, one pool and VSWA (window 16, page 8:
    the sliding pool releases blocks and rewinds with the global one). One
    request: the JAX package's VSWA admission fault (ROADMAP C) bites
    concurrent ones."""
    from tests.test_torch_gemma import save_random
    save_random(tmp_path, "gemma2", 16, seed=3)
    kv = dict(tokens_per_block=8, max_tokens=2048)
    if vswa:
        kv["max_attention_window"] = [16, 128]
    prompts = [[7, 8, 9, 10] * 6]
    spec = _spec("ngram", None)
    out = {}
    for name in ("jax", "torch"):
        P, _ = _pkg(name)
        out[name] = _families_run(name, tmp_path, spec, prompts,
                                  kv_cache_config=P.KvCacheConfig(**kv))
    base = _families_run("torch", tmp_path, None, prompts,
                         kv_cache_config=_pkg("torch")[0].KvCacheConfig(
                             **kv))[0]
    assert out["torch"][0] == out["jax"][0] == base
    assert out["torch"][1] == out["jax"][1]


def test_w4a16_target_equals_jax():
    """A weight-only quantized target (int4 per channel, lm_head excluded,
    as by default) with NGRAM: greedy tokens and counts equal the JAX
    package's (both dequantize in float32)."""
    prompts = [list(p.encode()) for p in CODE_PROMPTS[:2]]
    out = {}
    for name in ("jax", "torch"):
        P, _ = _pkg(name)
        out[name] = _run(name, str(CKPT), prompts,
                         dict(max_tokens=16, top_k=1, ignore_eos=True),
                         _spec("ngram", None), quant_config=P.QuantConfig(
                             quant_algo=P.QuantAlgo.W4A16))
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][1] == out["jax"][1]
