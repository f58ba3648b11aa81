"""The rest of A14 and the LLM surface of the port, against the JAX
package's behaviour (tests/test_misc_features.py, test_tracing.py,
test_native_block_manager.py): the lazy state dict over a sharded
checkpoint, detokenization workers, request tracing, the native block
manager, sleep / wake, the weight swap and the KV cache events."""
import gc
import http.server
import json
import threading
import weakref

import numpy as np
import pytest
import torch

import tensorrt_llm_tpu as J
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch.quantization import lazy_state_dict as lsd

PAGE = 16


def _tiny(layers=2, seed=0):
    from transformers import LlamaConfig, LlamaForCausalLM
    torch.manual_seed(seed)
    cfg = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=layers, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=512)
    return LlamaForCausalLM(cfg).eval()


def _kw(**extra):
    kw = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
              max_input_len=64, max_seq_len=128, max_num_tokens=256)
    kw.update(extra)
    return kw


def _tllm(model, **extra):
    kv = extra.pop("kv", {})
    return T.LLM(model, device="cpu", kv_cache_config=T.KvCacheConfig(
        tokens_per_block=PAGE, max_tokens=1024, **kv), **_kw(**extra))


def _tokens(llm, prompts, n=6, pkg=T):
    outs = llm.generate(prompts, pkg.SamplingParams(max_tokens=n, top_k=1))
    return [o.outputs[0].token_ids for o in outs]


# ---------------------------------------------------------------------- #
# The lazy state dict
# ---------------------------------------------------------------------- #
def _sharded(tmp_path, model):
    """The model saved as two shards and an index, float32."""
    from safetensors.torch import save_file
    sd = {k: v.detach().clone().contiguous()
          for k, v in model.state_dict().items()}
    names = sorted(sd)
    half = len(names) // 2
    weight_map = {}
    for fname, keys in (("model-00001-of-00002.safetensors", names[:half]),
                        ("model-00002-of-00002.safetensors", names[half:])):
        save_file({k: sd[k] for k in keys}, str(tmp_path / fname))
        weight_map.update({k: fname for k in keys})
    (tmp_path / "model.safetensors.index.json").write_text(
        json.dumps({"weight_map": weight_map}))
    model.config.save_pretrained(tmp_path)
    return sd


def test_sharded_checkpoint_loads_lazily(tmp_path, monkeypatch):
    """A sharded checkpoint with an index reads as the JAX LazyStateDict
    reads it, loads to the same parameters as the whole state dict, and
    is never materialised whole: at most a few tensors read from it are
    alive at once while the model's loader builds its parameters (bf16
    from float32, so each read tensor is converted, not kept)."""
    from tensorrt_llm_tpu.quantization.lazy_state_dict import \
        LazyStateDict as JLazy
    model = _tiny(layers=8)
    sd = _sharded(tmp_path, model)
    lazy = lsd.LazyStateDict(tmp_path)
    jl = JLazy(tmp_path)
    assert sorted(lazy) == sorted(jl) == sorted(sd)
    for k in ("model.embed_tokens.weight", "model.layers.7.mlp.up_proj.weight"):
        np.testing.assert_array_equal(lazy[k].numpy(), jl[k])

    alive, peak = [0], [0]
    real = lsd.LazyStateDict.__getitem__

    def spy(self, name):
        t = real(self, name)
        n = t.numel() * t.element_size()
        alive[0] += n
        peak[0] = max(peak[0], alive[0])
        weakref.finalize(t, lambda: alive.__setitem__(0, alive[0] - n))
        return t

    monkeypatch.setattr(lsd.LazyStateDict, "__getitem__", spy)
    llm = T.LLM(str(tmp_path), device="cpu", **_kw(dtype="bfloat16"))
    params = llm.engine.params
    total = sum(v.numel() * v.element_size() for v in sd.values())
    largest = max(v.numel() * v.element_size() for v in sd.values())
    gc.collect()
    assert 0 < peak[0] <= 4 * largest and peak[0] < total / 4, \
        (peak[0], largest, total)
    ref = llm.model.load_hf_state_dict(sd)
    flat = [(a, b) for a, b in zip(
        torch.utils._pytree.tree_leaves(params),
        torch.utils._pytree.tree_leaves(ref))]
    assert flat and all(torch.equal(a, b) for a, b in flat)
    got = _tokens(llm, [[5, 9, 23, 44]])
    llm.shutdown()
    inline = _tllm(model, dtype="bfloat16")
    assert got == _tokens(inline, [[5, 9, 23, 44]])
    inline.shutdown()


def test_renamed_views_read_on_lookup():
    """The views the loaders read through (prefix stripping, the
    prequantized and MXFP4 conversions) look nothing up before a name is
    asked for."""
    reads = []

    class Src(dict):
        def __getitem__(self, k):
            reads.append(k)
            return dict.__getitem__(self, k)

    src = Src({"model.a": 1, "b": 2})
    view = lsd.strip_prefix(src, "model.")
    assert sorted(view) == ["a", "b"] and reads == []
    assert view["a"] == 1 and reads == ["model.a"]
    rv = lsd.RenamedStateDict(src, {"x": "b"}, {"y": lambda: 7, "x": lambda: 8})
    assert sorted(rv) == ["x", "y"] and len(rv) == 2
    assert rv["x"] == 8 and rv["y"] == 7 and "x" in rv and "z" not in rv


# ---------------------------------------------------------------------- #
# Detokenization workers
# ---------------------------------------------------------------------- #
class _Tok:
    eos_token_id = 0
    vocab_size = 128

    def encode(self, text, add_special_tokens=True):
        return [ord(c) % 96 + 2 for c in text][:16]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(97 + i % 26) for i in ids)

    def __len__(self):
        return 128


def _stream(llm, pkg):
    fut = llm.generate_async([5, 9, 23, 44], pkg.SamplingParams(
        max_tokens=10, top_k=1), streaming=True)
    chunks = [(tuple(c.token_ids), c.text) for c in fut]
    final = fut.result(60).outputs[0]
    return chunks, final.text, final.token_ids


@pytest.mark.parametrize("workers", (1, 2))
def test_postprocess_workers_stream(workers):
    """Streamed chunks decoded on the workers come in the order and with
    the text of the loop's own decoding; the final text equals the JAX
    LLM's with its workers."""
    model = _tiny()
    base = T.LLM(model, tokenizer=_Tok(), device="cpu", **_kw(
        skip_tokenizer_init=False))
    ref = _stream(base, T)
    base.shutdown()
    llm = T.LLM(model, tokenizer=_Tok(), device="cpu", **_kw(
        skip_tokenizer_init=False, num_postprocess_workers=workers))
    got = _stream(llm, T)
    assert llm.executor._postproc is not None
    llm.shutdown()
    assert got == ref and ref[1] != ""
    jllm = J.LLM(model=model, tokenizer=_Tok(),
                 kv_cache_config=J.KvCacheConfig(tokens_per_block=PAGE,
                                                 max_tokens=1024),
                 num_postprocess_workers=workers,
                 **_kw(skip_tokenizer_init=False))
    jgot = _stream(jllm, J)
    jllm.shutdown()
    assert jgot[1:] == got[1:]


def test_incremental_detokenizer():
    from tensorrt_llm_tpu.runtime.detokenizer import \
        IncrementalDetokenizer as JDetok
    from tensorrt_llm_tpu_torch.runtime.detokenizer import \
        IncrementalDetokenizer

    class Bytes:
        """Token i is byte i; decode holds back an incomplete UTF-8
        sequence as the replacement character."""
        def decode(self, ids, skip_special_tokens=True):
            return bytes(ids).decode("utf-8", errors="replace")

    for tok in (_Tok(), Bytes()):
        d, j = IncrementalDetokenizer(tok), JDetok(tok)
        seq = [[0, 1], [0xE2], [0x82], [0xAC, 33]] if isinstance(
            tok, Bytes) else [[0, 1], [2], []]
        assert [d.put(s) for s in seq] == [j.put(s) for s in seq]
        assert d.finish() == j.finish() and d.full_text == j.full_text
    assert IncrementalDetokenizer(None).put([1]) == ""


# ---------------------------------------------------------------------- #
# Tracing
# ---------------------------------------------------------------------- #
class _Collector(http.server.BaseHTTPRequestHandler):
    received = []

    def do_POST(self):
        n = int(self.headers["Content-Length"])
        _Collector.received.append(json.loads(self.rfile.read(n)))
        self.send_response(200)
        self.end_headers()
        self.wfile.write(b"{}")

    def log_message(self, *a):
        pass


@pytest.fixture()
def collector():
    _Collector.received = []
    srv = http.server.HTTPServer(("127.0.0.1", 0), _Collector)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()


def _spans():
    return [sp for p in _Collector.received for rs in p["resourceSpans"]
            for ss in rs["scopeSpans"] for sp in ss["spans"]]


def test_request_span_reaches_a_local_collector(collector, monkeypatch):
    """A traced request lands one ``llm_request`` span with the JAX
    tracer's attributes and events at the collector (posted at the
    latest by ``LLM.shutdown``); an untraced one none."""
    from tensorrt_llm_tpu.llmapi.tracing import format_traceparent
    from tensorrt_llm_tpu_torch.llmapi import tracing as tt
    monkeypatch.setenv("OTEL_EXPORTER_OTLP_TRACES_ENDPOINT", collector)
    llm = _tllm(_tiny())
    tid, sid = "0af7651916cd43dd8448eb211c80319c", "b7ad6b7169203331"
    assert tt.format_traceparent(tid, sid) == format_traceparent(tid, sid)
    out = llm.generate_async(
        [1, 2, 3], T.SamplingParams(max_tokens=4, top_k=1),
        trace_headers={"traceparent": tt.format_traceparent(tid, sid)}
    ).result(timeout=300)
    assert len(out.outputs[0].token_ids) == 4
    llm.generate([4, 5], T.SamplingParams(max_tokens=2, top_k=1))
    llm.shutdown()          # posts the spans still buffered
    spans = _spans()
    assert len(spans) == 1, spans
    sp = spans[0]
    assert (sp["traceId"], sp["parentSpanId"], sp["name"], sp["kind"]) == \
        (tid, sid, "llm_request", 2)
    attrs = {a["key"]: a["value"] for a in sp["attributes"]}
    assert sorted(attrs) == sorted([
        "gen_ai.request.id", "gen_ai.usage.prompt_tokens",
        "gen_ai.usage.completion_tokens", "gen_ai.response.finish_reason",
        "gen_ai.request.max_tokens", "gen_ai.latency.time_to_first_token",
        "gen_ai.latency.kv_cache_hit_tokens"])
    assert attrs["gen_ai.usage.prompt_tokens"]["intValue"] == "3"
    assert attrs["gen_ai.usage.completion_tokens"]["intValue"] == "4"
    assert [e["name"] for e in sp["events"]] == [
        "queued", "scheduled", "first_token", "finished"]
    assert int(sp["endTimeUnixNano"]) >= int(sp["startTimeUnixNano"])


def test_traceparent_parsing_matches_jax():
    from tensorrt_llm_tpu.llmapi import tracing as jt
    from tensorrt_llm_tpu_torch.llmapi import tracing as tt
    sid = "b7ad6b7169203331"
    for hdr in (tt.format_traceparent("0af7651916cd43dd8448eb211c80319c",
                                      sid, 1), "garbage", None, "",
                "00-" + "0" * 32 + "-" + sid + "-01",
                " 00-0AF7651916CD43DD8448EB211C80319C-B7AD6B7169203331-00 "):
        assert tt.parse_traceparent(hdr) == jt.parse_traceparent(hdr)
    assert tt.extract_trace_context({}) is None
    assert tt.RequestTracer.from_env() is None or \
        tt.RequestTracer.from_env().exporter is not None
    exp = tt.OtlpJsonExporter("http://127.0.0.1:1")   # nothing listens
    exp.export({"traceId": "x", "spanId": "y", "name": "n"})
    exp.flush()
    exp.shutdown()


# ---------------------------------------------------------------------- #
# The native block manager
# ---------------------------------------------------------------------- #
def _req(tokens, n=8, pkg=T):
    if pkg is T:
        from tensorrt_llm_tpu_torch.runtime.request import LlmRequest
    else:
        from tensorrt_llm_tpu.runtime.request import LlmRequest
    return LlmRequest(prompt_token_ids=list(tokens),
                      sampling_params=pkg.SamplingParams(max_tokens=n))


def _managers():
    from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import \
        KVCacheManager
    from tensorrt_llm_tpu_torch.runtime.native_block_manager import \
        NativeKVCacheManager
    return KVCacheManager(num_blocks=32, tokens_per_block=4), \
        NativeKVCacheManager(num_blocks=32, tokens_per_block=4)


def test_native_and_python_managers_agree():
    """One sequence of operations on both managers: free counts, reused
    tokens, shared block ids, grows after a window's pre-allocation,
    rewinds, exhaustion and the dropped device blocks agree."""
    from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import \
        NoFreeBlocksError
    trace = []
    for kv in _managers():
        log = []
        a = _req(range(12))
        log.append(kv.add_sequence(a))
        a.num_device_tokens = 12
        a_blocks = list(a.kv_block_ids)
        kv.free_resources(a)
        b = _req(list(range(8)) + [99, 98, 97, 96])
        log.append(kv.add_sequence(b))
        log.append(b.kv_block_ids[:2] == a_blocks[:2])
        b.num_device_tokens = 12
        kv.add_tokens(b, 8)                      # a window's pages
        log.append(len(b.kv_block_ids))
        kv.add_token(b)                          # a single step after it
        log.append(len(b.kv_block_ids))
        b.output_token_ids = [1] * 6
        kv.rewind_tokens(b, 3)
        log.append((len(b.kv_block_ids), kv.get_num_free_blocks()))
        kv.free_resources(b)
        log.append(kv.get_num_free_blocks())
        big = _req(range(200))
        with pytest.raises(NoFreeBlocksError):
            kv.add_sequence(big)
        log.append(kv.get_num_free_blocks())
        log.append(kv.drop_device_blocks() > 0)
        c = _req(range(12))
        log.append(kv.add_sequence(c))
        trace.append(log)
    assert trace[0] == trace[1], trace


def test_jax_native_grow_truncates_the_page_table():
    """The JAX bindings size a grow's id buffer by the step's tokens, and
    the library copies the whole chain into it: after a window's
    pre-allocation a single step's grow hands back the first blocks only
    (a reference fault, ROADMAP C); the port's bindings keep the chain."""
    import subprocess
    from pathlib import Path
    cpp = Path(__file__).resolve().parent.parent / "cpp"
    subprocess.run(["make", "-C", str(cpp)], check=True, capture_output=True)
    from tensorrt_llm_tpu.runtime.native_block_manager import \
        NativeKVCacheManager as JNative
    from tensorrt_llm_tpu_torch.runtime.native_block_manager import \
        NativeKVCacheManager
    got = []
    for kv, pkg in ((JNative(num_blocks=32, tokens_per_block=4), J),
                    (NativeKVCacheManager(num_blocks=32,
                                          tokens_per_block=4), T)):
        r = _req(range(10), pkg=pkg)
        kv.add_sequence(r)
        r.num_device_tokens = 10
        kv.add_tokens(r, 8)
        kv.add_token(r)
        got.append(len(r.kv_block_ids))
    assert got == [3, 5]


def test_native_llm_tokens_and_refusals(monkeypatch):
    """TLLM_TPU_NATIVE=1 serves with the native manager: the same tokens
    as the Python manager, the second pass reusing the first's blocks;
    the host tier beside it is refused by name."""
    from tensorrt_llm_tpu_torch.runtime.native_block_manager import \
        NativeKVCacheManager
    model = _tiny()
    prompts = [list(range(3, 40)), list(range(3, 36)) + [7, 7]]
    ref = _tllm(model)
    want = _tokens(ref, prompts) + _tokens(ref, prompts)
    ref.shutdown()
    monkeypatch.setenv("TLLM_TPU_NATIVE", "1")
    llm = _tllm(model)
    assert isinstance(llm.kv_cache_manager, NativeKVCacheManager)
    got = _tokens(llm, prompts) + _tokens(llm, prompts)
    assert llm.kv_cache_manager.get_stats().reused_blocks > 0
    assert llm.get_kv_cache_events() == []
    llm.shutdown()
    assert got == want
    with pytest.raises(NotImplementedError, match="host_cache_size"):
        _tllm(model, kv=dict(host_cache_size=1 << 20))


# ---------------------------------------------------------------------- #
# Sleep, wake, weight swap, KV cache events
# ---------------------------------------------------------------------- #
def test_sleep_wake_roundtrip():
    """After sleep and wake the tokens are the same (a reused prefix
    included: the prefix cache forgot the freed pool's blocks, where the
    JAX LLM reuses its two stored blocks over the zeroed pool and its
    tokens change, a reference fault, ROADMAP C); the weights are off the
    engine while asleep, and requests are refused then."""
    model = _tiny()
    llm = _tllm(model)
    prompt = list(range(5, 45))
    before = _tokens(llm, [prompt])
    jllm = J.LLM(model=model, kv_cache_config=J.KvCacheConfig(
        tokens_per_block=PAGE, max_tokens=1024), **_kw())
    assert before == _tokens(jllm, [prompt], pkg=J)
    jllm.release_memory()
    jllm.resume_memory()
    assert _tokens(jllm, [prompt], pkg=J) != before
    assert jllm.kv_cache_manager.get_stats().reused_blocks == 2
    jllm.shutdown()
    llm.release_memory()
    assert llm.engine.params is None and llm.engine.kv_pages is None
    with pytest.raises(RuntimeError, match="asleep"):
        llm.generate([1, 2], T.SamplingParams(max_tokens=2))
    llm.release_memory()                      # asleep: nothing to do
    llm.resume_memory()
    assert llm.kv_cache_manager.get_stats().reusable_blocks == 0
    assert _tokens(llm, [prompt]) == before
    llm.shutdown()


def test_update_weights_equals_fresh_llm():
    """``update_weights`` gives the tokens of a fresh LLM built with those
    weights, leaves the caller's checkpoint as it was, and swapping the
    old weights back gives the old tokens, as in the JAX LLM."""
    model = _tiny()
    other = _tiny(seed=1)
    prompts = [[7, 8, 9], [3, 1, 4, 1, 5]]
    llm = _tllm(model)
    base = _tokens(llm, prompts)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    llm.update_weights(other.state_dict())
    new = _tokens(llm, prompts)
    assert all(torch.equal(v, before[k])
               for k, v in model.state_dict().items())
    fresh = _tllm(other)
    assert new == _tokens(fresh, prompts) != base
    fresh.shutdown()
    llm.update_weights(model.state_dict())
    assert _tokens(llm, prompts) == base
    llm.shutdown()


def test_kv_cache_events_match_jax():
    """``get_kv_cache_events``: the blocks stored by a finished request,
    under the JAX manager's stable hashes, then none until the next."""
    model = _tiny()
    prompt = list(range(3, 40))
    events = []
    for pkg in (J, T):
        kw = dict(tokens_per_block=PAGE, max_tokens=1024,
                  event_buffer_max_size=64)
        llm = J.LLM(model=model, kv_cache_config=J.KvCacheConfig(**kw),
                    **_kw()) if pkg is J else T.LLM(
            model, device="cpu", kv_cache_config=T.KvCacheConfig(**kw),
            **_kw())
        _tokens(llm, [prompt], pkg=pkg)
        ev = llm.get_kv_cache_events()
        events.append([(e.kind, list(e.block_hashes)) for e in ev])
        assert llm.get_kv_cache_events() == []
        llm.shutdown()
    assert events[0] == events[1] and events[0][0][0] == "stored"
