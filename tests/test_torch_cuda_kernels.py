"""The port's CUDA kernels against their plain PyTorch versions on the
card (skipped without one). float32 cases hold to 1e-4 (float32 sums in
another order); bfloat16 cases to 2e-2 (bf16 inputs and output rounding,
float32 accumulation in both). The dequant-matmul kernel rounds its
output to bf16 for either input type, so it holds to 2e-2 throughout."""
import numpy as np
import pytest
import torch

from tensorrt_llm_tpu_torch.ops.cuda import decode_attention as dec
from tensorrt_llm_tpu_torch.ops.cuda import prefill_attention as pre
from tensorrt_llm_tpu_torch.ops.cuda import quant_matmul as qmm

pytestmark = pytest.mark.cuda

TOLS = {torch.float32: dict(rtol=1e-4, atol=1e-4),
        torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(q_lens, ctx_lens, qh, kvh, hd, ps, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    S = len(q_lens)
    kv_lens = torch.tensor([c + q for c, q in zip(ctx_lens, q_lens)],
                           dtype=torch.int32)
    max_pages = max(int((kv_lens.max() + ps - 1) // ps), 1)
    P = S * max_pages + 3
    pool = torch.randn((P, ps, 2 * kvh, hd), generator=g)
    pt = torch.randperm(S * max_pages, generator=g).int().reshape(S, -1)
    q = torch.randn((int(sum(q_lens)), qh, hd), generator=g)
    cu = torch.zeros(S + 1, dtype=torch.int32)
    cu[1:] = torch.cumsum(torch.tensor(q_lens), 0)
    return [t.to(device) for t in (q.to(dtype), pool.to(dtype), kv_lens,
                                   pt, cu)]


def _opts(name, qh, device):
    if name == "window_softcap":
        return {"sliding_window": 45, "soft_cap": 30.0}
    if name == "sinks":
        return {"sinks": torch.linspace(-1.0, 2.0, qh, device=device)}
    if name == "alibi":
        return {"alibi_slopes": tuple(2.0 ** (-8.0 * (i + 1) / qh)
                                      for i in range(qh))}
    if name == "sinks_window":      # gpt-oss's sliding layers
        return {"sinks": torch.linspace(-1.0, 2.0, qh, device=device),
                "sliding_window": 128}
    return {}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_lens,qh,kvh,hd,ps,opt", [
    ([7, 300, 1, 0, 65], 8, 2, 64, 16, None),
    ([1024] * 64, 32, 4, 64, 32, None),             # serving decode shape
    ([150, 33, 513], 16, 4, 128, 16, None),
    ([100, 31], 8, 8, 64, 32, None),                # MHA
    ([161, 5, 290], 8, 2, 64, 16, "window_softcap"),
    ([17, 44, 3], 8, 2, 64, 16, "sinks"),
    ([9, 380, 26], 8, 2, 128, 16, "alibi"),
])
def test_decode_kernel_matches_plain(cuda, dtype, kv_lens, qh, kvh, hd, ps,
                                     opt):
    S = len(kv_lens)
    q, pool, _, pt, _ = _inputs([1] * S, [max(k - 1, 0) for k in kv_lens],
                                qh, kvh, hd, ps, dtype, cuda)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=cuda)
    kw = dict(sm_scale=hd ** -0.5, **_opts(opt, qh, cuda))
    before = dec.LAUNCHES
    got = dec.paged_decode_attention(q, pool, kvl, pt, **kw)
    torch.cuda.synchronize()
    assert dec.LAUNCHES == before + 1
    ref = dec.paged_decode_attention_plain(q, pool, kvl, pt, **kw)
    torch.testing.assert_close(got.float(), ref.float(), **TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_lens,ctx_lens,qh,kvh,hd,ps,opt", [
    ([7, 30, 1, 0], [0, 0, 40, 0], 8, 4, 64, 16, None),
    ([512] * 8, [0] * 8, 32, 4, 64, 32, None),      # serving prefill shape
    ([1, 1, 300, 1, 70], [900, 20, 0, 31, 500], 32, 4, 64, 32, None),
    ([200, 3], [0, 77], 16, 4, 128, 16, None),
    ([129], [0], 8, 8, 64, 16, None),               # MHA: 64 tokens / CTA
    ([250, 9], [10, 300], 8, 2, 64, 16, "window_softcap"),
    ([9, 121, 1], [4, 0, 30], 8, 2, 64, 16, "sinks"),
    ([9, 121, 1], [4, 0, 30], 8, 2, 128, 16, "alibi"),
])
def test_prefill_kernel_matches_plain(cuda, dtype, q_lens, ctx_lens, qh, kvh,
                                      hd, ps, opt):
    q, pool, kvl, pt, cu = _inputs(q_lens, ctx_lens, qh, kvh, hd, ps, dtype,
                                   cuda, seed=1)
    kw = dict(sm_scale=hd ** -0.5, **_opts(opt, qh, cuda))
    before = pre.LAUNCHES
    got = pre.ragged_prefill_attention(q, pool, kvl, pt, cu,
                                       max_q_len=max(q_lens), **kw)
    torch.cuda.synchronize()
    assert pre.LAUNCHES == before + 1
    ref = pre.ragged_prefill_attention_plain(q, pool, kvl, pt, cu, **kw)
    torch.testing.assert_close(got.float(), ref.float(), **TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("num_splits", [2, 5, None])
@pytest.mark.parametrize("kv_lens,qh,kvh,hd,ps,opt", [
    ([7, 300, 1, 0, 65, 0, 1000], 8, 2, 64, 16, None),   # ragged, zeros
    ([2500, 40, 0, 1700], 32, 4, 64, 32, None),     # chosen value > 1
    ([900, 33, 513], 16, 4, 128, 16, None),
    ([700, 31], 40, 2, 64, 32, None),               # three chunks of heads
    ([161, 5, 290, 0], 8, 2, 64, 16, "window_softcap"),
    ([170, 44, 3, 0], 8, 2, 64, 16, "sinks"),
    ([9, 380, 26], 8, 2, 128, 16, "alibi"),
])
def test_decode_kernel_split_matches_plain(cuda, dtype, num_splits, kv_lens,
                                           qh, kvh, hd, ps, opt):
    """Forced and chosen numbers of KV splits against the unsplit plain
    version: empty splits, rows of length 0, the sink counted once."""
    S = len(kv_lens)
    q, pool, _, pt, _ = _inputs([1] * S, [max(k - 1, 0) for k in kv_lens],
                                qh, kvh, hd, ps, dtype, cuda, seed=2)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=cuda)
    kw = dict(sm_scale=hd ** -0.5, **_opts(opt, qh, cuda))
    before = dec.LAUNCHES
    got = dec.paged_decode_attention(q, pool, kvl, pt, num_splits=num_splits,
                                     max_kv_len=max(kv_lens), **kw)
    torch.cuda.synchronize()
    assert dec.LAUNCHES == before + 1            # one per call, not per split
    ref = dec.paged_decode_attention_plain(q, pool, kvl, pt, **kw)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), ref.float(), **TOLS[dtype])
    assert not got[torch.tensor(kv_lens) == 0].any()


def test_decode_float32_growing_group_in_one_process(cuda):
    """The float32 route sizes its shared memory from the run-time group:
    a larger group after a smaller one must still launch (hd 128: group 8
    fits the default limit, 32 and 64 each need a larger opt-in)."""
    for group in (8, 32, 64):
        kv_lens = [70, 0, 333]
        q, pool, _, pt, _ = _inputs([1] * 3, [max(k - 1, 0) for k in kv_lens],
                                    group, 1, 128, 16, torch.float32, cuda,
                                    seed=group)
        kvl = torch.tensor(kv_lens, dtype=torch.int32, device=cuda)
        got = dec.paged_decode_attention(q, pool, kvl, pt, sm_scale=0.1)
        torch.cuda.synchronize()
        ref = dec.paged_decode_attention_plain(q, pool, kvl, pt, sm_scale=0.1)
        torch.testing.assert_close(got, ref, **TOLS[torch.float32])


def test_decode_chosen_splits_follow_the_hint(cuda):
    """Few long rows split; the same rows with a short host bound do not;
    the result is the same either way."""
    kv_lens = [3000, 2000]
    q, pool, _, pt, _ = _inputs([1, 1], [k - 1 for k in kv_lens], 32, 4, 64,
                                32, torch.bfloat16, cuda, seed=3)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    reach = pt.shape[1] * 32
    assert dec.choose_splits(2, 4, reach, sms, 8) > 1
    assert dec.choose_splits(2, 4, 200, sms, 8) == 1
    a = dec.paged_decode_attention(q, pool, kvl, pt, sm_scale=0.125)
    b = dec.paged_decode_attention(q, pool, kvl, pt, sm_scale=0.125,
                                   max_kv_len=200)
    torch.testing.assert_close(a.float(), b.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype,route", [(torch.float32, "float32_simple"),
                                         (torch.bfloat16, "tensor_core")])
@pytest.mark.parametrize("q_lens,ctx_lens,qh,kvh,hd,ps,opt,window", [
    ([70, 1, 45], [3, 90, 0], 6, 2, 64, 16, None, None),    # group 3: 126 rows
    ([13, 300], [0, 0], 4, 2, 64, 16, None, None),  # 300 tokens at offset 13
    ([13, 300], [5, 77], 16, 4, 128, 16, None, None),
    ([200, 40], [100, 0], 8, 2, 64, 16, "window", 20),      # window < a tile
    ([200, 40], [100, 0], 8, 2, 128, 32, "window", 70),
    ([1, 1, 1], [500, 0, 63], 32, 4, 64, 32, None, None),   # decode rows only
    ([64, 2], [0, 700], 64, 1, 64, 32, None, None),         # group 64
])
def test_prefill_routes_match_plain(cuda, dtype, route, q_lens, ctx_lens, qh,
                                    kvh, hd, ps, opt, window):
    assert pre.route_for(dtype) == route
    q, pool, kvl, pt, cu = _inputs(q_lens, ctx_lens, qh, kvh, hd, ps, dtype,
                                   cuda, seed=4)
    kw = dict(sm_scale=hd ** -0.5)
    if opt == "window":
        kw["sliding_window"] = window
    got = pre.ragged_prefill_attention(q, pool, kvl, pt, cu,
                                       max_q_len=max(q_lens), **kw)
    torch.cuda.synchronize()
    ref = pre.ragged_prefill_attention_plain(q, pool, kvl, pt, cu, **kw)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), ref.float(), **TOLS[dtype])


def test_prefill_pool_garbage_past_kv_len_is_ignored(cuda):
    """Positions past kv_len inside a tile may hold anything (NaN here):
    their weight is 0 and they must not reach the output."""
    q, pool, kvl, pt, cu = _inputs([50, 1], [0, 70], 8, 2, 64, 16,
                                   torch.bfloat16, cuda, seed=5)
    ref = pre.ragged_prefill_attention_plain(q, pool, kvl, pt, cu,
                                             sm_scale=0.125)
    flat = pool.view(-1, 16, 4, 64)
    for s, n in enumerate(kvl.tolist()):
        page, off = pt[s, n // 16].item(), n % 16
        flat[page, off:] = float("nan")
    got = pre.ragged_prefill_attention(q, pool, kvl, pt, cu, max_q_len=50,
                                       sm_scale=0.125)
    dgot = dec.paged_decode_attention(q[50:], pool, kvl[1:], pt[1:],
                                      sm_scale=0.125)
    torch.cuda.synchronize()
    tol = TOLS[torch.bfloat16]
    torch.testing.assert_close(got.float(), ref.float(), **tol)
    torch.testing.assert_close(dgot.float(), ref[50:].float(), **tol)


def _quant_inputs(M, K, N, G, bits, dtype, device, seed=0):
    """Seeded x, a group-quantized weight (packed for int4) and scales."""
    from tensorrt_llm_tpu_torch.ops import quant as Q
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K), np.float32))
    w = torch.from_numpy(rng.standard_normal((K, N), np.float32) * 0.02)
    q, s, _ = Q.quantize_weight_groupwise(w, group_size=G, bits=bits)
    if bits == 4:
        q = Q.pack_int4(q)
    return x.to(dtype).to(device), q.to(device), s.to(device)


@pytest.mark.parametrize("M,K,N,G,bits,dtype", [
    (64, 2048, 2560, 128, 4, torch.bfloat16),       # serving: qkv
    (64, 2048, 2048, 128, 4, torch.bfloat16),       # serving: o
    (64, 2048, 11264, 128, 4, torch.bfloat16),      # serving: gate_up
    (64, 5632, 2048, 128, 4, torch.bfloat16),       # serving: down
    (1, 2048, 2560, 128, 4, torch.bfloat16),
    (8, 512, 384, 64, 4, torch.float32),
    (17, 256, 257, 32, 4, torch.bfloat16),          # ragged rows and columns
    (33, 256, 1001, 64, 8, torch.bfloat16),
    (128, 2048, 2048, 128, 4, torch.bfloat16),      # two row blocks
    (100, 1024, 130, 16, 4, torch.bfloat16),
    (64, 2048, 2560, 32, 8, torch.bfloat16),        # the MXFP4 shape
    (64, 2048, 2560, 16, 8, torch.bfloat16),        # the NVFP4 shape
    (5, 48, 8, 16, 8, torch.float32),
    (8, 2048, 2560, 128, 4, torch.bfloat16),
    (16, 2048, 11264, 128, 4, torch.bfloat16),      # the serving run's live rows
    (16, 5632, 2048, 128, 4, torch.bfloat16),       # uneven split along K
    (65, 1024, 1024, 64, 4, torch.bfloat16),        # one row in the second block
    (120, 5632, 384, 128, 4, torch.bfloat16),
    (128, 1024, 257, 32, 4, torch.bfloat16),
    (64, 512, 8, 16, 4, torch.bfloat16),            # N = 8: 4-byte copies
    (64, 1536, 130, 64, 4, torch.bfloat16),         # N = 130: byte copies
    (1, 1024, 130, 128, 8, torch.bfloat16),
    (40, 2048, 1001, 32, 8, torch.bfloat16),
    (24, 768, 257, 16, 8, torch.float32),
    (64, 5632, 2048, 16, 8, torch.bfloat16),
])
def test_quant_matmul_kernel_matches_plain(cuda, M, K, N, G, bits, dtype):
    x, w, s = _quant_inputs(M, K, N, G, bits, dtype, cuda)
    before = qmm.LAUNCHES
    got = qmm.groupwise_dequant_matmul(x, w, s, group_size=G, bits=bits)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    ref = qmm.groupwise_dequant_matmul_plain(x, w, s, group_size=G, bits=bits)
    torch.testing.assert_close(got.float(), ref.float(), rtol=2e-2, atol=2e-2)


def test_quant_matmul_unaligned_x(cuda):
    """x starting 2 bytes past a 16-byte boundary: the wrapper copies it
    to an aligned buffer before the launch."""
    x, w, s = _quant_inputs(64, 2048, 2560, 128, 4, torch.bfloat16, cuda)
    buf = torch.empty(x.numel() + 8, dtype=torch.bfloat16, device=cuda)
    xu = buf[1:1 + x.numel()].view(x.shape)
    xu.copy_(x)
    assert xu.data_ptr() % 16 == 2
    got = qmm.groupwise_dequant_matmul(xu, w, s, group_size=128, bits=4)
    ref = qmm.groupwise_dequant_matmul_plain(x, w, s, group_size=128, bits=4)
    torch.testing.assert_close(got.float(), ref.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("M,K,N", [(64, 5632, 2048), (64, 2048, 2560),
                                   (16, 2048, 11264), (100, 2048, 1001)])
def test_quant_matmul_is_deterministic(cuda, M, K, N):
    """The split-K partial tiles are summed in a fixed order (no atomics):
    repeated calls give the same bits."""
    x, w, s = _quant_inputs(M, K, N, 128, 4, torch.bfloat16, cuda, seed=3)
    first = qmm.groupwise_dequant_matmul(x, w, s, group_size=128, bits=4)
    for _ in range(3):
        again = qmm.groupwise_dequant_matmul(x, w, s, group_size=128, bits=4)
        assert torch.equal(first, again)


def test_quant_matmul_replays_under_cuda_graph(cuda):
    """The grid comes from host ints, so a launch can be captured and
    replayed; a replay reads the current contents of x."""
    x, w, s = _quant_inputs(64, 5632, 2048, 128, 4, torch.bfloat16, cuda)
    kw = dict(group_size=128, bits=4)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = qmm.groupwise_dequant_matmul(x, w, s, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qmm.groupwise_dequant_matmul(x, w, s, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    x.mul_(-0.5)
    graph.replay()
    want = qmm.groupwise_dequant_matmul(x, w, s, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    torch.testing.assert_close(
        out.float(), qmm.groupwise_dequant_matmul_plain(x, w, s, **kw).float(),
        rtol=2e-2, atol=2e-2)


def test_quant_matmul_dispatch_on_cuda(cuda):
    """M > 128 takes the dequantize-then-matmul route (no launch); a
    shape outside the kernel's contract raises instead of falling back."""
    x, w, s = _quant_inputs(129, 256, 96, 64, 4, torch.bfloat16, cuda)
    before = qmm.LAUNCHES
    got = qmm.groupwise_dequant_matmul(x, w, s, group_size=64, bits=4)
    assert qmm.LAUNCHES == before
    ref = qmm.groupwise_dequant_matmul_plain(x, w, s, group_size=64, bits=4)
    torch.testing.assert_close(got.float(), ref.float(), rtol=2e-2, atol=2e-2)
    x, w, s = _quant_inputs(4, 192, 96, 64, 8, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="contract"):
        # 96 stored rows read as packed int4: K = 192 is no multiple of 128
        qmm.groupwise_dequant_matmul(x, w[:96].contiguous(), s,
                                     group_size=64, bits=4)


def test_llm_greedy_cuda_matches_cpu(cuda):
    """The parity checkpoint in float32: the kernel path on the card and
    the plain path on the CPU give the same greedy tokens — with more
    requests than batch rows (queueing), a prompt longer than the token
    budget (chunked prefill) and a repeated prompt (prefix reuse)."""
    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig, SamplingParams
    long = list(range(2, 120))
    # the first `long` stops early, so the second one takes its batch row
    # after it has stored its blocks in the reuse tree
    prompts = [[5, 9, 23, 44, 17], long, [1] * 20, list(b"def f("), long]
    n_out = [24, 8, 24, 24, 24]
    outs = {}
    for dev in ("cuda", "cpu"):
        llm = LLM("tests/assets/tinycode-llama", device=dev, dtype="float32",
                  skip_tokenizer_init=True, max_batch_size=4,
                  max_input_len=128, max_seq_len=256, max_num_tokens=64,
                  kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                                max_tokens=4096))
        try:
            res = llm.generate(prompts, [SamplingParams(max_tokens=n, top_k=1)
                                         for n in n_out])
            outs[dev] = [r.outputs[0].token_ids for r in res]
            assert llm.kv_cache_manager.get_stats().reused_blocks > 0
        finally:
            llm.shutdown()
    assert outs["cuda"] == outs["cpu"]
    assert [len(t) for t in outs["cuda"]] == n_out


# ---- CUDA graphs ---------------------------------------------------------

def _graphed(fn):
    """``fn`` run eagerly (on a side stream, as a warm-up), then captured
    into a graph and replayed once: (eager result, static output, graph)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return eager, out, graph


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_lens,qh,kvh,hd", [
    ([16384] * 4, 32, 4, 64),
    ([3000, 17, 2500, 1], 16, 4, 128),
])
def test_decode_split_replays_under_cuda_graph(cuda, dtype, kv_lens, qh, kvh,
                                               hd):
    """More than one KV split (partials in scratch from the graph's pool,
    the merge kernel): a replay gives the eager launch's bits, and reads
    the current contents of q."""
    S = len(kv_lens)
    q, pool, _, pt, _ = _inputs([1] * S, [k - 1 for k in kv_lens], qh, kvh,
                                hd, 32, dtype, cuda, seed=4)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=cuda)
    kw = dict(sm_scale=hd ** -0.5, max_kv_len=max(kv_lens))
    assert dec.splits_for(S, qh, kvh, pt.shape[1] * 32, max(kv_lens), None,
                          cuda) > 1
    eager, out, graph = _graphed(
        lambda: dec.paged_decode_attention(q, pool, kvl, pt, **kw))
    assert torch.equal(out, eager)
    q.mul_(-0.5)
    graph.replay()
    want = dec.paged_decode_attention(q, pool, kvl, pt, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    ref = dec.paged_decode_attention_plain(q, pool, kvl, pt,
                                           sm_scale=hd ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), **TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_rider_shape_replays_under_cuda_graph(cuda, dtype):
    """The rider window's launch: 64 decode rows at about 200 positions,
    8 chunks of 60 tokens and a filler row of 32 that self-attends over
    page 0, with the grid fixed by C = 512. A replay gives the eager
    launch's bits; the filler's rows are finite."""
    q_lens = [1] * 64 + [60] * 8 + [32]
    ctx = [180 + i for i in range(64)] + [64 * i for i in range(8)] + [0]
    q, pool, kvl, pt, cu = _inputs(q_lens, ctx, 16, 4, 128, 16, dtype, cuda,
                                   seed=6)
    pt[-1] = 0                                   # the filler reads page 0
    kw = dict(sm_scale=128 ** -0.5)
    eager, out, graph = _graphed(lambda: pre.ragged_prefill_attention(
        q, pool, kvl, pt, cu, max_q_len=512, **kw))
    assert torch.equal(out, eager)
    assert torch.isfinite(out.float()).all()
    q.mul_(0.5)
    graph.replay()
    want = pre.ragged_prefill_attention(q, pool, kvl, pt, cu, max_q_len=512,
                                        **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    ref = pre.ragged_prefill_attention_plain(q, pool, kvl, pt, cu, **kw)
    torch.testing.assert_close(out.float(), ref.float(), **TOLS[dtype])


def test_window_graph_draws_fresh_noise_per_replay(cuda):
    """Two replays of one captured temperature-1 window with the same
    inputs: the unseeded row draws new noise (the engine's generator is
    registered with the graph), the seeded row repeats its tokens; each
    replay counts the decode kernel once per layer and step."""
    from transformers import LlamaConfig
    from tensorrt_llm_tpu_torch import KvCacheConfig, SamplingParams
    from tensorrt_llm_tpu_torch.llmapi.llm_args import LlmArgs
    from tensorrt_llm_tpu_torch.models import ModelConfig, get_model_class
    from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import \
        KVCacheManager
    from tensorrt_llm_tpu_torch.runtime.model_engine import ModelEngine
    from tensorrt_llm_tpu_torch.runtime.request import (LlmRequest,
                                                        LlmRequestState)
    from tensorrt_llm_tpu_torch.runtime.scheduler import ScheduledRequests
    cfg = LlamaConfig(vocab_size=128, hidden_size=256, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=512)
    args = LlmArgs(model="tiny", dtype="float32", max_batch_size=4,
                   max_input_len=64, max_seq_len=128, max_num_tokens=256,
                   kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                                 max_tokens=2048))
    model = get_model_class("llama")(ModelConfig(
        hf_config=cfg, dtype=torch.float32, device=cuda))
    engine = ModelEngine(model, model.init_params(seed=0), args)
    kv = KVCacheManager(num_blocks=engine.num_kv_pages, tokens_per_block=16,
                        max_seq_len=128, enable_block_reuse=False)
    reqs = []
    for i, seed in enumerate((0, 1234)):
        r = LlmRequest(prompt_token_ids=[3, 1, 4, 1, 5, 9, 2, 6],
                       sampling_params=SamplingParams(
                           max_tokens=16, temperature=1.0, top_k=0,
                           seed=seed, ignore_eos=True))
        r.seq_slot = i
        kv.add_sequence(r)
        reqs.append(r)
    engine.forward_step(ScheduledRequests(context_requests=reqs))
    for r in reqs:
        r.state = LlmRequestState.GENERATION_IN_PROGRESS
        r.num_device_tokens = r.context_len
        r.host_token_override = 7              # the same input each time
        kv.add_tokens(r, 8)
        r.multi_step_budget = 8
    batch = ScheduledRequests(generation_requests=reqs)
    first = engine.forward_multi_step(batch, 8)[0].cpu()
    launches = dec.LAUNCHES
    second = engine.forward_multi_step(batch, 8)[0].cpu()
    assert engine.graphs.num_graphs == 1 and engine.graphs.replays == 2
    assert dec.LAUNCHES - launches == 8 * cfg.num_hidden_layers
    assert not torch.equal(first[:, 0], second[:, 0])
    assert torch.equal(first[:, 1], second[:, 1])


# ---- speculative verify and catch-up shapes ------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,qh,kvh", [(64, 8, 2), (128, 16, 4)])
def test_prefill_small_q_rows_match_plain_and_replay(cuda, dtype, hd, qh,
                                                     kvh):
    """The spec window's launches of the prefill kernel: segments of 2 to
    8 query rows after 0 to 300 positions (the verify pass), and segments
    whose KV length is shorter than their query length (the head's
    catch-up of an inactive row or of a short history: rows that see no
    key give 0). Against the plain version, and a graph replay gives the
    eager launch's bits."""
    q_lens = [2, 3, 4, 5, 6, 7, 8, 4, 4, 3]
    ctx = [300, 129, 0, 17, 64, 250, 31, 0, 0, 0]
    q, pool, kvl, pt, cu = _inputs(q_lens, ctx, qh, kvh, hd, 32, dtype, cuda,
                                   seed=8)
    kvl[-3:] = torch.tensor([1, 2, 2], dtype=torch.int32, device=cuda)
    kw = dict(sm_scale=hd ** -0.5)
    eager, out, graph = _graphed(lambda: pre.ragged_prefill_attention(
        q, pool, kvl, pt, cu, max_q_len=8, **kw))
    assert torch.equal(out, eager)
    ref = pre.ragged_prefill_attention_plain(q, pool, kvl, pt, cu, **kw)
    torch.testing.assert_close(out.float(), ref.float(), **TOLS[dtype])
    # rows placed before position 0 (row j of a segment sits at
    # kv_len - q_len + j) see no key: exactly 0 in both
    c = cu.tolist()
    blind = [c[7] + j for j in range(3)] + [c[8] + j for j in range(2)] + \
        [c[9]]
    assert out[c[7] + 3].any() and out[c[9] + 1].any()
    assert not out[blind].any() and not ref[blind].any()
    q.mul_(0.5)
    graph.replay()
    want = pre.ragged_prefill_attention(q, pool, kvl, pt, cu, max_q_len=8,
                                        **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spec_window_replay_equals_eager(cuda, dtype):
    """The in-repo pair (tinycode-llama + tinycode-eagle, d = 3) serves one
    workload twice on the card: spec windows replayed from CUDA graphs,
    and the same windows run eagerly on the same static buffers
    (``engine.graphs.capture = False``). Tokens and acceptance are
    identical; the spec graphs replayed both attention kernels."""
    from tensorrt_llm_tpu_torch import (LLM, KvCacheConfig, SamplingParams,
                                        SpeculativeConfig)
    prompts = [list(b"def forward(self, x):\n    return "),
               list(b"import torch\n"), list(range(32, 120))]
    sp = SamplingParams(max_tokens=40, top_k=1, ignore_eos=True)
    runs = {}
    for mode in ("graph", "eager"):
        llm = LLM("tests/assets/tinycode-llama", device=cuda, dtype=dtype,
                  skip_tokenizer_init=True, max_batch_size=4,
                  max_input_len=128, max_seq_len=256, max_num_tokens=256,
                  enable_warmup=mode == "graph",
                  speculative_config=SpeculativeConfig(
                      mode="EAGLE3", max_draft_len=3,
                      draft_model="tests/assets/tinycode-eagle"),
                  kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                                max_tokens=4096))
        llm.engine.graphs.capture = mode == "graph"
        try:
            toks = [o.outputs[0].token_ids for o in llm.generate(prompts, sp)]
            runs[mode] = (toks, list(llm.executor.drafter.acceptance_window),
                          llm.engine.graphs.replayed_launches("spec"))
        finally:
            llm.shutdown()
    assert runs["graph"][:2] == runs["eager"][:2]
    replayed = runs["graph"][2]
    assert replayed[dec.__name__] > 0 and replayed[pre.__name__] > 0
    assert not runs["eager"][2]


# ---- MoE block (ops/moe.py) ----------------------------------------------

def _moe_inputs(T, E, H, I, k, dtype, device, seed=0):
    from tensorrt_llm_tpu_torch.ops import moe
    from tensorrt_llm_tpu_torch.ops.linear import dot_f32
    g = torch.Generator(device=device).manual_seed(seed)

    def mat(*shape, std=0.02):
        return (torch.randn(shape, generator=g, device=device) * std) \
            .to(dtype)
    x = mat(T, H, std=1.0)
    router = mat(E, H)
    probs, idx = moe.topk_routing(dot_f32(x, router), k)
    return x, mat(E, H, 2 * I), mat(E, I, H), router, probs, idx


@pytest.mark.parametrize("T", [1, 64, 2048])
def test_moe_grouped_matches_plain_at_qwen3_30b_a3b_widths(cuda, T):
    """The grouped route (``torch._grouped_mm``, bf16) against the plain
    one at Qwen3-30B-A3B's widths (128 experts, top 8, hidden 2048,
    expert width 768); T = 1 leaves 120 experts without a token."""
    from tensorrt_llm_tpu_torch.ops import moe
    moe.check_grouped(2048, 768, cuda)
    x, wgu, wd, _, probs, idx = _moe_inputs(T, 128, 2048, 768, 8,
                                            torch.bfloat16, cuda)
    got = moe.moe_mlp_grouped(x, wgu, wd, probs, idx)
    want = moe.moe_mlp_plain(x, wgu, wd, probs, idx)
    torch.testing.assert_close(got.float(), want.float(),
                               **TOLS[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_block_makes_no_host_sync(cuda, dtype):
    """One eager MoE block (router, routing, the route of its type: dense
    in float32, grouped in bf16, combine) under
    ``set_sync_debug_mode("error")``: nothing reads a device value on the
    host, so the block can be captured."""
    from tensorrt_llm_tpu_torch.ops import moe
    x, wgu, wd, router, _, _ = _moe_inputs(64, 32, 512, 256, 4, dtype, cuda)
    moe.moe_mlp(x, wgu, wd, router, 4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = moe.moe_mlp(x, wgu, wd, router, 4)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(out.float()).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_block_replays_under_cuda_graph(cuda, dtype):
    """The block captured into a graph: a replay gives the eager run's
    bits (the combine sums over k in a fixed order, no atomics)."""
    from tensorrt_llm_tpu_torch.ops import moe
    x, wgu, wd, router, _, _ = _moe_inputs(64, 128, 2048, 768, 8, dtype,
                                           cuda, seed=1)
    eager, out, _ = _graphed(lambda: moe.moe_mlp(x, wgu, wd, router, 8))
    assert torch.equal(out, eager)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_window_replay_equals_eager(cuda, dtype):
    """A tiny Qwen3-MoE (seeded dummy weights, 4 x 64 heads, 8 experts,
    top 2) serves one workload twice: K-step windows replayed from CUDA
    graphs, and the same windows run eagerly on the same static buffers.
    Tokens are identical; the graphs replayed the decode kernel."""
    from transformers import Qwen3MoeConfig

    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig, SamplingParams
    cfg = Qwen3MoeConfig(vocab_size=512, hidden_size=256,
                         intermediate_size=512, moe_intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2, head_dim=64, num_experts=8,
                         num_experts_per_tok=2, norm_topk_prob=True,
                         max_position_embeddings=512,
                         tie_word_embeddings=False)
    prompts = [[5, 9, 23, 44, 17], list(range(2, 90)), [7] * 12]
    sp = SamplingParams(max_tokens=30, top_k=1, ignore_eos=True)
    runs = {}
    for mode in ("graph", "eager"):
        llm = LLM(cfg, device=cuda, dtype=dtype, skip_tokenizer_init=True,
                  max_batch_size=4, max_input_len=128, max_seq_len=192,
                  max_num_tokens=128, enable_warmup=mode == "graph",
                  kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                                max_tokens=4096))
        llm.engine.graphs.capture = mode == "graph"
        try:
            toks = [o.outputs[0].token_ids for o in llm.generate(prompts, sp)]
            runs[mode] = (toks, llm.engine.graphs.replayed_launches())
        finally:
            llm.shutdown()
    assert runs["graph"][0] == runs["eager"][0]
    assert [len(t) for t in runs["graph"][0]] == [30] * 3
    assert runs["graph"][1][dec.__name__] > 0
    assert not runs["eager"][1]


# ---- head_dim 256 (Gemma 2 and 3) ---------------------------------------
# With a soft cap, q is scaled by 8 so that the scores (std 8) reach the
# cap and attention is peaked; the plain version without the cap must then
# fail the kernel's tolerance, so a kernel that dropped the cap would too.
HD256_CAP_Q_SCALE = 8.0


def _cap_matters(plain, ref, kw, dtype):
    if kw.get("soft_cap"):
        nocap = plain(**{**kw, "soft_cap": None})
        assert not torch.allclose(nocap.float(), ref.float(), **TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("num_splits", [1, 3, None])
@pytest.mark.parametrize("kv_lens,qh,kvh,ps,opt", [
    ([7, 300, 1, 0, 65], 2, 2, 16, None),                  # group 1
    ([1500, 33, 0, 700], 16, 8, 32, "window_softcap"),     # Gemma-2-9B
    ([900, 4, 513], 4, 1, 16, "window_softcap"),           # Gemma-3-1B
    ([170, 44, 3, 0], 16, 2, 16, "sinks"),                 # group 8
    ([9, 380, 26], 8, 2, 32, "alibi"),                     # group 4
])
def test_decode_hd256_matches_plain(cuda, dtype, num_splits, kv_lens, qh,
                                    kvh, ps, opt):
    """K1 at hd 256: groups 1/2/4/8, ragged lengths with zeros, window and
    soft cap, sinks, ALiBi, forced and chosen splits."""
    S = len(kv_lens)
    q, pool, _, pt, _ = _inputs([1] * S, [max(k - 1, 0) for k in kv_lens],
                                qh, kvh, 256, ps, dtype, cuda, seed=6)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=cuda)
    kw = dict(sm_scale=256 ** -0.5, **_opts(opt, qh, cuda))
    if kw.get("soft_cap"):
        q.mul_(HD256_CAP_Q_SCALE)
    before = dec.LAUNCHES
    got = dec.paged_decode_attention(q, pool, kvl, pt, num_splits=num_splits,
                                     max_kv_len=max(kv_lens), **kw)
    torch.cuda.synchronize()
    assert dec.LAUNCHES == before + 1
    ref = dec.paged_decode_attention_plain(q, pool, kvl, pt, **kw)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), ref.float(), **TOLS[dtype])
    assert not got[torch.tensor(kv_lens) == 0].any()
    _cap_matters(lambda **o: dec.paged_decode_attention_plain(
        q, pool, kvl, pt, **o), ref, kw, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_lens,ctx_lens,qh,kvh,ps,opt", [
    ([70, 1, 45], [3, 90, 0], 2, 2, 16, None),             # group 1
    ([200, 40, 1], [100, 0, 300], 16, 8, 32, "window_softcap"),
    ([130, 1, 1], [0, 600, 20], 4, 1, 16, "window_softcap"),
    ([64, 2], [0, 700], 16, 2, 32, "sinks"),               # group 8
    ([13, 300], [5, 77], 8, 2, 16, "alibi"),               # group 4
])
def test_prefill_hd256_matches_plain(cuda, dtype, q_lens, ctx_lens, qh, kvh,
                                     ps, opt):
    """K2 at hd 256: both halves of the output columns, decode rows beside
    chunks, window and soft cap, sinks, ALiBi."""
    q, pool, kvl, pt, cu = _inputs(q_lens, ctx_lens, qh, kvh, 256, ps, dtype,
                                   cuda, seed=7)
    kw = dict(sm_scale=256 ** -0.5, **_opts(opt, qh, cuda))
    if kw.get("soft_cap"):
        q.mul_(HD256_CAP_Q_SCALE)
    before = pre.LAUNCHES
    got = pre.ragged_prefill_attention(q, pool, kvl, pt, cu,
                                       max_q_len=max(q_lens), **kw)
    torch.cuda.synchronize()
    assert pre.LAUNCHES == before + 1
    ref = pre.ragged_prefill_attention_plain(q, pool, kvl, pt, cu, **kw)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), ref.float(), **TOLS[dtype])
    _cap_matters(lambda **o: pre.ragged_prefill_attention_plain(
        q, pool, kvl, pt, cu, **o), ref, kw, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hd256_nan_past_kv_len_is_ignored(cuda, dtype):
    """Positions past kv_len (NaN here) reach neither kernel's output at
    hd 256."""
    q, pool, kvl, pt, cu = _inputs([50, 1], [0, 70], 8, 4, 256, 16, dtype,
                                   cuda, seed=8)
    ref = pre.ragged_prefill_attention_plain(q, pool, kvl, pt, cu,
                                             sm_scale=0.0625)
    for s, n in enumerate(kvl.tolist()):
        page, off = pt[s, n // 16].item(), n % 16
        pool[page, off:] = float("nan")
    got = pre.ragged_prefill_attention(q, pool, kvl, pt, cu, max_q_len=50,
                                       sm_scale=0.0625)
    dgot = dec.paged_decode_attention(q[50:], pool, kvl[1:], pt[1:],
                                      sm_scale=0.0625, num_splits=2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), **TOLS[dtype])
    torch.testing.assert_close(dgot.float(), ref[50:].float(), **TOLS[dtype])


@pytest.mark.parametrize("hd", [112, 192, 512])
def test_other_head_dims_refused_by_name(cuda, hd):
    q, pool, kvl, pt, cu = _inputs([3], [5], 4, 2, hd, 16, torch.bfloat16,
                                   cuda)
    with pytest.raises(ValueError, match=f"hd={hd}"):
        dec.paged_decode_attention(q[:1], pool, kvl, pt, sm_scale=0.1)
    with pytest.raises(ValueError, match=f"hd={hd}"):
        pre.ragged_prefill_attention(q, pool, kvl, pt, cu, sm_scale=0.1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_hd256_split_replays_under_cuda_graph(cuda, dtype):
    """K1 at hd 256 with more than one split, window on: a replay gives the
    eager launch's bits and reads the current q."""
    kv_lens = [6200, 6150, 17, 6208]
    S, qh, kvh, hd = 4, 16, 8, 256
    q, pool, _, pt, _ = _inputs([1] * S, [k - 1 for k in kv_lens], qh, kvh,
                                hd, 32, dtype, cuda, seed=9)
    q.mul_(HD256_CAP_Q_SCALE)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=cuda)
    kw = dict(sm_scale=hd ** -0.5, max_kv_len=8192, sliding_window=4096,
              soft_cap=50.0)
    assert dec.splits_for(S, qh, kvh, pt.shape[1] * 32, 8192, 4096,
                          cuda) > 1
    eager, out, graph = _graphed(
        lambda: dec.paged_decode_attention(q, pool, kvl, pt, **kw))
    assert torch.equal(out, eager)
    q.mul_(-0.5)
    graph.replay()
    want = dec.paged_decode_attention(q, pool, kvl, pt, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    pkw = dict(sm_scale=hd ** -0.5, sliding_window=4096, soft_cap=50.0)
    ref = dec.paged_decode_attention_plain(q, pool, kvl, pt, **pkw)
    torch.testing.assert_close(out.float(), ref.float(), **TOLS[dtype])
    _cap_matters(lambda **o: dec.paged_decode_attention_plain(
        q, pool, kvl, pt, **o), ref, pkw, dtype)


def _tiny_gemma2(hd=256):
    from transformers import Gemma2Config
    return Gemma2Config(vocab_size=512, hidden_size=256,
                        intermediate_size=512, num_hidden_layers=4,
                        num_attention_heads=4, num_key_value_heads=2,
                        head_dim=hd, query_pre_attn_scalar=hd,
                        sliding_window=32, max_position_embeddings=512)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vswa_window_replay_equals_eager(cuda, dtype):
    """A tiny Gemma 2 at hd 256 with VSWA (window 32, page 16) serves one
    workload twice: K-step windows replayed from CUDA graphs, and the
    same windows run eagerly on the same static buffers. Tokens are
    identical; the graphs replayed K1; and the windows ran with sliding
    page tables that hold released entries (blocks handed back while the
    sequences still ran)."""
    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig, SamplingParams
    prompts = [[5, 9, 23, 44, 17], list(range(2, 140)), [7] * 40]
    sp = SamplingParams(max_tokens=60, top_k=1, ignore_eos=True)
    runs = {}
    for mode in ("graph", "eager"):
        llm = LLM(_tiny_gemma2(), device=cuda, dtype=dtype,
                  skip_tokenizer_init=True, max_batch_size=4,
                  max_input_len=192, max_seq_len=256, max_num_tokens=256,
                  enable_warmup=mode == "graph",
                  kv_cache_config=KvCacheConfig(
                      tokens_per_block=16, max_tokens=4096,
                      max_attention_window=[32, 256]))
        llm.engine.graphs.capture = mode == "graph"
        try:
            toks = [o.outputs[0].token_ids for o in llm.generate(prompts, sp)]
            runs[mode] = (toks, llm.engine.graphs.replayed_launches(),
                          llm.kv_cache_manager.trimmed_blocks)
        finally:
            llm.shutdown()
    assert runs["graph"][0] == runs["eager"][0]
    assert [len(t) for t in runs["graph"][0]] == [60] * 3
    assert runs["graph"][1][dec.__name__] > 0
    assert not runs["eager"][1]
    assert runs["graph"][2] > 0 and runs["graph"][2] == runs["eager"][2]


@pytest.mark.parametrize("vswa", [False, True], ids=["single", "vswa"])
def test_gemma2_hd256_cuda_matches_cpu(cuda, vswa, tmp_path):
    """The tiny Gemma 2 at hd 256 in float32 (a seeded transformers model
    saved to a directory): the kernel path on the card (K1 and K2 at hd
    256, window and soft cap) and the plain path on the CPU give the same
    greedy tokens, with one pool and with VSWA."""
    from transformers import Gemma2ForCausalLM

    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig, SamplingParams
    torch.manual_seed(0)
    Gemma2ForCausalLM(_tiny_gemma2()).save_pretrained(tmp_path)
    prompts = [list(range(2, 100)), [3, 1, 4, 1, 5, 9, 2, 6], [8] * 50]
    sp = SamplingParams(max_tokens=40, top_k=1, ignore_eos=True)
    kv = dict(tokens_per_block=16, max_tokens=4096)
    if vswa:
        kv["max_attention_window"] = [32, 256]
    outs = {}
    for dev in ("cuda", "cpu"):
        llm = LLM(tmp_path, device=dev, dtype="float32",
                  skip_tokenizer_init=True, max_batch_size=4,
                  max_input_len=128, max_seq_len=256, max_num_tokens=128,
                  kv_cache_config=KvCacheConfig(**kv))
        try:
            outs[dev] = [o.outputs[0].token_ids
                         for o in llm.generate(prompts, sp)]
        finally:
            llm.shutdown()
    assert outs["cuda"] == outs["cpu"]


# ---- 8-bit KV pools (int8, float8 e4m3) -----------------------------------

# per-kind (k_scale, v_scale): different for K and V, so that a kernel that
# swapped or dropped one fails; randn pools quantized by them (int8 clips
# past about 4 sigma, e4m3 stays inside +-448)
KV8 = {torch.int8: (0.04, 0.03), torch.float8_e4m3fn: (0.02, 0.015)}


def _inputs8(q_lens, ctx_lens, qh, kvh, hd, ps, dtype, kv8, device, seed=0):
    """``_inputs`` with the pool quantized to ``kv8`` by its KV8 scales
    (``quantize_kv``, the port's write_kv arithmetic, K and V apart); the
    scales come back as float32 scalars on the device."""
    from tensorrt_llm_tpu_torch.ops.attention import quantize_kv
    q, pool, kvl, pt, cu = _inputs(q_lens, ctx_lens, qh, kvh, hd, ps,
                                   torch.float32, device, seed)
    ks, vs = (torch.tensor(v, dtype=torch.float32, device=device)
              for v in KV8[kv8])
    pool8 = torch.empty(pool.shape, dtype=kv8, device=device)
    pool8[:, :, 0::2] = quantize_kv(pool[:, :, 0::2], ks, kv8)
    pool8[:, :, 1::2] = quantize_kv(pool[:, :, 1::2], vs, kv8)
    return q.to(dtype), pool8, kvl, pt, cu, ks, vs


def _scales_matter(ref, plain, kw, dtype):
    """The plain version with either scale dropped misses the tolerance
    the kernel is held to, so a kernel that lost a scale would fail."""
    for drop in ("k_scale", "v_scale"):
        other = plain(**{**kw, drop: None})
        assert not torch.allclose(other.float(), ref.float(), **TOLS[dtype])


@pytest.mark.parametrize("kv8", list(KV8), ids=["int8", "e4m3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_lens,qh,kvh,hd,ps,opt,splits", [
    ([7, 300, 1, 0, 65], 8, 2, 64, 16, None, None),       # group 4
    ([150, 33, 513], 32, 4, 128, 16, None, None),         # group 8
    ([100, 31], 8, 8, 64, 32, None, None),                # group 1
    ([161, 5, 290], 8, 2, 64, 16, "window_softcap", None),
    ([17, 44, 3], 8, 2, 128, 16, "sinks", None),
    ([700, 1500, 33], 16, 8, 256, 32, "window_softcap", 3),
    ([3000, 17, 2500, 1], 16, 4, 128, 32, None, 5),
])
def test_decode_kernel_8bit_pool_matches_plain(cuda, kv8, dtype, kv_lens, qh,
                                               kvh, hd, ps, opt, splits):
    S = len(kv_lens)
    q, pool, _, pt, _, ks, vs = _inputs8([1] * S,
                                         [max(k - 1, 0) for k in kv_lens],
                                         qh, kvh, hd, ps, dtype, kv8, cuda)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=cuda)
    kw = dict(sm_scale=hd ** -0.5, k_scale=ks, v_scale=vs,
              **_opts(opt, qh, cuda))
    before = dec.LAUNCHES
    got = dec.paged_decode_attention(q, pool, kvl, pt, num_splits=splits,
                                     **kw)
    torch.cuda.synchronize()
    assert dec.LAUNCHES == before + 1

    def plain(**o):
        return dec.paged_decode_attention_plain(q, pool, kvl, pt, **o)
    ref = plain(**kw)
    torch.testing.assert_close(got.float(), ref.float(), **TOLS[dtype])
    _scales_matter(ref, plain, kw, dtype)


@pytest.mark.parametrize("kv8", list(KV8), ids=["int8", "e4m3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_lens,ctx_lens,qh,kvh,hd,ps,opt", [
    ([5, 1, 70], [0, 20, 100], 8, 2, 64, 16, None),
    ([64, 1, 33], [0, 500, 7], 32, 4, 128, 16, None),     # group 8, mixed
    ([40, 1], [0, 90], 8, 8, 64, 32, "window_softcap"),   # group 1
    ([30, 2], [5, 40], 8, 2, 64, 16, "sinks"),
    ([300, 1, 70], [0, 900, 500], 16, 8, 256, 32, "window_softcap"),
    # the rider window's launch: decode rows, chunks and a filler row
    ([1] * 64 + [60] * 8 + [32], [180 + i for i in range(64)]
     + [64 * i for i in range(8)] + [0], 16, 4, 128, 16, None),
    # the spec window's verify launch: 64 rows x 4 queries (d = 3)
    ([4] * 64, [125 + 2 * i for i in range(64)], 16, 4, 128, 32, None),
])
def test_prefill_kernel_8bit_pool_matches_plain(cuda, kv8, dtype, q_lens,
                                                ctx_lens, qh, kvh, hd, ps,
                                                opt):
    q, pool, kvl, pt, cu, ks, vs = _inputs8(q_lens, ctx_lens, qh, kvh, hd,
                                            ps, dtype, kv8, cuda)
    kw = dict(sm_scale=hd ** -0.5, k_scale=ks, v_scale=vs,
              **_opts(opt, qh, cuda))
    before = pre.LAUNCHES
    got = pre.ragged_prefill_attention(q, pool, kvl, pt, cu,
                                       max_q_len=max(q_lens), **kw)
    torch.cuda.synchronize()
    assert pre.LAUNCHES == before + 1

    def plain(**o):
        return pre.ragged_prefill_attention_plain(q, pool, kvl, pt, cu, **o)
    ref = plain(**kw)
    torch.testing.assert_close(got.float(), ref.float(), **TOLS[dtype])
    _scales_matter(ref, plain, kw, dtype)


@pytest.mark.parametrize("kv8", list(KV8), ids=["int8", "e4m3"])
@pytest.mark.parametrize("kind", ["decode_split", "prefill_rider"])
def test_8bit_pool_replay_reads_scales_changed_in_place(cuda, kv8, kind):
    """A captured launch on an 8-bit pool gives the eager launch's bits,
    and after the scales are changed in place (as calibration writes
    them) a replay gives the bits of an eager launch at the new scales."""
    if kind == "decode_split":
        kv_lens = [3000, 17, 2500, 1]
        q_lens, ctx = [1] * 4, [k - 1 for k in kv_lens]
    else:
        q_lens = [1] * 64 + [60] * 8 + [32]
        ctx = [180 + i for i in range(64)] + [64 * i for i in range(8)] + [0]
    q, pool, kvl, pt, cu, ks, vs = _inputs8(q_lens, ctx, 16, 4, 128, 32,
                                            torch.bfloat16, kv8, cuda, seed=9)
    kw = dict(sm_scale=128 ** -0.5, k_scale=ks, v_scale=vs)
    if kind == "decode_split":
        assert dec.splits_for(4, 16, 4, pt.shape[1] * 32, 3000, None,
                              cuda) > 1

        def run():
            return dec.paged_decode_attention(q, pool, kvl, pt,
                                              max_kv_len=3000, **kw)
    else:
        def run():
            return pre.ragged_prefill_attention(q, pool, kvl, pt, cu,
                                                max_q_len=512, **kw)
    eager, out, graph = _graphed(run)
    assert torch.equal(out, eager)
    ks.mul_(1.5)
    vs.mul_(0.5)
    graph.replay()
    want = run()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert not torch.equal(out, eager)


def test_pool_of_another_type_refused_by_name(cuda):
    """A pool that is neither q's type nor an 8-bit KV type raises."""
    q, pool, kvl, pt, cu = _inputs([1, 1], [3, 4], 4, 2, 64, 16,
                                   torch.bfloat16, cuda)
    for bad in (torch.float16, torch.float32):
        with pytest.raises(TypeError, match="KV pool dtype"):
            dec.paged_decode_attention(q, pool.to(bad), kvl, pt,
                                       sm_scale=0.125)
        with pytest.raises(TypeError, match="KV pool dtype"):
            pre.ragged_prefill_attention(q, pool.to(bad), kvl, pt, cu,
                                         sm_scale=0.125)


def test_llm_int8_kv_cuda_matches_cpu(cuda):
    """The parity checkpoint in float32 on an INT8 KV pool: the card's
    8-bit kernels and the CPU's plain path give the same greedy tokens,
    with the same calibrated scales."""
    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig, SamplingParams
    from tensorrt_llm_tpu_torch.llmapi.llm_args import QuantConfig
    from tensorrt_llm_tpu_torch.quantization.mode import KvCacheQuantAlgo
    prompts = [list(range(3 + i, 40 + i)) for i in range(3)] + [[7] * 70]
    outs, scales = {}, {}
    for dev in ("cuda", "cpu"):
        llm = LLM("tests/assets/tinycode-llama", device=dev, dtype="float32",
                  skip_tokenizer_init=True, max_batch_size=4,
                  max_input_len=128, max_seq_len=256, max_num_tokens=64,
                  quant_config=QuantConfig(
                      kv_cache_quant_algo=KvCacheQuantAlgo.INT8),
                  kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                                max_tokens=4096))
        try:
            assert llm.engine.kv_pages.dtype == torch.int8
            scales[dev] = [float(l["kv_scale"])
                           for l in llm.engine.params["layers"]]
            res = llm.generate(prompts, SamplingParams(max_tokens=24,
                                                       top_k=1))
            outs[dev] = [r.outputs[0].token_ids for r in res]
        finally:
            llm.shutdown()
    np.testing.assert_allclose(scales["cuda"], scales["cpu"], rtol=1e-4)
    assert outs["cuda"] == outs["cpu"]


# ---- host-orchestrated drafting (verify steps, the two-model drafter) ----

_HOST_KVS = [513 + (127 * i) // 31 for i in range(32)]


@pytest.mark.parametrize("kind,q_len,hd", [("verify_host_8b", 5, 128),
                                           ("decode_draft_1b", 1, 64)])
def test_host_spec_shapes_match_plain(cuda, kind, q_len, hd):
    """K2 at the target's verify step (32 sequences x 5 queries at
    513-640 KV, Llama-3-8B's 32 x 128 heads over 8) and K1 at the
    drafter's chained steps (32 rows at 513-640 KV, Llama-3.2-1B's 32 x 64
    over 8), bf16, against their plain versions."""
    q, pool, kvl, pt, cu = _inputs([q_len] * 32,
                                   [k - q_len for k in _HOST_KVS], 32, 8,
                                   hd, 32, torch.bfloat16, cuda, seed=5)
    kw = dict(sm_scale=hd ** -0.5)
    if q_len > 1:
        got = pre.ragged_prefill_attention(q, pool, kvl, pt, cu,
                                           max_q_len=q_len, **kw)
        ref = pre.ragged_prefill_attention_plain(q, pool, kvl, pt, cu, **kw)
    else:
        got = dec.paged_decode_attention(q, pool, kvl, pt,
                                         max_kv_len=max(_HOST_KVS), **kw)
        ref = dec.paged_decode_attention_plain(q, pool, kvl, pt, **kw)
    torch.testing.assert_close(got.float(), ref.float(),
                               **TOLS[torch.bfloat16])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_verify_step_replay_equals_eager(cuda, dtype):
    """One verify step (decode rows with 0-3 drafts after a prefill step)
    replayed from its graph and run eagerly on the same static buffers
    (``graphs.capture = False``), each in an engine of its own from the
    same state: tokens and logprobs bit-equal; the replay launched K2."""
    import tensorrt_llm_tpu_torch as T
    from tensorrt_llm_tpu_torch.runtime.request import (LlmRequest,
                                                        LlmRequestState)
    from tensorrt_llm_tpu_torch.runtime.scheduler import ScheduledRequests

    def _batch(_, specs):
        b = ScheduledRequests()
        for i, sp in enumerate(specs):
            r = LlmRequest(list(sp["prompt"]), T.SamplingParams(top_k=1),
                           request_id=100 + i)
            r.seq_slot, r.kv_block_ids = sp["slot"], list(sp["blocks"])
            if sp["kind"] == "ctx":
                r.context_chunk_size = sp["chunk"]
                b.context_requests.append(r)
            else:
                r.state = LlmRequestState.GENERATION_IN_PROGRESS
                r.output_token_ids = list(sp["out"])
                r.num_device_tokens = sp["pos"]
                r.host_token_override = sp["override"]
                r.draft_tokens = list(sp["drafts"])
                b.generation_requests.append(r)
        return b
    prompts = [list(range(3 + 2 * i, 30 + 3 * i)) for i in range(3)]
    blocks = [[2 * i, 2 * i + 1, 20 + i] for i in range(3)]
    ctx = [dict(kind="ctx", prompt=p, slot=i, blocks=b, start=0,
                chunk=len(p)) for i, (p, b) in enumerate(zip(prompts, blocks))]
    out = {}
    for mode in ("graph", "eager"):
        llm = T.LLM("tests/assets/tinycode-llama", device=cuda, dtype=dtype,
                    skip_tokenizer_init=True, max_batch_size=6,
                    max_input_len=64, max_seq_len=128, max_num_tokens=256,
                    enable_warmup=False,
                    speculative_config=T.SpeculativeConfig(mode="NGRAM",
                                                           max_draft_len=3),
                    kv_cache_config=T.KvCacheConfig(tokens_per_block=16,
                                                    max_tokens=2048))
        eng = llm.engine
        eng.graphs.capture = mode == "graph"
        try:
            first = eng.forward_step(_batch("torch", ctx))[0].cpu()
            first = first.view(-1, 4)[:3, 0].tolist()
            drafts = ([5, 6, 7], [], [first[2], 1])
            gen = [dict(kind="gen", prompt=p, out=[f], slot=i, blocks=b,
                        pos=len(p), override=f, drafts=d)
                   for i, (p, b, f, d) in enumerate(zip(prompts, blocks,
                                                        first, drafts))]
            before = pre.LAUNCHES
            tok, lp = eng.forward_step(_batch("torch", gen))
            torch.cuda.synchronize()
            out[mode] = (tok.cpu().clone(), lp.cpu().clone(),
                         pre.LAUNCHES - before,
                         [k for k, s in eng.graphs.steps.items()
                          if s.graph is not None and k[0] == "verify"])
        finally:
            llm.shutdown()
    assert torch.equal(out["graph"][0], out["eager"][0])
    assert torch.equal(out["graph"][1], out["eager"][1])
    assert out["graph"][2] > 0 and out["graph"][3] and not out["eager"][3]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_drafter_chain_graph_equals_eager(cuda, dtype):
    """The two-model drafter's chained steps replayed from a CUDA graph
    and run eagerly on the same static buffers: drafts and the drafter's
    KV pool bit-equal over three calls (catch-ups of one and of several
    tokens); the replay launched K1."""
    import tensorrt_llm_tpu_torch as T
    from tensorrt_llm_tpu_torch.llmapi.llm import LLM

    class R:
        def __init__(self, rid, toks):
            self.request_id, self.all_token_ids = rid, list(toks)
            self.draft_tokens = []
    out = {}
    for mode in ("graph", "eager"):
        holder = LLM.__new__(LLM)
        holder.args = T.LlmArgs(model="m", dtype=dtype, max_batch_size=4,
                                max_seq_len=256)
        holder.device = cuda
        dr = holder._build_two_model_drafter(T.SpeculativeConfig(
            mode="DRAFT_TARGET", max_draft_len=4,
            draft_model="tests/assets/tinycode-llama"), 4)
        dr.graphs.capture = mode == "graph"
        reqs = [R(0, b"def f(x):\n    return x"), R(1, b"import os\n"),
                R(2, list(range(40, 60)))]
        drafts = []
        for step in range(3):
            dr.prepare_draft_tokens(reqs)
            drafts.append([r.draft_tokens for r in reqs])
            for r in reqs:
                r.all_token_ids += r.draft_tokens[:step + 1]
        torch.cuda.synchronize()
        out[mode] = (drafts, dr.kv.cpu(), dr.graphs.replayed_launches())
    assert out["graph"][0] == out["eager"][0]
    assert torch.equal(out["graph"][1], out["eager"][1])
    assert out["graph"][2][dec.__name__] > 0 and not out["eager"][2]


# ---- the sampling surface (no-repeat-ngram, bias, bad words, beams) -------

@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_surface_options_replay_equals_eager(cuda, K, dtype):
    """tinycode-llama serves one batch with no-repeat-ngram, an embedding
    bias and bad words (each row its own mix) twice on the card: single
    steps (K = 1) or K-step windows (K = 8; the bad-word rows take single
    steps) replayed from CUDA graphs whose keys carry the options, and the
    same steps run eagerly on the same static buffers. Tokens are
    identical, and graphs with the options in their keys replayed."""
    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig, SamplingParams
    from tensorrt_llm_tpu_torch.runtime.model_engine import LogitsOps
    V = 256
    bias = np.random.default_rng(0).standard_normal(V).astype(np.float32)
    prompts = [list(b"def forward(self, x):\n    return "),
               list(b"abcabcabcabc"), list(b"import torch\n"),
               list(range(32, 90))]
    sps = [SamplingParams(max_tokens=32, top_k=1, ignore_eos=True, **kw)
           for kw in (dict(no_repeat_ngram_size=3),
                      dict(embedding_bias=bias),
                      dict(bad_token_ids=[32, 101, 10]),
                      dict(no_repeat_ngram_size=2, embedding_bias=bias))]
    runs = {}
    for mode in ("graph", "eager"):
        llm = LLM("tests/assets/tinycode-llama", device=cuda, dtype=dtype,
                  skip_tokenizer_init=True, max_batch_size=4,
                  max_input_len=128, max_seq_len=256, max_num_tokens=256,
                  decode_multi_step=K, enable_warmup=mode == "graph",
                  kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                                max_tokens=4096))
        llm.engine.graphs.capture = mode == "graph"
        try:
            futs = [llm.generate_async(p, sp) for p, sp in zip(prompts, sps)]
            toks = [f.result().outputs[0].token_ids for f in futs]
            ops = [[x for x in k if isinstance(x, LogitsOps)][0]
                   for k, st in llm.engine.graphs.steps.items()
                   if st.replays]
            keys = [o for o in ops if o.ngram or o.bias or o.nb]
            runs[mode] = (toks, keys)
        finally:
            llm.shutdown()
    assert runs["graph"][0] == runs["eager"][0]
    assert runs["graph"][1]
    assert 32 not in runs["graph"][0][2] and 101 not in runs["graph"][0][2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_beam_fork_copy_pages_equals_host_copy(cuda, dtype):
    """``ModelEngine.copy_pages`` on the card equals the same copy made on
    a host copy of the pool, a swap of two pages among the copies."""
    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig
    llm = LLM("tests/assets/tinycode-llama", device=cuda, dtype=dtype,
              skip_tokenizer_init=True, max_batch_size=2, max_input_len=64,
              max_seq_len=128, enable_warmup=False,
              kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                            max_tokens=512))
    try:
        eng = llm.engine
        g = torch.Generator(device=cuda).manual_seed(0)
        eng.kv_pages.copy_(torch.randn(eng.kv_pages.shape, generator=g,
                                       device=cuda).to(eng.kv_pages.dtype))
        src, dst = [3, 7, 5, 9], [7, 3, 11, 12]
        want = eng.kv_pages.cpu()
        want[:, dst] = want[:, src].clone()
        eng.copy_pages(src, dst)
        assert torch.equal(eng.kv_pages.cpu(), want)
        assert eng.pages_copied == 4
    finally:
        llm.shutdown()


def test_beam_search_card_equals_cpu(cuda):
    """Beam search (width 4, n 3) on tinycode-llama in float32: the card
    (steps replayed from graphs, forks copied on the device) returns the
    CPU's hypotheses, scores within 1e-4."""
    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig, SamplingParams
    sp = SamplingParams(max_tokens=12, use_beam_search=True, best_of=4, n=3,
                        length_penalty=0.0)
    prompts = [list(b"def forward(self, x):\n    return "),
               list(b"import numpy as np\nimport ")]
    outs = {}
    for device in (cuda, "cpu"):
        llm = LLM("tests/assets/tinycode-llama", device=device,
                  dtype="float32", skip_tokenizer_init=True, max_batch_size=8,
                  max_input_len=64, max_seq_len=128, max_beam_width=4,
                  kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                                max_tokens=1024))
        try:
            outs[str(device)] = [[(o.token_ids, o.cumulative_logprob)
                                  for o in r.outputs]
                                 for r in llm.generate(prompts, sp)]
            if device != "cpu":
                assert llm.engine.pages_copied > 0
                assert llm.engine.graphs.replays > 0
        finally:
            llm.shutdown()
    got, want = outs[str(cuda)], outs["cpu"]
    for g_, w_ in zip(got, want):
        assert [t for t, _ in g_] == [t for t, _ in w_]
        np.testing.assert_allclose([s for _, s in g_], [s for _, s in w_],
                                   rtol=0, atol=1e-4)


def _guided_llm(device, dtype, K, mode="graph"):
    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig
    llm = LLM("tests/assets/tinycode-llama", device=device, dtype=dtype,
              skip_tokenizer_init=True, max_batch_size=4, max_input_len=128,
              max_seq_len=256, max_num_tokens=256, decode_multi_step=K,
              enable_warmup=mode == "graph", guided_decoding_backend="dfa",
              guided_token_bytes="byte",
              kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                            max_tokens=4096))
    llm.engine.graphs.capture = mode == "graph"
    return llm


@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_guided_replay_equals_eager(cuda, K, dtype):
    """tinycode-llama with the device guided backend serves one batch of
    grammar rows (regex, EBNF) beside an unguided row twice on the card:
    single steps (K = 1) or K-step windows (K = 8) replayed from CUDA
    graphs whose keys carry the grammar walk, and the same steps run
    eagerly on the same static buffers. Tokens are identical, graphs with
    the walk in their keys replayed, and each guided output is a live
    prefix of its grammar."""
    from tensorrt_llm_tpu_torch import GuidedDecodingParams, SamplingParams
    from tensorrt_llm_tpu_torch.runtime.model_engine import LogitsOps
    prompts = [list(b"def forward(self, x):\n    return "),
               list(b"x = 1\ny = "), list(b"import torch\n")]
    gps = [GuidedDecodingParams(regex=r"[a-z_]+\(\d{1,3}\)"),
           GuidedDecodingParams(grammar='root ::= "[" [0-9]+ ("," [0-9]+)* '
                                        '"]"'), None]
    sps = [SamplingParams(max_tokens=32, top_k=1, end_id=0,
                          ignore_eos=gp is None, guided_decoding=gp)
           for gp in gps]
    runs = {}
    for mode in ("graph", "eager"):
        llm = _guided_llm(cuda, dtype, K, mode)
        try:
            futs = [llm.generate_async(p, sp) for p, sp in zip(prompts, sps)]
            toks = [f.result().outputs[0].token_ids for f in futs]
            ops = [[x for x in k if isinstance(x, LogitsOps)][0]
                   for k, st in llm.engine.graphs.steps.items()
                   if st.replays]
            runs[mode] = (toks, [o for o in ops if o.guided])
            factory = llm.executor.guided_decoder.factory
        finally:
            llm.shutdown()
    assert runs["graph"][0] == runs["eager"][0]
    assert runs["graph"][1]
    for toks, gp in zip(runs["graph"][0][:2], gps):
        _, dfa = factory.compile_dfa(gp)
        s = dfa.start
        for t in toks[:toks.index(0) if 0 in toks else len(toks)]:
            s = int(dfa.table[s, t])
            assert s >= 0


@pytest.mark.parametrize("V", [257, 128256])
def test_guided_mask_unpack_equals_bool(cuda, V):
    """The packed bit masks unpack on the card to the bool masks they came
    from: the device pool's rows (``np.packbits``, little-endian) and the
    host backend's mask as the step's int32 input (``_pack_mask``)."""
    from tensorrt_llm_tpu_torch.runtime.model_engine import (_pack_mask,
                                                             _unpack_bits)
    rng = np.random.default_rng(V)
    mask = rng.random((64, V)) < 0.3
    bits = torch.as_tensor(np.packbits(mask, axis=1, bitorder="little"),
                           device=cuda)
    assert torch.equal(_unpack_bits(bits, V).cpu(), torch.as_tensor(mask))
    words = torch.as_tensor(_pack_mask(mask), device=cuda)
    assert torch.equal(_unpack_bits(words.view(torch.uint8), V).cpu(),
                       torch.as_tensor(mask))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_guided_state_after_window_equals_host(cuda, dtype):
    """After a request's last replayed window (17 tokens: the prefill
    step's and two windows of K = 8, each of whose tokens the host keeps;
    the grammar never accepting so that no EOS ends it), the slot's
    grammar state on the card equals the host's ``state_after`` over the
    tokens it returned."""
    from tensorrt_llm_tpu_torch import GuidedDecodingParams, SamplingParams
    llm = _guided_llm(cuda, dtype, 8)
    seen = {}
    ex = llm.executor
    finish = ex._finish_request

    def record(req):
        if req.seq_slot is not None and req.guided_device:
            torch.cuda.synchronize()
            seen[req.request_id] = (int(llm.engine.g_state[req.seq_slot]),
                                    list(req.output_token_ids))
        finish(req)
    ex._finish_request = record
    gp = GuidedDecodingParams(regex="[a-z ]{40}")
    try:
        out = llm.generate(list(b"the quick brown fox "), SamplingParams(
            max_tokens=17, top_k=1, end_id=0, guided_decoding=gp))
        state, toks = seen[out.request_id]
        assert toks == out.outputs[0].token_ids and len(toks) == 17
        assert llm.engine.graphs.replays > 0
        assert state == ex.guided_decoder.device.state_after(gp, toks)
        assert state >= 0
    finally:
        llm.shutdown()


# --------------------------------------------------------------------- #
# The dequant-matmul kernel's e4m3 body and the load-time quantized
# linears (FP8, SmoothQuant, W4A8) on the card
# --------------------------------------------------------------------- #
def _e4m3_inputs(M, K, N, form, dtype, device, seed=0):
    """Seeded x, an e4m3 weight and its scales in ``form``: "tensor"
    (0-dim), "column" ([N], a fused per-tensor projection) or "block"."""
    from tensorrt_llm_tpu_torch.ops import quant as Q
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K), np.float32))
    w = torch.from_numpy(rng.standard_normal((K, N), np.float32) * 0.02)
    if form == "block":
        q, s = Q.quantize_weight_fp8_blockwise(w)
    else:
        q, s = Q.quantize_weight_fp8(w)
        if form == "column":
            s = torch.linspace(0.5, 2.0, N) * s
    return x.to(dtype).to(device), q.to(device), s.to(device)


@pytest.mark.parametrize("M,K,N,form,dtype", [
    (64, 4096, 6144, "column", torch.bfloat16),     # Llama-3-8B qkv
    (1, 4096, 4096, "tensor", torch.bfloat16),      # o, one row
    (64, 4096, 28672, "block", torch.bfloat16),     # gate_up
    (64, 14336, 4096, "block", torch.bfloat16),     # down
    (65, 1024, 1024, "tensor", torch.bfloat16),     # a second row block
    (8, 256, 130, "block", torch.bfloat16),         # N = 130: byte copies
    (128, 1024, 257, "column", torch.bfloat16),     # scales in 4-byte pieces
    (5, 384, 96, "tensor", torch.float32),          # float32 out
    (64, 4096, 6144, "column", torch.float32),
])
def test_e4m3_kernel_matches_plain(cuda, M, K, N, form, dtype):
    x, w, s = _e4m3_inputs(M, K, N, form, dtype, cuda)
    before = (qmm.LAUNCHES, qmm.LAUNCHES_E4M3)
    got = qmm.e4m3_dequant_matmul(x, w, s)
    torch.cuda.synchronize()
    assert (qmm.LAUNCHES, qmm.LAUNCHES_E4M3) == (before[0] + 1,
                                                 before[1] + 1)
    assert got.dtype == dtype and got.shape == (M, N)
    ref = qmm.e4m3_dequant_matmul_plain(x, w, s)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                               atol=tol * max(1.0, ref.abs().max().item()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_finite_e4m3_code_reaches_wgmma_exactly(cuda, dtype):
    """w [128, 256] holds each of the 254 finite e4m3 codes (and both
    zeros) in every row and column position class (code (k + n) % 256,
    the two NaN codes zeroed); x = I: out = w, exactly."""
    k = torch.arange(128)[:, None]
    n = torch.arange(256)[None, :]
    codes = ((k + n) % 256).to(torch.uint8)
    codes[(codes == 0x7F) | (codes == 0xFF)] = 0
    w = codes.view(torch.float8_e4m3fn).to(cuda)
    x = torch.eye(128, dtype=dtype, device=cuda)
    one = torch.ones((), dtype=torch.float32, device=cuda)
    got = qmm.e4m3_dequant_matmul(x, w, one)
    torch.cuda.synchronize()
    assert torch.equal(got.float(), w.float())


def test_e4m3_kernel_refuses_more_than_128_rows(cuda):
    x, w, s = _e4m3_inputs(129, 256, 96, "tensor", torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="contract"):
        qmm.e4m3_dequant_matmul(x, w, s)


def test_e4m3_kernel_is_deterministic_and_replays(cuda):
    x, w, s = _e4m3_inputs(64, 14336, 4096, "block", torch.bfloat16, cuda)
    first = qmm.e4m3_dequant_matmul(x, w, s)
    assert torch.equal(first, qmm.e4m3_dequant_matmul(x, w, s))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qmm.e4m3_dequant_matmul(x, w, s)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qmm.e4m3_dequant_matmul(x, w, s)
    x.mul_(-0.5)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, qmm.e4m3_dequant_matmul(x, w, s))


@pytest.mark.parametrize("algo", ["FP8", "FP8_BLOCK_SCALES",
                                  "W8A8_SQ_PER_CHANNEL", "W4A8_AWQ"])
@pytest.mark.parametrize("M", [1, 17, 64, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_linear_on_cuda_matches_cpu(cuda, algo, M, dtype):
    """Each load-time method's ``apply`` on the card against the CPU's
    (the JAX order): the e4m3 body at up to 128 rows (FP8; FP8 block in
    bf16), the int8 product with its rows padded past 16 inside the call
    (SmoothQuant, W4A8, smoothed), and the upcast route above 128 rows."""
    from tensorrt_llm_tpu_torch import QuantAlgo, QuantConfig
    from tensorrt_llm_tpu_torch.models.modeling_utils import quantize_linear
    from tensorrt_llm_tpu_torch.ops import linear as L
    m = L.make_linear_method(QuantConfig(quant_algo=QuantAlgo[algo]))
    g = torch.Generator().manual_seed(M)
    w = torch.randn((1024, 768), generator=g) * 0.02
    smooth = torch.rand(1024, generator=g) + 0.5 \
        if algo in ("W8A8_SQ_PER_CHANNEL", "W4A8_AWQ") else None
    p = quantize_linear(m, w, dtype=dtype, smooth=smooth)
    x = torch.randn((M, 1024), generator=g).to(dtype)
    want = m.apply(p, x)
    before = qmm.LAUNCHES_E4M3
    got = m.apply({k: v.to(cuda) for k, v in p.items()}, x.to(cuda))
    torch.cuda.synchronize()
    kernel = algo == "FP8" or (algo == "FP8_BLOCK_SCALES" and
                               dtype == torch.bfloat16)
    assert qmm.LAUNCHES_E4M3 - before == int(kernel and M <= 128)
    assert got.dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol * max(1.0, want.abs().max().item()))


def test_int8_product_pads_rows_inside_a_graph(cuda):
    from tensorrt_llm_tpu_torch.ops.linear import int8_mm
    a = torch.randint(-128, 128, (3, 256), dtype=torch.int8, device=cuda)
    b = torch.randint(-128, 128, (256, 512), dtype=torch.int8, device=cuda)
    want = (a.cpu().int() @ b.cpu().int())
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        int8_mm(a, b)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out = int8_mm(a, b)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), want)
    with pytest.raises(ValueError, match="multiples of 8"):
        int8_mm(a[:, :100], b[:100])


def test_phi3_mini_head_dim_96_is_served_on_cuda(cuda, tmp_path):
    """Phi-3-mini's head dim 96 (hidden 192 over 2 heads here) is served
    on the card since K1 and K2 stage hd 96 as 128-wide tiles: float32
    greedy tokens of one saved checkpoint equal the CPU's."""
    import transformers as tf
    import tensorrt_llm_tpu_torch as T
    cfg = tf.Phi3Config(vocab_size=128, hidden_size=192,
                        intermediate_size=256, num_hidden_layers=2,
                        num_attention_heads=2, num_key_value_heads=2,
                        max_position_embeddings=256, pad_token_id=0,
                        eos_token_id=1, bos_token_id=2)
    torch.manual_seed(0)
    model = tf.Phi3ForCausalLM(cfg).float()
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 2:
                p.mul_(4.0)
    model.save_pretrained(tmp_path)
    out = {}
    for dev in ("cuda", "cpu"):
        before = dec.LAUNCHES, pre.LAUNCHES
        llm = T.LLM(str(tmp_path), device=dev, dtype="float32",
                    skip_tokenizer_init=True, max_batch_size=2,
                    max_input_len=32, max_seq_len=64, max_num_tokens=64,
                    kv_cache_config=T.KvCacheConfig(tokens_per_block=16,
                                                    max_tokens=256))
        try:
            res = llm.generate([[5, 6, 7], [9, 3, 11, 40, 2]],
                               T.SamplingParams(max_tokens=6, top_k=1,
                                                end_id=-1))
            out[dev] = [r.outputs[0].token_ids for r in res]
        finally:
            llm.shutdown()
        if dev == "cuda":
            assert dec.LAUNCHES > before[0] and pre.LAUNCHES > before[1]
    assert out["cuda"] == out["cpu"]


def _oss_inputs(T, E, H, I, k, dtype, device, seed=0):
    from tensorrt_llm_tpu_torch.ops import moe
    from tensorrt_llm_tpu_torch.ops.linear import dot_f32
    g = torch.Generator(device=device).manual_seed(seed)

    def mat(*shape, std=0.02, dt=dtype):
        return (torch.randn(shape, generator=g, device=device) * std).to(dt)
    x, router = mat(T, H, std=1.0), mat(E, H)
    rb = mat(E, std=0.1, dt=torch.float32)
    probs, idx = moe.topk_softmax_routing(dot_f32(x, router) + rb, k)
    return dict(x=x, router=router, router_bias=rb,
                w_gate_up=mat(E, H, 2 * I), w_down=mat(E, I, H),
                b_gate_up=mat(E, 2 * I, std=0.1, dt=torch.float32),
                b_down=mat(E, H, std=0.1, dt=torch.float32),
                probs=probs, idx=idx)


@pytest.mark.parametrize("T", [1, 64, 512])
def test_gpt_oss_grouped_matches_plain_at_20b_widths(cuda, T):
    """GPT-OSS's experts on the grouped route (``torch._grouped_mm``,
    bf16, with the float32 biases and the clamped SwiGLU) against the plain
    route at gpt-oss-20b's widths: 32 experts, top 4, hidden 2880, expert
    width 2880 (``check_grouped`` takes them)."""
    from tensorrt_llm_tpu_torch.ops import moe
    moe.check_grouped(2880, 2880, cuda)
    a = _oss_inputs(T, 32, 2880, 2880, 4, torch.bfloat16, cuda)
    args = (a["x"], a["w_gate_up"], a["w_down"], a["probs"], a["idx"],
            a["b_gate_up"], a["b_down"], 7.0)
    got = moe.moe_mlp_grouped(*args)
    want = moe.moe_mlp_plain(*args)
    torch.testing.assert_close(got.float(), want.float(),
                               **TOLS[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpt_oss_moe_block_makes_no_host_sync_and_replays(cuda, dtype):
    """``moe_mlp_swiglu`` (dense route in float32, grouped in bf16) reads
    no device value on the host, and a graph replay gives the eager bits;
    the float32 dense route equals the plain one within 1e-4."""
    from tensorrt_llm_tpu_torch.ops import moe
    a = _oss_inputs(64, 8, 256, 128, 4, dtype, cuda, seed=3)
    keys = ("x", "router", "router_bias", "w_gate_up", "b_gate_up",
            "w_down", "b_down")

    def block():
        return moe.moe_mlp_swiglu(*(a[k] for k in keys), 4, 7.0)
    block()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = block()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    eager, graphed, _ = _graphed(block)
    assert torch.equal(graphed, eager)
    if dtype == torch.float32:
        want = moe.moe_mlp_plain(a["x"], a["w_gate_up"], a["w_down"],
                                 a["probs"], a["idx"], a["b_gate_up"],
                                 a["b_down"], 7.0)
        torch.testing.assert_close(out, want, **TOLS[dtype])


def test_quantizers_on_cuda_give_the_cpu_bytes(cuda):
    """Every load-time quantizer gives on the card the integers, fp8
    bytes and scales it gives on the CPU (where they equal the JAX
    package's): CUDA would multiply by the reciprocal of a host divisor,
    one bit off the quotient, so the quantizers divide by a tensor
    (``ops.quant.div``)."""
    from tensorrt_llm_tpu_torch.ops import quant as Q
    from tensorrt_llm_tpu_torch.ops.linear import W4A8QServeMethod
    g = torch.Generator().manual_seed(5)
    w = torch.randn((688, 384), generator=g) * 0.05
    x = torch.randn((33, 688), generator=g)
    cases = {
        "fp8": lambda t: Q.quantize_weight_fp8(t),
        "fp8_block": lambda t: Q.quantize_weight_fp8_blockwise(t),
        "per_channel": lambda t: Q.quantize_weight_per_channel(t, bits=8),
        "group": lambda t: Q.quantize_weight_groupwise(t, 16, 4)[:2],
        "group_asym": lambda t: Q.quantize_weight_groupwise(
            t, 16, 4, asymmetric=True),
        "nvfp4": lambda t: Q.quantize_weight_fp4(t, 16, "e4m3"),
        "w4a8": lambda t: tuple(W4A8QServeMethod(16).quantize_weights(
            t).values()),
        "per_token": lambda t: Q.quantize_activation_per_token_int8(x.to(
            t.device)),
    }
    for name, fn in cases.items():
        for a, b in zip(fn(w), fn(w.to(cuda))):
            if a is None:
                continue
            b = b.cpu()
            if a.dtype == torch.float8_e4m3fn:
                a, b = a.view(torch.uint8), b.view(torch.uint8)
            assert torch.equal(a, b), name


# ---- the GPT families' geometries: hd 80 and 96, groups above 64, sinks
# with a window, ALiBi -------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("num_splits", [1, 3, None])
@pytest.mark.parametrize("kv_lens,qh,kvh,hd,ps,opt", [
    ([7, 300, 1, 0, 65], 32, 32, 80, 16, None),         # StableLM-3B
    ([150, 33, 513], 16, 16, 96, 16, None),             # GPT-NeoX-20B
    ([9, 380, 26], 8, 8, 96, 16, "alibi"),
    ([170, 44, 3, 0], 8, 2, 80, 16, "sinks_window"),
    ([40, 700, 3, 0], 71, 1, 64, 16, None),             # Falcon-7B
    ([300, 17], 71, 1, 64, 16, "sinks"),
    ([513, 600, 640, 129, 5], 64, 8, 64, 16, "sinks_window"),   # gpt-oss
    ([9, 380, 26], 32, 32, 128, 16, "alibi"),           # bloom-7b1
])
def test_gpt_geometry_decode_matches_plain(cuda, dtype, num_splits, kv_lens,
                                           qh, kvh, hd, ps, opt):
    S = len(kv_lens)
    q, pool, _, pt, _ = _inputs([1] * S, [max(k - 1, 0) for k in kv_lens],
                                qh, kvh, hd, ps, dtype, cuda, seed=7)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=cuda)
    kw = dict(sm_scale=hd ** -0.5, **_opts(opt, qh, cuda))
    before = dec.LAUNCHES
    got = dec.paged_decode_attention(q, pool, kvl, pt, num_splits=num_splits,
                                     max_kv_len=max(kv_lens), **kw)
    torch.cuda.synchronize()
    assert dec.LAUNCHES == before + 1
    ref = dec.paged_decode_attention_plain(q, pool, kvl, pt, **kw)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), ref.float(), **TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_lens,ctx_lens,qh,kvh,hd,ps,opt", [
    ([70, 1, 45], [3, 90, 0], 8, 8, 80, 16, None),
    ([200, 3], [0, 77], 16, 16, 96, 16, None),
    ([250, 9], [10, 300], 8, 2, 96, 16, "window_softcap"),
    ([9, 121, 1], [4, 0, 30], 8, 8, 80, 16, "alibi"),
    ([13, 1, 90], [0, 400, 5], 71, 1, 64, 16, None),    # two head chunks
    ([30, 2], [5, 40], 71, 1, 64, 16, "sinks"),
    ([7, 20], [0, 33], 130, 1, 64, 16, "alibi"),        # three head chunks
    ([300, 1, 40], [0, 600, 100], 64, 8, 64, 16, "sinks_window"),
    ([130, 2], [0, 300], 8, 2, 96, 16, "sinks_window"),
    ([9, 121, 1], [4, 0, 30], 32, 32, 128, 16, "alibi"),
])
def test_gpt_geometry_prefill_matches_plain(cuda, dtype, q_lens, ctx_lens,
                                            qh, kvh, hd, ps, opt):
    q, pool, kvl, pt, cu = _inputs(q_lens, ctx_lens, qh, kvh, hd, ps, dtype,
                                   cuda, seed=8)
    kw = dict(sm_scale=hd ** -0.5, **_opts(opt, qh, cuda))
    before = pre.LAUNCHES
    got = pre.ragged_prefill_attention(q, pool, kvl, pt, cu,
                                       max_q_len=max(q_lens), **kw)
    torch.cuda.synchronize()
    assert pre.LAUNCHES == before + 1
    ref = pre.ragged_prefill_attention_plain(q, pool, kvl, pt, cu, **kw)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), ref.float(), **TOLS[dtype])


@pytest.mark.parametrize("kv8", list(KV8), ids=["int8", "e4m3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,qh,kvh", [(80, 8, 8), (96, 16, 4), (64, 71, 1)])
def test_gpt_geometry_8bit_pool_matches_plain(cuda, kv8, dtype, hd, qh, kvh):
    """K1 and K2 on int8 / e4m3 pools at hd 80 and 96 (the 8-bit stage is
    a 128-byte row, zero past hd) and at group 71."""
    kv_lens = [300, 17, 0, 129]
    q, pool, _, pt, _, ks, vs = _inputs8([1] * 4, [max(k - 1, 0)
                                                   for k in kv_lens],
                                         qh, kvh, hd, 16, dtype, kv8, cuda)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=cuda)
    kw = dict(sm_scale=hd ** -0.5, k_scale=ks, v_scale=vs)
    got = dec.paged_decode_attention(q, pool, kvl, pt, num_splits=2, **kw)
    torch.cuda.synchronize()
    ref = dec.paged_decode_attention_plain(q, pool, kvl, pt, **kw)
    torch.testing.assert_close(got.float(), ref.float(), **TOLS[dtype])
    q, pool, kvl, pt, cu, ks, vs = _inputs8([70, 1, 33], [0, 200, 7], qh,
                                            kvh, hd, 16, dtype, kv8, cuda)
    kw = dict(sm_scale=hd ** -0.5, k_scale=ks, v_scale=vs)
    got = pre.ragged_prefill_attention(q, pool, kvl, pt, cu, max_q_len=70,
                                       **kw)
    torch.cuda.synchronize()
    ref = pre.ragged_prefill_attention_plain(q, pool, kvl, pt, cu, **kw)
    torch.testing.assert_close(got.float(), ref.float(), **TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpt_geometry_padding_columns_stay_unwritten(cuda, dtype):
    """At hd 80 the tiles are 128 wide: q and out are exactly [.., 80], so
    a kernel that wrote a padding column would write into the next head.
    Each output head matches the plain version on its own."""
    q, pool, kvl, pt, cu = _inputs([40, 1], [0, 100], 4, 2, 80, 16, dtype,
                                   cuda, seed=9)
    kw = dict(sm_scale=80 ** -0.5)
    got = pre.ragged_prefill_attention(q, pool, kvl, pt, cu, max_q_len=40,
                                       **kw)
    dgot = dec.paged_decode_attention(q[40:], pool, kvl[1:], pt[1:], **kw)
    torch.cuda.synchronize()
    ref = pre.ragged_prefill_attention_plain(q, pool, kvl, pt, cu, **kw)
    for h in range(4):
        torch.testing.assert_close(got[:, h].float(), ref[:, h].float(),
                                   **TOLS[dtype])
    torch.testing.assert_close(dgot.float(), ref[40:].float(), **TOLS[dtype])


# --------------------------------------------------------------------- #
# MLA (models/deepseek.py): plain torch on the card, no kernel of its own
# --------------------------------------------------------------------- #
def _tiny_deepseek(device, dtype):
    import transformers
    from tensorrt_llm_tpu_torch.models import ModelConfig, get_model_class
    cfg = transformers.DeepseekV3Config(
        vocab_size=256, hidden_size=128, intermediate_size=256,
        moe_intermediate_size=64, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=4, n_routed_experts=8,
        num_experts_per_tok=2, n_shared_experts=1, q_lora_rank=48,
        kv_lora_rank=64, qk_rope_head_dim=32, qk_nope_head_dim=64,
        v_head_dim=64, first_k_dense_replace=1, n_group=2, topk_group=1,
        max_position_embeddings=512)
    model = get_model_class("deepseek_v3")(ModelConfig(
        hf_config=cfg, dtype=dtype, device=device))
    return model, model.init_params(seed=0)


def _mla_md(kv_lens, q_lens, pages_per_seq, ps, device):
    """Metadata of sequences with ``q_lens`` new tokens ending at
    ``kv_lens``, each on its own run of pages."""
    from tensorrt_llm_tpu_torch.ops.attention import AttentionMetadata
    S = len(kv_lens)
    pages = torch.arange(S * pages_per_seq, dtype=torch.int32).view(S, -1)
    pos = torch.cat([torch.arange(k - q, k) for k, q in zip(kv_lens,
                                                            q_lens)])
    seq = torch.repeat_interleave(torch.arange(S), torch.tensor(q_lens))
    slots = pages[seq, pos // ps] * ps + pos % ps
    cu = torch.zeros(S + 1, dtype=torch.int32)
    cu[1:] = torch.cumsum(torch.tensor(q_lens), 0)
    md = AttentionMetadata(
        kv_lens=torch.tensor(kv_lens, dtype=torch.int32), page_indices=pages,
        cu_q_lens=cu, num_seqs=torch.tensor([S], dtype=torch.int32),
        slot_mapping=slots.int(), positions=pos.int(),
        logits_indices=(cu[1:] - 1).long(), max_q_len=max(q_lens),
        max_kv_len=max(kv_lens))
    return AttentionMetadata(**{
        f: (v.to(device) if isinstance(v, torch.Tensor) else v)
        for f, v in vars(md).items()})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("path", ["absorbed", "decompressed"])
def test_mla_forward_replays_from_a_graph(cuda, dtype, path):
    """A decode step of MLA (T == S: absorbed, or with uk / uv stripped:
    decompressed) captured in a CUDA graph, with no host sync, and
    replayed: the eager step's logits and latent pool, bit for bit."""
    from tensorrt_llm_tpu_torch.models import deepseek
    model, params = _tiny_deepseek(cuda, dtype)
    if path == "decompressed":
        params = dict(params, layers=[
            {k: v for k, v in lay.items() if k not in ("uk", "uv")}
            for lay in params["layers"]])
    ps, per = 16, 4
    pool = model.make_kv_pages(3 * per + 1, ps)
    g = torch.Generator(device=cuda).manual_seed(0)
    pool.copy_(torch.randn(pool.shape, generator=g, device=cuda) * 0.5)
    toks = torch.randint(0, 256, (3,), generator=g, device=cuda)
    md = _mla_md([40, 17, 63], [1, 1, 1], per, ps, cuda)
    a0, d0 = deepseek.MLA_ABSORBED, deepseek.MLA_DECOMPRESSED
    eager_pool = pool.clone()
    torch.cuda.set_sync_debug_mode("error")
    try:
        want, _ = model.forward(params, toks, eager_pool, md)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    took = (deepseek.MLA_ABSORBED - a0, deepseek.MLA_DECOMPRESSED - d0)
    assert took == ((3, 0) if path == "absorbed" else (0, 3))
    graph_pool = pool.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        model.forward(params, toks, graph_pool.clone(), md)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, _ = model.forward(params, toks, graph_pool, md)
    graph_pool.copy_(pool)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(graph_pool, eager_pool)


def test_deepseek_pool_is_sized_by_its_own_shape(cuda):
    """The engine's pool on the card is one latent row (kv_lora_rank +
    qk_rope_head_dim) a token and layer, and its page bytes, by which the
    pool is sized from free memory, are that row's."""
    from tensorrt_llm_tpu_torch import LLM
    model, _ = _tiny_deepseek("cpu", torch.float32)
    llm = LLM(model.hf, device="cuda", dtype="bfloat16",
              skip_tokenizer_init=True, max_batch_size=4, max_input_len=64,
              max_seq_len=128, enable_warmup=False)
    try:
        e = llm.engine
        assert tuple(e.kv_pages.shape[2:]) == (e.page_size, 96)
        assert e.bytes_per_kv_block == 3 * e.page_size * 96 * 2
        assert e.kv_pages.numel() * 2 == e.num_kv_pages * \
            e.bytes_per_kv_block
        from tensorrt_llm_tpu_torch import SamplingParams
        out = llm.generate([5, 6, 7, 8], SamplingParams(max_tokens=4,
                                                        top_k=1))
        assert len(out.outputs[0].token_ids) == 4
    finally:
        llm.shutdown()


def test_mla_decompressed_chunks_match_one_chunk(cuda, monkeypatch):
    """The decompressed MLA step in chunks of 8 positions and tiles of 8
    tokens, merged by its online softmax, gives one chunk's logits and
    latent pool on the card (float32, within 1e-5)."""
    from tensorrt_llm_tpu_torch.models import deepseek
    model, params = _tiny_deepseek(cuda, torch.float32)
    ps, per = 16, 8
    pool = model.make_kv_pages(3 * per + 1, ps)
    g = torch.Generator(device=cuda).manual_seed(1)
    pool.copy_(torch.randn(pool.shape, generator=g, device=cuda) * 0.5)
    toks = torch.randint(0, 256, (70,), generator=g, device=cuda)
    md = _mla_md([100, 60, 120], [30, 20, 20], per, ps, cuda)
    outs = []
    for small in (False, True):
        if small:
            width = model.num_heads * (model.qk_nope + model.v_dim)
            monkeypatch.setattr(deepseek, "MLA_CHUNK_BYTES",
                                3 * width * 6 * 8)
            monkeypatch.setattr(deepseek, "MLA_TILE", 8)
        p = pool.clone()
        logits, _ = model.forward(params, toks, p, md)
        outs.append((logits, p))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=0, atol=1e-5)
    torch.testing.assert_close(outs[1][1], outs[0][1], rtol=0, atol=1e-5)


def test_profile_sums_match_key_averages(cuda):
    """``serving_profile.profile_sums`` (the profiler's raw events summed
    by name) gives ``key_averages``' device time by class, device kernels
    and host launches for a short greedy run on the card."""
    from torch.profiler import ProfilerActivity, profile
    from tensorrt_llm_tpu_torch import LLM, SamplingParams
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    llm = LLM("tests/assets/tinycode-llama", device="cuda", dtype="bfloat16",
              skip_tokenizer_init=True, max_batch_size=4, max_input_len=64,
              max_seq_len=128)
    try:
        sp = SamplingParams(max_tokens=16, top_k=1, ignore_eos=True)
        llm.generate([[5, 9, 23, 44], [7] * 30], sp)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            llm.generate([[5, 9, 23, 44], [7] * 30], sp)
    finally:
        llm.shutdown()
    by_class, _, device, host = sprof.profile_sums(prof)
    want: dict = {}
    want_device = want_host = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            if e.key.startswith(sprof._HOST_LAUNCH):
                want_host += e.count
            continue
        if e.device_time_total <= 0:
            continue
        want_device += e.count
        c = sprof._class(e.key)
        want[c] = want.get(c, 0.0) + e.device_time_total / 1e3
    assert (device, host) == (want_device, want_host)
    assert by_class.keys() == want.keys()
    for c in want:
        assert abs(by_class[c] - want[c]) <= 1e-6 * want[c] + 1e-9, c


# --------------------------------------------------------------------- #
# head_dim 48 (the tinypasskey checkpoint: 4 x 48 heads over 4 KV heads)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kv8", [None, torch.int8, torch.float8_e4m3fn],
                         ids=["same", "int8", "e4m3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_lens,splits", [
    ([250, 3072], None),                  # the passkey decode rows
    ([7, 300, 1, 0, 65], None),
    ([3000, 17, 2500, 1], 5),
])
def test_decode_hd48_matches_plain(cuda, kv8, dtype, kv_lens, splits):
    """K1 at hd 48 (64-wide tiles, zero past 48) on pools of q's type and
    8-bit ones, against the plain version; q and out are exactly [.., 48],
    so a written padding column would land in the next head."""
    S, qh, kvh, hd = len(kv_lens), 4, 4, 48
    ctx = [max(k - 1, 0) for k in kv_lens]
    if kv8 is None:
        q, pool, _, pt, _ = _inputs([1] * S, ctx, qh, kvh, hd, 32, dtype,
                                    cuda, seed=5)
        scales = {}
    else:
        q, pool, _, pt, _, ks, vs = _inputs8([1] * S, ctx, qh, kvh, hd, 32,
                                             dtype, kv8, cuda, seed=5)
        scales = dict(k_scale=ks, v_scale=vs)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=cuda)
    kw = dict(sm_scale=hd ** -0.5, **scales)
    before = dec.LAUNCHES
    got = dec.paged_decode_attention(q, pool, kvl, pt, num_splits=splits,
                                     **kw)
    torch.cuda.synchronize()
    assert dec.LAUNCHES == before + 1
    ref = dec.paged_decode_attention_plain(q, pool, kvl, pt, **kw)
    for h in range(qh):
        torch.testing.assert_close(got[:, h].float(), ref[:, h].float(),
                                   **TOLS[dtype])


@pytest.mark.parametrize("kv8", [None, torch.int8, torch.float8_e4m3fn],
                         ids=["same", "int8", "e4m3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_lens,ctx_lens", [
    ([3072], [0]),                        # the passkey prompt
    ([40, 1, 70], [0, 100, 500]),         # mixed rows
])
def test_prefill_hd48_matches_plain(cuda, kv8, dtype, q_lens, ctx_lens):
    """K2 at hd 48 against the plain version, each head on its own."""
    qh, kvh, hd = 4, 4, 48
    if kv8 is None:
        q, pool, kvl, pt, cu = _inputs(q_lens, ctx_lens, qh, kvh, hd, 32,
                                       dtype, cuda, seed=6)
        scales = {}
    else:
        q, pool, kvl, pt, cu, ks, vs = _inputs8(q_lens, ctx_lens, qh, kvh,
                                                hd, 32, dtype, kv8, cuda,
                                                seed=6)
        scales = dict(k_scale=ks, v_scale=vs)
    kw = dict(sm_scale=hd ** -0.5, **scales)
    before = pre.LAUNCHES
    got = pre.ragged_prefill_attention(q, pool, kvl, pt, cu,
                                       max_q_len=max(q_lens), **kw)
    torch.cuda.synchronize()
    assert pre.LAUNCHES == before + 1
    ref = pre.ragged_prefill_attention_plain(q, pool, kvl, pt, cu, **kw)
    for h in range(qh):
        torch.testing.assert_close(got[:, h].float(), ref[:, h].float(),
                                   **TOLS[dtype])


# --------------------------------------------------------------------- #
# GQA group 7 (Qwen2.5-VL-7B's trunk: 28 x 128 query heads over 4 KV heads)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_lens,splits", [
    (list(range(641, 769, 2)), None),     # the serving decode rows: 64
    ([700, 3, 1, 0, 2048], None),
    ([1500, 641, 90], 4),
])
def test_decode_group7_matches_plain(cuda, dtype, kv_lens, splits):
    S, qh, kvh, hd = len(kv_lens), 28, 4, 128
    q, pool, _, pt, _ = _inputs([1] * S, [max(k - 1, 0) for k in kv_lens],
                                qh, kvh, hd, 32, dtype, cuda, seed=7)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=cuda)
    before = dec.LAUNCHES
    got = dec.paged_decode_attention(q, pool, kvl, pt, num_splits=splits,
                                     max_kv_len=max(kv_lens),
                                     sm_scale=hd ** -0.5)
    torch.cuda.synchronize()
    assert dec.LAUNCHES == before + 1
    ref = dec.paged_decode_attention_plain(q, pool, kvl, pt,
                                           sm_scale=hd ** -0.5)
    torch.testing.assert_close(got.float(), ref.float(), **TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_lens,ctx_lens", [
    ([640] * 8, [0] * 8),                 # 8 fresh 640-token image prompts
    ([1, 1, 640, 1, 70], [700, 20, 0, 31, 500]),
])
def test_prefill_group7_matches_plain(cuda, dtype, q_lens, ctx_lens):
    qh, kvh, hd = 28, 4, 128
    q, pool, kvl, pt, cu = _inputs(q_lens, ctx_lens, qh, kvh, hd, 32, dtype,
                                   cuda, seed=8)
    before = pre.LAUNCHES
    got = pre.ragged_prefill_attention(q, pool, kvl, pt, cu,
                                       max_q_len=max(q_lens),
                                       sm_scale=hd ** -0.5)
    torch.cuda.synchronize()
    assert pre.LAUNCHES == before + 1
    ref = pre.ragged_prefill_attention_plain(q, pool, kvl, pt, cu,
                                             sm_scale=hd ** -0.5)
    torch.testing.assert_close(got.float(), ref.float(), **TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mrope_window_on_graphs_equals_eager_single_steps(cuda, dtype):
    """A tiny Qwen2-VL (seeded, 4 x 64 heads over 2) serves two image
    prompts whose mrope_delta is not 0: K = 8 windows replayed from CUDA
    graphs (each row rotated at pos + delta[slot]) give the tokens of the
    same windows run eagerly, and in float32 those of eager single steps
    (positions_mrope built on the host per step; in bf16 their other
    matmul shapes may round a near tie the other way)."""
    from transformers import Qwen2VLConfig

    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig, SamplingParams
    cfg = Qwen2VLConfig(
        text_config=dict(vocab_size=512, hidden_size=256,
                         intermediate_size=512, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=1024,
                         rope_scaling={"rope_type": "default",
                                       "mrope_section": [8, 12, 12]}),
        vision_config=dict(depth=1, embed_dim=64, num_heads=4,
                           hidden_size=256, patch_size=4,
                           temporal_patch_size=2, spatial_merge_size=2,
                           in_channels=3, mlp_ratio=2),
        image_token_id=151, video_token_id=152, vision_start_token_id=153,
        vision_end_token_id=154)
    rng = np.random.default_rng(0)
    prompts = [{"prompt_token_ids": [5, 153, 151, 154] + list(range(20, 20 + n)),
                "multi_modal_data": {
                    "image": [rng.standard_normal((16 * 16, 96))
                              .astype(np.float32)],
                    "image_grid_thw": [(1, 16, 16)]}} for n in (3, 40)]
    sp = SamplingParams(max_tokens=24, top_k=1, end_id=-1)
    runs = {}
    for mode, K in (("graph", 8), ("eager", 8), ("steps", 1)):
        llm = LLM(cfg, device=cuda, dtype=dtype, skip_tokenizer_init=True,
                  max_batch_size=4, max_input_len=256, max_seq_len=320,
                  max_num_tokens=512, decode_multi_step=K,
                  enable_warmup=mode == "graph",
                  kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                                max_tokens=4096))
        llm.engine.graphs.capture = mode == "graph"
        try:
            toks = [o.outputs[0].token_ids for o in llm.generate(prompts, sp)]
            runs[mode] = (toks, llm.engine.window_steps,
                          llm.engine.graphs.replayed_launches())
        finally:
            llm.shutdown()
    assert runs["graph"][0] == runs["eager"][0]
    if dtype == "float32":
        assert runs["graph"][0] == runs["steps"][0]
    assert runs["graph"][1] > 0 and runs["steps"][1] == 0
    assert runs["graph"][2][dec.__name__] > 0
    assert not runs["eager"][2] and not runs["steps"][2]


def _groups(pt, kv_lens, q_lens, ps, spans, device):
    """(q_groups i32[T], group pool i32[P * ps]) for image spans:
    ``spans[s]`` lists (first position, length) of sequence s's images,
    image i in group i; every other position -1."""
    P = int(pt.max()) + 4
    pool = torch.full((P * ps,), -1, dtype=torch.int32)
    q_groups = []
    for s, (kv, q) in enumerate(zip(kv_lens.tolist(), q_lens)):
        g = [-1] * kv
        for i, (a, n) in enumerate(spans[s]):
            for p in range(a, min(a + n, kv)):
                g[p] = i
        for p in range(kv):
            pool[int(pt[s, p // ps]) * ps + p % ps] = g[p]
        q_groups += g[kv - q:]
    return (torch.tensor(q_groups, dtype=torch.int32, device=device),
            pool.to(device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,q_lens,ctx_lens,qh,kvh,hd,window,spans", [
    # Gemma-3-4B's heads: 320-token prompts, one 256-token image each
    ("gemma3_global", [320] * 3, [0] * 3, 8, 4, 256, None,
     [[(4, 256)], [(40, 256)], [(60, 256)]]),
    ("gemma3_sliding", [320] * 3, [0] * 3, 8, 4, 256, 100,
     [[(4, 256)], [(40, 256)], [(60, 256)]]),
    # the chunk edge inside the image: a first chunk (kv_len bounds the
    # image) and a second one over the first's positions; text rows and a
    # decode row beside them
    ("chunk_cut", [150, 100, 1, 37], [0, 150, 90, 0], 8, 2, 64, 64,
     [[(20, 200)], [(20, 200)], [(3, 50)], []]),
    # PaliGemma: the whole prompt one group, two images' worth of rows
    ("prefix", [300, 77], [0, 40], 8, 4, 256, 128,
     [[(0, 300)], [(0, 117)]]),
    ("hd128_two_images", [200, 130], [0, 70], 16, 8, 128, None,
     [[(10, 64), (100, 64)], [(50, 64), (130, 64)]]),
])
def test_prefill_groups_match_plain(cuda, dtype, name, q_lens, ctx_lens, qh,
                                    kvh, hd, window, spans):
    """K2 with the image-group or-mask against its plain version, and the
    groups' effect: without them the kernel gives another answer."""
    ps = 32 if hd != 64 else 16
    q, pool, kvl, pt, cu = _inputs(q_lens, ctx_lens, qh, kvh, hd, ps, dtype,
                                   cuda, seed=11)
    qg, gpool = _groups(pt.cpu(), kvl.cpu(), q_lens, ps, spans, cuda)
    kw = dict(sm_scale=hd ** -0.5, sliding_window=window)
    before, grouped = pre.LAUNCHES, pre.LAUNCHES_GROUPS
    got = pre.ragged_prefill_attention(q, pool, kvl, pt, cu,
                                       max_q_len=max(q_lens), q_groups=qg,
                                       kv_group_pool=gpool, **kw)
    torch.cuda.synchronize()
    assert (pre.LAUNCHES, pre.LAUNCHES_GROUPS) == (before + 1, grouped + 1)
    ref = pre.ragged_prefill_attention_plain(q, pool, kvl, pt, cu,
                                             q_groups=qg,
                                             kv_group_pool=gpool, **kw)
    torch.testing.assert_close(got.float(), ref.float(), **TOLS[dtype])
    causal = pre.ragged_prefill_attention(q, pool, kvl, pt, cu,
                                          max_q_len=max(q_lens), **kw)
    assert (causal.float() - ref.float()).abs().max() > 0.05


def test_prefill_groups_of_a_text_step_cost_nothing(cuda):
    """A launch whose rows carry no group (all -1) gives the causal
    kernel's bits."""
    q_lens, ctx = [128, 64], [0, 64]
    q, pool, kvl, pt, cu = _inputs(q_lens, ctx, 8, 4, 256, 32,
                                   torch.bfloat16, cuda, seed=12)
    qg, gpool = _groups(pt.cpu(), kvl.cpu(), q_lens, 32, [[], []], cuda)
    a = pre.ragged_prefill_attention(q, pool, kvl, pt, cu, max_q_len=128,
                                     sm_scale=0.0625, sliding_window=64,
                                     q_groups=qg, kv_group_pool=gpool)
    b = pre.ragged_prefill_attention(q, pool, kvl, pt, cu, max_q_len=128,
                                     sm_scale=0.0625, sliding_window=64)
    assert torch.equal(a, b)
