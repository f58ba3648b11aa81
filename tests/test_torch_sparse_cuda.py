"""Sparse decode and STAR prefill on the card (skipped without one): the
sparse route (the indexer, the compacted table, the decode kernel) and
the prefill kernel over STAR's virtual sequences against their CPU
versions in float32 (1e-4), the tinycode-llama LLM under each algo,
card against CPU, its sparse steps replayed from CUDA graphs, and
sleep's staged copy between host and card. Run with
``python -m pytest --noconftest -q tests/test_torch_sparse_cuda.py``."""
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

CKPT = str(Path(__file__).resolve().parent / "assets" / "tinycode-llama")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(S=4, P=24, ps=32, kvh=8, qh=32, hd=128, seed=0):
    g = torch.Generator().manual_seed(seed)
    pool = torch.randn((S * P + 1, ps, 2 * kvh, hd), generator=g)
    table = torch.randperm(S * P, generator=g).int().reshape(S, P)
    q = torch.randn((S, qh, hd), generator=g)
    kv_lens = torch.tensor([P * ps, P * ps - 5, 11 * ps + 1, 3 * ps],
                           dtype=torch.int32)[:S]
    return q, pool, kv_lens, table


@pytest.mark.parametrize("algo", ("ROCKET_TOPK", "DSA"))
@pytest.mark.parametrize("whole", (False, True))
def test_sparse_route_on_the_card(cuda, algo, whole):
    from tensorrt_llm_tpu_torch.ops import sparse_attention as sa
    from tensorrt_llm_tpu_torch.ops.cuda import decode_attention as dec
    q, pool, kv_lens, table = _case()
    kw = dict(sm_scale=128 ** -0.5, keep_pages=5, algo=algo,
              max_kv_len=24 * 32)
    ref = sa.sparse_paged_decode_attention_plain(
        q, pool, kv_lens, table, sm_scale=kw["sm_scale"], keep_pages=5,
        algo=algo)
    before = dec.LAUNCHES_SPARSE
    got = sa.sparse_paged_decode_attention(
        *(t.to(cuda) for t in (q, pool, kv_lens, table)),
        pool_pages=(0, pool.shape[0]) if whole else None, **kw)
    assert dec.LAUNCHES_SPARSE == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("window", (None, 200))
def test_star_remap_on_the_card(cuda, window):
    """K2 through STAR's launches (with a window of 200 over blocks of
    128, two launches: rows 256-327 at window 72, the rest at 200)
    against the plain STAR reference."""
    from tensorrt_llm_tpu_torch.ops import attention as att
    from tensorrt_llm_tpu_torch.ops.cuda import prefill_attention as pre
    g = torch.Generator().manual_seed(1)
    ps, kvh, qh, hd, P = 32, 8, 32, 128, 16
    pool = torch.randn((P + 1, ps, 2 * kvh, hd), generator=g)
    table = torch.randperm(P, generator=g).int().reshape(1, P)
    q = torch.randn((300, qh, hd), generator=g)
    host = dict(kv_lens=torch.tensor([400], dtype=torch.int32),
                page_indices=table,
                cu_q_lens=torch.tensor([0, 300], dtype=torch.int32),
                num_seqs=torch.tensor([1], dtype=torch.int32),
                slot_mapping=torch.zeros(300, dtype=torch.int32),
                positions=torch.arange(100, 400, dtype=torch.int32),
                logits_indices=torch.tensor([299]))
    ref = att._reference_attention(q, pool, att.AttentionMetadata(**host),
                                   sm_scale=0.1, star_block_size=128,
                                   sliding_window=window)
    segs = att.star_metadata(host["cu_q_lens"].numpy(),
                             host["kv_lens"].numpy(), table.numpy(), 1,
                             128, ps, (window,), cuda)
    md = att.AttentionMetadata(
        **{k: v.to(cuda) for k, v in host.items()}, max_q_len=300,
        star_segments=segs)
    before = pre.LAUNCHES_STAR
    got = att.ragged_paged_attention(q.to(cuda), pool.to(cuda), md,
                                     sm_scale=0.1, sliding_window=window)
    assert pre.LAUNCHES_STAR == before + len(segs[window])
    assert len(segs[window]) == (1 if window is None else 2)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_star_plain_route_on_the_card(cuda):
    """The plain STAR route (``star_reference_attention``, in chunks of
    rows) on CUDA tensors equals the reference on the CPU."""
    from tensorrt_llm_tpu_torch.ops import attention as att
    g = torch.Generator().manual_seed(2)
    ps, kvh, qh, hd, P = 16, 8, 32, 128, 24
    pool = torch.randn((P + 1, ps, 2 * kvh, hd), generator=g)
    table = torch.randperm(P, generator=g).int().reshape(1, P)
    q = torch.randn((300, qh, hd), generator=g)
    host = dict(kv_lens=torch.tensor([380], dtype=torch.int32),
                page_indices=table,
                cu_q_lens=torch.tensor([0, 300], dtype=torch.int32),
                num_seqs=torch.tensor([1], dtype=torch.int32),
                slot_mapping=torch.zeros(300, dtype=torch.int32),
                positions=torch.arange(80, 380, dtype=torch.int32),
                logits_indices=torch.tensor([299]))
    kw = dict(sm_scale=0.1, star_block_size=120, sliding_window=150)
    ref = att._reference_attention(q, pool, att.AttentionMetadata(**host),
                                   **kw)
    got = att.star_reference_attention(
        q.to(cuda), pool.to(cuda),
        att.AttentionMetadata(**{k: v.to(cuda) for k, v in host.items()}),
        **kw)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("algo", ("ROCKET_TOPK", "DSA", "STAR"))
def test_tinycode_llm_card_equals_cpu(cuda, algo):
    """Greedy float32 tokens of the card (sparse windows replayed from
    graphs; STAR's prompt steps through K2's remap) equal the CPU's."""
    import tensorrt_llm_tpu_torch as T
    from tensorrt_llm_tpu_torch.ops.cuda import decode_attention as dec
    from tensorrt_llm_tpu_torch.ops.cuda import prefill_attention as pre
    r = np.random.default_rng(0)
    prompts = [r.integers(1, 255, n).tolist() for n in (90, 130, 161)]
    cfg = T.SparseAttentionConfig(algo=algo, keep_pages=4,
                                  star_block_size=32)
    out = {}
    for dev in ("cpu", "cuda"):
        llm = T.LLM(CKPT, device=dev, sparse_attention_config=cfg,
                    skip_tokenizer_init=True, dtype="float32",
                    max_batch_size=4, max_input_len=256, max_seq_len=320,
                    max_num_tokens=512,
                    kv_cache_config=T.KvCacheConfig(tokens_per_block=16,
                                                    max_tokens=4096))
        k1, k2 = dec.LAUNCHES_SPARSE, pre.LAUNCHES_STAR
        outs = llm.generate(prompts, T.SamplingParams(
            max_tokens=24, top_k=1, ignore_eos=True))
        out[dev] = [o.outputs[0].token_ids for o in outs]
        if dev == "cuda":
            if algo == "STAR":
                assert pre.LAUNCHES_STAR > k2
            else:
                assert dec.LAUNCHES_SPARSE > k1
                assert llm.engine.graphs.replays > 0
        llm.shutdown()
    assert out["cuda"] == out["cpu"]


def test_staged_copy_round_trip(cuda, monkeypatch):
    """Sleep's copy (``model_engine.staged_copy``) through a small pinned
    buffer: a tree of every pool and weight type, a tensor longer than
    the buffer, a non-contiguous view and a tied pair come back
    bit-identical from the host, the pair still tied."""
    from tensorrt_llm_tpu_torch.runtime import model_engine as me
    monkeypatch.setattr(me, "HOST_STAGE_BYTES", 4096)
    g = torch.Generator(device=cuda).manual_seed(0)
    w = torch.randn((129, 77), generator=g, device=cuda)
    tree = {"w": w.bfloat16(), "tied": [w, w], "view": w.t()[3:40],
            "i8": torch.randint(-128, 127, (1000,), generator=g,
                                device=cuda, dtype=torch.int8),
            "e4m3": w.to(torch.float8_e4m3fn), "flag": w > 0,
            "empty": w[:0], "scalar": w.sum()}
    host = me.staged_copy(tree, "cpu")
    assert host["tied"][0] is host["tied"][1]
    back = me.staged_copy(host, cuda)
    for k, v in tree.items():
        for a, h, b in zip(v if isinstance(v, list) else [v],
                           host[k] if isinstance(v, list) else [host[k]],
                           back[k] if isinstance(v, list) else [back[k]]):
            assert h.device.type == "cpu" and b.device == a.device
            assert torch.equal(a.view(torch.uint8) if a.dtype ==
                               torch.float8_e4m3fn else a,
                               b.view(torch.uint8) if b.dtype ==
                               torch.float8_e4m3fn else b)
