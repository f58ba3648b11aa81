"""The port's MoE block (ops/moe.py) against the JAX package's
``ops/moe.py``, CPU.

Routing against ``topk_routing``; the ``plain`` and ``dense`` routes
against ``moe_mlp_ragged`` / ``moe_mlp_dense`` in float32 at 1e-5 (sums in
another order), for E = 4, 8, 16, T = 1 to 37 and k >= E/2, so that some
experts get no token; the ``grouped`` route (``torch._grouped_mm``, which
runs on the CPU in bf16) against ``plain`` at 2e-2 (bf16 products and
rounding of every intermediate); padding rows; the route rule; the graph
pool's memory formula for a MoE model; and the MoE refusals, each by
name. The serving parity of whole MoE models is in
tests/test_torch_moe_llm.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrt_llm_tpu_torch.ops import moe as tmoe

CASES = [(4, 1, 2), (4, 5, 3), (8, 13, 4), (8, 37, 6), (16, 7, 8),
         (16, 29, 12)]                 # (E, T, k)


def _case(E, T, k, H=32, I=24, seed=0):
    rng = np.random.default_rng(seed + 97 * E + T)
    x = rng.standard_normal((T, H), np.float32)
    wg = rng.standard_normal((E, H, I), np.float32) * 0.2
    wu = rng.standard_normal((E, H, I), np.float32) * 0.2
    wd = rng.standard_normal((E, I, H), np.float32) * 0.2
    logits = rng.standard_normal((T, E), np.float32) * 2.0
    return x, wg, wu, wd, logits


def _routed(logits, k, renorm=True):
    from tensorrt_llm_tpu.ops.moe import topk_routing
    p, i = topk_routing(jnp.asarray(logits), k, renormalize=renorm)
    return np.array(p), np.array(i)


def _port(wg, wu, wd, dtype=torch.float32):
    return (torch.from_numpy(np.concatenate([wg, wu], -1)).to(dtype),
            torch.from_numpy(wd).to(dtype))


@pytest.mark.parametrize("renorm", [True, False])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_topk_routing_matches_jax(k, renorm):
    logits = np.random.default_rng(k).standard_normal((23, 16), np.float32)
    jp, ji = _routed(logits, k, renorm)
    tp, ti = tmoe.topk_routing(torch.from_numpy(logits), k, renorm)
    assert ti.dtype == torch.int32 and tp.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(tp.numpy(), jp, atol=1e-6)
    if renorm:
        np.testing.assert_allclose(tp.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("E,T,k", CASES)
def test_plain_matches_jax_ragged(E, T, k):
    from tensorrt_llm_tpu.ops.moe import moe_mlp_ragged
    x, wg, wu, wd, logits = _case(E, T, k)
    p, i = _routed(logits, k)
    ref = moe_mlp_ragged(*map(jnp.asarray, (x, wg, wu, wd, p, i)))
    wgu, wdn = _port(wg, wu, wd)
    got = tmoe.moe_mlp_plain(torch.from_numpy(x), wgu, wdn,
                             torch.from_numpy(p), torch.from_numpy(i))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("E,T,k", CASES)
def test_dense_matches_jax_dense(E, T, k):
    from tensorrt_llm_tpu.ops.moe import moe_mlp_dense
    x, wg, wu, wd, logits = _case(E, T, k)
    p, i = _routed(logits, k)
    ref = moe_mlp_dense(*map(jnp.asarray, (x, wg, wu, wd, p, i)))
    wgu, wdn = _port(wg, wu, wd)
    got = tmoe.moe_mlp_dense(torch.from_numpy(x), wgu, wdn,
                             torch.from_numpy(p), torch.from_numpy(i))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_some_expert_gets_no_token():
    """The cases above include empty groups (the grouped product's
    offsets repeat), and a case with one token over four experts."""
    empty = 0
    for E, T, k in CASES:
        _, _, _, _, logits = _case(E, T, k)
        empty += E - len(np.unique(_routed(logits, k)[1]))
    assert empty > 0


@pytest.mark.parametrize("E,T,k", CASES)
def test_grouped_matches_plain_in_bf16(E, T, k):
    x, wg, wu, wd, logits = _case(E, T, k)
    p, i = _routed(logits, k)
    wgu, wdn = _port(wg, wu, wd, torch.bfloat16)
    args = (torch.from_numpy(x).bfloat16(), wgu, wdn, torch.from_numpy(p),
            torch.from_numpy(i))
    got = tmoe.moe_mlp_grouped(*args)
    ref = tmoe.moe_mlp_plain(*args)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("route", ["plain", "grouped", "dense"])
def test_padding_rows_leave_live_rows_bit_equal(route):
    """A graph bucket pads the live rows with rows that are routed like
    any token; the live rows' outputs must not change by a bit."""
    E, T, k, pad = 8, 11, 4, 21
    dtype = torch.bfloat16 if route == "grouped" else torch.float32
    x, wg, wu, wd, _ = _case(E, T + pad, k, seed=3)
    wgu, wdn = _port(wg, wu, wd, dtype)
    router = torch.from_numpy(
        np.random.default_rng(4).standard_normal((E, 32), np.float32)
    ).to(dtype)
    xt = torch.from_numpy(x).to(dtype)
    fn = {"plain": tmoe.moe_mlp_plain, "grouped": tmoe.moe_mlp_grouped,
          "dense": tmoe.moe_mlp_dense}[route]

    def run(rows):
        p, i = tmoe.topk_routing(tmoe.dot_f32(rows, router), k)
        return fn(rows, wgu, wdn, p, i)
    live = run(xt[:T])
    padded = run(torch.cat([xt[:T], torch.zeros_like(xt[T:]), xt[T:]]))
    assert torch.equal(padded[:T], live)


def test_moe_mlp_block_matches_jax():
    """The whole block (float32 router logits, routing, experts, combine)
    against JAX ``moe_mlp`` on one device, with and without
    renormalisation."""
    from tensorrt_llm_tpu.ops.moe import moe_mlp
    x, wg, wu, wd, _ = _case(8, 19, 3, seed=7)
    router = np.random.default_rng(8).standard_normal((32, 8), np.float32)
    wgu, wdn = _port(wg, wu, wd)
    for renorm in (True, False):
        ref = moe_mlp(*map(jnp.asarray, (x, wg, wu, wd, router)), top_k=3,
                      renormalize=renorm)
        got = tmoe.moe_mlp(torch.from_numpy(x), wgu, wdn,
                           torch.from_numpy(router.T.copy()), 3,
                           renormalize=renorm)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_route_rule():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert tmoe.moe_route(torch.bfloat16, cuda) == "grouped"
    assert tmoe.moe_route(torch.float32, cuda) == "dense"
    assert tmoe.moe_route(torch.bfloat16, cpu) == "plain"
    assert tmoe.moe_route(torch.float32, cpu) == "plain"
    with pytest.raises(NotImplementedError, match="float16"):
        tmoe.moe_route(torch.float16, cuda)


def test_grouped_probe_accepts_the_model_widths():
    """``check_grouped`` (model build on the grouped route) passes where
    ``torch._grouped_mm`` takes the widths: here on the CPU, Qwen3-30B-A3B
    narrowed to fit."""
    tmoe.check_grouped(256, 96, torch.device("cpu"))


# --------------------------------------------------------------------- #
# Graph-pool reserve
# --------------------------------------------------------------------- #
def _engine(cfg):
    from tensorrt_llm_tpu_torch.llmapi.llm_args import LlmArgs
    from tensorrt_llm_tpu_torch.models import ModelConfig, get_model_class
    from tensorrt_llm_tpu_torch.runtime.model_engine import ModelEngine
    model = get_model_class(cfg.model_type)(ModelConfig(
        hf_config=cfg, dtype=torch.bfloat16, device="cpu"))
    return ModelEngine(model, {}, LlmArgs(model="x", max_batch_size=64),
                       num_kv_pages=8)


def _qwen3_moe(**kw):
    from transformers import Qwen3MoeConfig
    base = dict(vocab_size=1024, hidden_size=256, intermediate_size=768,
                moe_intermediate_size=96, num_hidden_layers=1,
                num_attention_heads=4, num_key_value_heads=2, head_dim=64,
                num_experts=16, num_experts_per_tok=4)
    base.update(kw)
    return Qwen3MoeConfig(**base)


def test_graph_pool_reserve_counts_routed_copies():
    """For a MoE model the reserve grows with k and the experts' width,
    and a change of ``intermediate_size`` (unused there) moves nothing;
    on the CPU nothing is reserved."""
    base = _engine(_qwen3_moe())
    assert base.graph_pool_reserve() == 0
    est = base.graph_pool_estimate()
    assert _engine(_qwen3_moe(num_experts_per_tok=8)) \
        .graph_pool_estimate() > est
    assert _engine(_qwen3_moe(moe_intermediate_size=192)) \
        .graph_pool_estimate() > est
    assert _engine(_qwen3_moe(intermediate_size=6144)) \
        .graph_pool_estimate() == est
    # k copies: sorted input and down output (H each), gate|up and their
    # product (3 I), beside 4 hidden-wide tensors and E router logits
    m = base.model
    assert m.act_width_per_token() == 4 * 256 + 16 + 4 * (2 * 256 + 3 * 96)


# --------------------------------------------------------------------- #
# Refusals
# --------------------------------------------------------------------- #
def _build(cfg):
    from tensorrt_llm_tpu_torch.models import ModelConfig, get_model_class
    return get_model_class(cfg.model_type)(ModelConfig(
        hf_config=cfg, dtype=torch.float32, device="cpu"))


def test_refuses_dense_interleaved_layers():
    from transformers import Qwen2MoeConfig
    with pytest.raises(NotImplementedError, match="mlp_only_layers"):
        _build(_qwen3_moe(mlp_only_layers=[0]))
    with pytest.raises(NotImplementedError, match="decoder_sparse_step"):
        _build(_qwen3_moe(decoder_sparse_step=2))
    with pytest.raises(NotImplementedError, match="mlp_only_layers"):
        _build(Qwen2MoeConfig(vocab_size=64, hidden_size=32,
                              num_hidden_layers=2, num_attention_heads=2,
                              mlp_only_layers=[1]))


def test_refuses_olmoe_clip_qkv():
    from transformers import OlmoeConfig
    with pytest.raises(NotImplementedError, match="clip_qkv"):
        _build(OlmoeConfig(vocab_size=64, hidden_size=32,
                           num_hidden_layers=1, num_attention_heads=2,
                           clip_qkv=8.0))


@pytest.mark.parametrize("kw,name", [
    (dict(moe_expert_parallel_size=2), "moe_expert_parallel_size"),
    (dict(moe_tensor_parallel_size=4), "moe_tensor_parallel_size"),
    (dict(load_balancer={"num_slots": 8}), "load_balancer"),
    (dict(backend="dense"), "backend"),
    (dict(backend="megablox"), "backend"),
    (dict(max_num_tokens=256), "max_num_tokens")])
def test_llm_args_refuse_moe_options(kw, name):
    from tensorrt_llm_tpu_torch.llmapi.llm_args import LlmArgs, MoeConfig
    if not name.startswith("moe_"):
        kw = dict(moe_config=MoeConfig(**kw))
    with pytest.raises(NotImplementedError, match=name):
        LlmArgs(model="x", **kw)
    # the single-device values and the default MoE options are accepted
    LlmArgs(model="x", moe_expert_parallel_size=1,
            moe_tensor_parallel_size=-1,
            moe_config=MoeConfig(backend="auto"))


@pytest.mark.parametrize("name,moe,cls", [
    ("void at::native::sbtopk::gatherTopK<float>", False, "other"),
    ("void at::native::sbtopk::gatherTopK<float>", True, "moe_routing_sort"),
    ("DeviceRadixSortOnesweepKernel", False, "other"),
    ("cutlass::GroupProblemShape kernel", True, "moe_grouped_gemm"),
    ("nvjet_tst_128x64", True, "gemm")])
def test_profile_classes_moe_kernels_only_on_moe_models(name, moe, cls):
    # the sampler's sort and top-k stay "other" on a dense model
    from tensorrt_llm_tpu_torch.tools.serving_profile import _class
    assert _class(name, moe) == cls


def test_eagle3_refused_on_moe_target():
    import tensorrt_llm_tpu_torch as T
    sc = T.SpeculativeConfig(mode="EAGLE3", max_draft_len=2)
    with pytest.raises(NotImplementedError, match="qwen3_moe target"):
        T.LLM(_qwen3_moe(), device="cpu", speculative_config=sc)


def test_prequantized_moe_checkpoint_refused(tmp_path):
    import json

    import tensorrt_llm_tpu_torch as T
    cfg = _qwen3_moe()
    cfg.save_pretrained(tmp_path)
    c = json.loads((tmp_path / "config.json").read_text())
    c["quantization_config"] = {"quant_method": "awq", "bits": 4,
                                "group_size": 128, "zero_point": True,
                                "version": "gemm"}
    (tmp_path / "config.json").write_text(json.dumps(c))
    from safetensors.torch import save_file
    save_file({"x": torch.zeros(1)}, str(tmp_path / "model.safetensors"))
    with pytest.raises(NotImplementedError, match="prequantized"):
        T.LLM(str(tmp_path), device="cpu", skip_tokenizer_init=True)
