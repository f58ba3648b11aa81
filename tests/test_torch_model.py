"""The port's Llama forward against the JAX package's on the in-repo
parity checkpoint (tests/assets/tinycode-llama), float32, CPU: a prefill
step of two ragged prompts, then a decode step, with the weights carried
over by ``from_jax_params`` and loaded directly from the safetensors.
Logits must agree within 1e-4 (float32 matmuls summed in another
order over six layers)."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

CKPT = Path(__file__).parent / "assets" / "tinycode-llama"
ATOL = 1e-4
PS, PAGES = 16, 8


@pytest.fixture(scope="module")
def models():
    from safetensors.torch import load_file
    from transformers import AutoConfig

    from tensorrt_llm_tpu.models import ModelConfig as JConfig
    from tensorrt_llm_tpu.models import get_model_class as jget
    from tensorrt_llm_tpu.quantization.lazy_state_dict import LazyStateDict
    from tensorrt_llm_tpu_torch.models import ModelConfig as TConfig
    from tensorrt_llm_tpu_torch.models import from_jax_params
    from tensorrt_llm_tpu_torch.models import get_model_class as tget

    cfg = AutoConfig.from_pretrained(CKPT)
    jm = jget("llama")(JConfig(hf_config=cfg, dtype=jnp.float32))
    jparams = jm.load_hf_state_dict(LazyStateDict(CKPT))
    tm = tget("llama")(TConfig(hf_config=cfg, dtype=torch.float32,
                               device="cpu"))
    via_jax = from_jax_params(jax.tree.map(np.asarray, jparams))
    direct = tm.load_hf_state_dict(load_file(str(CKPT / "model.safetensors")))
    return jm, jparams, tm, {"from_jax_params": via_jax,
                             "safetensors": direct}


def _steps():
    """(lens, page table, tokens, positions, slots, cu_q_lens) of a
    prefill step for prompts of 11 and 23 tokens, pages 0-1 and 2-3."""
    rng = np.random.default_rng(0)
    lens = [11, 23]
    pages = np.array([[0, 1] + [0] * (PAGES - 2),
                      [2, 3] + [0] * (PAGES - 2)], np.int32)
    toks = rng.integers(0, 256, size=sum(lens)).astype(np.int32)
    pos = np.concatenate([np.arange(n) for n in lens]).astype(np.int32)
    seq = np.repeat([0, 1], lens)
    slots = (pages[seq, pos // PS] * PS + pos % PS).astype(np.int32)
    cu = np.array([0, 11, 34], np.int32)
    return lens, pages, toks, pos, slots, cu


def _md(mod, tensor, kv_lens, pages, cu, slots, pos, logits_idx):
    return mod.AttentionMetadata(
        kv_lens=tensor(np.asarray(kv_lens, np.int32)),
        page_indices=tensor(pages), cu_q_lens=tensor(cu),
        num_seqs=tensor(np.asarray([2], np.int32)),
        slot_mapping=tensor(slots), positions=tensor(pos),
        logits_indices=tensor(np.asarray(logits_idx, np.int32)))


@pytest.mark.parametrize("load", ["from_jax_params", "safetensors"])
def test_prefill_then_decode_logits_match_jax(models, load):
    from tensorrt_llm_tpu.ops import attention as jattn
    from tensorrt_llm_tpu_torch.ops import attention as tattn
    jm, jparams, tm, tparams = models
    params = tparams[load]
    lens, pages, toks, pos, slots, cu = _steps()
    L = jm.num_layers
    jpool = jm.make_kv_pages(PAGES, PS)
    tpool = tm.make_kv_pages(PAGES, PS)
    t = torch.from_numpy

    # prefill
    li = [10, 33]
    jl, jpool = jm.forward(jparams, jnp.asarray(toks), jpool, _md(
        jattn, jnp.asarray, lens, pages, cu, slots, pos, li))
    tl, tpool = tm.forward(params, t(toks).long(), tpool, _md(
        tattn, t, lens, pages, cu, slots, pos, li))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), atol=ATOL)
    assert L == 6 and tpool.shape[0] == L

    # decode: each sequence's greedy next token at positions 11 and 23
    nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)
    dpos = np.array(lens, np.int32)
    dslots = (pages[[0, 1], dpos // PS] * PS + dpos % PS).astype(np.int32)
    dcu = np.array([0, 1, 2], np.int32)
    kv = [n + 1 for n in lens]
    jl2, _ = jm.forward(jparams, jnp.asarray(nxt), jpool, _md(
        jattn, jnp.asarray, kv, pages, dcu, dslots, dpos, [0, 1]))
    tl2, _ = tm.forward(params, t(nxt).long(), tpool, _md(
        tattn, t, kv, pages, dcu, dslots, dpos, [0, 1]))
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=ATOL)


def test_dummy_weights_are_seeded(models):
    _, _, tm, _ = models
    a = tm.init_params(seed=3)
    b = tm.init_params(seed=3)
    c = tm.init_params(seed=4)
    assert torch.equal(a["layers"][2]["qkv"]["weight"],
                       b["layers"][2]["qkv"]["weight"])
    assert not torch.equal(a["embed"], c["embed"])
    # tied embeddings share one tensor
    assert a["lm_head"]["weight"] is a["embed"]
