"""LoRA on every model type whose JAX forward applies adapters
(``llm_args.LORA_MODEL_TYPES``): the port's ``LLM`` against the JAX
``LLM`` on the CPU, float32, the tiny seeded models of the families'
parity tests (tests/test_torch_dense_families.py,
test_torch_moe_families.py, test_torch_multimodal.py,
tests/torch_mrope_util.py). One adapter on all seven modules of every
layer, two adapter requests and a base request in one batch (an image
prompt among them for a splice-only and an M-RoPE VLM): greedy tokens
equal the JAX ``LLM``'s, and the adapter moves them off the base's.
"""
import numpy as np
import pytest
import torch

import tensorrt_llm_tpu as J
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu.lora import lora_manager as jl
from tensorrt_llm_tpu_torch.llmapi.llm_args import LORA_MODEL_TYPES
from tensorrt_llm_tpu_torch.lora import lora_manager as tl


def _text(kind):
    import transformers as tf
    from tests import test_torch_dense_families as dense
    from tests import test_torch_moe_families as moe
    base = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=256)
    cfgs = {"qwen2": (tf.Qwen2Config(**base), tf.Qwen2ForCausalLM),
            "qwen3": (tf.Qwen3Config(head_dim=16, **base),
                      tf.Qwen3ForCausalLM),
            "mistral": (tf.MistralConfig(**base), tf.MistralForCausalLM)}
    cfgs.update(dense._configs())
    cfgs.update(moe._configs())
    cfg, cls = cfgs[kind]
    torch.manual_seed(0)
    return cls(cfg).float().eval(), None


def _vlm(kind):
    from tests import test_torch_multimodal as mm
    from tests import torch_mrope_util as U
    if kind in mm.FAMILIES:
        return mm.FAMILIES[kind](), (mm._mm_data(kind, 1) if kind == "llava"
                                     else None)
    hf = U.hf_model(kind)
    return hf, (U.mm((1, 4, 4), 1) if kind == "qwen2_vl" else None)


TEXT = ["mistral", "qwen2", "qwen3", "phi3", "olmo2", "granite", "glm",
        "glm4", "exaone4", "smollm3", "helium", "arcee", "seed_oss",
        "ernie4_5", "hunyuan_v1_dense"]
VLMS = ["llava", "llava_next", "internvl", "mistral3", "qwen2_vl",
        "qwen2_5_vl", "glm4v", "qwen3_vl"]


def test_every_served_type_is_held_here():
    assert set(TEXT + VLMS + ["llama", "tinyllama"]) == set(LORA_MODEL_TYPES)


def _adapter(shapes, layers, seed=3):
    rng = np.random.default_rng(seed)
    w = {m: {layer: ((rng.standard_normal((K, 4)) * 0.3).astype(np.float32),
                     (rng.standard_normal((4, N)) * 0.3).astype(np.float32))
             for layer in range(layers)} for m, (K, N) in shapes.items()}
    return (jl.LoraAdapter(9, 4, {m: {i: jl.LoraLayerWeights(a, b, 2.0)
                                      for i, (a, b) in per.items()}
                                  for m, per in w.items()}),
            tl.LoraAdapter(9, 4, {m: {i: tl.LoraLayerWeights(a, b, 2.0)
                                      for i, (a, b) in per.items()}
                                  for m, per in w.items()}))


@pytest.mark.parametrize("kind", TEXT + VLMS)
def test_adapter_tokens_match_jax(kind):
    hf, image = (_vlm if kind in VLMS else _text)(kind)
    kw = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
              max_input_len=96, max_seq_len=128, max_num_tokens=256,
              enable_lora=True,
              lora_config={"max_lora_rank": 4, "max_loras": 2})
    prompts = [[5, 9, 23, 44, 7], [3, 1, 4, 1, 5, 9, 2, 6], [5, 9, 23, 44, 7]]
    if image is not None:
        prompts[1] = {"prompt_token_ids": _image_ids(kind, hf) + [2, 3],
                      "multi_modal_data": image}
    out = {}
    for pkg, lora in ((T, tl), (J, jl)):
        llm = T.LLM(hf, device="cpu", kv_cache_config=T.KvCacheConfig(
            tokens_per_block=16, max_tokens=1024), **kw) if pkg is T else \
            J.LLM(model=hf, enable_warmup=False,
                  kv_cache_config=J.KvCacheConfig(tokens_per_block=16,
                                                  max_tokens=1024), **kw)
        try:
            if pkg is T:
                shapes = llm.engine.model.lora_module_shapes()
                layers = llm.engine.model.num_layers
                jad, tad = _adapter(shapes, layers)
            llm.lora_manager.add_adapter(tad if pkg is T else jad)
            sp = pkg.SamplingParams(max_tokens=6, top_k=1, end_id=-1)
            futs = [llm.generate_async(p, sp, lora_request=None if i == 2
                                       else lora.LoraRequest("a", 9, ""))
                    for i, p in enumerate(prompts)]
            out[pkg] = [f.result(120).outputs[0].token_ids for f in futs]
        finally:
            llm.shutdown()
    assert out[T] == out[J]
    assert out[T][0] != out[T][2]


def _image_ids(kind, hf):
    """The image placeholder a prompt carries for the processor."""
    if kind == "llava":
        return [hf.config.image_token_index]
    from tests import torch_mrope_util as U
    return [U.V_START, U.IMAGE, U.V_END]
