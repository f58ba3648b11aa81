"""Where the serving path's time goes on the card.

Runs a serving workload once to warm up, once timed without the profiler
and once under ``torch.profiler``, then prints one JSON line: both wall
times, tokens/s and the TTFT / TPOT medians of the timed run (and their maxima), the summed
GPU kernel time, the device's idle share (kernel time over the
unprofiled wall time; the profiler itself slows the host), the KV pages
the timed pass allocated (reused prefix pages included), the launches of
each kernel (and of the dequant-matmul kernel's e4m3 body), the kernel
time by class (the two attention kernels, the dequant-matmul kernel, the
int8 products of SmoothQuant and W4A8, the MoE block's grouped products and its routing and sort, library GEMMs,
everything else; the MoE block's counts, offsets and combine are small
elementwise kernels and stay in "other"), launches per output step (those the
host issues, a CUDA graph's replay being one, and the kernels the device
runs), the CUDA graphs captured and replayed, the windows' dead-step
share, and the top kernels by GPU time.

Two workloads:

- default: ``chip_smoke.py``'s first serving run (TinyLlama-1.1B
  geometry, 32 x 64 heads; seeded random bf16 weights; 16 requests of
  128 prompt tokens and 64 output tokens; ``LLM`` defaults);
- ``--bench-settings``: ``bench.py``'s throughput settings
  (``bench.py:183-251``: its default 1b geometry, 16 x 128 heads; 512
  requests of 128 -> 128 tokens with ``ignore_eos``; max_batch_size 256,
  decode_multi_step 16, max_inflight_steps 3, mixed_window_ctx 512,
  decode_wait_occupancy 1.0, max_num_tokens 16384, page 32);
- ``--geometry qwen3-30b-a3b``: ``chip_smoke.py``'s moe_serving run,
  Qwen3-30B-A3B at its published width and depth (48 layers, hidden
  2048, 32 x 128 q heads, 4 KV heads, 128 experts, top 8, expert width
  768, vocab 151,936; seeded random bf16 weights, 61.1 GB), 64 requests
  of 128 prompt tokens and 64 output tokens with ``ignore_eos``, ``LLM``
  defaults (64 rows, K = 8, depth 4);
- ``--geometry gemma2-9b``: ``chip_smoke.py``'s gemma_serving run,
  Gemma-2-9B at its published width and depth (42 layers, hidden 3584,
  16 x 256 q heads, 8 KV heads, intermediate 14,336, vocab 256,000,
  sliding window 4,096 on the even layers, soft caps 50 and 30; seeded
  random bf16 weights, 18.5 GB), 16 requests of 6,144 prompt tokens and
  64 output tokens with ``ignore_eos``, max_batch_size 16, max_seq_len
  8,192, max_num_tokens 6,144 (one prompt per prefill step), prefix
  reuse off (each pass prefills afresh, as VSWA must); with
  ``--vswa`` the sliding layers keep their KV in their own pool
  (``max_attention_window=[4096, 8192]``);
- ``--geometry gemma3-1b``: Gemma-3-1B at its published width and depth
  (26 layers, hidden 1152, 4 x 256 q heads over 1 KV head, intermediate
  6,912, vocab 262,144, window 512 on five layers of six, rope bases
  1e6 / 1e4; seeded random bf16 weights), 32 requests of 1,024 -> 64
  tokens with ``ignore_eos``, one pool, prefix reuse off;
- ``--geometry llama3-8b``: ``chip_smoke.py``'s kv_serving run,
  Llama-3-8B at its published width and depth (``bench.py``'s ``8b``
  geometry: 32 layers, hidden 4,096, 32 x 128 q heads over 8 KV heads,
  intermediate 14,336, vocab 128,256, rope theta 500,000; seeded random
  bf16 weights, 16.1 GB), 64 requests of 2,048 prompt tokens -> 128
  tokens with ``ignore_eos``, ``LLM`` defaults but prefix reuse off (each
  pass prefills afresh); ``--kv fp8`` (or ``int8``, ``nvfp4``) keeps the
  KV cache in 8 bits (``QuantConfig(kv_cache_quant_algo=...)``, scales
  calibrated at build);
- ``--geometry llama3-8b-copy``: ``chip_smoke.py``'s host_spec_serving
  run, Llama-3-8B as above, 32 requests of 512 prompt tokens, each a
  seeded random 128-token segment repeated 4 times (input-grounded
  copying traffic, what prompt lookup serves), 128 greedy tokens with
  ``ignore_eos``, ``LLM`` defaults but prefix reuse off;
- ``--surface``: ``chip_smoke.py``'s surface_serving run, Llama-3-8B as
  above behind one ``LLM`` with ``max_beam_width=4`` (the sync
  scheduler) and prefix reuse on, one mixed batch of the sampling
  surface's options (``surface_workload``: seeded n = 4 sampling,
  no-repeat-ngram with a bias and bad words, prompt logprobs, beam
  search, a logits processor); the line then carries each class's rate,
  TTFT and TPOT, and the surface's counters (``measure_surface``);
- ``--guided [--guided-backend dfa|dfa-host]``: ``chip_smoke.py``'s
  guided_serving run, Llama-3-8B as above behind one ``LLM`` with
  guided decoding on the device (``dfa``, the default: overlap depth 4,
  K = 8) or on the host (``dfa-host``, the sync scheduler), byte-level
  token bytes and a 16,384-state pool, prefix reuse off, serving one
  mixed batch (``guided_workload``: JSON schema, regex, EBNF and
  ``json_object`` requests, unguided ones, unguided ones aborted through
  ``LLM.abort_request`` at 16 tokens, and one regex too large for the
  pool); the line then carries each class's rate, TTFT and TPOT, each
  grammar's build ms, the pool states in use, the guided windows and
  single steps, and how each request ended (``measure_guided``).

- ``--geometry llama3-8b-quant``: ``chip_smoke.py``'s quant_serving run,
  Llama-3-8B as above, 64 requests of 512 prompt tokens -> 128 tokens
  with ``ignore_eos``, ``LLM`` defaults (64 rows, K =
  8 windows, depth 4, CUDA graphs) but prefix reuse off; with
  ``--layers N`` at the first N layers;
- ``--family NAME``: one Llama-derived family at a published model's
  width (``FAMILIES``: Granite-3.1-8B, OLMo-2-1124-7B, Phi-3-medium-4k,
  GLM-4-9B-0414, glm-4-9b-chat-hf, SmolLM3-3B, Helium-1-2B, AFM-4.5B,
  EXAONE-4.0-32B) at the run depth the table gives (2 layers; 4 for
  EXAONE 4 and SmolLM3, so that a global or NoPE layer runs), seeded
  random bf16 weights, 16 requests of 256 prompt tokens -> 32 tokens; and
  the GPT families (``GPT_FAMILIES``: GPT-2 XL, GPT-NeoX-20B, GPT-J-6B,
  Falcon-7B, StarCoder2-15B, c4ai-command-r-v01, c4ai-command-r7b-12-2024,
  Minitron-8B-Base, StableLM-3B-4E1T, bloom-7b1, MPT-7B, OPT-6.7B) the
  same way, 2 layers (4 for Command-R7B, so that its global NoPE layer
  runs);
- ``--geometry gpt-oss-20b``: ``chip_smoke.py``'s gptoss_serving run,
  gpt-oss-20b at its published width and depth (``GPT_OSS_20B``: 24
  layers, hidden 2,880, 64 x 64 q heads over 8 with sinks, windows of 128
  on the even layers, 32 experts top 4, seeded random bf16 weights), 64
  requests of 512 prompt tokens -> 128 with ``ignore_eos``, ``LLM``
  defaults (64 rows, K = 8, depth 4, CUDA graphs) but 8,192 tokens a
  prefill step (16 prompts) and prefix reuse off;
- ``--geometry deepseek-v2-lite``: ``chip_smoke.py``'s deepseek_serving
  run, DeepSeek-V2-Lite at its published width and depth
  (``DEEPSEEK_V2_LITE``: 27 layers, hidden 2,048, 16 MLA heads over a
  latent of 512 + 64 a token, 64 experts top 6 of width 1,408 and 2
  shared ones after one dense layer, yarn factor 40; seeded random bf16
  weights, ~31.4 GB), the same traffic as gpt-oss-20b's; MLA's float32
  products are their own class (``mla_einsum``);
- ``--family NAME`` also takes the DeepSeek-style families and the last
  attention-only dense ones (``MOE_FAMILIES``: GLM-4.5-Air,
  ERNIE-4.5-21B-A3B, Hunyuan-A13B, Granite-3.1-3B-A800M, DeepSeek-V3
  with one dense layer before one MoE layer, Hunyuan-7B, Seed-OSS-36B,
  ERNIE-4.5-0.3B, Apertus-8B), 2 layers;
- ``--geometry bamba-9b``: ``chip_smoke.py``'s bamba_serving run,
  Bamba-9B at its published width and depth (``BAMBA_9B``: 32 layers,
  attention at 9, 18 and 27 through K1/K2, 29 Mamba2 layers of 128 heads
  x 64 over a state of 128, seeded random bf16 weights, ~9.8 B
  parameters), 64 requests of 512 prompt tokens -> 128 with
  ``ignore_eos``, ``LLM`` defaults (64 rows, K = 8, depth 4, CUDA graphs)
  but 8,192 tokens a prefill step (16 prompts); the state pools hold
  124.6 MB a slot, float32;
- ``--geometry deepseek-v3-mtp``: ``chip_smoke.py``'s mtp_serving run,
  DeepSeek-V3 at its published width (``DEEPSEEK_V3``: hidden 7,168, 128
  MLA heads over a latent of 512 + 64, 256 experts top 8 of 2,048 in 8
  groups and 1 shared, vocab 129,280), cut to its first 4 layers (3
  dense, 1 MoE) plus its MTP module (``num_nextn_predict_layers`` 1),
  seeded random bf16 weights made on the card (~53.4 GB with the head),
  64 requests of 512 prompt tokens -> 128 with ``ignore_eos``, ``LLM``
  defaults but 8,192 tokens a prefill step; ``--spec MTP --draft-len 1``
  (``--spec-host``: the host path) drafts with the module's seeded random
  weights (``mtp_head_checkpoint``);
- ``--geometry longcat-flash``: ``chip_smoke.py``'s longcat_serving run,
  LongCat-Flash at its published width (``LONGCAT_FLASH``: hidden 6,144,
  64 MLA heads, dense MLPs of 12,288, 512 experts top 12 of 2,048 beside
  256 zero experts, vocab 131,072) at 1 of its 28 pairs, seeded random
  bf16 weights made on the card (~43.1 GB), the same traffic;
- ``--geometry llava-1.5-7b``: ``chip_smoke.py``'s llava_serving run,
  LLaVA-1.5-7B at its published width and depth (``LLAVA_15_7B``: CLIP
  ViT-L/14 at 336 px, its layer -2 features, a GELU projector to 4,096,
  Vicuna-7B's 32 layers), seeded random bf16 weights made on the card
  (~14.1 GB), 64 requests of one 336 x 336 image (576 tokens) and 64
  text tokens -> 128 with ``ignore_eos``, ``LLM`` defaults but 8,192
  tokens a prefill step and prefix reuse off (``--layers N`` cuts the
  text model only);
- ``--family NAME`` also takes the recurrent families
  (``RECURRENT_FAMILIES``: Mamba-2.8B, Falcon-Mamba-7B, Mamba2-2.7B,
  Granite-4.0-H-Tiny, Zamba2-1.2B, Jamba-v0.1, LFM2-1.2B,
  Qwen3-Next-80B-A3B, MiniMax-Text-01), each cut in depth so that every
  kind of its layers runs at least once.

``--quant ALGO`` quantizes the weights at load (``--group-size`` for the
group-wise algorithms and W4A8): any ``QuantAlgo`` the package serves,
among them FP8, FP8_PER_CHANNEL_PER_TOKEN, FP8_BLOCK_SCALES,
W8A8_SQ_PER_CHANNEL and W4A8_AWQ. ``--inline`` builds the model as a
``transformers`` module on the card in bf16 (its own seeded
initialisation) and hands it to ``LLM`` as ``model=``; under
W8A8_SQ_PER_CHANNEL its SmoothQuant scales are then calibrated on that
module, on the card in bf16 (without ``--inline`` SmoothQuant applies no
smoothing, as in the JAX package). ``--spec EAGLE3 --draft-len d`` serves the
workload with EAGLE3 speculative decoding in the fused device window and
a seeded random head (which accepts close to nothing: the run shows the
window's mechanics and costs, not a speed-up); the line then also carries
the spec windows dispatched, their iterations, the dead ones the host
foresaw and those that emitted nothing (a graph runs them all), the mean
drafts accepted per iteration, the decode rows that ran
outside spec windows, and the launches replayed from spec graphs.
``--spec NGRAM|SA|DRAFT_TARGET|PARD --draft-len d`` serves it with a host
drafter on the sync scheduler (DRAFT_TARGET and PARD draft with
Llama-3.2-1B from its published config, ``LLAMA32_1B``, seeded random
weights); the line then also carries the rows verified with drafts, the
drafts proposed and accepted (per verify step and per drafted row), the
verify steps replayed from graphs and run eagerly (with prompt tokens and
without: the latter must be 0 on the card), the drafting calls' device
time (CUDA events around each call, which ends in a host sync) and the
K1 / K2 launches made while drafting (the rest are the target's).

    python -m tensorrt_llm_tpu_torch.tools.serving_profile
    python -m tensorrt_llm_tpu_torch.tools.serving_profile --bench-settings
    python -m tensorrt_llm_tpu_torch.tools.serving_profile \
        --geometry qwen3-30b-a3b
    python -m tensorrt_llm_tpu_torch.tools.serving_profile \
        --geometry gemma2-9b [--vswa]
    python -m tensorrt_llm_tpu_torch.tools.serving_profile \
        --geometry llama3-8b [--kv fp8|int8]
    python -m tensorrt_llm_tpu_torch.tools.serving_profile --quant W4A16_AWQ
    python -m tensorrt_llm_tpu_torch.tools.serving_profile --spec EAGLE3 \
        --draft-len 3
    python -m tensorrt_llm_tpu_torch.tools.serving_profile \
        --geometry llama3-8b-copy --spec DRAFT_TARGET --draft-len 4
    python -m tensorrt_llm_tpu_torch.tools.serving_profile \
        --geometry llama3-8b-quant --quant FP8 [--layers 8]
    python -m tensorrt_llm_tpu_torch.tools.serving_profile \
        --geometry llama3-8b-quant --quant W8A8_SQ_PER_CHANNEL --inline \
        --layers 8
    python -m tensorrt_llm_tpu_torch.tools.serving_profile --family glm4
    python -m tensorrt_llm_tpu_torch.tools.serving_profile --family falcon
    python -m tensorrt_llm_tpu_torch.tools.serving_profile \
        --geometry gpt-oss-20b
    python -m tensorrt_llm_tpu_torch.tools.serving_profile \
        --geometry bamba-9b
    python -m tensorrt_llm_tpu_torch.tools.serving_profile --family jamba
    python -m tensorrt_llm_tpu_torch.tools.serving_profile \
        --geometry deepseek-v3-mtp [--spec MTP --draft-len 1 [--spec-host]]
    python -m tensorrt_llm_tpu_torch.tools.serving_profile \
        --geometry longcat-flash
    python -m tensorrt_llm_tpu_torch.tools.serving_profile --surface
    python -m tensorrt_llm_tpu_torch.tools.serving_profile --guided \
        [--guided-backend dfa-host]
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import time

from typing import Optional

import numpy as np
import torch

_DECODE = ("decode_tc_kernel", "decode_f32_simple_kernel",
           "decode_merge_kernel")
_PREFILL = ("prefill_wgmma_kernel", "prefill_f32_simple_kernel")
# runtime calls by which the host starts work on the device
_HOST_LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                "cudaMemcpyAsync", "cudaMemsetAsync")

TINYLLAMA = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                 num_hidden_layers=22, num_attention_heads=32,
                 num_key_value_heads=4, max_position_embeddings=4096)
BENCH_1B = dict(TINYLLAMA, num_attention_heads=16, head_dim=128)
# https://huggingface.co/Qwen/Qwen3-30B-A3B/blob/main/config.json
QWEN3_30B_A3B = dict(
    model_type="qwen3_moe", architectures=["Qwen3MoeForCausalLM"],
    vocab_size=151936, hidden_size=2048, intermediate_size=6144,
    moe_intermediate_size=768, num_hidden_layers=48,
    num_attention_heads=32, num_key_value_heads=4, head_dim=128,
    num_experts=128, num_experts_per_tok=8, norm_topk_prob=True,
    decoder_sparse_step=1, mlp_only_layers=[], max_position_embeddings=40960,
    rms_norm_eps=1e-6, rope_theta=1e6, attention_bias=False,
    use_sliding_window=False, sliding_window=None,
    tie_word_embeddings=False, bos_token_id=151643, eos_token_id=151645)
# https://huggingface.co/google/gemma-2-9b/blob/main/config.json
GEMMA2_9B = dict(
    vocab_size=256000, hidden_size=3584, intermediate_size=14336,
    num_hidden_layers=42, num_attention_heads=16, num_key_value_heads=8,
    head_dim=256, query_pre_attn_scalar=256, sliding_window=4096,
    attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
    max_position_embeddings=8192, rms_norm_eps=1e-6, rope_theta=10000.0,
    hidden_activation="gelu_pytorch_tanh", bos_token_id=2, eos_token_id=1,
    pad_token_id=0)
# https://huggingface.co/meta-llama/Meta-Llama-3-8B/blob/main/config.json
# (bench.py's "8b" geometry, with the config's rope theta and norm eps)
LLAMA3_8B = dict(
    vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    max_position_embeddings=8192, rope_theta=500000.0, rms_norm_eps=1e-5,
    tie_word_embeddings=False, bos_token_id=128000, eos_token_id=128001)
# https://huggingface.co/meta-llama/Llama-3.2-1B/blob/main/config.json
# (the draft model of DRAFT_TARGET / PARD beside LLAMA3_8B)
LLAMA32_1B = dict(
    vocab_size=128256, hidden_size=2048, intermediate_size=8192,
    num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8,
    head_dim=64, max_position_embeddings=131072, rope_theta=500000.0,
    rope_scaling={"factor": 32.0, "high_freq_factor": 4.0,
                  "low_freq_factor": 1.0,
                  "original_max_position_embeddings": 8192,
                  "rope_type": "llama3"},
    rms_norm_eps=1e-5, tie_word_embeddings=True, bos_token_id=128000,
    eos_token_id=128001)
HOST_SPEC_MODES = ("NGRAM", "SA", "DRAFT_TARGET", "PARD")
# The Llama-derived dense families at a published model's width: (the
# transformers config class, its fields, the layers a run keeps, the
# source of the widths). Depth is cut to the run's layers; every width
# is the source's.
FAMILIES = {
    # https://huggingface.co/ibm-granite/granite-3.1-8b-base config.json
    "granite": ("GraniteConfig", dict(
        vocab_size=49155, hidden_size=4096, intermediate_size=12800,
        num_hidden_layers=40, num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=131072, rope_theta=10000000.0,
        rms_norm_eps=1e-5, embedding_multiplier=12.0,
        attention_multiplier=0.0078125, residual_multiplier=0.22,
        logits_scaling=16.0, tie_word_embeddings=True), 2,
        "Granite-3.1-8B"),
    # https://huggingface.co/allenai/OLMo-2-1124-7B config.json
    "olmo2": ("Olmo2Config", dict(
        vocab_size=100352, hidden_size=4096, intermediate_size=11008,
        num_hidden_layers=32, num_attention_heads=32,
        num_key_value_heads=32, max_position_embeddings=4096,
        rope_theta=500000.0, rms_norm_eps=1e-6, tie_word_embeddings=False),
        2, "OLMo-2-1124-7B"),
    # https://huggingface.co/microsoft/Phi-3-medium-4k-instruct config.json
    # (head dim 128; Phi-3-mini's 96 runs in GPT-NeoX-20B's geometry)
    "phi3": ("Phi3Config", dict(
        vocab_size=32064, hidden_size=5120, intermediate_size=17920,
        num_hidden_layers=40, num_attention_heads=40,
        num_key_value_heads=10, max_position_embeddings=4096,
        sliding_window=2047, rope_theta=10000.0, rms_norm_eps=1e-5,
        tie_word_embeddings=False, pad_token_id=32000, eos_token_id=32000,
        bos_token_id=1), 2, "Phi-3-medium-4k"),
    # https://huggingface.co/THUDM/glm-4-9b-chat-hf config.json
    "glm": ("GlmConfig", dict(
        vocab_size=151552, hidden_size=4096, intermediate_size=13696,
        num_hidden_layers=40, num_attention_heads=32, num_key_value_heads=2,
        head_dim=128, partial_rotary_factor=0.5, attention_bias=True,
        max_position_embeddings=131072, rope_theta=10000.0,
        rms_norm_eps=1.5625e-07, tie_word_embeddings=False,
        pad_token_id=151329, eos_token_id=151329, bos_token_id=151329), 2,
        "glm-4-9b-chat-hf"),
    # https://huggingface.co/THUDM/GLM-4-9B-0414 config.json
    "glm4": ("Glm4Config", dict(
        vocab_size=151552, hidden_size=4096, intermediate_size=13696,
        num_hidden_layers=40, num_attention_heads=32, num_key_value_heads=2,
        head_dim=128, partial_rotary_factor=0.5, attention_bias=True,
        max_position_embeddings=32768, rope_theta=10000.0,
        rms_norm_eps=1e-5, tie_word_embeddings=False,
        pad_token_id=151329, eos_token_id=151329, bos_token_id=151329), 2,
        "GLM-4-9B-0414"),
    # https://huggingface.co/HuggingFaceTB/SmolLM3-3B config.json (NoPE
    # every fourth layer)
    "smollm3": ("SmolLM3Config", dict(
        vocab_size=128256, hidden_size=2048, intermediate_size=11008,
        num_hidden_layers=36, num_attention_heads=16, num_key_value_heads=4,
        max_position_embeddings=65536, rope_theta=5000000.0,
        rms_norm_eps=1e-6, no_rope_layer_interval=4,
        tie_word_embeddings=True, pad_token_id=128004,
        eos_token_id=128012, bos_token_id=128000), 4, "SmolLM3-3B"),
    # https://huggingface.co/kyutai/helium-1-preview-2b config.json
    # (transformers' HeliumConfig defaults)
    "helium": ("HeliumConfig", dict(
        vocab_size=48000, hidden_size=2560, intermediate_size=7040,
        num_hidden_layers=24, num_attention_heads=20,
        num_key_value_heads=20, head_dim=128, max_position_embeddings=4096,
        rope_theta=100000.0, rms_norm_eps=1e-8, tie_word_embeddings=False,
        pad_token_id=3, eos_token_id=2, bos_token_id=1), 2,
        "Helium-1-2B"),
    # https://huggingface.co/arcee-ai/AFM-4.5B config.json (its long-
    # context rope scaling left out: the runs stay in 4,096 positions)
    "arcee": ("ArceeConfig", dict(
        vocab_size=128004, hidden_size=2560, intermediate_size=18432,
        num_hidden_layers=36, num_attention_heads=20, num_key_value_heads=4,
        head_dim=128, max_position_embeddings=4096, rope_theta=10000.0,
        rms_norm_eps=1e-5, tie_word_embeddings=False, pad_token_id=0,
        eos_token_id=128001, bos_token_id=128000), 2, "AFM-4.5B"),
    # https://huggingface.co/LGAI-EXAONE/EXAONE-4.0-32B config.json (three
    # sliding-window layers of 4,096 to one global NoPE layer)
    "exaone4": ("Exaone4Config", dict(
        vocab_size=102400, hidden_size=5120, intermediate_size=27392,
        num_hidden_layers=64, num_attention_heads=40,
        num_key_value_heads=8, head_dim=128, max_position_embeddings=131072,
        sliding_window=4096, sliding_window_pattern=4, rope_theta=1000000.0,
        rope_scaling={"rope_type": "llama3", "factor": 16.0,
                      "high_freq_factor": 4.0, "low_freq_factor": 1.0,
                      "original_max_position_embeddings": 8192},
        rms_norm_eps=1e-5, tie_word_embeddings=False, pad_token_id=0,
        eos_token_id=361, bos_token_id=1), 4, "EXAONE-4.0-32B"),
}


# The LayerNorm GPT families and GPT-2 at a published model's width, as
# FAMILIES (a family's fields name its transformers config's own keys).
GPT_FAMILIES = {
    # https://huggingface.co/openai-community/gpt2-xl config.json
    "gpt2": ("GPT2Config", dict(
        vocab_size=50257, n_embd=1600, n_head=25, n_layer=48,
        n_positions=1024, layer_norm_epsilon=1e-5, bos_token_id=50256,
        eos_token_id=50256), 2, "GPT-2 XL"),
    # https://huggingface.co/EleutherAI/gpt-neox-20b config.json (head
    # dim 96)
    "gpt_neox": ("GPTNeoXConfig", dict(
        vocab_size=50432, hidden_size=6144, intermediate_size=24576,
        num_hidden_layers=44, num_attention_heads=64, rotary_pct=0.25,
        rotary_emb_base=10000, rope_theta=10000.0,
        max_position_embeddings=2048, layer_norm_eps=1e-5,
        use_parallel_residual=True, tie_word_embeddings=False,
        bos_token_id=0, eos_token_id=0), 2, "GPT-NeoX-20B"),
    # https://huggingface.co/EleutherAI/gpt-j-6b config.json (head dim 256)
    "gptj": ("GPTJConfig", dict(
        vocab_size=50400, n_embd=4096, n_head=16, n_layer=28,
        rotary_dim=64, n_positions=2048, layer_norm_epsilon=1e-5,
        tie_word_embeddings=False, bos_token_id=50256,
        eos_token_id=50256), 2, "GPT-J-6B"),
    # https://huggingface.co/tiiuae/falcon-7b config.json (71 q heads over
    # one KV head)
    "falcon": ("FalconConfig", dict(
        vocab_size=65024, hidden_size=4544, num_hidden_layers=32,
        num_attention_heads=71, multi_query=True, parallel_attn=True,
        new_decoder_architecture=False, bias=False, alibi=False,
        layer_norm_epsilon=1e-5, max_position_embeddings=2048,
        rope_theta=10000.0, bos_token_id=11, eos_token_id=11), 2,
        "Falcon-7B"),
    # https://huggingface.co/bigcode/starcoder2-15b config.json
    "starcoder2": ("Starcoder2Config", dict(
        vocab_size=49152, hidden_size=6144, intermediate_size=24576,
        num_hidden_layers=40, num_attention_heads=48,
        num_key_value_heads=4, max_position_embeddings=16384,
        sliding_window=4096, rope_theta=100000.0, norm_epsilon=1e-5,
        use_bias=True, tie_word_embeddings=False, bos_token_id=0,
        eos_token_id=0), 2, "StarCoder2-15B"),
    # https://huggingface.co/CohereForAI/c4ai-command-r-v01 config.json
    "cohere": ("CohereConfig", dict(
        vocab_size=256000, hidden_size=8192, intermediate_size=22528,
        num_hidden_layers=40, num_attention_heads=64,
        num_key_value_heads=64, max_position_embeddings=8192,
        rope_theta=8000000.0, layer_norm_eps=1e-5, logit_scale=0.0625,
        use_qk_norm=False, tie_word_embeddings=True, bos_token_id=5,
        eos_token_id=255001, pad_token_id=0), 2, "c4ai-command-r-v01"),
    # https://huggingface.co/CohereForAI/c4ai-command-r7b-12-2024
    # config.json (three sliding layers of 4,096 to one global NoPE one)
    "cohere2": ("Cohere2Config", dict(
        vocab_size=256000, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32,
        num_key_value_heads=8, head_dim=128, max_position_embeddings=8192,
        sliding_window=4096, sliding_window_pattern=4, rope_theta=50000.0,
        layer_norm_eps=1e-5, logit_scale=0.25, tie_word_embeddings=True,
        bos_token_id=5, eos_token_id=255001, pad_token_id=0), 4,
        "c4ai-command-r7b-12-2024"),
    # https://huggingface.co/nvidia/Minitron-8B-Base config.json
    "nemotron": ("NemotronConfig", dict(
        vocab_size=256000, hidden_size=4096, intermediate_size=16384,
        num_hidden_layers=32, num_attention_heads=48,
        num_key_value_heads=8, head_dim=128, partial_rotary_factor=0.5,
        max_position_embeddings=4096, rope_theta=10000.0, norm_eps=1e-5,
        hidden_act="relu2", tie_word_embeddings=False, bos_token_id=2,
        eos_token_id=3), 2, "Minitron-8B-Base"),
    # https://huggingface.co/stabilityai/stablelm-3b-4e1t config.json (head
    # dim 80)
    "stablelm": ("StableLmConfig", dict(
        vocab_size=50304, hidden_size=2560, intermediate_size=6912,
        num_hidden_layers=32, num_attention_heads=32,
        num_key_value_heads=32, partial_rotary_factor=0.25,
        max_position_embeddings=4096, rope_theta=10000.0,
        layer_norm_eps=1e-5, use_qkv_bias=False, tie_word_embeddings=False,
        bos_token_id=0, eos_token_id=0), 2, "StableLM-3B-4E1T"),
    # https://huggingface.co/bigscience/bloom-7b1 config.json (ALiBi)
    "bloom": ("BloomConfig", dict(
        vocab_size=250880, hidden_size=4096, n_head=32, n_layer=30,
        layer_norm_epsilon=1e-5, bos_token_id=1, eos_token_id=2,
        pad_token_id=3), 2, "bloom-7b1"),
    # https://huggingface.co/mosaicml/mpt-7b config.json (ALiBi)
    "mpt": ("MptConfig", dict(
        vocab_size=50432, d_model=4096, n_heads=32, n_layers=32,
        expansion_ratio=4, max_seq_len=2048, layer_norm_epsilon=1e-5,
        no_bias=True), 2, "MPT-7B"),
    # facebook/opt-6.7b on the Hugging Face Hub, its config.json
    "opt": ("OPTConfig", dict(
        vocab_size=50272, hidden_size=4096, ffn_dim=16384,
        num_hidden_layers=32, num_attention_heads=32,
        max_position_embeddings=2048, word_embed_proj_dim=4096,
        do_layer_norm_before=True, bos_token_id=2, eos_token_id=2,
        pad_token_id=1), 2, "OPT-6.7B"),
}
# https://huggingface.co/openai/gpt-oss-20b config.json (every field set:
# transformers' GptOssConfig defaults are gpt-oss-120b's and carry no
# swiglu_limit)
GPT_OSS_20B = dict(
    vocab_size=201088, hidden_size=2880, intermediate_size=2880,
    num_hidden_layers=24, num_attention_heads=64, num_key_value_heads=8,
    head_dim=64, num_local_experts=32, num_experts_per_tok=4,
    sliding_window=128,
    layer_types=["sliding_attention", "full_attention"] * 12,
    rope_theta=150000.0,
    rope_scaling={"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
                  "beta_slow": 1.0, "truncate": False,
                  "original_max_position_embeddings": 4096},
    max_position_embeddings=131072, rms_norm_eps=1e-5, swiglu_limit=7.0,
    attention_bias=True, tie_word_embeddings=False, eos_token_id=200002,
    pad_token_id=199999)


# https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite config.json (every
# field the port reads; yarn factor 40)
DEEPSEEK_V2_LITE = dict(
    vocab_size=102400, hidden_size=2048, intermediate_size=10944,
    moe_intermediate_size=1408, num_hidden_layers=27,
    num_attention_heads=16, num_key_value_heads=16, n_routed_experts=64,
    num_experts_per_tok=6, n_shared_experts=2, first_k_dense_replace=1,
    moe_layer_freq=1, q_lora_rank=None, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    topk_method="greedy", n_group=1, topk_group=1, norm_topk_prob=False,
    routed_scaling_factor=1.0, scoring_func="softmax",
    max_position_embeddings=163840, rope_theta=10000.0,
    rope_scaling={"type": "yarn", "factor": 40.0, "beta_fast": 32.0,
                  "beta_slow": 1.0, "mscale": 0.707, "mscale_all_dim": 0.707,
                  "original_max_position_embeddings": 4096},
    rms_norm_eps=1e-6, attention_bias=False, tie_word_embeddings=False,
    bos_token_id=100000, eos_token_id=100001)

# The DeepSeek-style MoE families and the last attention-only dense ones
# at a published model's width, as FAMILIES: (config class, its fields, the
# layers a run keeps, the source). ``moe_family_config`` cuts the
# per-layer lists and ERNIE's last MoE layer with the depth.
MOE_FAMILIES = {
    # https://huggingface.co/zai-org/GLM-4.5-Air config.json
    "glm4_moe": ("Glm4MoeConfig", dict(
        vocab_size=151552, hidden_size=4096, intermediate_size=10944,
        moe_intermediate_size=1408, num_hidden_layers=46,
        num_attention_heads=96, num_key_value_heads=8, head_dim=128,
        n_routed_experts=128, num_experts_per_tok=8, n_shared_experts=1,
        first_k_dense_replace=1, n_group=1, topk_group=1,
        norm_topk_prob=True, routed_scaling_factor=1.0,
        partial_rotary_factor=0.5, attention_bias=True, use_qk_norm=False,
        max_position_embeddings=131072, rope_theta=1000000.0,
        rms_norm_eps=1e-5, tie_word_embeddings=False, pad_token_id=151329,
        eos_token_id=151329), 2, "GLM-4.5-Air"),
    # https://huggingface.co/baidu/ERNIE-4.5-21B-A3B-PT config.json
    "ernie4_5_moe": ("Ernie4_5_MoeConfig", dict(
        vocab_size=103424, hidden_size=2560, intermediate_size=12288,
        moe_intermediate_size=1536, num_hidden_layers=28,
        num_attention_heads=20, num_key_value_heads=4, head_dim=128,
        moe_num_experts=64, moe_k=6, moe_num_shared_experts=2,
        moe_layer_start_index=1, moe_layer_end_index=27,
        moe_layer_interval=1, moe_norm_min=1e-12, use_bias=False,
        max_position_embeddings=131072, rope_theta=500000.0,
        rms_norm_eps=1e-5, tie_word_embeddings=True, pad_token_id=0,
        bos_token_id=1, eos_token_id=2), 2, "ERNIE-4.5-21B-A3B"),
    # https://huggingface.co/tencent/Hunyuan-A13B-Instruct config.json
    "hunyuan_v1_moe": ("HunYuanMoEV1Config", dict(
        vocab_size=128167, hidden_size=4096, intermediate_size=3072,
        moe_intermediate_size=[3072] * 32, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=8, head_dim=128,
        num_experts=64, moe_topk=[8] * 32, num_shared_expert=[1] * 32,
        use_qk_norm=True, max_position_embeddings=32768,
        rope_theta=10000.0, rope_scaling={"type": "dynamic",
                                          "alpha": 1000.0, "factor": 1.0},
        rms_norm_eps=1e-5, tie_word_embeddings=True, pad_token_id=127961,
        bos_token_id=1, eos_token_id=127960), 2, "Hunyuan-A13B"),
    # https://huggingface.co/ibm-granite/granite-3.1-3b-a800m-instruct
    # config.json (head dim 64)
    "granitemoe": ("GraniteMoeConfig", dict(
        vocab_size=49155, hidden_size=1536, intermediate_size=512,
        num_hidden_layers=32, num_attention_heads=24, num_key_value_heads=8,
        num_local_experts=40, num_experts_per_tok=8,
        embedding_multiplier=12.0, attention_multiplier=0.015625,
        residual_multiplier=0.22, logits_scaling=6.0,
        max_position_embeddings=131072, rope_theta=10000000.0,
        rms_norm_eps=1e-6, tie_word_embeddings=True, pad_token_id=0,
        bos_token_id=0, eos_token_id=0), 2, "Granite-3.1-3B-A800M"),
    # https://huggingface.co/deepseek-ai/DeepSeek-V3 config.json, cut to
    # one dense layer before one MoE layer (first_k_dense_replace 1)
    "deepseek_v3": ("DeepseekV3Config", dict(
        vocab_size=129280, hidden_size=7168, intermediate_size=18432,
        moe_intermediate_size=2048, num_hidden_layers=61,
        num_attention_heads=128, num_key_value_heads=128, q_lora_rank=1536,
        kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128, n_routed_experts=256, num_experts_per_tok=8,
        n_shared_experts=1, first_k_dense_replace=3, n_group=8,
        topk_group=4, norm_topk_prob=True, routed_scaling_factor=2.5,
        topk_method="noaux_tc", max_position_embeddings=163840,
        rope_theta=10000.0,
        rope_scaling={"type": "yarn", "factor": 40.0, "beta_fast": 32.0,
                      "beta_slow": 1.0, "mscale": 1.0, "mscale_all_dim": 1.0,
                      "original_max_position_embeddings": 4096},
        rms_norm_eps=1e-6, tie_word_embeddings=False, bos_token_id=0,
        eos_token_id=1), 2, "DeepSeek-V3"),
    # https://huggingface.co/tencent/Hunyuan-7B-Instruct config.json
    "hunyuan_v1_dense": ("HunYuanDenseV1Config", dict(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        head_dim=128, use_qk_norm=True, max_position_embeddings=32768,
        rope_theta=10000.0, rope_scaling={"type": "dynamic",
                                          "alpha": 1000.0, "factor": 1.0},
        rms_norm_eps=1e-5, tie_word_embeddings=True, pad_token_id=127961,
        bos_token_id=1, eos_token_id=127960), 2, "Hunyuan-7B"),
    # https://huggingface.co/ByteDance-Seed/Seed-OSS-36B-Instruct
    # config.json
    "seed_oss": ("SeedOssConfig", dict(
        vocab_size=155136, hidden_size=5120, intermediate_size=27648,
        num_hidden_layers=64, num_attention_heads=80, num_key_value_heads=8,
        head_dim=128, attention_bias=True, attention_out_bias=False,
        mlp_bias=False, max_position_embeddings=524288,
        rope_theta=10000000.0, rms_norm_eps=1e-6, tie_word_embeddings=False,
        pad_token_id=1, bos_token_id=0, eos_token_id=2), 2,
        "Seed-OSS-36B"),
    # https://huggingface.co/baidu/ERNIE-4.5-0.3B-PT config.json
    "ernie4_5": ("Ernie4_5Config", dict(
        vocab_size=103424, hidden_size=1024, intermediate_size=3072,
        num_hidden_layers=18, num_attention_heads=16, num_key_value_heads=2,
        head_dim=128, use_bias=False, max_position_embeddings=131072,
        rope_theta=500000.0, rms_norm_eps=1e-5, tie_word_embeddings=True,
        pad_token_id=0, bos_token_id=1, eos_token_id=2), 2,
        "ERNIE-4.5-0.3B"),
    # https://huggingface.co/swiss-ai/Apertus-8B-2509 config.json
    "apertus": ("ApertusConfig", dict(
        vocab_size=131072, hidden_size=4096, intermediate_size=21504,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=65536, rope_theta=12000000.0,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "high_freq_factor": 4.0, "low_freq_factor": 1.0,
                      "original_max_position_embeddings": 8192},
        rms_norm_eps=1e-5, attention_bias=False, tie_word_embeddings=False,
        pad_token_id=3, bos_token_id=1, eos_token_id=68), 2,
        "Apertus-8B"),
}


# https://huggingface.co/deepseek-ai/DeepSeek-V3 config.json (the widths of
# transformers' DeepseekV3Config() defaults, with the published yarn
# rope_scaling) and its one MTP module (num_nextn_predict_layers 1), cut to
# its first 4 layers: the 3 dense ones and the first MoE layer
DEEPSEEK_V3 = dict(MOE_FAMILIES["deepseek_v3"][1], num_hidden_layers=4,
                   num_nextn_predict_layers=1)

# https://huggingface.co/meituan-longcat/LongCat-Flash-Chat config.json
# (the fields of transformers' LongcatFlashConfig() defaults), at 1 of its
# 28 pairs of MLA + dense sublayers
LONGCAT_FLASH = dict(
    vocab_size=131072, hidden_size=6144, ffn_hidden_size=12288,
    expert_ffn_hidden_size=2048, num_layers=1, num_attention_heads=64,
    num_key_value_heads=64, head_dim=64, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    n_routed_experts=512, zero_expert_num=256, moe_topk=12,
    routed_scaling_factor=6.0, max_position_embeddings=131072,
    rope_theta=10000000.0, rope_scaling=None, rms_norm_eps=1e-5,
    attention_bias=False, tie_word_embeddings=False, bos_token_id=1,
    eos_token_id=2)


# https://huggingface.co/ibm-ai-platform/Bamba-9B config.json: the fields
# the port reads (the others at BambaConfig's defaults, among them
# partial_rotary_factor 0.5 and rope_theta 10,000)
BAMBA_9B = dict(
    vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    attn_layer_indices=[9, 18, 27], mamba_n_heads=128, mamba_d_head=64,
    mamba_n_groups=1, mamba_d_state=128, mamba_d_conv=4, mamba_expand=2,
    mamba_chunk_size=256, rms_norm_eps=1e-5, tie_word_embeddings=False)

# The recurrent families at a published model's width, as MOE_FAMILIES:
# (config class, its fields, the layers a run keeps, the source). The
# run's layers keep every kind of layer the model has (``layer_kinds``
# cuts the per-layer lists); Jamba keeps one period of 8 (its MoE layers
# alternate, its attention layer is the fifth).
RECURRENT_FAMILIES = {
    # https://huggingface.co/state-spaces/mamba-2.8b-hf config.json
    "mamba": ("MambaConfig", dict(
        vocab_size=50280, hidden_size=2560, num_hidden_layers=64,
        state_size=16, expand=2, conv_kernel=4, time_step_rank=160,
        layer_norm_epsilon=1e-5, use_bias=False, use_conv_bias=True),
        2, "Mamba-2.8B"),
    # https://huggingface.co/tiiuae/falcon-mamba-7b config.json
    "falcon_mamba": ("FalconMambaConfig", dict(
        vocab_size=65024, hidden_size=4096, num_hidden_layers=64,
        state_size=16, expand=2, conv_kernel=4, time_step_rank=256,
        mixer_rms_eps=1e-6, layer_norm_epsilon=1e-5, use_bias=False,
        use_conv_bias=True), 2, "Falcon-Mamba-7B"),
    # https://huggingface.co/state-spaces/mamba2-2.7b config.json
    "mamba2": ("Mamba2Config", dict(
        vocab_size=50288, hidden_size=2560, num_hidden_layers=64,
        state_size=128, expand=2, conv_kernel=4, num_heads=80, head_dim=64,
        n_groups=1, chunk_size=256, layer_norm_epsilon=1e-5,
        use_bias=False, use_conv_bias=True), 2, "Mamba2-2.7B"),
    # https://huggingface.co/ibm-granite/granite-4.0-h-tiny config.json
    "granitemoehybrid": ("GraniteMoeHybridConfig", dict(
        vocab_size=100352, hidden_size=1536, intermediate_size=512,
        shared_intermediate_size=1024, num_hidden_layers=40,
        num_attention_heads=12, num_key_value_heads=4,
        num_local_experts=64, num_experts_per_tok=6, mamba_n_heads=48,
        mamba_d_head=64, mamba_d_state=128, mamba_n_groups=1,
        mamba_d_conv=4, mamba_expand=2, position_embedding_type="nope",
        embedding_multiplier=12.0, residual_multiplier=0.22,
        attention_multiplier=0.0078125, logits_scaling=6.0,
        rms_norm_eps=1e-5, tie_word_embeddings=True,
        layer_types=["attention" if i in (5, 15, 25, 35) else "mamba"
                     for i in range(40)]), 2, "Granite-4.0-H-Tiny"),
    # https://huggingface.co/Zyphra/Zamba2-1.2B config.json
    "zamba2": ("Zamba2Config", dict(
        vocab_size=32000, hidden_size=2048, num_hidden_layers=38,
        num_attention_heads=32, num_key_value_heads=32,
        intermediate_size=8192, mamba_d_state=128, mamba_d_conv=4,
        mamba_expand=2, mamba_ngroups=1, n_mamba_heads=64,
        num_mem_blocks=1, use_shared_attention_adapter=True,
        adapter_rank=128, use_mem_rope=True,
        layers_block_type=["hybrid" if i % 6 == 5 else "mamba"
                           for i in range(38)]), 2, "Zamba2-1.2B"),
    # https://huggingface.co/ai21labs/Jamba-v0.1 config.json
    "jamba": ("JambaConfig", dict(
        vocab_size=65536, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        num_experts=16, num_experts_per_tok=2, attn_layer_period=8,
        attn_layer_offset=4, expert_layer_period=2, expert_layer_offset=1,
        mamba_d_state=16, mamba_d_conv=4, mamba_expand=2, mamba_dt_rank=256,
        use_mamba_kernels=False, rms_norm_eps=1e-6,
        tie_word_embeddings=False), 8, "Jamba-v0.1"),
    # https://huggingface.co/LiquidAI/LFM2-1.2B config.json
    "lfm2": ("Lfm2Config", dict(
        vocab_size=65536, hidden_size=2048, num_hidden_layers=16,
        num_attention_heads=32, num_key_value_heads=8, conv_L_cache=3,
        block_ff_dim=12288, block_auto_adjust_ff_dim=True,
        block_ffn_dim_multiplier=1.0, block_multiple_of=256, norm_eps=1e-5,
        rope_theta=1000000.0, max_position_embeddings=128000,
        layer_types=["full_attention" if i in (2, 5, 8, 10, 12, 14)
                     else "conv" for i in range(16)]), 3, "LFM2-1.2B"),
    # https://huggingface.co/Qwen/Qwen3-Next-80B-A3B-Instruct config.json
    # (transformers' Qwen3NextConfig defaults are this model's)
    "qwen3_next": ("Qwen3NextConfig", dict(
        vocab_size=151936, hidden_size=2048, num_hidden_layers=48,
        num_attention_heads=16, num_key_value_heads=2, head_dim=256,
        linear_num_value_heads=32, linear_num_key_heads=16,
        linear_key_head_dim=128, linear_value_head_dim=128,
        linear_conv_kernel_dim=4, num_experts=512, num_experts_per_tok=10,
        moe_intermediate_size=512, shared_expert_intermediate_size=512,
        partial_rotary_factor=0.25, rope_theta=10000000.0,
        rms_norm_eps=1e-6, tie_word_embeddings=False,
        layer_types=["full_attention" if i % 4 == 3 else "linear_attention"
                     for i in range(48)]), 4, "Qwen3-Next-80B-A3B"),
    # https://huggingface.co/MiniMaxAI/MiniMax-Text-01-hf config.json
    # (its first linear and first full attention layer)
    "minimax": ("MiniMaxConfig", dict(
        vocab_size=200064, hidden_size=6144, num_hidden_layers=80,
        num_attention_heads=64, num_key_value_heads=8, head_dim=128,
        intermediate_size=9216, num_local_experts=32, num_experts_per_tok=2,
        rope_theta=10000000.0, rms_norm_eps=1e-5,
        full_attn_alpha_factor=3.5565588200778455, full_attn_beta_factor=1.0,
        linear_attn_alpha_factor=3.5565588200778455,
        linear_attn_beta_factor=1.0, mlp_alpha_factor=3.5565588200778455,
        mlp_beta_factor=1.0, tie_word_embeddings=False,
        layer_types=["full_attention" if i % 8 == 7 else "linear_attention"
                     for i in range(80)]), 2, "MiniMax-Text-01"),
}


def _layer_kinds(kinds: list, n: int) -> list:
    """The first ``n`` layers of ``kinds``, the last of them replaced by
    the first layer of another kind where those leave one out (a cut
    that keeps every kind of layer)."""
    out = list(kinds[:n])
    for k in dict.fromkeys(kinds):
        if k not in out:
            out[-1] = k
    return out


def recurrent_family_config(name: str, layers: Optional[int] = None):
    """The config of ``RECURRENT_FAMILIES[name]`` at ``layers`` layers
    (default the table's), its per-layer lists cut to keep every kind."""
    cls, fields, run_layers, _ = RECURRENT_FAMILIES[name]
    L = layers or run_layers
    fields = dict(fields, num_hidden_layers=L)
    for key in ("layer_types", "layers_block_type"):
        if key in fields:
            fields[key] = _layer_kinds(fields[key], L)
    return _config(cls, name, fields)


def bamba_9b_config(layers: Optional[int] = None, kinds=None):
    """Bamba-9B's published config (``BAMBA_9B``) at ``layers`` layers
    (default all 32); ``kinds`` ("mamba" / "attention" per layer) replaces
    its attention indices."""
    fields = dict(BAMBA_9B)
    if layers:
        fields["num_hidden_layers"] = layers
        fields["attn_layer_indices"] = [
            i for i in fields["attn_layer_indices"] if i < layers]
    if kinds is not None:
        fields["num_hidden_layers"] = len(kinds)
        fields["attn_layer_indices"] = [i for i, k in enumerate(kinds)
                                        if k == "attention"]
    return _config("BambaConfig", "bamba", fields)


def _config(cls_name: str, model_type: str, fields: dict):
    """``transformers``' config class ``cls_name`` of ``fields``, or, where
    the installed version lacks it, a ``PretrainedConfig`` carrying the
    same fields and ``model_type`` (the port reads attributes only)."""
    import transformers
    cls = getattr(transformers, cls_name, None)
    if cls is not None:
        return cls(**fields)
    cfg = transformers.PretrainedConfig(**fields)
    cfg.model_type = model_type
    return cfg


def deepseek_v2_lite_config(layers: Optional[int] = None):
    """DeepSeek-V2-Lite's published config (``DEEPSEEK_V2_LITE``) at
    ``layers`` layers (default all 27)."""
    fields = dict(DEEPSEEK_V2_LITE)
    if layers:
        fields["num_hidden_layers"] = layers
    return _config("DeepseekV2Config", "deepseek_v2", fields)


def deepseek_v3_config(layers: Optional[int] = None):
    """DeepSeek-V3's published config (``DEEPSEEK_V3``) at ``layers``
    layers (default 4)."""
    fields = dict(DEEPSEEK_V3)
    if layers:
        fields["num_hidden_layers"] = layers
    return _config("DeepseekV3Config", "deepseek_v3", fields)


def longcat_flash_config(pairs: Optional[int] = None):
    """LongCat-Flash's published config (``LONGCAT_FLASH``) at ``pairs``
    pairs (default 1); two pool layers a pair."""
    fields = dict(LONGCAT_FLASH)
    if pairs:
        fields["num_layers"] = pairs
    fields["num_hidden_layers"] = 2 * fields["num_layers"]
    return _config("LongcatFlashConfig", "longcat_flash", fields)


def mtp_head_checkpoint(cfg, device="cuda", seed: int = 11):
    """The MTP module of a DeepSeek config as a seeded ``RandomCheckpoint``
    on ``device`` (bf16, drawn when the loader reads each tensor): at
    DeepSeek-V3's width the JAX package's numpy draws (``speculative.mtp.
    synth_state_dict``) would take minutes on the host."""
    from tensorrt_llm_tpu_torch.models import ModelConfig, get_model_class
    from tensorrt_llm_tpu_torch.models.recurrent import RandomCheckpoint
    from tensorrt_llm_tpu_torch.speculative.mtp import synth_shapes
    m = get_model_class(cfg.model_type)(ModelConfig(
        hf_config=cfg, dtype=torch.bfloat16, device=device))
    return RandomCheckpoint(synth_shapes(m, m.num_layers), device,
                            torch.bfloat16, seed)


def moe_family_config(name: str, layers: Optional[int] = None):
    """The config of ``MOE_FAMILIES[name]`` at ``layers`` layers (default
    the table's): per-layer lists cut to that depth, DeepSeek-V3's dense
    layers cut to one and ERNIE's MoE layers ending at the last layer."""
    cls, fields, run_layers, _ = MOE_FAMILIES[name]
    L = layers or run_layers
    fields = dict(fields, num_hidden_layers=L)
    for key in ("moe_intermediate_size", "moe_topk", "num_shared_expert"):
        if isinstance(fields.get(key), list):
            fields[key] = fields[key][:L]
    if name == "deepseek_v3":
        fields["first_k_dense_replace"] = 1
    if name == "ernie4_5_moe":
        fields["moe_layer_end_index"] = L - 1
    return _config(cls, name, fields)


def gpt_oss_20b_config(layers: Optional[int] = None):
    """gpt-oss-20b's published config (``GPT_OSS_20B``) at ``layers``
    layers (default all 24)."""
    import transformers
    fields = dict(GPT_OSS_20B)
    if layers:
        fields.update(num_hidden_layers=layers,
                      layer_types=fields["layer_types"][:layers])
    return transformers.GptOssConfig(**fields)


def family_config(name: str, layers: Optional[int] = None):
    """The ``transformers`` config of family ``name`` at its source's
    widths and ``layers`` layers (default: the table's run depth)."""
    import transformers
    cls, fields, run_layers, _ = {**FAMILIES, **GPT_FAMILIES}[name]
    fields = dict(fields, num_hidden_layers=layers or run_layers)
    for key in ("n_layer", "n_layers"):        # the GPT configs' own name
        if key in fields:
            fields[key] = fields.pop("num_hidden_layers")
    if name == "smollm3":
        n = fields["num_hidden_layers"]
        fields["no_rope_layers"] = [int((i + 1) % 4 != 0) for i in range(n)]
    if name == "exaone4":
        n = fields["num_hidden_layers"]
        fields["layer_types"] = ["full_attention" if (i + 1) % 4 == 0
                                 else "sliding_attention" for i in range(n)]
    return getattr(transformers, cls)(**fields)


def family_workload(name: str):
    """(config, LLM keyword arguments, prompts, SamplingParams) of
    ``--family``: 16 requests of 256 seeded tokens -> 32."""
    from tensorrt_llm_tpu_torch import KvCacheConfig, SamplingParams
    cfg = moe_family_config(name) if name in MOE_FAMILIES \
        else recurrent_family_config(name) if name in RECURRENT_FAMILIES \
        else family_config(name)
    gen = torch.Generator().manual_seed(0)
    prompts = torch.randint(3, cfg.vocab_size - 1, (16, 256),
                            generator=gen).tolist()
    kwargs = dict(max_batch_size=16, max_input_len=256, max_seq_len=512,
                  kv_cache_config=KvCacheConfig(enable_block_reuse=False))
    return cfg, kwargs, prompts, SamplingParams(
        max_tokens=32, top_k=1, ignore_eos=True, logprobs=0)


def inline_module(cfg, device="cuda"):
    """A ``transformers`` causal LM of ``cfg`` built on ``device`` in bf16
    with its own initialisation under torch seed 0 (the ``--inline``
    model)."""
    import transformers
    torch.manual_seed(0)
    with torch.device(device):
        model = transformers.AutoModelForCausalLM.from_config(cfg)
    return model.to(torch.bfloat16).eval()
# https://huggingface.co/google/gemma-3-1b-pt/blob/main/config.json
GEMMA3_1B = dict(
    vocab_size=262144, hidden_size=1152, intermediate_size=6912,
    num_hidden_layers=26, num_attention_heads=4, num_key_value_heads=1,
    head_dim=256, query_pre_attn_scalar=256, sliding_window=512,
    sliding_window_pattern=6, max_position_embeddings=32768,
    rms_norm_eps=1e-6, rope_theta=1e6, rope_local_base_freq=10000.0,
    rope_scaling=None, attn_logit_softcapping=None,
    final_logit_softcapping=None, hidden_activation="gelu_pytorch_tanh",
    bos_token_id=2, eos_token_id=1, pad_token_id=0)


# https://huggingface.co/llava-hf/llava-1.5-7b-hf config.json: CLIP
# ViT-L/14 at 336 px (24 layers, 1,024 wide, 16 heads, quick GELU),
# features from layer -2 without the class token (576 a 336 x 336 image),
# a 1,024 -> 4,096 -> 4,096 GELU projector, and Vicuna-7B-v1.5 (the Llama
# defaults: 32 layers, 4,096 wide, 32 heads without GQA, MLP 11,008, rope
# theta 10,000) over a vocabulary of 32,064 with the image token 32,000
LLAVA_15_7B = dict(
    image_token_index=32000, pad_token_id=32001, projector_hidden_act="gelu",
    tie_word_embeddings=False, vision_feature_layer=-2,
    vision_feature_select_strategy="default", vocab_size=32064)
LLAVA_15_7B_VISION = dict(
    hidden_size=1024, image_size=336, intermediate_size=4096,
    num_attention_heads=16, num_hidden_layers=24, patch_size=14,
    projection_dim=768, vocab_size=32000)
LLAVA_15_7B_TEXT = dict(
    vocab_size=32064, hidden_size=4096, intermediate_size=11008,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
    max_position_embeddings=4096, rms_norm_eps=1e-5, rope_theta=10000.0,
    tie_word_embeddings=False)
# https://huggingface.co/google-bert/bert-large-uncased config.json, with
# one label: a cross-encoder reranker's score head
BERT_LARGE = dict(
    vocab_size=30522, hidden_size=1024, num_hidden_layers=24,
    num_attention_heads=16, intermediate_size=4096, hidden_act="gelu",
    max_position_embeddings=512, type_vocab_size=2, layer_norm_eps=1e-12,
    pad_token_id=0, num_labels=1)


def llava_15_7b_config(text_layers: Optional[int] = None):
    """LLaVA-1.5-7B's published config (``LLAVA_15_7B``) with its text
    model cut to ``text_layers`` layers (default all 32; the tower and
    the projector stay whole)."""
    import transformers
    text = dict(LLAVA_15_7B_TEXT)
    if text_layers:
        text["num_hidden_layers"] = text_layers
    return transformers.LlavaConfig(
        vision_config=transformers.CLIPVisionConfig(**LLAVA_15_7B_VISION),
        text_config=transformers.LlamaConfig(**text), **LLAVA_15_7B)


def llava_prompts(n: int, text_tokens: int, seed: int = 0,
                  distinct_images: bool = True, device="cuda"):
    """``n`` LLaVA-1.5-7B prompts: one image placeholder (576 tokens once
    expanded) and ``text_tokens`` seeded random text ids, each with a
    336 x 336 image of seeded normal pixels drawn on ``device``
    (``distinct_images`` False: every prompt the same image)."""
    gen = torch.Generator().manual_seed(seed)
    text = torch.randint(3, LLAVA_15_7B["image_token_index"],
                         (n, text_tokens), generator=gen).tolist()
    dgen = torch.Generator(device=device)
    dgen.manual_seed(seed)
    images = [torch.randn((3, 336, 336), generator=dgen, device=device)
              for _ in range(n if distinct_images else 1)]
    return [{"prompt_token_ids": [LLAVA_15_7B["image_token_index"]] + t,
             "multi_modal_data": {"image": [images[i % len(images)]]}}
            for i, t in enumerate(text)]


def bert_large_config():
    import transformers
    return transformers.BertConfig(**BERT_LARGE)


def bert_pairs(n: int = 128, lo: int = 200, hi: int = 512, seed: int = 0):
    """``n`` query-passage pairs of ``lo`` to ``hi`` tokens in all
    ([CLS] query [SEP] passage [SEP], a query of 16-32 tokens): (token ids,
    token types), seeded."""
    gen = torch.Generator().manual_seed(seed)
    ids, types = [], []
    for _ in range(n):
        total = int(torch.randint(lo, hi + 1, (1,), generator=gen))
        q = int(torch.randint(16, 33, (1,), generator=gen))
        p = total - q - 3
        words = torch.randint(1000, BERT_LARGE["vocab_size"], (q + p,),
                              generator=gen).tolist()
        ids.append([101] + words[:q] + [102] + words[q:] + [102])
        types.append([0] * (q + 2) + [1] * (p + 1))
    return ids, types


def qwen3_30b_a3b_config():
    """Qwen3-30B-A3B's published config: ``transformers``'
    ``Qwen3MoeConfig`` where it has one, else a ``PretrainedConfig``
    carrying the same fields (the port reads attributes only)."""
    import transformers
    fields = {k: v for k, v in QWEN3_30B_A3B.items()
              if k not in ("model_type", "architectures")}
    cls = getattr(transformers, "Qwen3MoeConfig", None)
    if cls is not None:
        return cls(architectures=QWEN3_30B_A3B["architectures"], **fields)
    return transformers.PretrainedConfig(**QWEN3_30B_A3B)


def workload(bench_settings: bool = False, geometry: str = "tinyllama",
             vswa: bool = False):
    """(config, LLM keyword arguments, prompts, SamplingParams)."""
    from transformers import LlamaConfig

    from tensorrt_llm_tpu_torch import KvCacheConfig, SamplingParams
    gen = torch.Generator().manual_seed(0)
    if geometry == "llama3-8b-copy":
        seg = torch.randint(0, LLAMA3_8B["vocab_size"], (32, 128),
                            generator=gen)
        prompts = seg.repeat(1, 4).tolist()
        kwargs = dict(kv_cache_config=KvCacheConfig(enable_block_reuse=False))
        return (LlamaConfig(**LLAMA3_8B), kwargs, prompts,
                SamplingParams(max_tokens=128, top_k=1, ignore_eos=True))
    if geometry == "llama3-8b-quant":
        prompts = torch.randint(0, LLAMA3_8B["vocab_size"], (64, 512),
                                generator=gen).tolist()
        kwargs = dict(kv_cache_config=KvCacheConfig(enable_block_reuse=False))
        return (LlamaConfig(**LLAMA3_8B), kwargs, prompts,
                SamplingParams(max_tokens=128, top_k=1, ignore_eos=True))
    if geometry == "llama3-8b":
        prompts = torch.randint(0, LLAMA3_8B["vocab_size"], (64, 2048),
                                generator=gen).tolist()
        kwargs = dict(kv_cache_config=KvCacheConfig(enable_block_reuse=False))
        return (LlamaConfig(**LLAMA3_8B), kwargs, prompts,
                SamplingParams(max_tokens=128, top_k=1, ignore_eos=True))
    if geometry == "gemma2-9b":
        from transformers import Gemma2Config
        prompts = torch.randint(3, GEMMA2_9B["vocab_size"], (16, 6144),
                                generator=gen).tolist()
        # prefix reuse off in both runs (VSWA has none): every pass
        # prefills its prompts afresh
        kv = dict(max_attention_window=[4096, 8192]) if vswa else {}
        kwargs = dict(max_batch_size=16, max_input_len=6144,
                      max_seq_len=8192, max_num_tokens=6144,
                      kv_cache_config=KvCacheConfig(enable_block_reuse=False,
                                                    **kv))
        return (Gemma2Config(**GEMMA2_9B), kwargs, prompts,
                SamplingParams(max_tokens=64, top_k=1, ignore_eos=True))
    if geometry == "gemma3-1b":
        from transformers import Gemma3TextConfig
        prompts = torch.randint(3, GEMMA3_1B["vocab_size"], (32, 1024),
                                generator=gen).tolist()
        kwargs = dict(max_batch_size=32, max_input_len=1024,
                      max_seq_len=1024 + 128,
                      kv_cache_config=KvCacheConfig(enable_block_reuse=False))
        return (Gemma3TextConfig(**GEMMA3_1B), kwargs, prompts,
                SamplingParams(max_tokens=64, top_k=1, ignore_eos=True))
    if geometry == "gpt-oss-20b":
        prompts = torch.randint(0, GPT_OSS_20B["vocab_size"], (64, 512),
                                generator=gen).tolist()
        kwargs = dict(max_batch_size=64, max_input_len=512, max_seq_len=640,
                      max_num_tokens=8192,
                      kv_cache_config=KvCacheConfig(enable_block_reuse=False))
        return (gpt_oss_20b_config(), kwargs, prompts,
                SamplingParams(max_tokens=128, top_k=1, ignore_eos=True))
    if geometry == "bamba-9b":
        prompts = torch.randint(0, BAMBA_9B["vocab_size"], (64, 512),
                                generator=gen).tolist()
        kwargs = dict(max_batch_size=64, max_input_len=512, max_seq_len=640,
                      max_num_tokens=8192,
                      kv_cache_config=KvCacheConfig(enable_block_reuse=False))
        return (bamba_9b_config(), kwargs, prompts,
                SamplingParams(max_tokens=128, top_k=1, ignore_eos=True))
    if geometry in ("deepseek-v3-mtp", "longcat-flash"):
        cfg = deepseek_v3_config() if geometry == "deepseek-v3-mtp" \
            else longcat_flash_config()
        prompts = torch.randint(0, cfg.vocab_size, (64, 512),
                                generator=gen).tolist()
        kwargs = dict(max_batch_size=64, max_input_len=512, max_seq_len=640,
                      max_num_tokens=8192,
                      kv_cache_config=KvCacheConfig(enable_block_reuse=False))
        return (cfg, kwargs, prompts,
                SamplingParams(max_tokens=128, top_k=1, ignore_eos=True))
    if geometry == "deepseek-v2-lite":
        prompts = torch.randint(0, DEEPSEEK_V2_LITE["vocab_size"], (64, 512),
                                generator=gen).tolist()
        kwargs = dict(max_batch_size=64, max_input_len=512, max_seq_len=640,
                      max_num_tokens=8192,
                      kv_cache_config=KvCacheConfig(enable_block_reuse=False))
        return (deepseek_v2_lite_config(), kwargs, prompts,
                SamplingParams(max_tokens=128, top_k=1, ignore_eos=True))
    if geometry == "llava-1.5-7b":
        # one image (576 tokens) + 64 text tokens -> 128; prefix reuse off
        # (each pass prefills afresh)
        kwargs = dict(max_batch_size=64, max_input_len=640, max_seq_len=768,
                      max_num_tokens=8192,
                      kv_cache_config=KvCacheConfig(enable_block_reuse=False))
        return (llava_15_7b_config(), kwargs, llava_prompts(64, 64),
                SamplingParams(max_tokens=128, top_k=1, ignore_eos=True))
    if geometry == "qwen3-30b-a3b":
        prompts = torch.randint(0, QWEN3_30B_A3B["vocab_size"], (64, 128),
                                generator=gen).tolist()
        return (qwen3_30b_a3b_config(), {}, prompts,
                SamplingParams(max_tokens=64, top_k=1, ignore_eos=True))
    if not bench_settings:
        prompts = torch.randint(0, 32000, (16, 128), generator=gen).tolist()
        return (LlamaConfig(**TINYLLAMA), {}, prompts,
                SamplingParams(max_tokens=64, top_k=1))
    isl = osl = 128
    batch = 256
    prompts = torch.randint(1, 32000 - 1, (2 * batch, isl),
                            generator=gen).tolist()
    kwargs = dict(max_batch_size=batch, max_input_len=isl + 8,
                  max_seq_len=isl + osl + 8, max_num_tokens=isl * batch // 2,
                  decode_multi_step=16, max_inflight_steps=3,
                  mixed_window_ctx=512, decode_wait_occupancy=1.0,
                  kv_cache_config=KvCacheConfig(tokens_per_block=32))
    return (LlamaConfig(**BENCH_1B), kwargs, prompts,
            SamplingParams(max_tokens=osl, top_k=1, ignore_eos=True))


def _class(name: str, moe: bool = False, mla: bool = False) -> str:
    """The GPU-time class of kernel ``name``. The MoE classes are kept for
    a MoE model (``moe``): elsewhere a sort or top-k is the sampler's.
    With MLA (``mla``, models/deepseek.py) the float32 products are its
    einsums (the float32 router products are bf16 inputs)."""
    if any(k in name for k in _DECODE):
        return "decode_attention"
    if any(k in name for k in _PREFILL):
        return "prefill_attention"
    if "quant_matmul_kernel" in name:
        return "quant_matmul"
    low = name.lower()
    if "int8" in low or "imma" in low or "tensorop_i" in low:
        return "int8_gemm"
    if moe and any(k in low for k in ("grouped", "ptrarray", "groupproblem")):
        return "moe_grouped_gemm"
    if moe and ("topk" in low or "sort" in low):
        return "moe_routing_sort"
    if mla and any(k in low for k in ("sgemm", "f32f32", "simt", "gemv")):
        return "mla_einsum"
    if any(k in low for k in ("gemm", "cutlass", "xmma", "nvjet")):
        return "gemm"
    return "other"


def kernel_modules() -> dict:
    """Each kernel's wrapper module (its ``LAUNCHES``), by kernel name."""
    from tensorrt_llm_tpu_torch.ops.cuda import decode_attention as dec
    from tensorrt_llm_tpu_torch.ops.cuda import prefill_attention as pre
    from tensorrt_llm_tpu_torch.ops.cuda import quant_matmul as qmm
    return {"paged_decode_attention": dec, "ragged_prefill_attention": pre,
            "groupwise_dequant_matmul": qmm}


def spec_config(mode: str, draft_len: int, cfg=None,
                device_window: bool = True):
    """The ``SpeculativeConfig`` of ``--spec``: EAGLE3 with a seeded
    random head; MTP with the seeded random module of the target config
    ``cfg`` (``mtp_head_checkpoint``), in the window or (``device_window``
    False) on the host path; the host drafters, DRAFT_TARGET / PARD
    drafting with Llama-3.2-1B's published config (seeded random weights;
    PARD's mask token 0)."""
    from transformers import LlamaConfig

    from tensorrt_llm_tpu_torch import SpeculativeConfig
    kw = dict(device_window=device_window)
    if mode == "MTP":
        kw["draft_model"] = mtp_head_checkpoint(cfg)
    if mode in ("DRAFT_TARGET", "PARD"):
        kw["draft_model"] = LlamaConfig(**LLAMA32_1B)
    if mode == "PARD":
        kw["pard_mask_token_id"] = 0
    return SpeculativeConfig(mode=mode, max_draft_len=draft_len, **kw)


class DraftTimer:
    """Wraps a host drafter's ``prepare_draft_tokens``: device time of
    each call (CUDA events around it; the call ends in a host sync, so
    the span holds its work) and the kernels' launches made inside it."""

    def __init__(self, drafter, kernels: dict):
        self.drafter, self.kernels = drafter, kernels
        self.orig = drafter.prepare_draft_tokens
        self.events = []
        self.launches = {k: 0 for k in kernels}
        drafter.prepare_draft_tokens = self

    def __call__(self, requests):
        before = {k: m.LAUNCHES for k, m in self.kernels.items()}
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        self.orig(requests)
        e1.record()
        self.events.append((e0, e1))
        for k, m in self.kernels.items():
            self.launches[k] += m.LAUNCHES - before[k]

    def close(self) -> dict:
        self.drafter.prepare_draft_tokens = self.orig
        torch.cuda.synchronize()
        return dict(drafter_calls=len(self.events),
                    drafter_ms=sum(a.elapsed_time(b) for a, b in self.events),
                    launches_drafter=dict(self.launches))


def host_spec_counts(llm):
    """The host drafting counters (None without a host drafter);
    ``measure`` reports their change over the timed pass."""
    ex, eng = llm.executor, llm.engine
    if ex.host_drafter is None:
        return None
    return dict(rows=ex.drafted_rows, proposed=ex.drafts_proposed,
                accepted=ex.drafts_accepted, verify=eng.verify_steps,
                verify_prompt=eng.verify_steps_with_prompt,
                verify_replays=sum(
                    st.replays for k, st in eng.graphs.steps.items()
                    if k[0] == "verify" and st.graph is not None))


def host_spec_summary(c: dict) -> dict:
    """Host drafting counters ``c`` (of ``host_spec_counts``, or their
    change over a pass) by name, with the derived shares: verify steps
    without prompt tokens that no graph replayed ran eagerly."""
    return dict(
        drafted_rows=c["rows"], drafts_proposed=c["proposed"],
        drafts_accepted=c["accepted"], verify_steps=c["verify"],
        accepted_per_verify_step=c["accepted"] / max(1, c["verify"]),
        accepted_per_drafted_row=c["accepted"] / max(1, c["rows"]),
        verify_steps_replayed=c["verify_replays"],
        verify_steps_eager_with_prompt=c["verify_prompt"],
        verify_steps_eager_without_prompt=c["verify"] - c["verify_prompt"]
        - c["verify_replays"])


def _mla_module(llm):
    """models/deepseek.py (its MLA path counters) when ``llm`` serves
    MLA, else None."""
    if not hasattr(llm.engine.model, "kv_lora_rank"):
        return None
    from tensorrt_llm_tpu_torch.models import deepseek
    return deepseek


def mla_graph_calls(eng) -> dict:
    """MLA layer calls made by CUDA graph replays, by graph kind ("multi"
    windows without riders, "multi_riders", "step", "verify") and path:
    {kind: {"replays", "absorbed", "decompressed"}}."""
    from tensorrt_llm_tpu_torch.models import deepseek
    out: dict = {}
    for key, st in eng.graphs.steps.items():
        kind = key[0] + ("_riders" if key[0] == "multi" and key[3] else "")
        d = out.setdefault(kind, dict(replays=0, absorbed=0,
                                      decompressed=0))
        d["replays"] += st.replays
        for (mod, counter), n in st.launches.items():
            if mod == deepseek.__name__:
                path = "absorbed" if counter == "MLA_ABSORBED" \
                    else "decompressed"
                d[path] += n * st.replays
    return out


def _generate(llm, prompts, sp):
    """All requests submitted at once (``sp``: one SamplingParams, or
    one per prompt); (wall seconds, outputs)."""
    sps = sp if isinstance(sp, list) else [sp] * len(prompts)
    t0 = time.monotonic()
    futs = [llm.generate_async(p, s) for p, s in zip(prompts, sps)]
    outs = [f.result() for f in futs]
    torch.cuda.synchronize()
    return time.monotonic() - t0, outs


def measure(llm, prompts, sp, profile: bool = True,
            outputs: Optional[list] = None) -> dict:
    """Warm-up pass, timed pass, then (``profile``) a profiled pass of
    the same requests through ``llm``. The kernels' launch counters are
    zeroed right before the timed pass and read right after it. The timed
    pass's ``RequestOutput``s are appended to ``outputs``."""
    kernels = kernel_modules()
    _generate(llm, prompts, sp)
    eng = llm.engine
    replays0 = eng.graphs.replays
    steps0 = (eng.decode_steps, eng.window_steps, eng.dead_window_steps)
    spec0 = _spec_counts(llm)
    host0 = host_spec_counts(llm)
    timer = None if host0 is None else \
        DraftTimer(llm.executor.host_drafter, kernels)
    blocks0 = llm.kv_cache_manager.get_stats().alloc_total_blocks
    qmm = kernels["groupwise_dequant_matmul"]
    attn = [kernels["paged_decode_attention"],
            kernels["ragged_prefill_attention"]]
    for mod in kernels.values():
        mod.LAUNCHES = 0
    qmm.LAUNCHES_E4M3 = 0
    for mod in attn:
        mod.LAUNCHES_SINKS = mod.LAUNCHES_ALIBI = 0
    mla = _mla_module(llm)
    if mla is not None:
        mla.MLA_ABSORBED = mla.MLA_DECOMPRESSED = 0
    try:
        wall, outs = _generate(llm, prompts, sp)
    finally:
        drafting = timer.close() if timer is not None else None
    if outputs is not None:
        outputs.extend(outs)
    launches = {k: mod.LAUNCHES for k, mod in kernels.items()}
    launches_e4m3 = qmm.LAUNCHES_E4M3
    launches_sinks = {k: kernels[k].LAUNCHES_SINKS for k in
                      ("paged_decode_attention", "ragged_prefill_attention")}
    launches_alibi = {k: kernels[k].LAUNCHES_ALIBI for k in
                      ("paged_decode_attention", "ragged_prefill_attention")}
    spec1 = _spec_counts(llm)
    blocks = llm.kv_cache_manager.get_stats().alloc_total_blocks - blocks0
    steps = max(1, eng.decode_steps - steps0[0])
    perf = [o._result.request.perf for o in outs]
    n_out = [len(o.outputs[0].token_ids) for o in outs]
    ttft = [p.first_token_time - p.arrival_time for p in perf]
    tpot = [(p.last_token_time - p.first_token_time) / max(1, n - 1)
            for p, n in zip(perf, n_out)]
    # the chosen tokens' log-probabilities, which every step records
    lps = [v for o in outs for d in (o.outputs[0].logprobs or [])
           for v in d.values()]
    res = dict(
        device=torch.cuda.get_device_name(0),
        nvidia_smi=subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(),
        requests=len(prompts), output_tokens=sum(n_out),
        wall_ms=wall * 1e3, output_tok_per_s=sum(n_out) / wall,
        ttft_ms_median=statistics.median(ttft) * 1e3,
        ttft_ms_max=max(ttft) * 1e3,
        tpot_ms_median=statistics.median(tpot) * 1e3,
        tpot_ms_max=max(tpot) * 1e3,
        min_output_tokens=min(n_out),
        logprobs_recorded=len(lps),
        nonfinite_logprobs=sum(not math.isfinite(v) for v in lps),
        decode_steps=steps, launches=launches, launches_e4m3=launches_e4m3,
        launches_sinks=launches_sinks, launches_alibi=launches_alibi,
        graphs_captured=eng.graphs.num_graphs,
        graph_replays=eng.graphs.replays - replays0,
        window_steps=eng.window_steps - steps0[1],
        dead_window_steps=eng.dead_window_steps - steps0[2],
        mixed_windows_dispatched=eng.mixed_windows_dispatched,
        mixed_ctx_carved=eng.mixed_ctx_carved,
        kv_blocks_allocated=blocks)
    res["dead_step_share"] = res["dead_window_steps"] / max(
        1, res["window_steps"])
    if mla is not None:
        res["mla_calls"] = dict(absorbed=mla.MLA_ABSORBED,
                                decompressed=mla.MLA_DECOMPRESSED)
    if spec0 is not None:
        d = {k: spec1[k] - spec0[k] for k in spec0}
        res.update(spec_windows=d["windows"], spec_iters=d["iters"],
                   spec_dead_iters=d["dead_iters"],
                   spec_idle_iters=d["idle_iters"],
                   spec_mean_accepted=d["accepted"] / max(1, d["steps"]),
                   nonspec_decode_rows=d["nonspec_rows"])
    if host0 is not None:
        res.update(host_spec_summary(
            {k: v - host0[k] for k, v in host_spec_counts(llm).items()}),
            launches_target={k: v - drafting["launches_drafter"][k]
                             for k, v in launches.items()}, **drafting)
    if profile:
        res.update(_profiled(llm, prompts, sp, wall))
    return res


class BanTokens:
    """A numpy logits processor (one-argument form) that bans a token
    set: its logits become -inf."""

    def __init__(self, ids):
        self.ids = np.asarray(sorted(ids), np.int64)

    def __call__(self, logits):
        logits[self.ids] = -np.inf
        return logits


def surface_workload():
    """``chip_smoke.py``'s surface_serving traffic: Llama-3-8B (``LLAMA3_8B``,
    seeded random weights) behind one ``LLM`` with ``max_beam_width=4``
    (which implies the sync scheduler) and prefix reuse on, serving one
    mixed OpenAI-style batch. Returns (config, LLM keyword arguments,
    prompts, a SamplingParams per prompt, a class name per prompt, and
    the bad-word ids and the processor's banned ids). The classes:

    - ``sampled_n4``: 16 prompts of 512 tokens -> 128, temperature 0.8,
      top_p 0.95, seeded, n = 4;
    - ``ngram_bias_bad``: 8 x 512 -> 128 greedy with
      ``no_repeat_ngram_size=3``, a seeded [V] embedding bias and 16
      ``bad_token_ids``;
    - ``prompt_logprobs``: 4 x 512 -> 16 greedy, ``prompt_logprobs=5``;
    - ``beam``: 4 x 256 -> 64, beam search, ``best_of=4``, ``n=2``;
    - ``processor``: 4 x 512 -> 64 greedy with a numpy logits processor
      that bans 64 tokens (``BanTokens``).

    No class stops at an end id: the model has no tokenizer here."""
    from transformers import LlamaConfig

    from tensorrt_llm_tpu_torch import SamplingParams
    V = LLAMA3_8B["vocab_size"]
    gen = torch.Generator().manual_seed(0)

    def toks(n, length):
        return torch.randint(0, V, (n, length), generator=gen).tolist()
    bias = (torch.randn(V, generator=gen) * 2.0).numpy()
    bad = torch.randint(0, V, (16,), generator=gen).tolist()
    banned = sorted(set(torch.randint(0, V, (64,), generator=gen).tolist()))
    prompts, sps, classes = [], [], []

    def add(name, ps, make):
        for i, p in enumerate(ps):
            prompts.append(p)
            sps.append(make(i))
            classes.append(name)
    add("sampled_n4", toks(16, 512), lambda i: SamplingParams(
        max_tokens=128, temperature=0.8, top_p=0.95, seed=1000 + i, n=4))
    add("ngram_bias_bad", toks(8, 512), lambda i: SamplingParams(
        max_tokens=128, top_k=1, no_repeat_ngram_size=3,
        embedding_bias=bias, bad_token_ids=bad))
    add("prompt_logprobs", toks(4, 512), lambda i: SamplingParams(
        max_tokens=16, top_k=1, prompt_logprobs=5))
    add("beam", toks(4, 256), lambda i: SamplingParams(
        max_tokens=64, use_beam_search=True, best_of=4, n=2))
    add("processor", toks(4, 512), lambda i: SamplingParams(
        max_tokens=64, top_k=1, logits_processor=BanTokens(banned)))
    return (LlamaConfig(**LLAMA3_8B), dict(max_beam_width=4), prompts, sps,
            classes, dict(bad_token_ids=bad, banned=banned))


def surface_class_stats(outs, classes, wall: float) -> dict:
    """Per class of ``surface_workload``: requests, the tokens returned
    (every sample of n > 1, every hypothesis of a beam group), their rate
    over the pass's wall time, and TTFT and TPOT (median, max) over the
    class's engine requests (a beam group's from its rows' first and last
    token)."""
    per: dict = {}
    for o, c in zip(outs, classes):
        d = per.setdefault(c, dict(requests=0, tokens=0, ttft=[], tpot=[]))
        d["requests"] += 1
        d["tokens"] += sum(len(x.token_ids) for x in o.outputs)
        for r in [o._result] + list(o._extra):
            p = r.request.perf
            n = len(r.outputs[0].token_ids)
            d["ttft"].append((p.first_token_time - p.arrival_time) * 1e3)
            d["tpot"].append((p.last_token_time - p.first_token_time)
                             * 1e3 / max(1, n - 1))
    return {c: dict(requests=d["requests"], output_tokens=d["tokens"],
                    output_tok_per_s=d["tokens"] / wall,
                    ttft_ms_median=statistics.median(d["ttft"]),
                    ttft_ms_max=max(d["ttft"]),
                    tpot_ms_median=statistics.median(d["tpot"]),
                    tpot_ms_max=max(d["tpot"]))
            for c, d in per.items()}


def measure_surface(llm, prompts, sps, classes, profile: bool = True
                    ) -> dict:
    """Warm-up pass, timed pass (the kernels' launch counters zeroed right
    before it and read right after), then (``profile``) a profiled pass of
    the surface workload: per-class rates and latencies, and over the
    timed pass the graphs captured and replayed, window steps against
    single decode steps, the prompt-logprobs forwards and their mean
    wall time, beam forks and pages copied, prefix-reuse blocks, the
    device idle share (profiled pass) and peak allocated memory."""
    kernels = kernel_modules()
    _generate(llm, prompts, sps)
    eng, ex, kv = llm.engine, llm.executor, llm.kv_cache_manager
    c0 = dict(replays=eng.graphs.replays, decode=eng.decode_steps,
              window=eng.window_steps, plp=ex.prompt_logprob_forwards,
              plp_ms=ex.prompt_logprob_ms, forks=ex.beam_forks,
              pages=eng.pages_copied, reused=kv.get_stats().reused_blocks)
    torch.cuda.reset_peak_memory_stats()
    for mod in kernels.values():
        mod.LAUNCHES = 0
    wall, outs = _generate(llm, prompts, sps)
    launches = {k: mod.LAUNCHES for k, mod in kernels.items()}
    plp = ex.prompt_logprob_forwards - c0["plp"]
    res = dict(
        device=torch.cuda.get_device_name(0),
        nvidia_smi=subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(),
        requests=len(prompts), wall_ms=wall * 1e3,
        classes=surface_class_stats(outs, classes, wall),
        launches=launches, graphs_captured=eng.graphs.num_graphs,
        graph_replays=eng.graphs.replays - c0["replays"],
        window_steps=eng.window_steps - c0["window"],
        single_decode_steps=(eng.decode_steps - c0["decode"])
        - (eng.window_steps - c0["window"]),
        prompt_logprob_forwards=plp,
        prompt_logprob_ms_mean=(ex.prompt_logprob_ms - c0["plp_ms"])
        / max(1, plp),
        beam_forks=ex.beam_forks - c0["forks"],
        pages_copied=eng.pages_copied - c0["pages"],
        reused_blocks=kv.get_stats().reused_blocks - c0["reused"],
        peak_allocated_bytes=torch.cuda.max_memory_allocated())
    if profile:
        res.update(_profiled(llm, prompts, sps, wall))
    return res, outs


# guided_workload's grammars: an extraction / tool-call schema, a
# fixed-length ID, arithmetic with bounded recursion (the EBNF compiler
# expands it to a depth of 6), and a regex of 20,001 DFA states, more
# than the pool's 16,384 (json_object_regex() needs 10,976, more than
# the default 8,192, hence the larger pool)
GUIDED_SCHEMA = {
    "type": "object",
    "properties": {"name": {"type": "string"},
                   "age": {"type": "integer"},
                   "color": {"type": "string",
                             "enum": ["red", "green", "blue"]},
                   "ids": {"type": "array", "items": {"type": "integer"},
                           "maxItems": 8}},
    "required": ["name", "age", "color", "ids"]}
GUIDED_REGEX = r"\d{3}-\d{4}"
GUIDED_EBNF = """root ::= expr
expr ::= num | num op expr | "(" expr ")" | "(" expr ")" op expr
num ::= [0-9]+
op ::= [-+*/]
"""
GUIDED_OVERSIZE = "[0-9]{20000}"
GUIDED_POOL_STATES = 16384
GUIDED_ABORT_AT = 16


def guided_workload(backend: str = "dfa"):
    """``chip_smoke.py``'s guided_serving traffic: Llama-3-8B
    (``LLAMA3_8B``, seeded random weights) behind one ``LLM`` with
    ``guided_decoding_backend=backend``, ``guided_token_bytes="byte"``
    (token i < 256 is byte i, EOS is token 0, so a grammar ends only with
    ``end_id=0``), prefix reuse off, and otherwise ``LLM`` defaults (64
    rows; on ``dfa`` overlap depth 4 and K = 8). Returns (config, LLM
    keyword arguments, pool states for TLLM_TPU_GUIDED_POOL_STATES,
    prompts, a SamplingParams per prompt, a class name per prompt). The
    classes, 512 seeded random prompt tokens each:

    - ``json_schema``: 16 -> 128 greedy, ``GUIDED_SCHEMA`` (a string, an
      integer, an enum, an array of integers: what an extraction or a
      tool-call client sends);
    - ``regex``: 16 -> 128 greedy, ``GUIDED_REGEX`` (an ID, which ends on
      EOS);
    - ``ebnf``: 8 -> 128 greedy, ``GUIDED_EBNF`` (arithmetic);
    - ``json_object``: 8 -> 128 greedy, any JSON object;
    - ``unguided``: 16 -> 128 greedy;
    - ``aborted``: 8 -> 128 greedy, unguided, each aborted through
      ``LLM.abort_request`` once it has ``GUIDED_ABORT_AT`` tokens;
    - ``oversize``: 1 -> 128, ``GUIDED_OVERSIZE``, which cannot fit the
      pool: it must fail, naming the pool."""
    from transformers import LlamaConfig

    from tensorrt_llm_tpu_torch import (GuidedDecodingParams, KvCacheConfig,
                                        SamplingParams)
    V = LLAMA3_8B["vocab_size"]
    gen = torch.Generator().manual_seed(0)
    prompts, sps, classes = [], [], []

    def add(name, n, **kw):
        for p in torch.randint(0, V, (n, 512), generator=gen).tolist():
            prompts.append(p)
            classes.append(name)
            gd = GuidedDecodingParams(**kw) if kw else None
            sps.append(SamplingParams(max_tokens=128, top_k=1, end_id=0,
                                      ignore_eos=not kw,
                                      guided_decoding=gd))
    add("json_schema", 16, json=GUIDED_SCHEMA)
    add("regex", 16, regex=GUIDED_REGEX)
    add("ebnf", 8, grammar=GUIDED_EBNF)
    add("json_object", 8, json_object=True)
    add("unguided", 16)
    add("aborted", 8)
    add("oversize", 1, regex=GUIDED_OVERSIZE)
    kwargs = dict(guided_decoding_backend=backend, guided_token_bytes="byte",
                  kv_cache_config=KvCacheConfig(enable_block_reuse=False))
    return (LlamaConfig(**LLAMA3_8B), kwargs, GUIDED_POOL_STATES, prompts,
            sps, classes)


def _guided_pass(llm, prompts, sps, classes):
    """One pass of the guided workload: every request submitted at once,
    the ``aborted`` class cancelled through ``LLM.abort_request`` once
    each has ``GUIDED_ABORT_AT`` tokens (a thread polls them). Returns
    (wall seconds, outputs by request: a RequestOutput, or the exception
    its result raised)."""
    import threading
    t0 = time.monotonic()
    futs = [llm.generate_async(p, s) for p, s in zip(prompts, sps)]
    watch = [f for f, c in zip(futs, classes) if c == "aborted"]
    stop = threading.Event()

    def aborter():
        left = list(watch)
        while left and not stop.is_set():
            for f in list(left):
                req = f._result.request
                if req.num_output_tokens >= GUIDED_ABORT_AT or \
                        req.is_finished:
                    llm.abort_request(f.request_id)
                    left.remove(f)
            time.sleep(0.001)
    th = threading.Thread(target=aborter, daemon=True)
    th.start()
    outs = []
    for f in futs:
        try:
            outs.append(f.result(timeout=900))
        except Exception as e:      # the oversize request's error
            outs.append(e)
    stop.set()
    th.join()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.monotonic() - t0, outs


def measure_guided(llm, prompts, sps, classes, profile: bool = True
                   ) -> dict:
    """Warm-up pass (every grammar compiles and lands in the pool here),
    timed pass (the kernels' launch counters zeroed right before it and
    read right after), then (``profile``) a profiled pass of the guided
    workload: per-class rates and latencies (of the requests that
    returned), each grammar's build ms (warm-up pass), the pool states
    in use, windows that carried device-guided rows against single steps
    with guided rows, graph replays (and those of guided window keys),
    free KV blocks before and after the timed pass, segment refcounts
    after it, ``LLM.get_stats`` length, each request's end, the device
    idle share and GPU time by class (profiled pass) and peak allocated
    memory. Returns (result, the timed pass's outputs)."""
    kernels = kernel_modules()
    eng, ex, kv = llm.engine, llm.executor, llm.kv_cache_manager
    mgr = ex.guided_decoder.device
    _guided_pass(llm, prompts, sps, classes)
    build_ms = dict(mgr.build_ms) if mgr is not None else {}
    c0 = dict(replays=eng.graphs.replays, decode=eng.decode_steps,
              window=eng.window_steps, gwin=eng.guided_windows,
              gstep=eng.guided_steps, failed=ex.requests_failed,
              adm=ex.guided_admissions, adm_ms=ex.guided_admission_ms,
              gkeys=_guided_window_replays(eng))
    free0 = kv.get_num_free_blocks()
    torch.cuda.reset_peak_memory_stats()
    for mod in kernels.values():
        mod.LAUNCHES = 0
    wall, outs = _guided_pass(llm, prompts, sps, classes)
    launches = {k: mod.LAUNCHES for k, mod in kernels.items()}
    # the loop releases a request's KV as it finishes; let it settle
    for _ in range(200):
        if kv.get_num_free_blocks() == free0:
            break
        time.sleep(0.01)
    ok = [(o, c) for o, c in zip(outs, classes)
          if not isinstance(o, Exception)]
    ends: dict = {}
    for o, c in zip(outs, classes):
        end = "error" if isinstance(o, Exception) else \
            o.outputs[0].finish_reason
        ends.setdefault(c, {}).setdefault(end, 0)
        ends[c][end] += 1
    res = dict(
        device=torch.cuda.get_device_name(0),
        nvidia_smi=subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(),
        backend=llm.args.guided_decoding_backend,
        requests=len(prompts), wall_ms=wall * 1e3,
        classes=surface_class_stats([o for o, _ in ok],
                                    [c for _, c in ok], wall),
        ends=ends,
        errors=[f"{c}: {o}" for o, c in zip(outs, classes)
                if isinstance(o, Exception)],
        grammar_build_ms=list(build_ms.values()),
        guided_admissions=ex.guided_admissions - c0["adm"],
        guided_admission_ms=ex.guided_admission_ms - c0["adm_ms"],
        pool_states=mgr.pool_states if mgr is not None else 0,
        pool_states_in_use=mgr.states_in_use if mgr is not None else 0,
        segment_refs=[s.refs for s in mgr._segments.values()]
        if mgr is not None else [],
        launches=launches, graphs_captured=eng.graphs.num_graphs,
        graph_replays=eng.graphs.replays - c0["replays"],
        guided_window_replays=_guided_window_replays(eng) - c0["gkeys"],
        window_steps=eng.window_steps - c0["window"],
        single_decode_steps=(eng.decode_steps - c0["decode"])
        - (eng.window_steps - c0["window"]),
        guided_windows=eng.guided_windows - c0["gwin"],
        guided_single_steps=eng.guided_steps - c0["gstep"],
        requests_failed=ex.requests_failed - c0["failed"],
        free_blocks_before=free0, free_blocks_after=kv.get_num_free_blocks(),
        stats_len=len(llm.get_stats()),
        peak_allocated_bytes=torch.cuda.max_memory_allocated())
    if profile:
        t0 = time.monotonic()
        res.update(_profiled(llm, prompts, sps, wall,
                             run=lambda: _guided_pass(llm, prompts, sps,
                                                      classes)))
        res["profiled_pass_s"] = time.monotonic() - t0
        if mgr is not None:
            # the grammar's cost per decode step (mask and byte walk over
            # every row), times the guided decode steps of a pass, over
            # the pass's GPU time
            ms = guided_step_ms(eng, mgr.states_in_use)
            steps = res["guided_windows"] * llm.args.decode_multi_step + \
                res["guided_single_steps"]
            res.update(guided_mask_walk_ms=ms,
                       guided_share_of_gpu=ms * steps / res["gpu_kernel_ms"])
    return res, outs


def guided_step_ms(eng, states: int, reps: int = 30) -> float:
    """Median ms (CUDA events) of one step's grammar work on the card at
    ``max_batch_size`` rows: the device mask (``_guided_mask``) over
    float32 logits and the byte walk (``_guided_walk``), from seeded
    states below ``states``."""
    dev, S, V = eng.device, eng.max_batch_size, eng.model.vocab_size
    g = torch.Generator(device=dev).manual_seed(0)
    logits = torch.randn((S, V), generator=g, device=dev)
    st = torch.randint(0, max(1, states), (S,), generator=g, device=dev,
                       dtype=torch.int32)
    tok = torch.randint(0, V, (S,), generator=g, device=dev)
    act = torch.ones(S, dtype=torch.bool, device=dev)
    times = []
    for _ in range(reps + 3):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        eng._guided_mask(logits, st, act)
        eng._guided_walk(tok, st)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times[3:])


def _guided_window_replays(eng) -> int:
    """Replays of K-step window graphs whose key carries the device
    grammar walk."""
    return sum(s.replays for k, s in eng.graphs.steps.items()
               if k[0] == "multi" and k[8].guided)


def _spec_counts(llm):
    """The spec window's cumulative counters (None without speculation);
    ``measure`` reports their change over the timed pass."""
    sd = llm.engine.sd
    if sd is None:
        return None
    dr, ex = sd.drafter, llm.executor
    return dict(windows=sd.windows, iters=sd.iters, dead_iters=sd.dead_iters,
                accepted=dr.accepted_total, steps=dr.steps_total,
                nonspec_rows=ex.nonspec_decode_rows,
                idle_iters=ex.spec_idle_iters)


def profile_sums(prof, moe: bool = False, mla: bool = False):
    """A finished ``torch.profiler.profile``'s device time by class
    (``_class``, ms), its kernels by device time (ms, count, name), the
    device kernels and the host launches (``_HOST_LAUNCH``): the sums of
    ``key_averages`` taken from the raw events, without the event tree."""
    per_name: dict = {}
    host_launches = 0
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        name = e.name()
        if e.device_type() != cuda:
            if name.startswith(_HOST_LAUNCH):
                host_launches += 1
            continue
        if getattr(e, "is_user_annotation", lambda: False)():
            continue
        us, n = per_name.get(name, (0.0, 0))
        per_name[name] = (us + e.duration_ns() / 1e3, n + 1)
    by_class: dict = {}
    kernels = []
    device_launches = 0
    for name, (dev_us, count) in per_name.items():
        if dev_us <= 0:
            continue
        device_launches += count
        c = _class(name, moe, mla)
        by_class[c] = by_class.get(c, 0.0) + dev_us / 1e3
        kernels.append((dev_us / 1e3, count, name[:90]))
    kernels.sort(reverse=True)
    return by_class, kernels, device_launches, host_launches


def _profiled(llm, prompts, sp, plain_wall: float, run=None) -> dict:
    """A pass under ``torch.profiler`` (``run``: the pass, by default
    ``_generate`` of ``prompts`` and ``sp``). Its events are summed by
    name straight from the profiler's raw results: building the
    profiler's event tree (``key_averages``) takes tens of seconds of
    host time at a few hundred thousand kernels, and grows with them;
    ``profile_processing_s`` is what the sums took."""
    from torch.profiler import ProfilerActivity, profile
    eng = llm.engine
    steps0 = eng.decode_steps
    moe = getattr(eng.model, "num_experts", 0) > 0
    mla = hasattr(eng.model, "kv_lora_rank")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _ = run() if run is not None else \
            _generate(llm, prompts, sp)
    t0 = time.perf_counter()
    # a pass's schedule may differ by a step or so between passes
    steps = max(1, eng.decode_steps - steps0)
    by_class, kernels, device_launches, host_launches = \
        profile_sums(prof, moe, mla)
    busy_ms = sum(by_class.values())
    return dict(
        profile_processing_s=time.perf_counter() - t0,
        profiled_wall_ms=wall * 1e3, gpu_kernel_ms=busy_ms,
        idle_share=max(0.0, 1.0 - busy_ms / (plain_wall * 1e3)),
        profiled_idle_share=max(0.0, 1.0 - busy_ms / (wall * 1e3)),
        kernel_ms_by_class=by_class,
        device_kernels=device_launches, host_launches=host_launches,
        host_launches_per_output_step=host_launches / steps,
        device_kernels_per_output_step=device_launches / steps,
        top_kernels=[{"ms": ms, "count": n, "name": k}
                     for ms, n, k in kernels[:12]])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quant", default="NO_QUANT",
                    help="QuantAlgo name, e.g. W4A16_AWQ, W8A16, MXFP4")
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("--bench-settings", action="store_true",
                    help="bench.py's throughput workload and settings")
    ap.add_argument("--geometry", choices=["tinyllama", "qwen3-30b-a3b",
                                           "gemma2-9b", "gemma3-1b",
                                           "llama3-8b", "llama3-8b-copy",
                                           "llama3-8b-quant", "gpt-oss-20b",
                                           "deepseek-v2-lite", "bamba-9b",
                                           "deepseek-v3-mtp",
                                           "longcat-flash",
                                           "llava-1.5-7b"],
                    default="tinyllama",
                    help="the model of the default workload")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the geometry's first N layers")
    ap.add_argument("--inline", action="store_true",
                    help="hand LLM a transformers module built on the card "
                    "(SmoothQuant calibrates on it)")
    ap.add_argument("--family", choices=sorted({**FAMILIES, **GPT_FAMILIES,
                                                **MOE_FAMILIES,
                                                **RECURRENT_FAMILIES}),
                    default=None,
                    help="a Llama-derived or GPT family at a published "
                    "width")
    ap.add_argument("--kv", choices=["none", "int8", "fp8", "nvfp4"],
                    default="none", help="the KV cache's quantization")
    ap.add_argument("--vswa", action="store_true",
                    help="gemma2-9b: the sliding layers on their own pool")
    ap.add_argument("--spec", choices=("NONE", "EAGLE3", "MTP")
                    + HOST_SPEC_MODES, default="NONE",
                    help="speculative mode (EAGLE3, MTP: a seeded random "
                    "head; DRAFT_TARGET / PARD: Llama-3.2-1B, random "
                    "weights)")
    ap.add_argument("--spec-host", action="store_true",
                    help="EAGLE3 / MTP on the host path "
                    "(device_window=False)")
    ap.add_argument("--draft-len", type=int, default=3,
                    help="drafts per spec iteration")
    ap.add_argument("--surface", action="store_true",
                    help="Llama-3-8B serving the sampling surface's mixed "
                    "batch (surface_workload)")
    ap.add_argument("--guided", action="store_true",
                    help="Llama-3-8B serving guided_workload's mixed batch")
    ap.add_argument("--guided-backend", choices=("dfa", "dfa-host"),
                    default="dfa", help="--guided: where the grammar walks")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from tensorrt_llm_tpu_torch import LLM
    if args.guided:
        import os
        cfg, kwargs, pool, prompts, sps, classes = guided_workload(
            args.guided_backend)
        os.environ["TLLM_TPU_GUIDED_POOL_STATES"] = str(pool)
        llm = LLM(cfg, dtype="bfloat16", **kwargs)
        try:
            res, _ = measure_guided(llm, prompts, sps, classes)
        finally:
            llm.shutdown()
        print(json.dumps(dict(guided=True, **res)))
        return
    if args.surface:
        cfg, kwargs, prompts, sps, classes, _ = surface_workload()
        llm = LLM(cfg, dtype="bfloat16", **kwargs)
        try:
            res, _ = measure_surface(llm, prompts, sps, classes)
        finally:
            llm.shutdown()
        print(json.dumps(dict(surface=True, **res)))
        return
    from tensorrt_llm_tpu_torch.llmapi.llm_args import QuantConfig
    from tensorrt_llm_tpu_torch.quantization.mode import (KvCacheQuantAlgo,
                                                          QuantAlgo)
    if args.family:
        cfg, kwargs, prompts, sp = family_workload(args.family)
    else:
        cfg, kwargs, prompts, sp = workload(args.bench_settings,
                                            args.geometry, args.vswa)
    if args.layers and args.geometry == "llava-1.5-7b":
        cfg = llava_15_7b_config(args.layers)
    elif args.layers:
        cfg = gpt_oss_20b_config(args.layers) \
            if args.geometry == "gpt-oss-20b" else \
            bamba_9b_config(args.layers) \
            if args.geometry == "bamba-9b" else \
            moe_family_config(args.family, args.layers) \
            if args.family in MOE_FAMILIES else \
            recurrent_family_config(args.family, args.layers) \
            if args.family in RECURRENT_FAMILIES else cfg
        cfg.num_hidden_layers = args.layers
    model = inline_module(cfg) if args.inline else cfg
    if args.spec != "NONE":
        kwargs["speculative_config"] = spec_config(
            args.spec, args.draft_len, cfg, not args.spec_host)
    kv = "NO_QUANT" if args.kv == "none" else args.kv.upper()
    llm = LLM(model, dtype="bfloat16", quant_config=QuantConfig(
        quant_algo=QuantAlgo[args.quant], group_size=args.group_size,
        kv_cache_quant_algo=KvCacheQuantAlgo[kv]), **kwargs)
    try:
        res = measure(llm, prompts, sp)
        res["spec_replayed_launches"] = dict(
            llm.engine.graphs.replayed_launches("spec"))
        if _mla_module(llm) is not None:
            res["mla_graph_calls"] = mla_graph_calls(llm.engine)
    finally:
        llm.shutdown()
    print(json.dumps(dict(quant_algo=args.quant, kv=args.kv,
                          bench_settings=args.bench_settings,
                          geometry=args.geometry, vswa=args.vswa,
                          family=args.family,
                          layers=getattr(cfg, "text_config",
                                         cfg).num_hidden_layers,
                          inline=args.inline,
                          spec=args.spec, draft_len=args.draft_len, **res)))


if __name__ == "__main__":
    main()
