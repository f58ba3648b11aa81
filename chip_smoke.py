#!/usr/bin/env python3
"""Smoke test of tensorrt_llm_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs a
CUDA device and nvcc, and exits non-zero (printing no result) without
them or when the package is not beside it. Phases, each of which fails
the run on error:

  1. device + build: the card's name and power limit, then every kernel
     of the serving paths built from csrc/ (one nvcc per source, in
     parallel), with the build time;
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     same bf16 inputs (atol = rtol = 2e-2: bf16 inputs, probabilities and
     output rounding, float32 accumulation in both), at the shapes of
     both serving runs below (``decode_bench`` and ``prefill_bench`` are
     the bench-settings run's, whose launches the last JSON line counts),
     plus decode cases that force a split of the KV axis (few long rows),
     exceed the L2 cache, or mix lengths from 1 to 4,096 (each prints its
     number of splits), the rider window's one launch (256 decode rows,
     8 chunks of 64 tokens and a filler row, timed beside the decode
     kernel on the rows alone and the prefill kernel on the chunks
     alone, each of the three held against its plain version), the spec
     window's verify launch (``verify_bench``: 64 sequences x 4 query
     rows at 129-264 KV, timed beside the decode kernel on the same
     queries as 256 single rows), and one
     float32 prefill case held to 1e-4 (each prefill
     case prints its route); times (CUDA events, median
     of 30 launches; 10 for the plain version and the library call), the
     bound from this run's bytes and FLOPs, and as a yardstick the time
     of one PyTorch call that computes the same function where there is
     one: ``scaled_dot_product_attention`` over the gathered KV for the
     attention kernels (with a mask of each row's length where the
     decode rows differ in length, and for ragged query segments the
     queries padded to the longest one under an explicit mask of each
     row's causal offset), ``F.linear`` on the weight dequantized to bf16
     beforehand (4x the int4 bytes) for the dequant-matmul kernel, which
     is also timed with its weights cold (rotating over copies past the
     L2 cache) at the serving shapes;
  3. parity: through ``LLM.generate`` on the card and on the CPU (the
     plain path the CPU tests hold to the JAX package), (a) the float32
     parity checkpoint (tests/assets/tinycode-llama) must give identical
     greedy tokens; (b) a seeded float32 checkpoint whose widths fit the
     dequant-matmul kernel, served with W4A16_AWQ, must give identical
     greedy tokens wherever the CPU run decides by more than 3e-2 in
     log-probability (a random-weight model has near-ties, and the
     kernel's float32 sums, taken in another order than the plain
     version's, can round a projection output to the neighbouring bf16
     value and resolve a near-tie the other way);
  4. graphs: the parity checkpoint, in float32 and in bf16, serves one
     workload twice through ``LLM.generate``: replaying the engine's CUDA
     graphs, and eagerly on the same static buffers
     (``engine.graphs.capture = False``). Eight requests are queued
     before the executor admits any (so both runs schedule alike), with
     4 batch rows, 128 tokens per prefill step and
     ``mixed_window_ctx=64``, so context chunks ride inside decode
     windows. Greedy tokens must be identical; riders must have ridden
     and graphs replayed. Prints the graphs captured, capture seconds,
     pool bytes, launches by replays per kernel and the rider counters;
  5. spec_parity: EAGLE3 in the fused window with the in-repo pair
     (tests/assets/tinycode-llama + tinycode-eagle), 6 prompts x 64
     tokens, d = 2 and 3, float32 and bf16, against the same engine
     without speculation: tokens identical in float32 (in bf16 a parting
     only at a near-tie below 3e-2), mean drafts accepted per iteration
     at least 0.5 in float32, spec windows replayed from graphs and no
     row outside them; a seeded sampled run identical to the run without
     speculation;
  6. serving: the TinyLlama-1.1B geometry (32 x 64 heads, 4 KV heads, 22
     layers) with seeded random weights, 16 requests of 128 prompt tokens
     and 64 output tokens through ``LLM.generate`` with default
     arguments, once in bf16 and once with
     ``QuantConfig(quant_algo=W4A16_AWQ, group_size=128)``; the kernels'
     launch counters are zeroed right before each run and read right
     after, every request must return 64 tokens, every kernel of the
     run's path must have launched, and replayed windows must have
     launched the decode kernel (and, quantized, the dequant-matmul
     kernel); the graph pool must fit the memory kept free for it;
  7. serving at ``bench.py``'s throughput settings (its default 1b
     geometry, 16 x 128 heads; 512 requests of 128 -> 128 tokens,
     max_batch_size 256, decode_multi_step 16, max_inflight_steps 3,
     mixed_window_ctx 512, decode_wait_occupancy 1.0, max_num_tokens
     16384, page 32; ``tools/serving_profile.py --bench-settings``): a
     warm-up pass, a timed pass with the launch counters zeroed before and
     read after (tokens/s, TTFT and TPOT medians, graphs replayed, the
     windows' dead-step share), then a profiled pass (device idle share,
     launches per output step); the graph pool must fit its reserve;
  8. spec_serving: EAGLE3 at bench.py's 1b geometry with a random head,
     d = 3 (64 requests of 128 -> 128 greedy tokens, max_batch_size 64,
     decode_multi_step 8, so K = 2), a warm-up and a timed pass (the
     launch counters zeroed right before it and read right after) beside
     the same traffic without speculation: tokens/s, TTFT and TPOT
     medians, spec windows and dead iterations, mean accepted drafts,
     graphs and pool bytes against the reserve, launches replayed from
     spec graphs (the decode and prefill kernels must be among them), no
     decode row outside the spec windows. The first 8 requests' tokens
     against the run without speculation: in bf16 a stream may part only
     where that run decides by less than max(3e-2, twice the logprob
     drift measured on the agreed tokens) (``_compare_streams``); at the
     same geometry in float32 they must be identical.

  9. moe_block (after the kernels): one Qwen3-30B-A3B MoE block at full
     width (128 experts, top 8, hidden 2048, expert width 768; seeded
     bf16) at T = 64 and 2,048: the grouped route (``torch._grouped_mm``,
     a library call) against the plain one at 2e-2, the dense route
     against the plain one in float32 at T = 64 (1e-4), each route's
     time, whether ``torch._grouped_mm`` in float32 syncs with the host
     (why float32 takes the dense route), the whole block replayed from a
     CUDA graph (equal to the eager run), the experts touched and the
     bound (bytes of the experts touched plus x and out, or FLOPs);
 10. moe_parity (after spec_parity): tiny Qwen3-MoE, Qwen2-MoE and
     Mixtral checkpoints (random ``transformers`` models saved to a
     temporary directory) through ``LLM.generate``, the card against the
     CPU plain path: greedy tokens identical in float32, in bf16 a
     parting only at a near-tie (``_compare_streams``); replayed graphs
     against eager runs: identical tokens, replays required;
 11. moe_serving (last): Qwen3-30B-A3B at full width and depth (48
     layers; seeded random bf16, 61.1 GB), 64 requests of 128 -> 64
     greedy tokens, ``LLM`` defaults, measured by
     tools/serving_profile.py (``--geometry qwen3-30b-a3b``): tok/s,
     TTFT, TPOT, device idle share, GPU time by class, weight bytes, KV
     pool pages, graphs, launches replayed per kernel; fails if no window
     replayed K1, K2 never launched or the graph pool outgrew its
     reserve. The kernel phase's ``decode_qwen3moe`` (64 rows at 129-200
     KV) and ``prefill_qwen3moe`` (32 prompts x 128: one 4,096-token
     prefill step) are K1 and K2 at the shapes moe_serving launches them
     with (32 x 128 q heads, 4 KV heads).

 12. gemma kernels (after spec_serving): K1 and K2 at head_dim 256 at the
     shapes gemma_serving launches them with (``decode_gemma2_9b``: 16
     rows at 6,145-6,208 KV, 16 x 256 q heads over 8 KV heads, soft cap
     50, once global and once with window 4,096 (``_window``);
     ``prefill_gemma2_9b``: one 6,144-token prompt, the first eager
     prefill step; the Gemma-3-1B cases at group 4 over 1 KV head,
     window 512), and float32 cases of both held to 1e-4; page tables as
     wide as the engines'; q scaled by 8 so that the scores reach the
     soft cap, each case held to its tolerance as ``allclose`` and
     against tol x max |plain|, and the plain version without the cap or
     the window must fail that check; each prints its time, its bound
     (the KV the rows can see; operations at bf16 or float32 peak), its
     share of the bound, the plain version's time and one SDPA call's
     (with a soft cap, SDPA computes the attention without it, and is
     held against the plain version without it: ``library_computes``);
 13. gemma_parity: tiny Gemma 2 (one pool and VSWA) and Gemma 3
     checkpoints at hd 256 and 64 through ``LLM.generate``, the card
     against the CPU plain path: identical greedy tokens in float32, in
     bf16 a parting only at a near-tie; K1 and K2 must launch, VSWA must
     release sliding blocks;
 14. gemma_serving: Gemma-2-9B at full width, 12 of its 42 layers
     (``GEMMA2_9B_LAYERS``: a depth cut for the script's time budget;
     seeded random bf16, 7.0 GB), 16 x 6,144 -> 64 greedy tokens,
     max_seq_len 8,192, once with VSWA (``max_attention_window=[4096,
     8192]``) and once with one pool (tools/serving_profile.py
     ``--geometry gemma2-9b [--vswa]``: tok/s, TTFT, TPOT, idle share,
     GPU time by class, each pool's pages, tokens and bytes, sliding
     blocks released, launches, replays, graph keys; the one-pool run
     without its profiled pass); the first 8 tokens of every stream of
     the two runs identical or parted at a near-tie;
     then Gemma-3-1B at full width, 32 x 1,024 -> 64, one pool. Each
     run records the (q_lens, ctx) of its eager steps. The ``kernels``
     line's rows carry ``launches_gemma_serving`` (the VSWA run's timed
     pass);
 15. gemma_steps: K2 held against plain at every distinct eager step
     gemma_serving recorded (Gemma-2-9B global and sliding, Gemma-3-1B),
     and timed at the 9B step past a fresh prompt with the most attention
     pairs (``prefill_gemma2_9b_step`` and ``_window``).
 16. kv_quant_parity: tests/assets/tinycode-llama in float32 on INT8, FP8
     and NVFP4 KV pools (``QuantConfig(kv_cache_quant_algo=...)``), the
     card against the CPU with the CPU's calibrated scales written into
     the card's scale tensors after its graphs were captured: greedy
     tokens identical wherever the CPU run decides by more than 3e-2 in
     log-probability; K1, K2 and graph replays required;
 17. kv_serving: Llama-3-8B at its published width and 16 of its 32
     layers (``KV_SERVING_LAYERS``: a depth cut for the time budget;
     seeded random bf16 weights, 16.1 GB), 64 x 2,048 -> 128 greedy
     tokens, ``LLM`` defaults but prefix reuse off, on an FP8 pool
     (tools/serving_profile.py ``--geometry llama3-8b --kv fp8``; the
     bf16 pool by ``--geometry llama3-8b`` and an INT8 pool by ``--kv
     int8``, left out here for the script's time budget):
     tok/s, TTFT and TPOT (median, max; unprofiled, for the time budget),
     the pool's pages, tokens and bytes, the calibrated scales'
     range, launches and replays; every request 128 tokens, no NaN in
     the pool or in the returned logprobs, K1 replayed in windows, K2
     launched; the ``kernels`` line's ``launches_kv_serving`` (the FP8
     run's timed pass);
 18. kv_quant_kernels: K1 and K2 on int8 and e4m3 pools against their
     plain versions (q scaled by 8; bf16 held to 2e-2 x max |plain|,
     and the plain version without either scale must fail that check),
     at kv_serving's shapes (``decode_kv_*``: 64 rows at 2,049-2,176 KV,
     32 x 128 q heads over 8; ``prefill_kv_*``: the FP8 run's first
     eager prefill step), timed beside the plain version, the same
     kernel on the bf16 pool (``bf16_pool_ms``) and SDPA on the KV
     dequantized beforehand, the bound from the 8-bit bytes; one case at
     hd 64 and one at hd 256, and float32 cases held to 1e-4; the
     ``kernels`` line's ``max_abs_err_kv8``.

 19. host_spec_parity: tests/assets/tinycode-llama in float32, 6 prompts
     with repeated structure -> 32 greedy tokens, on the card and on the
     CPU, without speculation and with the host drafters NGRAM (d = 3),
     SA, DRAFT_TARGET (the checkpoint as its own draft model) and PARD
     (the same, mask token 0): every mode's tokens equal the run without
     speculation on both devices, DRAFT_TARGET accepts more than 0.9 of
     its drafts, verify steps replayed from graphs on the card; prints the
     drafts accepted per verify step of each mode;
 20. host_spec_serving: Llama-3-8B at its published width and 16 of its
     32 layers (``HOST_SPEC_TARGET_LAYERS``: a depth cut for the time
     budget) on a bf16 pool, 32 prompts of 512 tokens, each a seeded random 128-token
     segment repeated 4 times, 128 greedy tokens with ``ignore_eos``,
     ``LLM`` defaults but prefix reuse off (tools/serving_profile.py
     ``--geometry llama3-8b-copy [--spec DRAFT_TARGET]``): without
     speculation and with DRAFT_TARGET (d = 4), drafting with
     Llama-3.2-1B from its published config (seeded random weights:
     acceptance near 0, so the run measures what drafting costs); the
     NGRAM run (``--spec NGRAM``) is left out for the script's time
     budget. Per run: tok/s, TTFT and TPOT (median, max), idle share and
     GPU time by class (the run without speculation only: time
     budget), the drafting calls' device time, accepted drafts per
     verify step, verify steps replayed and run eagerly (0 without prompt
     tokens, or the phase fails), K1 / K2 launches of the target and of
     the drafter (both must launch both), peak allocated memory; the
     greedy stream of the spec run against the first
     (``_compare_streams``);
 21. host_spec_kernels: K1 and K2 at the new shapes of that path:
     ``verify_host_8b`` (K2, 32 sequences x 5 queries at 513-640 KV, 32 x
     128 q heads over 8) and ``decode_draft_1b`` (K1, 32 rows at 513-640
     KV, 32 x 64 over 8, the drafter's 128-column page table), each
     against its plain version, its bound and one SDPA call.

 22. surface_parity: tests/assets/tinycode-llama in float32, the card
     against the CPU, on the overlap scheduler (K = 8) and on the sync
     scheduler (``max_beam_width=4``): no-repeat-ngram, an embedding bias,
     bad words, all three together, n = 3 greedy and seeded, and
     prompt_logprobs on both; a forcing and a sampling logits processor
     and beam search (width 4, n 3) on the sync one. Tokens identical,
     prompt logprobs within 1e-4 (the same keys), beam hypotheses
     identical and their scores within 1e-4;
 23. surface_serving: Llama-3-8B at its published width and depth on a
     bf16 pool (seeded random weights), one ``LLM`` with
     ``max_beam_width=4`` (the sync scheduler) and prefix reuse on,
     serving one mixed batch (tools/serving_profile.py ``--surface``,
     ``surface_workload``): 16 x 512 -> 128 seeded sampling with n = 4,
     8 x 512 -> 128 greedy with no-repeat-ngram 3, a [V] bias and 16 bad
     words, 4 x 512 -> 16 with prompt_logprobs 5, 4 x 256 -> 64 beam
     search (best_of 4, n 2), 4 x 512 -> 64 with a numpy processor banning
     64 tokens; per class tok/s, TTFT and TPOT (median, max), and
     (without a profiled pass: time budget) graphs, windows against single steps, K1 / K2
     launches, the prompt-logprobs forward's mean ms, beam forks and
     pages copied, reuse hits, peak memory. Fails unless every class
     finishes at its length, every prompt-logprob dict holds its prompt
     token, no bad word and no repeated 3-gram appears in that class, no
     banned token in the processor's class, and K1 and K2 launched.

 24. guided_parity: tests/assets/tinycode-llama in float32 with
     byte-level token bytes (``guided_token_bytes="byte"``, EOS token 0,
     ``end_id=0``) and a 16,384-state pool, the card against the CPU,
     with the device guided backend on the overlap scheduler (K = 8) and
     the host one (``dfa-host``, the sync scheduler): regex, JSON
     schema, ``json_object``, EBNF and structural-tag requests, a mixed
     batch with unguided rows, and beside 3 guided requests an unguided
     request aborted mid-window and one whose grammar cannot fit the
     pool (device) or one whose logits processor raises (host). Tokens
     identical card/CPU and backend/backend, every guided output a live
     prefix of its grammar (accepted where it ended on EOS), guided
     windows replayed on the card; the aborted request CANCELLED, the
     oversize one failed naming the pool, the poison one a
     ``RequestError``, the requests beside them finished;
 25. guided_serving: Llama-3-8B at its published width, 8 of its 32
     layers (for the script's time limit), on a bf16 pool (seeded random
     weights), one ``LLM`` with the device guided backend, byte-level
     token bytes, a 16,384-state pool, prefix reuse off, otherwise
     defaults (overlap depth 4, K = 8, 64 rows),
     serving one mixed batch (tools/serving_profile.py ``--guided``,
     ``guided_workload``): 16 x 512 -> 128 JSON-schema requests, 16
     ID-regex ones, 8 EBNF arithmetic, 8 ``json_object``, 16 unguided,
     8 unguided aborted through ``LLM.abort_request`` at 16 tokens, and
     one regex of 20,001 DFA states; per class tok/s, TTFT and TPOT
     (median, max), each grammar's build ms, pool states in use, guided
     windows against single steps, graph replays, K1 / K2 launches (no
     profiled pass, for the time budget: no idle share, GPU time by class
     or grammar share), free KV blocks before and after,
     ``get_stats`` length and peak memory. Fails unless each guided
     output that ended on EOS matches its grammar in full (``json.loads``
     and the schema's fields; ``re.fullmatch``) and each that hit its
     length is a live prefix, the regex class ended on EOS, the aborted
     requests ended CANCELLED and the oversize one failed naming the
     pool while the rest finished, free blocks returned and every pool
     segment's refcount is 0, guided rows rode replayed windows, and K1
     and K2 launched.

 26. quant_linear_kernels: K3's e4m3 body (FP8 weights) at Llama-3-8B's
     projection shapes (qkv 4096 -> 6144, o 4096 -> 4096, gate_up 4096 ->
     28672, down 14336 -> 4096) at 64 rows and one row, with per-tensor
     scales (a fused projection's [N]) and 128 x 128 block scales: held
     against its plain version (2e-2, and 2e-2 x max |plain|), timed warm
     and cold beside its byte bound, ``F.linear`` on the bf16 weight (warm
     and cold), the per-call-upcast route and the plain version; and
     SmoothQuant's and W4A8's whole ``apply`` at the same shapes;
 27. quant_parity: tests/assets/tinycode-llama in float32 under FP8, FP8
     block, SmoothQuant W8A8 (through the inline-model entry) and W4A8,
     the card against the CPU: greedy tokens identical (FP8, through K3's
     e4m3 body, wherever the CPU decides by more than 3e-2); K3's e4m3
     body must launch under FP8 and smoothed q/k/v must stay apart;
 28. quant_serving: Llama-3-8B at full width and depth with FP8 weights
     and a bf16 KV cache, 64 x 512 -> 128 (tools/serving_profile.py
     ``--geometry llama3-8b-quant --quant FP8``): tok/s, TTFT, TPOT,
     idle share, GPU time by class, weight bytes, peak memory, launches;
     every window step's projections must launch K3's e4m3 body (no
     weight widened in memory on a decode step); beside it 8-layer
     passes of 64 x 512 -> 64 in bf16, FP8, FP8 block, SmoothQuant
     (calibrated on an inline ``transformers`` module built on the card
     in bf16, ``--inline``) and W4A8, with the same figures but the
     profiled ones (left out for the time budget);
 29. families_parity: the nine Llama-derived families (Granite, OLMo 2,
     Phi-3, GLM, GLM-4, SmolLM3, Helium, Arcee, EXAONE 4): a tiny seeded
     float32 checkpoint of each, the card against the CPU, greedy tokens
     identical and K1 / K2 launched; and one bf16 run of each at a
     published model's width (``serving_profile.FAMILIES``: 2 layers, 4
     for EXAONE-4.0-32B and SmolLM3-3B), 16 x 256 -> 32 through graphs,
     K1 / K2 launched, windows replayed, every logprob finite.

 30. gpt_kernels: K1 and K2 at this slice's shapes, held against their
     plain versions and timed beside them, their bounds and one SDPA
     call where one computes the same function: gpt-oss-20b's sliding
     layers (sinks, window 128), bloom-7b1 (ALiBi), GPT-NeoX-20B (hd 96),
     StableLM-3B-4E1T (hd 80) and Falcon-7B (71 q heads over one KV
     head);
 31. gpt_parity: a tiny seeded float32 checkpoint of each GPT family
     (GPT-2, GPT-NeoX, GPT-J, Falcon, StarCoder2, Cohere, Nemotron,
     Cohere2, StableLM, BLOOM, MPT, OPT) and a tiny GPT-OSS whose experts
     are MXFP4 blocks and scales, the card against the CPU: greedy tokens
     identical, K1 / K2 launched (with sinks, with ALiBi);
 32. gpt_families: each GPT family at a published model's width
     (``serving_profile.GPT_FAMILIES``: 2 layers, 4 for Command-R7B), 16 x
     256 -> 32 through graphs: K1 / K2 launched, windows replayed, every
     logprob finite;
 33. gptoss_serving: gpt-oss-20b at full width and depth (24 layers, 32
     experts top 4, sinks, windows of 128), 64 x 512 -> 128, one bf16 KV
     pool, K = 8 windows, graphs (``serving_profile --geometry
     gpt-oss-20b``): tok/s, TTFT, TPOT, idle share, GPU time by class,
     weights and peak memory, K1 / K2 launches and those with sinks.

 34. deepseek_parity: tiny float32 DeepSeek-V3 (``q_lora_rank``) and
     DeepSeek-V2 (group-limited) checkpoints written from a seeded numpy
     generator, queued requests on 4 rows with K = 4 windows and rider
     chunks: greedy tokens identical card against CPU and graphs
     against eager, the windows on MLA's absorbed path, rider windows
     and prefill steps on the decompressed one, on both devices;
 35. deepseek_serving: DeepSeek-V2-Lite at full width and depth (27
     layers, MLA over a 576-wide latent pool, 64 experts top 6), 64 x 512
     -> 128, one bf16 latent pool, K = 8 windows, graphs
     (``serving_profile --geometry deepseek-v2-lite``): tok/s, TTFT,
     TPOT, idle share, GPU time by class (MLA's float32 einsums among
     them), weights and peak memory, MLA calls by path in the timed pass
     and by graph kind over the replays: every replayed window absorbed;
 36. moe_families: GLM-4.5-Air, ERNIE-4.5-21B-A3B, Hunyuan-A13B,
     Granite-3.1-3B-A800M, DeepSeek-V3 (one dense, one MoE layer),
     Hunyuan-7B, Seed-OSS-36B, ERNIE-4.5-0.3B and Apertus-8B at
     published widths (``serving_profile.MOE_FAMILIES``: 2 layers), 16 x
     256 -> 32 through graphs: K1 / K2 launched (MLA's paths for
     DeepSeek-V3), windows replayed, every logprob finite.

 37. recurrent_kernels: K1 and K2 at bamba_serving's shapes
     (``decode_bamba``: 64 rows at 513-640 KV, ``prefill_bamba``: 16
     fresh 512-token prompts; 32 x 128 q heads over 8), each against its
     plain version, its bound and one SDPA call;
 38. recurrent_parity: a tiny float32 checkpoint of each recurrent
     family (Mamba, FalconMamba, Mamba2, Bamba, Granite-4.0-H, Zamba2,
     Jamba, LFM2, Qwen3-Next, MiniMax), 7 queued requests on 4 rows (the
     later ones in recycled slots), K = 4 windows: greedy tokens
     identical card against CPU and graphs against eager, K1 and K2
     launched for the hybrids; and Bamba-9B's widths at 2 layers (one
     Mamba2, one attention; float32): the card's first 8 tokens of 4
     streams against the CPU's, partings only at near-ties;
 39. bamba_serving: Bamba-9B at its published width, its first 19 of
     32 layers (for the script's time limit; attention at 9 and 18,
     seeded random bf16), 64 x 512 -> 128, K = 8 windows, graphs
     (``serving_profile --geometry bamba-9b``): tok/s, TTFT, TPOT, idle
     share, GPU time by class, weights, state-pool and peak bytes, K1 /
     K2 launches, each eager prefill step's device ms, and one Mamba2
     layer's SSD scan, conv and mixer timed alone at a prefill step's
     and a decode step's shapes with the chunked SSD's peak memory
     beside the per-token states of the plain form, and the chunked SSD
     against the plain one at the model's widths (1e-3);
 40. recurrent_families: each recurrent family at a published model's
     width (``serving_profile.RECURRENT_FAMILIES``, cut in depth so that
     each kind of layer runs), 16 x 256 -> 32 through graphs: K1 / K2
     launched for the hybrids, windows replayed, every logprob finite;
     then Qwen3-Next's delta rule timed alone at its widths (a prefill
     step's loop over 256 positions, a decode step's one iteration) and
     its loop held against its plain form (1e-4).

 41. mtp_parity: tiny float32 DeepSeek-V3 and DeepSeek-V2 checkpoints
     with MTP (d = 2, the JAX package's seeded random module) in the
     fused window and on the host path, queued requests on 4 rows: greedy
     tokens identical card against CPU and against the run without
     speculation, the drafts' counts equal on both devices;
 42. mtp_serving: DeepSeek-V3 at its published width, its first 4 layers
     (3 dense, 1 MoE) and its MTP module (~53.4 GB), 64 x 512 -> 128,
     K = 8, graphs (``serving_profile --geometry deepseek-v3-mtp``),
     served without speculation, with MTP (d = 1) in the window and on
     the host path: tok/s, TTFT, TPOT, idle share, GPU time by class,
     weights and peak memory, MLA calls by path, drafts proposed and
     accepted, one window iteration's head and verify ms, and the three
     token streams against each other (partings only at near-ties);
 43. longcat_serving: LongCat-Flash at its published width at 1 of 28
     pairs (512 experts top 12 beside 256 zero experts, ~43.1 GB), 64 x
     512 -> 128, K = 8, graphs (``serving_profile --geometry
     longcat-flash``): tok/s, TTFT, TPOT, idle share, GPU time by class,
     weights and peak memory, MLA calls by path;
 44. longcat_parity: a tiny float32 LongCat-Flash checkpoint (queued
     requests on 4 rows, K = 4 windows with rider chunks): greedy tokens
     identical card against CPU and graphs against eager, zero experts
     picked; and longcat_serving's full-width weights copied to the host:
     the card's tokens of 2 prompts of 64 -> 8 against the CPU model's
     forward, partings only at near-ties, and the share of picks that
     fell on zero experts.
 45. hd48_kernels: K1 and K2 at head dim 48 (tinypasskey-llama's 4 x 48
     heads over 4 KV heads) at eval_accuracy's shapes, on a bf16 and an
     e4m3 pool, against the plain version, timed beside it, its bound and
     SDPA;
 46. eval_accuracy: the port's first accuracy on trained weights:
     PasskeyRetrieval on tests/assets/tinypasskey-llama at context 250
     and 3,072, each in bf16, on an FP8 KV pool and with FP8 weights,
     and HumanEval on tests/assets/tinycode-llama in bf16: accuracies and
     K1 / K2 / K3 launches (bf16 at 250 must reach 80 %);
 47. bert_parity: ``LLM.classify`` in float32 card against CPU, a tiny
     BERT (also against transformers) and BERT-large at full width on 4
     pairs (2e-4);
 48. bert_serving: BERT-large as a cross-encoder reranker, 128 pairs of
     200-512 tokens with token types (bucket 512): pairs/s, ms a batch,
     peak memory;
 49. llava_parity: image prompts through ``LLM.generate`` in float32,
     card against CPU: the tiny LLaVA (tokens identical) and
     LLaVA-1.5-7B's full-width tower and projector over 2 text layers
     (partings only at near-ties);
 50. llava_serving: LLaVA-1.5-7B at full width and depth, 64 x (one 336
     x 336 image + 64 text tokens = 640) -> 128, K = 8, graphs
     (``serving_profile --geometry llava-1.5-7b``): tok/s, TTFT, TPOT,
     the tower's ms per image, K1 / K2 launches, idle share, GPU time by
     class, weights and peak memory, and the blocks reused by 16 requests
     of one text beside different images (none) and of one text and one
     image.

``python3 chip_smoke.py --only a,b`` runs just the named phases (a
development run: no kernels line, no result line).

The last three lines are the nvidia-smi line, one JSON object with the
per-kernel results (launches from the bench-settings run, or the
W4A16_AWQ run for the dequant-matmul kernel, and from spec_serving's,
moe_serving's, gemma_serving's, kv_serving's, host_spec_serving's
DRAFT_TARGET (as the target's and the drafter's), surface_serving's,
guided_serving's, gptoss_serving's (and those with sinks) and
deepseek_serving's timed passes (none: MLA calls no kernel), gpt_families'
summed, moe_families' by family, bamba_serving's timed pass,
recurrent_families' by family, mtp_serving's three timed passes and
longcat_serving's (none: MLA, the MTP head and the ScMoE call no
kernel), eval_accuracy's runs, bert_serving's (none: the encoder calls no
kernel) and llava_serving's timed pass; K1's and K2's rows also their
hd-48 cases; the dequant-matmul kernel's row also its
e4m3 cases and its e4m3 launches in quant_serving's runs) and
``{"ok": true, "device": {...}}``.
"""
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
BF16_FLOPS = 989e12           # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
TOL = 2e-2
# depths cut for the script's 1,200 s limit (guided_serving's time is
# mostly its grammars' builds; bamba_serving keeps 2 of its 3 attention
# layers)
GUIDED_SERVING_LAYERS = 8
BAMBA_SERVING_LAYERS = 19
# deepseek_serving keeps its dense first layer and 8 of its 26 MoE layers
DEEPSEEK_SERVING_LAYERS = 9
NEAR_TIE = 3e-2               # log-probability margin below which the
                              # quantized cuda/cpu runs may part ways


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def kernel_phase():
    import torch
    import torch.nn.functional as F
    from tensorrt_llm_tpu_torch.ops.cuda import decode_attention as dec
    from tensorrt_llm_tpu_torch.ops.cuda import prefill_attention as pre
    from tensorrt_llm_tpu_torch.tools.card_timing import (
        PAGE, dense_kv, make_case, time_ms)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = {}
    # ---- K1: paged decode --------------------------------------------
    # decode_long: S x kvh alone is 16 CTAs, so the KV axis must be split;
    # decode_hbm: 268 MB of KV, well above the 50 MB L2; decode_ragged: KV
    # lengths from 1 to 4,096 in one batch; decode_bench: the windows of
    # the bench-settings run (256 rows at 129 to 264 positions, hd 128).
    ragged = [1 + (4095 * i) // 63 for i in range(64)]
    bench_rows = [129 + (135 * i) // 255 for i in range(256)]
    # decode_qwen3moe: moe_serving's windows (64 rows of 128 -> 64 traffic
    # at 129-200 positions, the last window's K = 8 steps included;
    # Qwen3-30B-A3B's 32 x 128 q heads over 4 KV heads)
    qwen_rows = [129 + (71 * i) // 63 for i in range(64)]
    for name, kvs, qh, kvh, hd, page in [
            ("decode_bench", bench_rows, 16, 4, 128, PAGE),
            ("decode_qwen3moe", qwen_rows, 32, 4, 128, PAGE),
            ("decode_hd64", [1024] * 64, 32, 4, 64, PAGE),
            ("decode_hd64_page16", [1024] * 64, 32, 4, 64, 16),
            ("decode_hd128", [1024] * 64, 16, 4, 128, PAGE),
            ("decode_serving_rows", [160] * 64, 32, 4, 64, PAGE),
            ("decode_long", [16384] * 4, 32, 4, 64, PAGE),
            ("decode_hbm", [4096] * 64, 32, 4, 64, PAGE),
            ("decode_ragged", ragged, 32, 4, 64, PAGE)]:
        S = len(kvs)
        q, pool, kv_lens, pt, _ = make_case([1] * S, [k - 1 for k in kvs],
                                            qh, kvh, hd, seed=len(name),
                                            page=page)
        kw = dict(sm_scale=hd ** -0.5)
        fast = dict(max_kv_len=max(kvs), **kw)    # the engine's host hint
        got = dec.paged_decode_attention(q, pool, kv_lens, pt, **fast)
        splits = dec.choose_splits(S, kvh, max(kvs), sms, qh // kvh)
        ref = dec.paged_decode_attention_plain(q, pool, kv_lens, pt, **kw)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        if not torch.allclose(got.float(), ref.float(), atol=TOL, rtol=TOL):
            raise AssertionError(f"{name}: kernel != plain (max {err})")
        ms = time_ms(lambda: dec.paged_decode_attention(
            q, pool, kv_lens, pt, **fast), 30)
        plain_ms = time_ms(lambda: dec.paged_decode_attention_plain(
            q, pool, kv_lens, pt, **kw), 10)
        # one SDPA call over the KV gathered to the longest row computes
        # the same function, with a mask of each row's length when the
        # lengths differ
        k, v = dense_kv(pool, pt, kvh, hd, max(kvs))
        q4 = q.reshape(S, qh, 1, hd)
        mask = None
        if len(set(kvs)) > 1:
            mask = (torch.arange(max(kvs), device="cuda")[None, :]
                    < kv_lens[:, None])[:, None, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(
                q4, k, v, attn_mask=mask, scale=kw["sm_scale"],
                enable_gqa=True)
        lib = sdpa()
        torch.cuda.synchronize()
        lib = lib.reshape(S, qh, hd).float()
        lib_err = (lib - ref.float()).abs().max().item()
        if not torch.allclose(lib, ref.float(), atol=TOL, rtol=TOL):
            raise AssertionError(f"{name}: library != plain (max {lib_err})")
        library_ms = time_ms(sdpa, 10)
        del k, v, lib, mask
        kv_bytes = sum(kvs) * kvh * hd * 2 * 2
        io_bytes = kv_bytes + 2 * q.numel() * 2 + pt.numel() * 4 + S * 4
        flops = 4 * qh * hd * sum(kvs)
        results[name] = dict(
            shape=dict(seqs=S, kv_len=kvs[0] if len(set(kvs)) == 1
                       else [min(kvs), max(kvs)], qh=qh, kvh=kvh, hd=hd,
                       page=page),
            splits=splits, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, library_max_abs_err=lib_err,
            bytes=io_bytes, flops=flops,
            **_bound(io_bytes, flops))
        emit({"phase": "kernels", "case": name, **results[name]})
        del q, pool, kv_lens, pt, got, ref
        torch.cuda.empty_cache()

    # ---- K2: ragged prefill / mixed ------------------------------------
    for name, q_lens, ctx, qh, kvh, hd in [
            ("prefill_hd64", [512] * 8, [0] * 8, 32, 4, 64),
            ("prefill_hd128", [512] * 8, [0] * 8, 16, 4, 128),
            ("prefill_serving", [128] * 16, [0] * 16, 32, 4, 64),
            ("prefill_bench", [128] * 128, [0] * 128, 16, 4, 128),
            ("prefill_qwen3moe", [128] * 32, [0] * 32, 32, 4, 128),
            ("mixed_hd64", [1] * 32 + [256] * 4, [1023] * 32 + [256] * 4,
             32, 4, 64),
            ("mixed_hd128", [1] * 32 + [256] * 4, [1023] * 32 + [256] * 4,
             16, 4, 128)]:
        q, pool, kv_lens, pt, cu = make_case(q_lens, ctx, qh, kvh, hd,
                                             seed=len(name))
        kw = dict(sm_scale=hd ** -0.5)
        mq = max(q_lens)
        got = pre.ragged_prefill_attention(q, pool, kv_lens, pt, cu,
                                           max_q_len=mq, **kw)
        ref = pre.ragged_prefill_attention_plain(q, pool, kv_lens, pt, cu,
                                                 **kw)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        if not torch.allclose(got.float(), ref.float(), atol=TOL, rtol=TOL):
            raise AssertionError(f"{name}: kernel != plain (max {err})")
        ms = time_ms(lambda: pre.ragged_prefill_attention(
            q, pool, kv_lens, pt, cu, max_q_len=mq, **kw), 30)
        plain_ms = time_ms(lambda: pre.ragged_prefill_attention_plain(
            q, pool, kv_lens, pt, cu, **kw), 10)
        if not any(ctx):
            # one causal SDPA call over the gathered KV computes the same
            # function when every sequence is a fresh prompt of one length
            S, L = len(q_lens), q_lens[0]
            k, v = dense_kv(pool, pt, kvh, hd, L)
            q4 = q.reshape(S, L, qh, hd).transpose(1, 2).contiguous()
            lib = F.scaled_dot_product_attention(
                q4, k, v, is_causal=True, scale=kw["sm_scale"],
                enable_gqa=True)
            torch.cuda.synchronize()
            lib_err = (lib.transpose(1, 2).reshape(q.shape).float()
                       - ref.float()).abs().max().item()
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q4, k, v, is_causal=True, scale=kw["sm_scale"],
                enable_gqa=True), 10)
        else:
            # decode rows beside chunks: one SDPA call over the KV gathered
            # to the longest row, the queries padded to the longest
            # segment, with an explicit mask of each row's causal offset
            library_ms, lib_err = _ragged_library(
                q, pool, pt, q_lens, [c + n for c, n in zip(ctx, q_lens)],
                kvh, hd, kw["sm_scale"], ref, name)
        pairs = sum(c * n + n * (n + 1) // 2 for c, n in zip(ctx, q_lens))
        flops = 4 * qh * hd * pairs
        io_bytes = sum(c + n for c, n in zip(ctx, q_lens)) * kvh * hd * 4 \
            + 2 * q.numel() * 2 + pt.numel() * 4 + 2 * cu.numel() * 4
        results[name] = dict(
            shape=dict(q_lens=sorted(set(q_lens)), ctx=sorted(set(ctx)),
                       seqs=len(q_lens), qh=qh, kvh=kvh, hd=hd, page=PAGE),
            route=pre.route_for(q.dtype), max_abs_err=err, ms=ms,
            plain_ms=plain_ms,
            library_ms=library_ms, library_max_abs_err=lib_err,
            bytes=io_bytes, flops=flops, **_bound(io_bytes, flops))
        emit({"phase": "kernels", "case": name, **results[name]})
    results["rider_hd128"] = rider_case()
    results["verify_bench"] = verify_case()
    # the float32 route (the parity path's) stays covered: checked, not
    # timed; float32 sums in another order than the plain version's
    q, pool, kv_lens, pt, cu = make_case(
        [1, 300, 1, 70], [900, 0, 31, 500], 32, 4, 64, seed=5,
        dtype=torch.float32)
    kw = dict(sm_scale=0.125)
    got = pre.ragged_prefill_attention(q, pool, kv_lens, pt, cu,
                                       max_q_len=300, **kw)
    ref = pre.ragged_prefill_attention_plain(q, pool, kv_lens, pt, cu, **kw)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    if not torch.allclose(got, ref, atol=1e-4, rtol=1e-4):
        raise AssertionError(f"prefill float32: kernel != plain (max {err})")
    emit({"phase": "kernels", "case": "prefill_float32_checked",
          "route": pre.route_for(q.dtype), "max_abs_err": err, "tol": 1e-4})
    quant_kernel_phase(results)
    return results


def rider_case() -> dict:
    """The rider window's one launch of the prefill kernel at bench.py's
    settings: 256 decode rows at 190-209 positions, 8 chunks of 64 tokens
    after 0-448 positions and a filler row without tokens, hd 128 (16 x
    128 heads, 4 KV heads), its grid fixed by the window's chunk width
    C = 512. Timed beside the same work in two launches: the decode
    kernel on the 256 rows, the prefill kernel on the chunks."""
    import torch
    from tensorrt_llm_tpu_torch.ops.cuda import decode_attention as dec
    from tensorrt_llm_tpu_torch.ops.cuda import prefill_attention as pre
    from tensorrt_llm_tpu_torch.tools.card_timing import (PAGE, make_case,
                                                          time_ms)
    Sb, NC, chunk, C = 256, 8, 64, 512
    qh, kvh, hd = 16, 4, 128
    q_lens = [1] * Sb + [chunk] * NC + [0]
    ctx = [189 + i % 20 for i in range(Sb)] + \
        [64 * i for i in range(NC)] + [1]
    q, pool, kv_lens, pt, cu = make_case(q_lens, ctx, qh, kvh, hd, seed=11)
    kw = dict(sm_scale=hd ** -0.5)
    got = pre.ragged_prefill_attention(q, pool, kv_lens, pt, cu,
                                       max_q_len=C, **kw)
    ref = pre.ragged_prefill_attention_plain(q, pool, kv_lens, pt, cu, **kw)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    if not torch.isfinite(got.float()).all() or not torch.allclose(
            got.float(), ref.float(), atol=TOL, rtol=TOL):
        raise AssertionError(f"rider_hd128: kernel != plain (max {err})")
    ms = time_ms(lambda: pre.ragged_prefill_attention(
        q, pool, kv_lens, pt, cu, max_q_len=C, **kw), 30)
    plain_ms = time_ms(lambda: pre.ragged_prefill_attention_plain(
        q, pool, kv_lens, pt, cu, **kw), 10)
    # the same work in two launches, each held against its plain version
    qd, kvd, ptd = q[:Sb], kv_lens[:Sb], pt[:Sb]
    qc = q[Sb:Sb + NC * chunk]
    cuc = cu[Sb:Sb + NC + 1] - Sb
    kvc, ptc = kv_lens[Sb:Sb + NC], pt[Sb:Sb + NC]
    dkw = dict(max_kv_len=max(ctx[:Sb]) + 1, **kw)
    for part, got_p, ref_p in [
            ("decode rows", dec.paged_decode_attention(qd, pool, kvd, ptd,
                                                       **dkw),
             dec.paged_decode_attention_plain(qd, pool, kvd, ptd, **kw)),
            ("chunks", pre.ragged_prefill_attention(qc, pool, kvc, ptc, cuc,
                                                    max_q_len=chunk, **kw),
             pre.ragged_prefill_attention_plain(qc, pool, kvc, ptc, cuc,
                                                **kw))]:
        torch.cuda.synchronize()
        part_err = (got_p.float() - ref_p.float()).abs().max().item()
        if not torch.allclose(got_p.float(), ref_p.float(), atol=TOL,
                              rtol=TOL):
            raise AssertionError(f"rider_hd128 {part}: kernel != plain "
                                 f"(max {part_err})")
        err = max(err, part_err)
    dec_ms = time_ms(lambda: dec.paged_decode_attention(
        qd, pool, kvd, ptd, **dkw), 30)
    pre_ms = time_ms(lambda: pre.ragged_prefill_attention(
        qc, pool, kvc, ptc, cuc, max_q_len=chunk, **kw), 30)
    library_ms, lib_err = _ragged_library(
        q, pool, pt, q_lens, [c + n for c, n in zip(ctx, q_lens)], kvh, hd,
        kw["sm_scale"], ref, "rider_hd128")
    pairs = sum(c * n + n * (n + 1) // 2 for c, n in zip(ctx, q_lens))
    flops = 4 * qh * hd * pairs
    io_bytes = sum(c + n for c, n in zip(ctx, q_lens)) * kvh * hd * 4 \
        + 2 * q.numel() * 2 + pt.numel() * 4 + 2 * cu.numel() * 4
    res = dict(
        shape=dict(decode_rows=Sb, decode_kv=[min(ctx[:Sb]) + 1,
                                              max(ctx[:Sb]) + 1],
                   chunks=NC, chunk_tokens=chunk, filler_rows=1, C=C,
                   qh=qh, kvh=kvh, hd=hd, page=PAGE),
        route=pre.route_for(q.dtype), max_q_len=C, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, library_ms=library_ms,
        library_max_abs_err=lib_err, bytes=io_bytes, flops=flops,
        decode_rows_k1_ms=dec_ms, chunks_k2_ms=pre_ms,
        two_launches_ms=dec_ms + pre_ms, **_bound(io_bytes, flops))
    emit({"phase": "kernels", "case": "rider_hd128", **res})
    return res


def verify_case() -> dict:
    """The spec window's verify pass, one launch of the prefill kernel: 64
    sequences x 4 query rows (d = 3) at KV lengths 129-264 (the 4 rows
    included), 16 x 128 heads, 4 KV heads, page 32, bf16, its grid fixed
    by max_q_len = 4. Beside it the same queries through the decode
    kernel as 256 single-query rows, each at its causal length (the other
    way to launch this work), both held against their plain versions."""
    import torch
    from tensorrt_llm_tpu_torch.ops.cuda import decode_attention as dec
    from tensorrt_llm_tpu_torch.ops.cuda import prefill_attention as pre
    from tensorrt_llm_tpu_torch.tools.card_timing import (PAGE, make_case,
                                                          time_ms)
    Sb, Dp, qh, kvh, hd = 64, 4, 16, 4, 128
    kvs = [129 + (135 * i) // (Sb - 1) for i in range(Sb)]
    q_lens = [Dp] * Sb
    ctx = [k - Dp for k in kvs]
    q, pool, kv_lens, pt, cu = make_case(q_lens, ctx, qh, kvh, hd, seed=13)
    kw = dict(sm_scale=hd ** -0.5)
    got = pre.ragged_prefill_attention(q, pool, kv_lens, pt, cu,
                                       max_q_len=Dp, **kw)
    ref = pre.ragged_prefill_attention_plain(q, pool, kv_lens, pt, cu, **kw)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    if not torch.allclose(got.float(), ref.float(), atol=TOL, rtol=TOL):
        raise AssertionError(f"verify_bench: kernel != plain (max {err})")
    ms = time_ms(lambda: pre.ragged_prefill_attention(
        q, pool, kv_lens, pt, cu, max_q_len=Dp, **kw), 30)
    plain_ms = time_ms(lambda: pre.ragged_prefill_attention_plain(
        q, pool, kv_lens, pt, cu, **kw), 10)
    library_ms, lib_err = _ragged_library(q, pool, pt, q_lens, kvs, kvh, hd,
                                          kw["sm_scale"], ref,
                                          "verify_bench")
    # the decode kernel, one row per query at its own causal length
    kv1 = torch.tensor([c + j + 1 for c in ctx for j in range(Dp)],
                       dtype=torch.int32, device="cuda")
    pt1 = pt.repeat_interleave(Dp, dim=0)
    dkw = dict(max_kv_len=max(kvs), **kw)
    got1 = dec.paged_decode_attention(q, pool, kv1, pt1, **dkw)
    ref1 = dec.paged_decode_attention_plain(q, pool, kv1, pt1, **kw)
    torch.cuda.synchronize()
    k1_err = (got1.float() - ref1.float()).abs().max().item()
    if not torch.allclose(got1.float(), ref1.float(), atol=TOL, rtol=TOL):
        raise AssertionError(f"verify_bench K1: kernel != plain (max "
                             f"{k1_err})")
    if not torch.allclose(ref1.float(), ref.float(), atol=TOL, rtol=TOL):
        raise AssertionError("verify_bench: the two plain versions differ")
    k1_ms = time_ms(lambda: dec.paged_decode_attention(
        q, pool, kv1, pt1, **dkw), 30)
    pairs = sum(c * n + n * (n + 1) // 2 for c, n in zip(ctx, q_lens))
    flops = 4 * qh * hd * pairs
    io_bytes = sum(kvs) * kvh * hd * 4 + 2 * q.numel() * 2 \
        + pt.numel() * 4 + 2 * cu.numel() * 4
    res = dict(
        shape=dict(seqs=Sb, q_len=Dp, kv_len=[min(kvs), max(kvs)], qh=qh,
                   kvh=kvh, hd=hd, page=PAGE),
        route=pre.route_for(q.dtype), max_q_len=Dp, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, library_ms=library_ms,
        library_max_abs_err=lib_err, bytes=io_bytes, flops=flops,
        k1_per_query_ms=k1_ms, k1_max_abs_err=k1_err,
        k1_splits=dec.choose_splits(
            Sb * Dp, kvh, max(kvs),
            torch.cuda.get_device_properties(0).multi_processor_count,
            qh // kvh),
        **_bound(io_bytes, flops))
    emit({"phase": "kernels", "case": "verify_bench", **res})
    return res


def _ragged_library(q, pool, pt, q_lens, kv_lens, kvh, hd, scale, ref,
                    name):
    """One SDPA call that computes what the prefill kernel computes for
    ragged segments: the KV gathered to the longest row, the queries
    padded to the longest segment, an explicit mask of each row's causal
    offset (a padding row sees position 0, its output dropped). Held
    against the plain version ``ref``; returns (ms, max abs err)."""
    import torch
    import torch.nn.functional as F
    from tensorrt_llm_tpu_torch.tools.card_timing import dense_kv, time_ms
    S, Lq, Lk = len(q_lens), max(q_lens), max(kv_lens)
    qh = q.shape[1]
    dev = q.device
    k, v = dense_kv(pool, pt, kvh, hd, Lk)
    nq = torch.tensor(q_lens, device=dev)
    seq = torch.repeat_interleave(torch.arange(S, device=dev), nq)
    row = torch.cat([torch.arange(n, device=dev) for n in q_lens])
    qp = torch.zeros((S, Lq, qh, hd), dtype=q.dtype, device=dev)
    qp[seq, row] = q
    qp = qp.transpose(1, 2).contiguous()                    # [S, qh, Lq, hd]
    off = torch.tensor(kv_lens, device=dev) - nq
    qpos = off[:, None] + torch.arange(Lq, device=dev)[None]
    live = torch.arange(Lq, device=dev)[None] < nq[:, None]
    mask = (torch.arange(Lk, device=dev)[None, None] <= qpos[:, :, None]) \
        & live[:, :, None]
    mask[:, :, 0] |= ~live
    mask = mask[:, None]                                    # [S, 1, Lq, Lk]

    def sdpa():
        return F.scaled_dot_product_attention(qp, k, v, attn_mask=mask,
                                              scale=scale, enable_gqa=True)
    lib = sdpa().transpose(1, 2)[seq, row]
    torch.cuda.synchronize()
    lib_err = (lib.float() - ref.float()).abs().max().item()
    if not torch.allclose(lib.float(), ref.float(), atol=TOL, rtol=TOL):
        raise AssertionError(f"{name}: library != plain (max {lib_err})")
    ms = time_ms(sdpa, 10)
    del k, v, qp, mask, lib
    torch.cuda.empty_cache()
    return ms, lib_err


def quant_kernel_phase(results: dict) -> None:
    """K3: the dequant-matmul kernel at the serving shapes of the
    TinyLlama-1.1B geometry (M = 64 decode rows; qkv, o, gate_up, down),
    16 rows (the serving run's live rows), one row, 128 rows, the int8 body
    at the MXFP4 and NVFP4 group sizes, and an N that is no multiple of
    16 (the narrow-copy route). Each case prints the host rule's split
    count along K. The serving shapes and the 16-row case are also timed
    cold: rotating over copies of the weight and scales (and of the bf16
    weight for ``F.linear``) that together pass COLD_BYTES, as a decode
    step streams every layer's weights from HBM; the share of the bound
    is read from the cold time."""
    import torch
    import torch.nn.functional as F
    from tensorrt_llm_tpu_torch.ops import quant as Q
    from tensorrt_llm_tpu_torch.ops.cuda import quant_matmul as qmm
    from tensorrt_llm_tpu_torch.tools.card_timing import time_ms

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    one = torch.empty(1, device="cuda")
    emit({"phase": "kernels", "case": "launch_floor",
          "note": "an empty elementwise launch, timed like every kernel",
          "ms": time_ms(lambda: one.fill_(1.0), 30)})
    for name, M, K, N, G, bits, cold in [
            ("qmm_qkv", 64, 2048, 2560, 128, 4, True),
            ("qmm_o", 64, 2048, 2048, 128, 4, True),
            ("qmm_gate_up", 64, 2048, 11264, 128, 4, True),
            ("qmm_down", 64, 5632, 2048, 128, 4, True),
            ("qmm_rows16", 16, 2048, 11264, 128, 4, True),
            ("qmm_rows1", 1, 2048, 2560, 128, 4, False),
            ("qmm_rows128", 128, 2048, 2560, 128, 4, False),
            ("qmm_int8_group32", 64, 2048, 2560, 32, 8, False),
            ("qmm_int8_group16", 64, 2048, 2560, 16, 8, False),
            ("qmm_ragged_n257", 64, 2048, 257, 128, 4, False)]:
        g = torch.Generator(device="cuda").manual_seed(len(name) + M)
        x = torch.randn((M, K), generator=g, device="cuda",
                        dtype=torch.bfloat16)
        w = torch.randn((K, N), generator=g, device="cuda") * 0.02
        q, s, _ = Q.quantize_weight_groupwise(w, group_size=G, bits=bits)
        wd = Q.dequantize_weight(q, s, group_size=G).t().contiguous()
        if bits == 4:
            q = Q.pack_int4(q)
        del w
        kw = dict(group_size=G, bits=bits)
        got = qmm.groupwise_dequant_matmul(x, q, s, **kw)
        ref = qmm.groupwise_dequant_matmul_plain(x, q, s, **kw)
        lib = F.linear(x, wd)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        if not torch.allclose(got.float(), ref.float(), atol=TOL, rtol=TOL):
            raise AssertionError(f"{name}: kernel != plain (max {err})")
        lib_err = (lib.float() - ref.float()).abs().max().item()
        ms = time_ms(lambda: qmm.groupwise_dequant_matmul(x, q, s, **kw), 30)
        plain_ms = time_ms(
            lambda: qmm.groupwise_dequant_matmul_plain(x, q, s, **kw), 10)
        library_ms = time_ms(lambda: F.linear(x, wd), 10)
        io_bytes = K * N * bits // 8 + s.numel() * 4 + x.numel() * 2 \
            + M * N * 2
        flops = 2 * M * K * N
        res = dict(
            shape=dict(M=M, K=K, N=N, group=G, bits=bits),
            splits=qmm.choose_splits(M, K, N, G, bits, sms),
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, library_max_abs_err=lib_err,
            bytes=io_bytes, flops=flops, **_bound(io_bytes, flops))
        if cold:
            qs = _copies([q, s])
            wds = _copies([wd])
            res["ms_cold"] = time_ms(_rotate(
                lambda i: qmm.groupwise_dequant_matmul(x, *qs[i], **kw),
                len(qs)), 30)
            res["library_ms_cold"] = time_ms(_rotate(
                lambda i: F.linear(x, wds[i][0]), len(wds)), 30)
            res["cold_copies"] = [len(qs), len(wds)]
            res["bound_share_cold"] = res["bound_ms"] / res["ms_cold"]
            del qs, wds
        results[name] = res
        emit({"phase": "kernels", "case": name, **res})
        del x, q, s, wd, got, ref, lib
        torch.cuda.empty_cache()


COLD_BYTES = 100e6      # well past the H100's 50 MB L2


def _copies(tensors):
    """Enough copies of ``tensors`` to pass COLD_BYTES together."""
    size = sum(t.numel() * t.element_size() for t in tensors)
    n = int(COLD_BYTES // size) + 2
    return [[t.clone() for t in tensors] for _ in range(n)]


def _rotate(fn, n):
    """A function that calls ``fn(i)`` for i = 1, 2, ..., n - 1, 0, 1, ...:
    each launch reads a copy that the last n - 1 launches did not."""
    state = [0]

    def step():
        state[0] = (state[0] + 1) % n
        return fn(state[0])
    return step


def _bound(io_bytes: int, flops: int, flops_per_s: float = BF16_FLOPS) -> dict:
    t_bytes = io_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def parity_phase(repo: Path):
    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig, SamplingParams
    prompts = [list(b"def forward(self, x):\n    return "),
               list(b"import torch\n"), list(range(32, 120))]
    toks = {}
    for dev in ("cuda", "cpu"):
        llm = LLM(repo / "tests" / "assets" / "tinycode-llama", device=dev,
                  dtype="float32", skip_tokenizer_init=True,
                  max_batch_size=8, max_input_len=128, max_seq_len=256,
                  max_num_tokens=512,
                  kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                                max_tokens=4096))
        try:
            outs = llm.generate(prompts, SamplingParams(max_tokens=32,
                                                        top_k=1))
        finally:
            llm.shutdown()
        toks[dev] = [o.outputs[0].token_ids for o in outs]
    if toks["cuda"] != toks["cpu"]:
        raise AssertionError(f"cuda/cpu greedy tokens differ: {toks}")
    if any(len(t) != 32 for t in toks["cuda"]):
        raise AssertionError("parity run returned short outputs")
    emit({"phase": "parity", "prompts": len(prompts), "tokens_each": 32,
          "identical": True})


def quant_parity_phase():
    """W4A16_AWQ on a seeded float32 checkpoint whose widths fit the
    dequant-matmul kernel (hidden 256 = 4 x 64 heads, intermediate 512,
    group 64), through ``LLM.generate`` on the card (the kernel) and on
    the CPU (its plain version)."""
    import torch
    from safetensors.torch import save_file
    from transformers import LlamaConfig
    from tensorrt_llm_tpu_torch import (LLM, KvCacheConfig, QuantAlgo,
                                        QuantConfig, SamplingParams)
    from tensorrt_llm_tpu_torch.ops.cuda import quant_matmul as qmm

    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=4, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=256,
                      tie_word_embeddings=False)
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    gen = torch.Generator().manual_seed(1)

    def mat(*shape):
        return torch.randn(shape, generator=gen) * 0.05

    sd = {"model.embed_tokens.weight": mat(V, H), "lm_head.weight": mat(V, H),
          "model.norm.weight": torch.ones(H)}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = torch.ones(H)
        sd[p + "post_attention_layernorm.weight"] = torch.ones(H)
        for n, shape in [("self_attn.q_proj", (H, H)),
                         ("self_attn.k_proj", (H // 2, H)),
                         ("self_attn.v_proj", (H // 2, H)),
                         ("self_attn.o_proj", (H, H)),
                         ("mlp.gate_proj", (I, H)), ("mlp.up_proj", (I, H)),
                         ("mlp.down_proj", (H, I))]:
            sd[p + n + ".weight"] = mat(*shape)
    prompts = [list(range(3, 40)), [7, 300, 41, 5, 99, 250],
               list(range(500, 470, -1))]
    n_out = 24
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg.save_pretrained(tmp)
        save_file(sd, str(Path(tmp) / "model.safetensors"))
        for dev in ("cuda", "cpu"):
            qmm.LAUNCHES = 0
            llm = LLM(tmp, device=dev, dtype="float32",
                      skip_tokenizer_init=True, max_batch_size=8,
                      max_input_len=128, max_seq_len=256, max_num_tokens=128,
                      quant_config=QuantConfig(
                          quant_algo=QuantAlgo.W4A16_AWQ, group_size=64),
                      kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                                    max_tokens=4096))
            try:
                outs = llm.generate(prompts, SamplingParams(
                    max_tokens=n_out, top_k=1, logprobs=2))
            finally:
                llm.shutdown()
            runs[dev] = [(o.outputs[0].token_ids, o.outputs[0].logprobs)
                         for o in outs]
            if (qmm.LAUNCHES > 0) != (dev == "cuda"):
                raise AssertionError(
                    f"{dev}: {qmm.LAUNCHES} dequant-matmul launches")
    agreed = near_ties = 0
    for (ref, lps), (got, _) in zip(runs["cpu"], runs["cuda"]):
        if len(ref) != n_out or len(got) != n_out:
            raise AssertionError("quantized parity run returned short "
                                 "outputs")
        for a, b, lp in zip(ref, got, lps):
            if a != b:
                top = sorted(lp.values(), reverse=True)
                if top[0] - top[1] > NEAR_TIE:
                    raise AssertionError(
                        f"cuda/cpu greedy tokens differ where the cpu run "
                        f"decides by {top[0] - top[1]:.4f}: {ref} vs {got}")
                near_ties += 1
                break
            agreed += 1
    total = n_out * len(prompts)
    if agreed < total // 2:
        raise AssertionError(f"only {agreed} of {total} tokens compared "
                             "equal before a near-tie")
    emit({"phase": "parity_quantized", "quant_algo": "W4A16_AWQ",
          "group_size": 64, "prompts": len(prompts), "tokens_each": n_out,
          "tokens_equal": agreed, "parted_at_near_tie": near_ties,
          "near_tie_logprob_margin": NEAR_TIE,
          "identical": near_ties == 0})


def _queued_generate(llm, prompts, sps):
    """Every request queued before the executor admits any, so that a
    run's schedule follows from the workload alone."""
    import threading
    ex = llm.executor
    gate = threading.Event()
    fetch = ex._fetch_new_requests
    ex._fetch_new_requests = lambda: fetch() if gate.is_set() else None
    futs = [llm.generate_async(p, sp) for p, sp in zip(prompts, sps)]
    gate.set()
    return [f.result(timeout=600).outputs[0].token_ids for f in futs]


def _kernel_counts():
    from tensorrt_llm_tpu_torch.tools.serving_profile import kernel_modules
    return kernel_modules()


def _zero_launches() -> None:
    for mod in _kernel_counts().values():
        mod.LAUNCHES = 0


def _read_launches() -> dict:
    return {k: mod.LAUNCHES for k, mod in _kernel_counts().items()}


def _graph_stats(engine) -> dict:
    """The engine's CUDA graphs and what their replays launched."""
    g = engine.graphs
    by_module = g.replayed_launches()
    return dict(graphs_captured=g.num_graphs, capture_s=g.capture_seconds,
                pool_bytes=g.pool_bytes, graph_replays=g.replays,
                replayed_launches={k: by_module[mod.__name__]
                                   for k, mod in _kernel_counts().items()},
                mixed_windows_dispatched=engine.mixed_windows_dispatched,
                mixed_ctx_carved=engine.mixed_ctx_carved,
                window_steps=engine.window_steps,
                dead_window_steps=engine.dead_window_steps)


def graph_phase(repo: Path, device: str = "cuda"):
    """One rider-window workload on the parity checkpoint, replayed from
    CUDA graphs and run eagerly on the same static buffers, in float32
    and in bf16: greedy tokens must be identical, riders must ride and
    graphs replay."""
    import torch
    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig, SamplingParams
    gen = torch.Generator().manual_seed(3)
    lengths = [30, 200, 90, 150, 60, 180, 45, 120]
    prompts = [torch.randint(1, 256, (n,), generator=gen).tolist()
               for n in lengths]
    sps = [SamplingParams(max_tokens=n, top_k=1, ignore_eos=True)
           for n in (40, 24, 37, 40, 13, 24, 40, 21)]
    out = {}
    for dtype in ("float32", "bfloat16"):
        toks, stats = {}, {}
        for mode in ("graph", "eager"):
            llm = LLM(repo / "tests" / "assets" / "tinycode-llama",
                      device=device, dtype=dtype, skip_tokenizer_init=True,
                      max_batch_size=4, max_input_len=256, max_seq_len=320,
                      max_num_tokens=128, decode_multi_step=8,
                      mixed_window_ctx=64, enable_warmup=mode == "graph",
                      kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                                    max_tokens=8192))
            llm.engine.graphs.capture = mode == "graph" and \
                device == "cuda"
            try:
                _zero_launches()
                toks[mode] = _queued_generate(llm, prompts, sps)
                stats[mode] = dict(launches=_read_launches(),
                                   **_graph_stats(llm.engine))
            finally:
                llm.shutdown()
        g, e = stats["graph"], stats["eager"]
        if toks["graph"] != toks["eager"]:
            raise AssertionError(f"{dtype}: graph and eager greedy tokens "
                                 f"differ: {toks}")
        if [len(t) for t in toks["graph"]] != [sp.max_tokens for sp in sps]:
            raise AssertionError(f"{dtype}: short outputs")
        if not (g["mixed_windows_dispatched"] and g["mixed_ctx_carved"]):
            raise AssertionError(f"{dtype}: no context rode a window: {g}")
        if (g["mixed_windows_dispatched"], g["mixed_ctx_carved"]) != \
                (e["mixed_windows_dispatched"], e["mixed_ctx_carved"]):
            raise AssertionError(f"{dtype}: the two runs scheduled "
                                 f"differently: {g} {e}")
        if device == "cuda" and not (
                g["graph_replays"] and g["replayed_launches"][
                    "paged_decode_attention"] and g["replayed_launches"][
                    "ragged_prefill_attention"]):
            raise AssertionError(f"{dtype}: no graph replayed the "
                                 f"attention kernels: {g}")
        out[dtype] = dict(identical=True, graph=g, eager=e)
        emit({"phase": "graphs", "dtype": dtype, "requests": len(prompts),
              "tokens": sum(len(t) for t in toks["graph"]), **out[dtype]})
    return out


def _spec_stats(llm) -> dict:
    """The spec window's counters and what its graphs replayed."""
    sd, dr = llm.engine.sd, llm.executor.drafter
    by_module = llm.engine.graphs.replayed_launches("spec")
    return dict(
        spec_windows=sd.windows, spec_iters=sd.iters,
        spec_dead_iters=sd.dead_iters,
        spec_idle_iters=llm.executor.spec_idle_iters,
        mean_accepted=dr.accepted_total / max(1, dr.steps_total),
        spec_graph_replays=sum(
            st.replays for k, st in llm.engine.graphs.steps.items()
            if k[0] == "spec" and st.graph is not None),
        spec_replayed_launches={k: by_module[mod.__name__]
                                for k, mod in _kernel_counts().items()},
        nonspec_decode_rows=llm.executor.nonspec_decode_rows)


def spec_parity_phase(repo: Path):
    """EAGLE3 in the fused window on the card with the in-repo pair
    (tinycode-llama + tinycode-eagle), 6 prompts x 64 tokens, d = 2 and 3,
    float32 and bf16, against the same engine without speculation: tokens
    identical in float32 (in bf16 a parting only at a near-tie), at least
    0.5 drafts accepted per iteration in float32, spec windows replayed
    from graphs; a seeded sampled run equals the same run without spec."""
    from tensorrt_llm_tpu_torch import (LLM, KvCacheConfig, SamplingParams,
                                        SpeculativeConfig)
    prompts = [list(b"def forward(self, x):\n    return "),
               list(b"import torch\n"), list(range(32, 120)),
               list(b"class Cache:\n    def __init__(self, size):\n"),
               list(b"for i in range(10):\n    print("),
               list(b"def softmax(x):\n    e = np.exp(x - x.max())\n")]
    n_out = 64

    def run(dtype, d, sp):
        spec = None if d is None else SpeculativeConfig(
            mode="EAGLE3", max_draft_len=d,
            draft_model=str(repo / "tests" / "assets" / "tinycode-eagle"))
        llm = LLM(repo / "tests" / "assets" / "tinycode-llama",
                  dtype=dtype, skip_tokenizer_init=True, max_batch_size=8,
                  max_input_len=128, max_seq_len=256, max_num_tokens=512,
                  speculative_config=spec,
                  kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                                max_tokens=8192))
        try:
            outs = llm.generate(prompts, sp)
            stats = _spec_stats(llm) if d is not None else {}
        finally:
            llm.shutdown()
        if any(len(o.outputs[0].token_ids) != n_out for o in outs):
            raise AssertionError(f"{dtype} d={d}: short outputs")
        return ([o.outputs[0].token_ids for o in outs],
                [o.outputs[0].logprobs for o in outs], stats)

    greedy = SamplingParams(max_tokens=n_out, top_k=1, ignore_eos=True)
    res = {}
    for dtype in ("float32", "bfloat16"):
        ref, ref_lps, _ = run(dtype, None, SamplingParams(
            max_tokens=n_out, top_k=1, ignore_eos=True, logprobs=2))
        for d in (2, 3):
            got, got_lps, stats = run(dtype, d, greedy)
            cmp = _compare_streams((ref, ref_lps), (got, got_lps))
            if cmp["parting_margins"] and max(
                    cmp["parting_margins"]) > NEAR_TIE:
                raise AssertionError(f"{dtype} d={d}: tokens part where the "
                                     f"run without spec decides by more "
                                     f"than {NEAR_TIE}: {cmp}")
            if dtype == "float32" and got != ref:
                raise AssertionError(f"float32 d={d}: spec tokens differ "
                                     f"from non-spec: {got} vs {ref}")
            if dtype == "float32" and stats["mean_accepted"] < 0.5:
                raise AssertionError(f"d={d}: mean accepted "
                                     f"{stats['mean_accepted']} < 0.5")
            if not stats["spec_graph_replays"] or stats["nonspec_decode_rows"]:
                raise AssertionError(f"{dtype} d={d}: no spec window "
                                     f"replayed, or rows left them: {stats}")
            res[f"{dtype}_d{d}"] = dict(
                tokens_equal=cmp["tokens_equal"], parted=cmp["parted"],
                parting_margins=cmp["parting_margins"], identical=got == ref,
                tokens=len(prompts) * n_out, **stats)
            emit({"phase": "spec_parity", "dtype": dtype, "draft_len": d,
                  "near_tie_logprob_margin": NEAR_TIE,
                  **res[f"{dtype}_d{d}"]})
    seeded = SamplingParams(max_tokens=n_out, temperature=0.8, top_k=0,
                            top_p=0.95, seed=1234, ignore_eos=True)
    ref, _, _ = run("float32", None, seeded)
    got, _, stats = run("float32", 3, seeded)
    if got != ref:
        raise AssertionError("seeded sampled spec run differs from the run "
                             f"without spec: {got} vs {ref}")
    res["seeded_sampled"] = dict(identical=True, **stats)
    emit({"phase": "spec_parity", "dtype": "float32", "draft_len": 3,
          "sampling": "seeded", **res["seeded_sampled"]})
    return res


def spec_serving_phase():
    """EAGLE3 at full width: bench.py's 1b geometry (hidden 2048, 22
    layers, 16 x 128 heads, 4 KV heads, seeded random weights) with a
    random head, d = 3; 64 requests of 128 -> 128 greedy tokens with
    ignore_eos, max_batch_size 64, decode_multi_step 8 (so K = 2), in
    bf16, timed by tools/serving_profile.py's ``measure`` (a warm-up pass,
    then a timed pass with the launch counters zeroed right before it and
    read right after), beside the same traffic without speculation. The
    first 8 requests' tokens are compared with the run without
    speculation (``_compare_streams``), and again in float32, where they
    must be identical."""
    import gc

    import torch
    from transformers import LlamaConfig
    from tensorrt_llm_tpu_torch import (LLM, KvCacheConfig, SamplingParams,
                                        SpeculativeConfig)
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    cfg = LlamaConfig(**sprof.BENCH_1B)
    n_req, isl, osl, d = 64, 128, 128, 3
    gen = torch.Generator().manual_seed(0)
    prompts = torch.randint(1, cfg.vocab_size - 1, (n_req, isl),
                            generator=gen).tolist()
    sp = SamplingParams(max_tokens=osl, top_k=1, ignore_eos=True)
    sp_lp = SamplingParams(max_tokens=osl, top_k=1, ignore_eos=True,
                           logprobs=2)
    kwargs = dict(max_batch_size=n_req, max_input_len=isl + 8,
                  max_seq_len=isl + osl + 8, max_num_tokens=isl * n_req // 2,
                  decode_multi_step=8,
                  kv_cache_config=KvCacheConfig(tokens_per_block=32))

    def build(mode, dtype, **kw):
        gc.collect()
        torch.cuda.empty_cache()
        extra = dict(speculative_config=SpeculativeConfig(
            mode="EAGLE3", max_draft_len=d)) if mode == "spec" else {}
        return LLM(cfg, dtype=dtype, **dict(kwargs, **kw), **extra)

    def first8(llm, params):
        outs = llm.generate(prompts[:8], params)
        return ([o.outputs[0].token_ids for o in outs],
                [o.outputs[0].logprobs for o in outs])

    runs, toks = {}, {}
    for mode in ("spec", "plain"):
        t0 = time.monotonic()
        llm = build(mode, "bfloat16")
        build_s = time.monotonic() - t0
        try:
            res = sprof.measure(llm, prompts, sp, profile=False)
            res.update(
                engine_build_s=build_s, graphs=_graph_stats(llm.engine),
                graph_pool_reserve_bytes=llm.engine.graph_pool_reserve())
            if mode == "spec":
                # measure's counters cover the timed pass; these, both
                # passes
                st = _spec_stats(llm)
                res.update(spec_graph_replays=st["spec_graph_replays"],
                           spec_replayed_launches=st["spec_replayed_launches"],
                           spec_state_bytes=llm.engine.spec_state_bytes())
            toks[mode] = first8(llm, sp if mode == "spec" else sp_lp)
        finally:
            llm.shutdown()
        del llm
        if res["output_tokens"] != n_req * osl:
            raise AssertionError(f"{mode}: {res['output_tokens']} tokens")
        _check_reserve(res)
        runs[mode] = res
    f32 = {}
    for mode in ("spec", "plain"):
        llm = build(mode, "float32", max_batch_size=8, enable_warmup=False)
        try:
            f32[mode] = first8(llm, sp)[0]
        finally:
            llm.shutdown()
        del llm
    spec = runs["spec"]
    cmp = _compare_streams(toks["plain"], toks["spec"])
    out = dict(requests=n_req, isl=isl, osl=osl, draft_len=d, layers=22,
               first8_bf16=cmp, first8_float32_identical=f32["spec"] == f32[
                   "plain"], spec=spec, plain=runs["plain"])
    emit({"phase": "spec_serving", **out})
    if not (spec["spec_windows"] and spec["spec_replayed_launches"][
            "paged_decode_attention"] and spec["spec_replayed_launches"][
            "ragged_prefill_attention"]):
        raise AssertionError(f"spec graphs did not replay K1 and K2: {spec}")
    if spec["nonspec_decode_rows"]:
        raise AssertionError(f"{spec['nonspec_decode_rows']} decode rows "
                             "left the spec windows")
    if min(spec["launches"][k] for k in ("paged_decode_attention",
                                         "ragged_prefill_attention")) <= 0:
        raise AssertionError(f"a kernel never launched: {spec['launches']}")
    if cmp["unexplained_partings"]:
        raise AssertionError(f"spec_serving bf16: tokens part where the run "
                             f"without speculation decides by more than the "
                             f"measured noise allows: {cmp}")
    if not out["first8_float32_identical"]:
        raise AssertionError("spec_serving float32: spec tokens differ from "
                             f"the run without speculation: {f32}")
    return out


def _compare_streams(ref, got) -> dict:
    """Token streams with and without speculation: the verify pass (the
    prefill kernel over d+1 rows per sequence, GEMMs of d+1 times the
    rows) rounds in another order than the decode steps, so in bf16 the
    logits drift apart. ``ref`` = (tokens, top-2 logprobs per token) of
    the run without speculation, ``got`` = (tokens, the chosen token's
    logprob per token). Each stream is compared up to its first parting,
    where the margin by which the reference decides is recorded; the
    drift, delta, is the largest difference of the chosen token's
    logprob on the agreed prefixes. A parting is explained where the
    margin is at most max(NEAR_TIE, 2 * delta) (the two leading logprobs
    moving delta each)."""
    delta, margins = 0.0, []
    for a_row, a_lps, b_row, b_lps in zip(ref[0], ref[1], got[0], got[1]):
        for a, b, alp, blp in zip(a_row, b_row, a_lps, b_lps):
            if a != b:
                top = sorted(alp.values(), reverse=True)
                margins.append(top[0] - top[1])
                break
            delta = max(delta, abs(alp[a] - blp[b]))
    allowed = max(NEAR_TIE, 2 * delta)
    return dict(tokens_equal=sum(
        next((i for i, (x, y) in enumerate(zip(r, g)) if x != y), len(r))
        for r, g in zip(ref[0], got[0])), parted=len(margins),
        parting_margins=margins, max_logprob_drift=delta,
        allowed_margin=allowed,
        unexplained_partings=sum(m > allowed for m in margins))


def serving_phase(quant_algo=None):
    """One serving run; ``quant_algo`` None serves bf16 weights, else a
    ``QuantAlgo`` name with group size 128."""
    import gc

    import torch
    from transformers import LlamaConfig
    from tensorrt_llm_tpu_torch import (LLM, QuantAlgo, QuantConfig,
                                        SamplingParams)

    cfg = LlamaConfig(vocab_size=32000, hidden_size=2048,
                      intermediate_size=5632, num_hidden_layers=22,
                      num_attention_heads=32, num_key_value_heads=4,
                      max_position_embeddings=4096)
    n_req, isl, osl = 16, 128, 64
    gc.collect()
    torch.cuda.empty_cache()       # size the KV pool from what is free now
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    llm = LLM(cfg, dtype="bfloat16", quant_config=QuantConfig(
        quant_algo=QuantAlgo[quant_algo or "NO_QUANT"], group_size=128))
    build_s = time.monotonic() - t0
    weights_bytes = sum(t.numel() * t.element_size()
                        for t in _tensors(llm.engine.params))
    gen = torch.Generator().manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (n_req, isl),
                            generator=gen).tolist()
    sp = SamplingParams(max_tokens=osl, top_k=1)
    try:
        llm.generate(prompts[:2], SamplingParams(max_tokens=8, top_k=1))
        torch.cuda.synchronize()
        replayed = llm.engine.graphs.replayed_launches()
        reserve = llm.engine.graph_pool_reserve()
        _zero_launches()
        t0 = time.monotonic()
        outs = llm.generate(prompts, sp)
        wall = time.monotonic() - t0
        launches = _read_launches()
        graphs = _graph_stats(llm.engine)
        graphs["replayed_launches"] = {
            k: v - replayed[_kernel_counts()[k].__name__]
            for k, v in graphs["replayed_launches"].items()}
    finally:
        llm.shutdown()
    peak_bytes = torch.cuda.max_memory_allocated()
    del llm
    for o in outs:
        toks = o.outputs[0].token_ids
        if len(toks) != osl or not all(0 <= t < cfg.vocab_size
                                       for t in toks):
            raise AssertionError(f"request {o.request_id}: bad output "
                                 f"({len(toks)} tokens)")
    on_path = [k for k in launches
               if quant_algo or k != "groupwise_dequant_matmul"]
    if min(launches[k] for k in on_path) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    if not quant_algo and launches["groupwise_dequant_matmul"]:
        raise AssertionError("the bf16 run launched the dequant-matmul "
                             f"kernel: {launches}")
    perf = [o._result.request.perf for o in outs]
    ttft = [p.first_token_time - p.arrival_time for p in perf]
    tpot = [(p.last_token_time - p.first_token_time) / (osl - 1)
            for p in perf]
    res = dict(quant_algo=quant_algo or "NO_QUANT", requests=n_req,
               isl=isl, osl=osl, layers=22,
               engine_build_s=build_s, weights_bytes=weights_bytes,
               peak_allocated_bytes=peak_bytes, wall_s=wall,
               output_tok_per_s=n_req * osl / wall,
               ttft_ms_median=statistics.median(ttft) * 1e3,
               ttft_ms_max=max(ttft) * 1e3,
               tpot_ms_median=statistics.median(tpot) * 1e3,
               graph_pool_reserve_bytes=reserve, launches=launches,
               decode_steps=launches["paged_decode_attention"] // 22,
               prefill_steps=launches["ragged_prefill_attention"] // 22,
               graphs=graphs)
    if not graphs["replayed_launches"]["paged_decode_attention"]:
        raise AssertionError(f"no decode window was replayed: {graphs}")
    if quant_algo and not \
            graphs["replayed_launches"]["groupwise_dequant_matmul"]:
        raise AssertionError("no replayed window launched the "
                             f"dequant-matmul kernel: {graphs}")
    _check_reserve(res)
    emit({"phase": "serving", **res})
    return res


def bench_serving_phase():
    """bench.py's throughput settings on its 1b geometry (seeded random
    bf16 weights), measured by tools/serving_profile.py: a warm-up pass,
    a timed pass (the launch counters zeroed right before it and read
    right after), a profiled pass."""
    import gc

    import torch
    from tensorrt_llm_tpu_torch import LLM
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    cfg, kwargs, prompts, sp = sprof.workload(bench_settings=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    llm = LLM(cfg, dtype="bfloat16", **kwargs)
    build_s = time.monotonic() - t0
    try:
        res = sprof.measure(llm, prompts, sp)
        graphs = _graph_stats(llm.engine)
        reserve = llm.engine.graph_pool_reserve()
    finally:
        llm.shutdown()
    del llm
    launches = res["launches"]
    if res["output_tokens"] != len(prompts) * sp.max_tokens:
        raise AssertionError(f"bench run: {res['output_tokens']} tokens")
    if min(launches[k] for k in ("paged_decode_attention",
                                 "ragged_prefill_attention")) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    res.update(engine_build_s=build_s, capture_s=graphs["capture_s"],
               pool_bytes=graphs["pool_bytes"],
               graph_pool_reserve_bytes=reserve)
    _check_reserve(dict(res, graphs=graphs))
    emit({"phase": "serving_bench_settings", **res})
    return res


def _check_reserve(res: dict) -> None:
    """The graph pool must fit the memory the engine kept free for it
    when it sized the KV pool (``ModelEngine.graph_pool_reserve``)."""
    pool = res["graphs"]["pool_bytes"]
    if pool > res["graph_pool_reserve_bytes"]:
        raise AssertionError(f"graph pool {pool} B exceeds its reserve "
                             f"{res['graph_pool_reserve_bytes']} B")


def _tensors(tree):
    """Every distinct tensor of a parameter tree."""
    import torch
    seen = {}
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            seen[id(node)] = node
        elif isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
    return seen.values()


# --------------------------------------------------------------------- #
# MoE (Qwen3-30B-A3B and the tiny MoE checkpoints)
# --------------------------------------------------------------------- #
def moe_block_phase() -> dict:
    """One Qwen3-30B-A3B MoE block at full width (128 experts, top 8,
    hidden 2048, expert width 768), seeded bf16 weights, at T = 64 (a
    decode step of 64 rows) and T = 2,048 (a prefill step): the grouped
    route (``torch._grouped_mm``, a library call: the JAX package's
    ``lax.ragged_dot`` is no Pallas kernel) against the plain route at
    2e-2, the dense route against the plain one in float32 at T = 64
    (1e-4), each route's time (CUDA events), ``torch._grouped_mm`` in
    float32 (its error, its time, and whether it syncs with the host,
    which would keep it out of a CUDA graph), the whole block with its
    routing replayed from a CUDA graph, the experts touched, and the
    bound: the bytes of the experts touched plus x and out over 3.35 TB/s,
    or the FLOPs over 989 TFLOP/s, whichever is larger."""
    import torch
    from tensorrt_llm_tpu_torch.ops import moe
    from tensorrt_llm_tpu_torch.ops.linear import dot_f32
    from tensorrt_llm_tpu_torch.tools.card_timing import time_ms
    E, H, I, k = 128, 2048, 768, 8
    g = torch.Generator(device="cuda").manual_seed(7)

    def mat(*shape):
        return (torch.randn(shape, generator=g, device="cuda") * 0.02) \
            .to(torch.bfloat16)
    wgu, wd, router = mat(E, H, 2 * I), mat(E, I, H), mat(E, H)
    out = {}
    for T in (64, 2048):
        x = torch.randn((T, H), generator=g, device="cuda",
                        dtype=torch.bfloat16)
        probs, idx = moe.topk_routing(dot_f32(x, router), k)
        args = (x, wgu, wd, probs, idx)
        got = moe.moe_mlp_grouped(*args)
        ref = moe.moe_mlp_plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        if not torch.isfinite(got.float()).all() or not torch.allclose(
                got.float(), ref.float(), atol=TOL, rtol=TOL):
            raise AssertionError(f"moe_block T={T}: grouped != plain "
                                 f"(max {err})")
        touched = int(torch.unique(idx).numel())
        io_bytes = touched * (H * 2 * I + I * H) * 2 + 2 * T * H * 2 \
            + probs.numel() * 4 + idx.numel() * 4
        flops = 2 * T * k * (H * 2 * I + I * H)
        res = dict(T=T, k=k, experts=E, hidden=H, moe_intermediate=I,
                   experts_touched=touched, max_abs_err=err, tol=TOL,
                   grouped_ms=time_ms(lambda: moe.moe_mlp_grouped(*args), 30),
                   plain_ms=time_ms(lambda: moe.moe_mlp_plain(*args), 10),
                   bytes=io_bytes, flops=flops, **_bound(io_bytes, flops))
        # the whole block (router, routing, experts, combine) as a serving
        # window runs it: replayed from a CUDA graph
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            moe.moe_mlp(x, wgu, wd, router, k)
        torch.cuda.current_stream().wait_stream(s)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static = moe.moe_mlp(x, wgu, wd, router, k)
        graph.replay()
        eager = moe.moe_mlp(x, wgu, wd, router, k)
        torch.cuda.synchronize()
        if not torch.equal(static, eager):
            raise AssertionError(f"moe_block T={T}: graph replay != eager")
        res["block_graph_ms"] = time_ms(graph.replay, 30)
        res["block_eager_ms"] = time_ms(
            lambda: moe.moe_mlp(x, wgu, wd, router, k), 30)
        res["bound_share_grouped"] = res["bound_ms"] / res["grouped_ms"]
        del graph, static
        if T == 64:
            f32 = (x.float(), wgu.float(), wd.float(), probs, idx)
            dense = moe.moe_mlp_dense(*f32)
            plain = moe.moe_mlp_plain(*f32)
            torch.cuda.synchronize()
            derr = (dense - plain).abs().max().item()
            if not torch.allclose(dense, plain, atol=1e-4, rtol=1e-4):
                raise AssertionError(f"moe_block float32: dense != plain "
                                     f"(max {derr})")
            res.update(dense_max_abs_err=derr, dense_tol=1e-4,
                       dense_ms=time_ms(lambda: moe.moe_mlp_dense(*f32), 10),
                       plain_f32_ms=time_ms(
                           lambda: moe.moe_mlp_plain(*f32), 10))
            # the grouped product in float32, measured, not served: a
            # host sync here would fail a graph capture
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                moe.moe_mlp_grouped(*f32)
                gsync = None
            except RuntimeError as e:
                gsync = str(e).splitlines()[0][:120]
            finally:
                torch.cuda.set_sync_debug_mode("default")
            gf32 = moe.moe_mlp_grouped(*f32)
            torch.cuda.synchronize()
            res.update(grouped_f32_host_sync=gsync,
                       grouped_f32_max_abs_err=(gf32 - plain).abs().max()
                       .item(),
                       grouped_f32_ms=time_ms(
                           lambda: moe.moe_mlp_grouped(*f32), 10))
            del f32, dense, plain, gf32
        out[T] = res
        emit({"phase": "moe_block", **res})
        del x, got, ref
    del wgu, wd, router
    torch.cuda.empty_cache()
    return out


MOE_TINY = {
    "qwen3_moe": ("Qwen3MoeConfig", dict(
        moe_intermediate_size=128, num_experts=8, num_experts_per_tok=2,
        norm_topk_prob=True, head_dim=64)),
    "qwen2_moe": ("Qwen2MoeConfig", dict(
        moe_intermediate_size=128, shared_expert_intermediate_size=256,
        num_experts=8, num_experts_per_tok=2, norm_topk_prob=False,
        decoder_sparse_step=1, mlp_only_layers=[])),
    "mixtral": ("MixtralConfig", dict(num_local_experts=8,
                                      num_experts_per_tok=2)),
}


def _save_tiny_moe(path: Path, family: str) -> None:
    """A tiny random ``transformers`` model of ``family`` (hidden 256, 4
    x 64 heads over 2 KV heads, 2 layers, 8 experts, top 2, vocab 512)
    saved to ``path``, its routers redrawn at std 0.5 so that top-k
    choices are decisive."""
    import torch
    import transformers
    cls_name, extra = MOE_TINY[family]
    cfg = getattr(transformers, cls_name)(
        vocab_size=512, hidden_size=256, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=512, tie_word_embeddings=False, **extra)
    model_cls = getattr(transformers, cls_name.replace("Config",
                                                       "ForCausalLM"))
    torch.manual_seed(21)
    model = model_cls(cfg).float()
    gen = torch.Generator().manual_seed(22)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".gate.weight") and "proj" not in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    model.save_pretrained(path)


def moe_parity_phase() -> dict:
    """Tiny Qwen3-MoE, Qwen2-MoE and Mixtral checkpoints (random
    ``transformers`` models saved to a temporary directory) through
    ``LLM.generate``: the card against the port's CPU plain path, greedy
    tokens identical in float32 (the dense MoE route against the plain
    one), and in bf16 (the grouped route) a parting only where the CPU
    run decides by less than ``_compare_streams``' margin; then replayed
    CUDA graphs against eager runs on the same static buffers (bf16, and
    float32 for Qwen3-MoE): identical tokens, replays required."""
    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig, SamplingParams
    prompts = [[5, 17, 99, 3, 64, 12, 7] * 3, list(range(20, 81)),
               [101, 2, 33, 400, 7], list(range(300, 260, -1))]
    n_out = 24
    kw = dict(skip_tokenizer_init=True, max_batch_size=4, max_input_len=96,
              max_seq_len=160, max_num_tokens=128,
              kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                            max_tokens=4096))
    sp = SamplingParams(max_tokens=n_out, top_k=1, ignore_eos=True,
                        logprobs=2)
    res = {}

    def run(path, device, dtype, capture=None):
        llm = LLM(str(path), device=device, dtype=dtype,
                  enable_warmup=capture is not False, **kw)
        if capture is not None:
            llm.engine.graphs.capture = capture
        try:
            outs = llm.generate(prompts, sp)
            stats = _graph_stats(llm.engine) if device == "cuda" else {}
        finally:
            llm.shutdown()
        toks = [o.outputs[0].token_ids for o in outs]
        if any(len(t) != n_out for t in toks):
            raise AssertionError(f"{path.name} {device} {dtype}: short "
                                 "outputs")
        return toks, [o.outputs[0].logprobs for o in outs], stats

    with tempfile.TemporaryDirectory() as tmp:
        for family in MOE_TINY:
            path = Path(tmp) / family
            _save_tiny_moe(path, family)
            for dtype in ("float32", "bfloat16"):
                cpu = run(path, "cpu", dtype)
                card = run(path, "cuda", dtype)
                cmp = _compare_streams(cpu[:2], card[:2])
                if dtype == "float32" and card[0] != cpu[0]:
                    raise AssertionError(f"moe_parity {family} float32: "
                                         f"card {card[0]} != cpu {cpu[0]}")
                if cmp["unexplained_partings"]:
                    raise AssertionError(f"moe_parity {family} {dtype}: "
                                         f"a parting above the near-tie "
                                         f"margin: {cmp}")
                r = dict(family=family, dtype=dtype,
                         identical=card[0] == cpu[0], **cmp)
                if dtype == "bfloat16" or family == "qwen3_moe":
                    eager = run(path, "cuda", dtype, capture=False)
                    g = card[2]
                    if eager[0] != card[0]:
                        raise AssertionError(
                            f"moe_parity {family} {dtype}: graph replay "
                            f"{card[0]} != eager {eager[0]}")
                    if not g["graph_replays"] or not g["replayed_launches"][
                            "paged_decode_attention"]:
                        raise AssertionError(f"moe_parity {family} {dtype}: "
                                             f"no window replayed: {g}")
                    r.update(graph_equals_eager=True,
                             graph_replays=g["graph_replays"],
                             replayed_launches=g["replayed_launches"])
                res[f"{family}_{dtype}"] = r
                emit({"phase": "moe_parity", **r})
    return res


def moe_serving_phase() -> dict:
    """Qwen3-30B-A3B at its published width and depth (48 layers, 128
    experts, top 8; seeded random bf16 weights, 61.1 GB), 64 requests of
    128 prompt tokens -> 64 greedy tokens with ``ignore_eos`` through
    ``LLM.generate`` with ``LLM`` defaults (64 rows, K = 8, depth 4),
    measured by tools/serving_profile.py (``--geometry qwen3-30b-a3b``): a
    warm-up pass, a timed pass (the launch counters zeroed right before
    it and read right after; tok/s, TTFT and TPOT medians) and a profiled
    pass (device idle share, GPU time by class). Fails if a request comes
    back short or out of the vocabulary, if no window was replayed from a
    graph, if a replay launched no decode kernel, if the prefill kernel
    never launched, or if the graph pool outgrew its reserve."""
    import gc

    import torch
    from tensorrt_llm_tpu_torch import LLM
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    cfg, kwargs, prompts, sp = sprof.workload(geometry="qwen3-30b-a3b")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    llm = LLM(cfg, dtype="bfloat16", **kwargs)
    build_s = time.monotonic() - t0
    try:
        weights_bytes = sum(t.numel() * t.element_size()
                            for t in _tensors(llm.engine.params))
        replayed0 = llm.engine.graphs.replayed_launches()
        res = sprof.measure(llm, prompts, sp)
        graphs = _graph_stats(llm.engine)
        graphs["replayed_launches"] = {
            k: v - replayed0[_kernel_counts()[k].__name__]
            for k, v in graphs["replayed_launches"].items()}
        reserve = llm.engine.graph_pool_reserve()
        pages = llm.engine.num_kv_pages
        kv_bytes_per_token = llm.engine.bytes_per_kv_block // \
            llm.engine.page_size
        outs = llm.generate(prompts[:4], sp)
    finally:
        llm.shutdown()
    peak = torch.cuda.max_memory_allocated()
    del llm
    gc.collect()
    torch.cuda.empty_cache()
    V = cfg.vocab_size
    for o in outs:
        toks = o.outputs[0].token_ids
        if len(toks) != sp.max_tokens or not all(0 <= t < V for t in toks):
            raise AssertionError(f"moe_serving: bad output {toks}")
    if res["output_tokens"] != len(prompts) * sp.max_tokens:
        raise AssertionError(f"moe_serving: {res['output_tokens']} tokens")
    res.update(model="Qwen3-30B-A3B", layers=cfg.num_hidden_layers,
               experts=cfg.num_experts, top_k=cfg.num_experts_per_tok,
               engine_build_s=build_s, weights_bytes=weights_bytes,
               peak_allocated_bytes=peak, kv_pool_pages=pages,
               kv_bytes_per_token=kv_bytes_per_token,
               graph_pool_reserve_bytes=reserve, graphs=graphs)
    emit({"phase": "moe_serving", **res})
    if not graphs["graph_replays"] or not \
            graphs["replayed_launches"]["paged_decode_attention"]:
        raise AssertionError(f"moe_serving: no window replayed K1: {graphs}")
    if res["launches"]["ragged_prefill_attention"] <= 0:
        raise AssertionError(f"moe_serving: K2 never launched: "
                             f"{res['launches']}")
    _check_reserve(res)
    return res


# --------------------------------------------------------------------- #
# Gemma 2 / Gemma 3: K1 and K2 at head_dim 256, VSWA
# --------------------------------------------------------------------- #
GEMMA_HD = 256
# the hd-256 cases scale q so that scores (std 8 after sm_scale) reach a
# soft cap of 50 and attention is peaked: the output is then of order one,
# and a kernel that drops the cap, the window or a split's partial fails
GEMMA_Q_SCALE = 8.0


def _hold(name, got, ref, tol, what="kernel") -> float:
    """Max |got - ref|, held to ``allclose(atol=rtol=tol)`` and to tol
    times the largest |ref|."""
    import torch
    err = (got.float() - ref.float()).abs().max().item()
    lim = tol * ref.float().abs().max().item()
    if not torch.allclose(got.float(), ref.float(), atol=tol, rtol=tol) \
            or err > lim:
        raise AssertionError(f"{name}: {what} != plain (max {err}, "
                             f"limit {lim})")
    return err


def _sensitive(name, ref, other, tol, what) -> float:
    """Max |other - ref|, where ``other`` is the plain version without
    the option ``what``: it must fail the check a kernel is held to, so a
    kernel that ignored the option would fail too."""
    import torch
    diff = (other.float() - ref.float()).abs().max().item()
    if torch.allclose(other.float(), ref.float(), atol=tol, rtol=tol) \
            and diff <= tol * ref.float().abs().max().item():
        raise AssertionError(f"{name}: the plain version without {what} "
                             f"passes the kernel's check (max {diff})")
    return diff


# an 8-bit pool's (k_scale, v_scale) in the kernel cases, for a pool
# quantized from standard normals: int8 clips past 4 (3.5) sigma, e4m3
# holds 7 (5.6) sigma inside +-448; K and V apart, so that a kernel that
# swapped or dropped one fails
KV8_SCALES = {"int8": (4 / 127, 3.5 / 127), "e4m3": (1 / 64, 1 / 80)}


def _attention_case(name, kind, q_lens, ctx, qh, kvh, window, cap,
                    dtype, seed, pages_per_seq=0, timed=True, hd=GEMMA_HD,
                    kv8=None, sinks=False, alibi=False,
                    q_scale=GEMMA_Q_SCALE) -> dict:
    """One K1 (``kind`` "decode") or K2 ("prefill") case at ``hd``, q
    scaled by ``GEMMA_Q_SCALE``, held against its plain version (bf16
    2e-2, float32 1e-4, as ``allclose`` and against tol x max |plain|);
    the plain version without the soft cap, and without the window, must
    fail that check. ``kv8`` ("int8" or "e4m3"): the pool is quantized by
    ``KV8_SCALES`` and the plain version without either scale must fail
    the check too. ``sinks``: a per-head sink logit (1 to 5) joins every
    softmax; ``alibi``: the ALiBi slopes of ``qh`` heads (the models'
    ``alibi_slopes``); the plain version without either must fail the
    check. The page table has the
    engine's ``pages_per_seq`` columns, so that K1's ``max_kv_len`` hint
    and split count are the serving launch's. With ``timed``: timed
    beside the plain version and one SDPA call on the KV gathered to the
    longest row (dequantized to q's type beforehand from an 8-bit pool)
    under an explicit mask of each row's causal and window limits, and
    from an 8-bit pool beside the same kernel on the bf16 pool it was
    quantized from (``bf16_pool_ms``). SDPA has no soft cap: with one,
    its call computes the same attention without the cap, and is held
    against the plain version without it (``library_computes``); ALiBi
    enters SDPA as a float mask of the bias; a sink enters as one more
    key, a zero key and value whose mask column holds the sink logit. The
    bound counts the KV positions the rows can see (the window's, not the
    row's), each read once at the pool's element size, and the operations
    at the type's peak (bf16 tensor cores, float32 CUDA cores)."""
    import torch
    import torch.nn.functional as F
    from tensorrt_llm_tpu_torch.ops.attention import quantize_kv
    from tensorrt_llm_tpu_torch.ops.cuda import decode_attention as dec
    from tensorrt_llm_tpu_torch.ops.cuda import prefill_attention as pre
    from tensorrt_llm_tpu_torch.tools.card_timing import (PAGE, dense_kv,
                                                          make_case,
                                                          time_ms)
    q, pool, kv_lens, pt, cu = make_case(q_lens, ctx, qh, kvh, hd, seed=seed,
                                         dtype=dtype,
                                         pages_per_seq=pages_per_seq)
    q.mul_(q_scale)
    kvs = [c + n for c, n in zip(ctx, q_lens)]
    kw = dict(sm_scale=hd ** -0.5, sliding_window=window, soft_cap=cap)
    if sinks:
        kw["sinks"] = torch.linspace(1.0, 5.0, qh, device="cuda")
    if alibi:
        from tensorrt_llm_tpu_torch.models.modeling_utils import \
            alibi_slopes
        kw["alibi_slopes"] = alibi_slopes(qh)
    tol = TOL if dtype == torch.bfloat16 else 1e-4
    wide_pool = pool
    if kv8:
        kdt = {"int8": torch.int8, "e4m3": torch.float8_e4m3fn}[kv8]
        ks, vs = (torch.tensor(v, dtype=torch.float32, device="cuda")
                  for v in KV8_SCALES[kv8])
        pool = torch.empty(pool.shape, dtype=kdt, device="cuda")
        pool[:, :, 0::2] = quantize_kv(wide_pool[:, :, 0::2], ks, kdt)
        pool[:, :, 1::2] = quantize_kv(wide_pool[:, :, 1::2], vs, kdt)
        kw.update(k_scale=ks, v_scale=vs)
    S, mq = len(q_lens), max(q_lens)
    if kind == "decode":
        reach = pt.shape[1] * PAGE
        # the engine's hint (_kv_bound): a power of two, capped at reach
        hint = min(1 << (max(kvs) - 1).bit_length(), reach)

        def kernel(pool=pool, kw=kw):
            return dec.paged_decode_attention(q, pool, kv_lens, pt,
                                              max_kv_len=hint, **kw)

        def plain(**o):
            return dec.paged_decode_attention_plain(q, pool, kv_lens, pt,
                                                    **{**kw, **o})
        extra = dict(max_kv_len_hint=hint,
                     splits=dec.splits_for(S, qh, kvh, reach, hint, window,
                                           q.device))
    else:
        def kernel(pool=pool, kw=kw):
            return pre.ragged_prefill_attention(q, pool, kv_lens, pt, cu,
                                                max_q_len=mq, **kw)

        def plain(**o):
            return pre.ragged_prefill_attention_plain(
                q, pool, kv_lens, pt, cu, **{**kw, **o})
        extra = dict(route=pre.route_for(dtype))
    got = kernel()
    ref = plain()
    torch.cuda.synchronize()
    err = _hold(name, got, ref, tol)
    lref = plain(soft_cap=None) if cap else ref
    if cap:
        extra["cap_effect"] = _sensitive(name, ref, lref, tol, "the cap")
    if window:
        extra["window_effect"] = _sensitive(
            name, ref, plain(sliding_window=None), tol, "the window")
    if kv8:
        for s_name in ("k_scale", "v_scale"):
            extra[f"{s_name}_effect"] = _sensitive(
                name, ref, plain(**{s_name: None}), tol, s_name)
    for opt in ("sinks", "alibi_slopes"):
        if opt in kw:
            extra[f"{opt}_effect"] = _sensitive(name, ref,
                                                plain(**{opt: None}), tol,
                                                opt)
    res = dict(shape=dict(seqs=S, q_lens=sorted(set(q_lens)),
                          kv_len=[min(kvs), max(kvs)], qh=qh, kvh=kvh, hd=hd,
                          page=PAGE, pages_per_seq=pt.shape[1],
                          window=window, soft_cap=cap, q_scale=q_scale,
                          sinks=sinks, alibi=alibi,
                          dtype=str(dtype).split(".")[-1],
                          kv=kv8 or str(dtype).split(".")[-1]),
               max_abs_err=err, max_abs_ref=ref.float().abs().max().item(),
               tol=tol, **extra)
    if not timed:
        del q, pool, wide_pool, kv_lens, pt, cu, got, ref, lref
        return res
    # what the rows can see: query i of a row at position p sees
    # max(0, p - window + 1) .. p
    pairs = seen = 0
    for c, n in zip(ctx, q_lens):
        lo_first = max(0, c - window + 1) if window else 0
        seen += c + n - lo_first
        for i in range(n):
            p = c + i
            pairs += p + 1 - (max(0, p - window + 1) if window else 0)
    el = q.element_size()
    flops = 4 * qh * hd * pairs
    io_bytes = seen * kvh * hd * 2 * pool.element_size() \
        + 2 * q.numel() * el + pt.numel() * 4 \
        + (S + 1) * 4 * (2 if kind == "prefill" else 1) + (8 if kv8 else 0) \
        + 4 * qh * (sinks + alibi)
    res.update(bytes=io_bytes, flops=flops, **_bound(
        io_bytes, flops, BF16_FLOPS if dtype == torch.bfloat16
        else F32_FLOPS))
    res["ms"] = time_ms(kernel, 30)
    res["plain_ms"] = time_ms(plain, 5)
    res["bound_share"] = res["bound_ms"] / res["ms"]
    if kv8:
        no_scale = {k: v for k, v in kw.items() if "scale" not in k
                    or k == "sm_scale"}
        res["bf16_pool_ms"] = time_ms(lambda: kernel(wide_pool, no_scale),
                                      30)
    # one SDPA call over the gathered KV, queries padded to the
    # longest segment, an explicit mask of each row's limits
    Lq, Lk = mq, max(kvs)
    dev = q.device
    if kv8:
        # the 8-bit KV gathered by its bytes, then dequantized to q's type
        k, v = dense_kv(pool.view(torch.uint8), pt, kvh, hd, Lk)
        k = dec.dequant_kv(k.view(pool.dtype), ks, dtype)
        v = dec.dequant_kv(v.view(pool.dtype), vs, dtype)
    else:
        k, v = dense_kv(pool, pt, kvh, hd, Lk)
    nq = torch.tensor(q_lens, device=dev)
    seq = torch.repeat_interleave(torch.arange(S, device=dev), nq)
    row = torch.cat([torch.arange(n, device=dev) for n in q_lens])
    qp = torch.zeros((S, Lq, qh, hd), dtype=dtype, device=dev)
    qp[seq, row] = q
    qp = qp.transpose(1, 2).contiguous()
    qpos = (torch.tensor(kvs, device=dev) - nq)[:, None] \
        + torch.arange(Lq, device=dev)[None]
    kpos = torch.arange(Lk, device=dev)[None, None]
    mask = kpos <= qpos[:, :, None]
    if window:
        mask &= kpos > qpos[:, :, None] - window
    mask[:, :, 0] |= ~mask.any(-1)            # padding rows: see one
    mask = mask[:, None]
    if alibi:
        slopes = torch.tensor(kw["alibi_slopes"], device=dev)
        mask = torch.where(
            mask, slopes[None, :, None, None]
            * (kpos - qpos[:, :, None])[:, None].float(),
            float("-inf")).to(dtype)
    if sinks:
        # the sink as one more key: a zero key and value whose mask column
        # holds the head's sink logit, so exp(sink) joins each denominator
        # and adds nothing to the sum of values
        k, v = (torch.cat([x, x.new_zeros(x.shape[:2] + (1, hd))], 2)
                for x in (k, v))
        if mask.dtype == torch.bool:
            mask = torch.zeros(mask.shape, dtype=dtype, device=dev) \
                .masked_fill(~mask, float("-inf"))
        mask = mask.expand(S, qh, Lq, Lk)
        mask = torch.cat([mask, kw["sinks"].to(dtype)[None, :, None, None]
                          .expand(S, qh, Lq, 1)], -1)
    # fresh prompts of one length and no window: the causal flag alone
    # (SDPA's fast backends take it; an explicit mask may not)
    causal = not window and not alibi and not sinks and not any(ctx) and \
        len(set(q_lens)) == 1

    def sdpa():
        return F.scaled_dot_product_attention(
            qp, k, v, attn_mask=None if causal else mask,
            is_causal=causal, scale=kw["sm_scale"], enable_gqa=True)
    lib = sdpa().transpose(1, 2)[seq, row]
    torch.cuda.synchronize()
    if alibi:
        # the bias rounds to bf16 in SDPA's mask (to 1 at a distance of
        # 256 and slope 1), which the check is not meant for: reported
        lib_err = (lib.float() - lref.float()).abs().max().item()
        computes = "the same function, the ALiBi bias rounded to bf16 " \
            "in its mask"
    else:
        lib_err = _hold(name, lib, lref, tol, "library")
        computes = "the same function" if not cap else \
            "the same attention without the soft cap"
        if sinks:
            computes += ", the sink as a zero key whose mask column " \
                "holds the sink logit (rounded to q's type)"
    res.update(library_ms=time_ms(sdpa, 10), library_max_abs_err=lib_err,
               library_computes=computes)
    del k, v, qp, mask, lib
    emit({"phase": "kernels", "case": name, **res})
    del q, pool, wide_pool, kv_lens, pt, cu, got, ref, lref
    torch.cuda.empty_cache()
    return res


# the engines' page-table widths: max_seq_len 8,192 (Gemma-2-9B) and
# 1,152 (Gemma-3-1B) over pages of 32
PAGES_9B, PAGES_1B = 256, 36
# gemma_serving's depth of Gemma-2-9B: 12 of its 42 layers (even, as
# VSWA's strict alternation needs), to keep the script inside its time
# budget; every layer has the full width
GEMMA2_9B_LAYERS = 12


def gemma_kernel_phase(results: dict) -> None:
    """K1 and K2 at hd 256 at the shapes gemma_serving launches them with
    (16 rows at 6,145-6,208 KV; the first eager prefill step, one fresh
    6,144-token prompt; Gemma-2-9B's 16 q heads over 8 KV heads, soft cap
    50), each once on a global layer and once on a sliding one (window
    4,096), Gemma-3-1B's group 4 over one KV head (window 512, no cap: 32
    rows at 1,025-1,088 KV; a 4,096-token prefill step of 4 prompts), and
    float32 cases of both kernels held to 1e-4. The other eager steps are
    held after gemma_serving, which records them (``gemma_step_phase``)."""
    import torch
    bf, f32 = torch.bfloat16, torch.float32
    rows9 = [6145 + (63 * i) // 15 for i in range(16)]
    rows1 = [1025 + (63 * i) // 31 for i in range(32)]
    for args, pages in [
            (("decode_gemma2_9b", "decode", [1] * 16, [k - 1 for k in rows9],
              16, 8, None, 50.0, bf, 41), PAGES_9B),
            (("decode_gemma2_9b_window", "decode", [1] * 16,
              [k - 1 for k in rows9], 16, 8, 4096, 50.0, bf, 42), PAGES_9B),
            (("prefill_gemma2_9b", "prefill", [6144], [0], 16, 8, None, 50.0,
              bf, 43), PAGES_9B),
            (("prefill_gemma2_9b_window", "prefill", [6144], [0], 16, 8,
              4096, 50.0, bf, 44), PAGES_9B),
            (("decode_gemma3_1b", "decode", [1] * 32, [k - 1 for k in rows1],
              4, 1, 512, None, bf, 45), PAGES_1B),
            (("prefill_gemma3_1b", "prefill", [1024] * 4, [0] * 4, 4, 1, 512,
              None, bf, 46), PAGES_1B),
            (("decode_float32_hd256", "decode", [1] * 4, [699, 32, 1499, 0],
              16, 8, 512, 50.0, f32, 47), 0),
            (("prefill_float32_hd256", "prefill", [300, 1, 70],
              [0, 900, 500], 16, 8, 256, 50.0, f32, 48), 0)]:
        results[args[0]] = _attention_case(*args, pages_per_seq=pages)


def gemma_step_phase(results: dict, steps: dict) -> None:
    """K2 held against plain at every distinct eager step that
    gemma_serving recorded (``steps``: run -> [(q_lens, ctx), ...]),
    global and sliding for Gemma-2-9B, sliding and global for Gemma-3-1B,
    and timed at the 9B step past a fresh prompt with the most attention
    pairs (``prefill_gemma2_9b_step`` and its ``_window`` twin). Fails if
    a run recorded no step besides a fresh prompt."""
    import torch
    bf = torch.bfloat16
    geo = {"vswa": (16, 8, 4096, 50.0, PAGES_9B),
           "gemma3_1b": (4, 1, 512, None, PAGES_1B)}
    checked, later9 = {}, []
    for run, (qh, kvh, window, cap, pages) in geo.items():
        shapes = list(dict.fromkeys(
            (tuple(q), tuple(c)) for q, c in steps[run]))
        later = [sh for sh in shapes if any(sh[1]) or len(sh[0]) > 1]
        if not later:
            raise AssertionError(f"gemma_steps {run}: no eager step past a "
                                 f"fresh prompt: {shapes}")
        if run == "vswa":
            later9 = later
        errs = []
        for i, (q, c) in enumerate(shapes):
            for w in (None, window):
                r = _attention_case(f"step_{run}_{i}", "prefill", list(q),
                                       list(c), qh, kvh, w, cap, bf, 60 + i,
                                       pages_per_seq=pages, timed=False)
                errs.append(r["max_abs_err"])
        checked[run] = dict(distinct_steps=len(shapes), checks=len(errs),
                            max_abs_err=max(errs), steps=[
                                dict(q_lens=list(q), ctx=list(c))
                                for q, c in shapes])
    emit({"phase": "gemma_steps", **checked})

    def pairs(sh):
        return sum(n * c + n * (n + 1) // 2 for n, c in zip(*sh))
    q, c = max(later9, key=pairs)
    for name, w in (("prefill_gemma2_9b_step", None),
                    ("prefill_gemma2_9b_step_window", 4096)):
        results[name] = _attention_case(
            name, "prefill", list(q), list(c), 16, 8, w, 50.0, bf, 70,
            pages_per_seq=PAGES_9B)


def _save_tiny_gemma(path: Path, kind: str, hd: int) -> None:
    """A tiny random ``transformers`` Gemma 2 or Gemma 3 (hidden 256, 4
    q heads over 2 KV heads of ``hd``, intermediate 512, vocab 512, 4 or
    6 layers, window 32) saved to ``path``, its norms redrawn at std 0.3
    so that Gemma's (1 + w) offsets matter."""
    import torch
    import transformers as tf
    base = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                num_attention_heads=4, num_key_value_heads=2, head_dim=hd,
                query_pre_attn_scalar=hd, sliding_window=32,
                max_position_embeddings=512)
    if kind == "gemma2":
        cfg = tf.Gemma2Config(num_hidden_layers=4, **base)
        cls = tf.Gemma2ForCausalLM
    else:
        cfg = tf.Gemma3TextConfig(num_hidden_layers=6, **base)
        cls = tf.Gemma3ForCausalLM
    torch.manual_seed(31)
    model = cls(cfg).float()
    gen = torch.Generator().manual_seed(32)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    model.save_pretrained(path)


def gemma_parity_phase() -> dict:
    """Tiny Gemma 2 (one pool, and VSWA with window 32) and Gemma 3
    checkpoints at hd 256 and hd 64 (the card's kernels take hd 64, 128
    and 256) through ``LLM.generate``, the card against the port's CPU
    plain path: greedy tokens identical in float32, in bf16 a parting only
    where the CPU run decides by less than ``_compare_streams``' margin.
    The card runs must launch K1 and K2."""
    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig, SamplingParams
    prompts = [list(range(2, 100)), [5, 17, 99, 3, 64, 12, 7] * 6,
               [101, 2, 33, 400, 7], list(range(300, 240, -1))]
    n_out = 40
    sp = SamplingParams(max_tokens=n_out, top_k=1, ignore_eos=True,
                        logprobs=2)
    res = {}

    def run(path, device, dtype, vswa):
        kv = dict(tokens_per_block=16, max_tokens=4096)
        if vswa:
            kv["max_attention_window"] = [32, 256]
        llm = LLM(str(path), device=device, dtype=dtype,
                  skip_tokenizer_init=True, max_batch_size=4,
                  max_input_len=128, max_seq_len=256, max_num_tokens=128,
                  kv_cache_config=KvCacheConfig(**kv))
        _zero_launches()
        try:
            outs = llm.generate(prompts, sp)
            launches = _read_launches()
            trimmed = getattr(llm.kv_cache_manager, "trimmed_blocks", 0)
        finally:
            llm.shutdown()
        toks = [o.outputs[0].token_ids for o in outs]
        if any(len(t) != n_out for t in toks):
            raise AssertionError(f"gemma_parity {path.name} {device}: short")
        return toks, [o.outputs[0].logprobs for o in outs], launches, trimmed

    with tempfile.TemporaryDirectory() as tmp:
        for kind, hd, vswa in [("gemma2", 256, False), ("gemma2", 256, True),
                               ("gemma2", 64, False), ("gemma2", 64, True),
                               ("gemma3_text", 256, False),
                               ("gemma3_text", 64, False)]:
            path = Path(tmp) / f"{kind}_{hd}"
            if not path.exists():
                _save_tiny_gemma(path, kind, hd)
            for dtype in ("float32", "bfloat16"):
                cpu = run(path, "cpu", dtype, vswa)
                card = run(path, "cuda", dtype, vswa)
                cmp = _compare_streams(cpu[:2], card[:2])
                name = f"{kind}_hd{hd}{'_vswa' if vswa else ''}_{dtype}"
                if dtype == "float32" and card[0] != cpu[0]:
                    raise AssertionError(f"gemma_parity {name}: card "
                                         f"{card[0]} != cpu {cpu[0]}")
                if cmp["unexplained_partings"]:
                    raise AssertionError(f"gemma_parity {name}: a parting "
                                         f"above the near-tie margin: {cmp}")
                if min(card[2]["paged_decode_attention"],
                       card[2]["ragged_prefill_attention"]) <= 0:
                    raise AssertionError(f"gemma_parity {name}: K1 or K2 "
                                         f"never launched: {card[2]}")
                if vswa and not card[3]:
                    raise AssertionError(f"gemma_parity {name}: no sliding "
                                         "block was released")
                res[name] = dict(kind=kind, hd=hd, vswa=vswa, dtype=dtype,
                                 identical=card[0] == cpu[0],
                                 launches=card[2], trimmed_blocks=card[3],
                                 **cmp)
                emit({"phase": "gemma_parity", **res[name]})
    return res


def _record_eager_steps(eng) -> list:
    """Record (q_lens, ctx) of every eager step ``eng`` prepares (a step
    whose longest query segment is more than one token) into the returned
    list, until ``del eng.prepare_inputs``."""
    import numpy as np
    steps, real = [], eng.prepare_inputs

    def spy(batch):
        inp = real(batch)
        if inp.max_q_len > 1:
            n = inp.num_reqs
            q = np.diff(inp.cu_q_lens[:n + 1])
            steps.append((q.tolist(), (inp.kv_lens[:n] - q).tolist()))
        return inp
    eng.prepare_inputs = spy
    return steps


def gemma_serving_phase() -> dict:
    """Gemma-2-9B at its published width, 12 of its 42 layers
    (``GEMMA2_9B_LAYERS``; seeded random bf16 weights, 7.0 GB), 16
    requests of 6,144 prompt tokens ->
    64 greedy tokens with ``ignore_eos`` (max_seq_len 8,192; one prompt
    per prefill step), measured by tools/serving_profile.py
    (``--geometry gemma2-9b [--vswa]``), twice: with VSWA
    (``max_attention_window=[4096, 8192]``: the 21 sliding layers on a
    pool of their own) and with one pool (without its profiled pass, for
    the script's time budget). Per run: tok/s, TTFT, TPOT, device idle
    share and GPU time by class (VSWA), each pool's pages, tokens and
    bytes, sliding blocks released over the passes, launches and
    replays, graph keys. Then the first 8 tokens of every stream of the
    two runs (logprobs on, so single steps): identical, or parted only
    where the one-pool run decides by less than ``_compare_streams``'
    margin. Last, Gemma-3-1B at full width (26 layers, 4 x 256 q heads
    over 1 KV head, window 512 on five layers of six), 32 x 1,024 -> 64,
    one pool, without the profiled pass. Prefix reuse is off in every
    run (each pass prefills afresh). Each run records the (q_lens, ctx)
    of its eager steps (``eager_steps``) for ``gemma_step_phase``. Fails
    if a request comes back short or out of the
    vocabulary, if K1 or K2 never launched, if no window replayed K1, or
    if the graph pool outgrew its reserve."""
    import gc

    import torch
    from tensorrt_llm_tpu_torch import LLM, SamplingParams
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    out, first8 = {}, {}
    for label, geometry, vswa in [("vswa", "gemma2-9b", True),
                                  ("single_pool", "gemma2-9b", False),
                                  ("gemma3_1b", "gemma3-1b", False)]:
        cfg, kwargs, prompts, sp = sprof.workload(geometry=geometry,
                                                  vswa=vswa)
        if geometry == "gemma2-9b":
            cfg = type(cfg)(**{**sprof.GEMMA2_9B,
                               "num_hidden_layers": GEMMA2_9B_LAYERS})
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        llm = LLM(cfg, dtype="bfloat16", **kwargs)
        build_s = time.monotonic() - t0
        try:
            eng = llm.engine
            weights_bytes = sum(t.numel() * t.element_size()
                                for t in _tensors(eng.params))
            replayed0 = eng.graphs.replayed_launches()
            mgr = llm.kv_cache_manager
            trimmed0 = getattr(mgr, "trimmed_blocks", 0)
            steps = _record_eager_steps(eng)
            # Gemma-3-1B's run shows it serves, and the one-pool run is
            # held against the VSWA run: their profiles are left out to
            # keep the script inside its time budget (since kv_serving)
            try:
                res = sprof.measure(llm, prompts, sp, profile=label == "vswa")
            finally:
                del eng.prepare_inputs
            trimmed = getattr(mgr, "trimmed_blocks", 0) - trimmed0
            graphs = _graph_stats(eng)
            graphs["replayed_launches"] = {
                k: v - replayed0[_kernel_counts()[k].__name__]
                for k, v in graphs["replayed_launches"].items()}
            graphs["keys"] = [str(k) for k in eng.graphs.steps]
            reserve = eng.graph_pool_reserve()
            ps = eng.page_size
            pools = dict(global_pages=eng.num_kv_pages,
                         global_tokens=eng.num_kv_pages * ps,
                         global_bytes=eng.num_kv_pages
                         * eng.bytes_per_kv_block,
                         global_layers=eng._pool_layers,
                         sliding_pages=eng.num_sw_pages,
                         sliding_tokens=eng.num_sw_pages * ps,
                         sliding_bytes=eng.num_sw_pages
                         * eng.bytes_per_kv_block if eng._vswa else 0)
            if geometry == "gemma2-9b":
                f8 = llm.generate(prompts, SamplingParams(
                    max_tokens=8, top_k=1, ignore_eos=True, logprobs=2))
                first8[label] = ([o.outputs[0].token_ids for o in f8],
                                 [o.outputs[0].logprobs for o in f8])
            outs = llm.generate(prompts[:2], sp)
        finally:
            llm.shutdown()
        peak = torch.cuda.max_memory_allocated()
        del llm, eng, mgr          # the next run sizes its pools from what
        gc.collect()               # is free
        torch.cuda.empty_cache()
        V = cfg.vocab_size
        for o in outs:
            toks = o.outputs[0].token_ids
            if len(toks) != sp.max_tokens or not all(0 <= t < V
                                                     for t in toks):
                raise AssertionError(f"gemma_serving {label}: bad output")
        if res["output_tokens"] != len(prompts) * sp.max_tokens:
            raise AssertionError(f"gemma_serving {label}: "
                                 f"{res['output_tokens']} tokens")
        res.update(run=label, layers=cfg.num_hidden_layers,
                   engine_build_s=build_s, weights_bytes=weights_bytes,
                   peak_allocated_bytes=peak, pools=pools,
                   eager_steps=steps,
                   sliding_blocks_released=trimmed,
                   graph_pool_reserve_bytes=reserve, graphs=graphs)
        emit({"phase": "gemma_serving", **res})
        if min(res["launches"][k] for k in ("paged_decode_attention",
                                            "ragged_prefill_attention")) <= 0:
            raise AssertionError(f"gemma_serving {label}: K1 or K2 never "
                                 f"launched: {res['launches']}")
        if not graphs["replayed_launches"]["paged_decode_attention"]:
            raise AssertionError(f"gemma_serving {label}: no window "
                                 f"replayed K1: {graphs}")
        if vswa and not trimmed:
            raise AssertionError("gemma_serving: no sliding block released")
        _check_reserve(res)
        out[label] = res
    cmp = _compare_streams(first8["single_pool"], first8["vswa"])
    emit({"phase": "gemma_serving_streams", "tokens_each": 8,
          "identical": first8["single_pool"][0] == first8["vswa"][0], **cmp})
    if cmp["unexplained_partings"]:
        raise AssertionError(f"gemma_serving: VSWA and one pool part above "
                             f"the near-tie margin: {cmp}")
    return out


# --------------------------------------------------------------------- #
# The quantized KV cache: K1 and K2 on 8-bit pools, Llama-3-8B on FP8
# --------------------------------------------------------------------- #
# Llama-3-8B's page table in kv_serving: max_seq_len 2,048 + 2,048 (the
# LLM defaults) over pages of 32
PAGES_8B = 128


def _kv_scales(llm):
    """The per-layer KV scales of an engine's layers."""
    return [float(layer["kv_scale"]) for layer in llm.engine.params["layers"]]


def kv_quant_parity_phase(repo: Path) -> dict:
    """tests/assets/tinycode-llama in float32 on INT8, FP8 and NVFP4 KV
    pools through ``LLM.generate``, the card (K1 and K2 on the 8-bit pool,
    windows replayed from graphs captured at build) against the CPU (the
    plain versions), the CPU's calibrated scales written into the card
    engine's scale tensors in place after its graphs were captured.
    Greedy tokens must be identical wherever the CPU run decides by more
    than ``NEAR_TIE`` in log-probability; the card must have launched K1
    and K2 and replayed windows."""
    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig, SamplingParams
    from tensorrt_llm_tpu_torch.llmapi.llm_args import QuantConfig
    from tensorrt_llm_tpu_torch.quantization.mode import KvCacheQuantAlgo
    prompts = [list(b"def forward(self, x):\n    return "),
               list(b"import torch\n"), list(range(32, 120)),
               list(range(3, 40))]
    out = {}
    for algo in ("INT8", "FP8", "NVFP4"):
        runs = {}
        for dev in ("cpu", "cuda"):
            llm = LLM(repo / "tests" / "assets" / "tinycode-llama",
                      device=dev, dtype="float32", skip_tokenizer_init=True,
                      max_batch_size=8, max_input_len=128, max_seq_len=256,
                      max_num_tokens=512,
                      quant_config=QuantConfig(
                          kv_cache_quant_algo=KvCacheQuantAlgo[algo]),
                      kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                                    max_tokens=4096))
            try:
                if dev == "cpu":
                    scales = _kv_scales(llm)
                else:
                    card_own = _kv_scales(llm)
                    for layer, sc in zip(llm.engine.params["layers"],
                                         scales):
                        layer["kv_scale"].fill_(sc)
                    _zero_launches()
                    replays0 = llm.engine.graphs.replays
                outs = llm.generate(prompts, SamplingParams(
                    max_tokens=32, top_k=1, ignore_eos=True,
                    logprobs=2 if dev == "cpu" else None))
                runs[dev] = ([o.outputs[0].token_ids for o in outs],
                             [o.outputs[0].logprobs for o in outs])
                if dev == "cuda":
                    launches = _read_launches()
                    replays = llm.engine.graphs.replays - replays0
                    pool = llm.engine.kv_pages
            finally:
                llm.shutdown()
        margins = []
        for a_row, a_lps, b_row in zip(runs["cpu"][0], runs["cpu"][1],
                                       runs["cuda"][0]):
            for a, b, alp in zip(a_row, b_row, a_lps):
                if a != b:
                    top = sorted(alp.values(), reverse=True)
                    margins.append(top[0] - top[1])
                    break
        res = dict(algo=algo, pool=str(pool.dtype).split(".")[-1],
                   identical=runs["cpu"][0] == runs["cuda"][0],
                   parting_margins=margins, scales=[min(scales), max(scales)],
                   card_calibration_max_rel_diff=max(
                       abs(a - b) / b for a, b in zip(card_own, scales)),
                   launches=launches, graph_replays=replays)
        emit({"phase": "kv_quant_parity", **res})
        if any(m > NEAR_TIE for m in margins):
            raise AssertionError(f"kv_quant_parity {algo}: the card parts "
                                 f"from the CPU above the near-tie: {res}")
        if min(launches[k] for k in ("paged_decode_attention",
                                     "ragged_prefill_attention")) <= 0 \
                or not replays:
            raise AssertionError(f"kv_quant_parity {algo}: K1 or K2 never "
                                 f"launched, or no graph replayed: {res}")
        out[algo] = res
    return out


def _pool_nans(pools) -> int:
    """NaN entries of a KV pool (or of each VSWA pool), counted one layer
    at a time (a bool mask of the whole pool would not fit beside it);
    e4m3 NaNs by their bytes (0x7f, 0xff)."""
    import torch
    n = 0
    for pool in pools if isinstance(pools, tuple) else (pools,):
        for layer in pool:
            if layer.dtype == torch.float8_e4m3fn:
                n += int(((layer.view(torch.uint8) & 0x7F) == 0x7F).sum())
            elif layer.is_floating_point():
                n += int(torch.isnan(layer).sum())
    return n


def kv_serving_phase() -> dict:
    """Llama-3-8B at its published width and 16 of its 32 layers
    (``KV_SERVING_LAYERS``, a depth cut for the script's time budget;
    seeded random bf16 weights), 64 requests of 2,048 prompt tokens ->
    128 greedy tokens with ``ignore_eos``, ``LLM`` defaults but prefix
    reuse off, measured by tools/serving_profile.py (``--geometry
    llama3-8b --kv fp8``): on an FP8 pool, scales calibrated at build
    (the bf16 pool, ``--geometry llama3-8b``, and an INT8 pool, ``--kv
    int8``, are left out here to keep the script inside its time
    budget, and its profiled pass too).
    Per run: tok/s, TTFT and TPOT (median, max), the pool's pages,
    tokens and bytes, the calibrated
    scales' range, launches and replays, and the (q_lens, ctx) of its
    eager steps. Fails if a request comes back short, if the pool or the
    returned log-probabilities hold a NaN, if K1 or K2 never launched, if
    no window replayed K1, or if the graph pool outgrew its reserve."""
    import gc

    import torch
    from tensorrt_llm_tpu_torch import LLM
    from tensorrt_llm_tpu_torch.llmapi.llm_args import QuantConfig
    from tensorrt_llm_tpu_torch.quantization.mode import KvCacheQuantAlgo
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    out = {}
    for label, algo in (("fp8", "FP8"),):
        cfg, kwargs, prompts, sp = sprof.workload(geometry="llama3-8b")
        cfg.num_hidden_layers = KV_SERVING_LAYERS
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        llm = LLM(cfg, dtype="bfloat16", quant_config=QuantConfig(
            kv_cache_quant_algo=KvCacheQuantAlgo[algo]), **kwargs)
        build_s = time.monotonic() - t0
        try:
            eng = llm.engine
            weights_bytes = sum(t.numel() * t.element_size()
                                for t in _tensors(eng.params))
            scales = _kv_scales(llm) if algo != "NO_QUANT" else [1.0]
            replayed0 = eng.graphs.replayed_launches()
            steps = _record_eager_steps(eng)
            try:
                res = sprof.measure(llm, prompts, sp, profile=False)
            finally:
                del eng.prepare_inputs
            graphs = _graph_stats(eng)
            graphs["replayed_launches"] = {
                k: v - replayed0[_kernel_counts()[k].__name__]
                for k, v in graphs["replayed_launches"].items()}
            reserve = eng.graph_pool_reserve()
            ps = eng.page_size
            pool = dict(dtype=str(eng.kv_pages.dtype).split(".")[-1],
                        pages=eng.num_kv_pages, tokens=eng.num_kv_pages * ps,
                        bytes=eng.num_kv_pages * eng.bytes_per_kv_block,
                        bytes_per_token=eng.bytes_per_kv_block // ps)
            nans = _pool_nans(eng.kv_pages)
        finally:
            llm.shutdown()
        peak = torch.cuda.max_memory_allocated()
        del llm, eng
        gc.collect()
        torch.cuda.empty_cache()
        res.update(run=label, kv_cache_quant_algo=algo, model="Llama-3-8B",
                   layers=cfg.num_hidden_layers, engine_build_s=build_s,
                   weights_bytes=weights_bytes, peak_allocated_bytes=peak,
                   pool=pool, scales=[min(scales), max(scales)],
                   pool_nans=nans, eager_steps=steps,
                   graph_pool_reserve_bytes=reserve, graphs=graphs)
        emit({"phase": "kv_serving", **res})
        if res["output_tokens"] != len(prompts) * sp.max_tokens \
                or res["min_output_tokens"] != sp.max_tokens:
            raise AssertionError(f"kv_serving {label}: short outputs")
        if nans or res["nonfinite_logprobs"] or not res["logprobs_recorded"]:
            raise AssertionError(f"kv_serving {label}: NaN in the pool "
                                 f"({nans}) or in the logprobs")
        if min(res["launches"][k] for k in ("paged_decode_attention",
                                            "ragged_prefill_attention")) <= 0:
            raise AssertionError(f"kv_serving {label}: K1 or K2 never "
                                 f"launched: {res['launches']}")
        if not graphs["replayed_launches"]["paged_decode_attention"]:
            raise AssertionError(f"kv_serving {label}: no window replayed "
                                 f"K1: {graphs}")
        _check_reserve(res)
        out[label] = res
    return out


def kv_quant_kernel_phase(results: dict, first_step) -> None:
    """K1 and K2 on int8 and e4m3 pools against their plain versions
    (``_attention_case`` with ``kv8``: q scaled by 8, bf16 held to 2e-2
    and to 2e-2 x max |plain|, the plain version without either scale must
    fail that check): at kv_serving's shapes, K1 on 64 rows at 2,049-2,176
    KV (32 x 128 q heads over 8 KV heads, the engine's 128-column page
    table) and K2 at kv_serving's first eager prefill step
    (``first_step``, (q_lens, ctx)), each timed beside its plain version,
    the same kernel on the bf16 pool it was quantized from, and one SDPA
    call on the KV gathered and dequantized beforehand, the bound by this
    run's 8-bit bytes; then one case at hd 64 (K1, int8) and one at hd 256
    (K2, e4m3, window 512 and soft cap 50), and float32 cases of both held
    to 1e-4."""
    import torch
    bf, f32 = torch.bfloat16, torch.float32
    rows = [2049 + (127 * i) // 63 for i in range(64)]
    q_lens, ctx = first_step
    cases = []
    for kv8 in ("int8", "e4m3"):
        cases += [
            (f"decode_kv_{kv8}", "decode", [1] * 64, [k - 1 for k in rows],
             32, 8, None, None, bf, 90, PAGES_8B, True, 128, kv8),
            (f"prefill_kv_{kv8}", "prefill", list(q_lens), list(ctx), 32, 8,
             None, None, bf, 91, PAGES_8B, True, 128, kv8)]
    cases += [
        ("decode_kv_int8_hd64", "decode", [1] * 32, [1023] * 32, 32, 4,
         None, None, bf, 92, 0, False, 64, "int8"),
        ("prefill_kv_e4m3_hd256", "prefill", [1024, 1], [0, 700], 16, 8,
         512, 50.0, bf, 93, 0, False, 256, "e4m3"),
        ("decode_kv_float32", "decode", [1] * 4, [699, 32, 1499, 0], 32, 8,
         512, 50.0, f32, 94, 0, False, 128, "e4m3"),
        ("prefill_kv_float32", "prefill", [300, 1, 70], [0, 900, 500], 32,
         8, None, None, f32, 95, 0, False, 128, "int8")]
    for (name, kind, ql, cx, qh, kvh, window, cap, dtype, seed, pages,
         timed, hd, kv8) in cases:
        r = _attention_case(name, kind, ql, cx, qh, kvh, window, cap, dtype,
                            seed, pages_per_seq=pages, timed=timed, hd=hd,
                            kv8=kv8)
        if not timed:
            emit({"phase": "kernels", "case": name, **r})
        results[name] = r


def host_spec_parity_phase(repo: Path) -> dict:
    """Host drafting on the parity checkpoint (tests/assets/tinycode-llama,
    float32), 6 prompts with repeated structure -> 32 greedy tokens, on
    the card and on the CPU: no speculation, NGRAM (d = 3), SA,
    DRAFT_TARGET with the checkpoint as its own draft model, PARD with it
    and mask token 0. Every mode's tokens equal the run without
    speculation on both devices; DRAFT_TARGET accepts more than 0.9 of
    its drafts; on the card the verify steps without prompt tokens replay
    graphs (none runs eagerly)."""
    from tensorrt_llm_tpu_torch import (LLM, KvCacheConfig, SamplingParams,
                                        SpeculativeConfig)
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    ckpt = repo / "tests" / "assets" / "tinycode-llama"
    prompts = [list(b"def add(a, b):\n    return a + b\n\n\ndef sub(a, b):"
                    b"\n    return "),
               list(b"for i in range(10):\n    print(i)\nfor j in range("
                    b"10):\n    "),
               list(b"x = [1, 2, 3]\ny = [1, 2, 3]\nz = ["),
               list(b"abcabcabcabcabcabc"),
               list(b"self.a = a\nself.b = b\nself.c = "),
               list(b"if x:\n    y = 1\nif z:\n    y = ")]
    sp = SamplingParams(max_tokens=32, top_k=1, ignore_eos=True)
    modes = {"none": None,
             "NGRAM": dict(mode="NGRAM", max_draft_len=3),
             "SA": dict(mode="SA", max_draft_len=3),
             "DRAFT_TARGET": dict(mode="DRAFT_TARGET", max_draft_len=3,
                                  draft_model=str(ckpt)),
             "PARD": dict(mode="PARD", max_draft_len=3, draft_model=str(ckpt),
                          pard_mask_token_id=0)}
    out, ref = {}, None
    for mode, spec in modes.items():
        for device in ("cuda", "cpu"):
            llm = LLM(ckpt, device=device, dtype="float32",
                      skip_tokenizer_init=True, max_batch_size=8,
                      max_input_len=128, max_seq_len=256, max_num_tokens=512,
                      kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                                    max_tokens=8192),
                      speculative_config=None if spec is None
                      else SpeculativeConfig(**spec))
            try:
                toks = [o.outputs[0].token_ids
                        for o in llm.generate(prompts, sp)]
                stats = {} if spec is None else sprof.host_spec_summary(
                    sprof.host_spec_counts(llm))
            finally:
                llm.shutdown()
            ref = toks if ref is None else ref
            r = dict(identical=toks == ref, **stats)
            emit({"phase": "host_spec_parity", "mode": mode,
                  "device": device, **r})
            if toks != ref:
                raise AssertionError(f"host_spec_parity {mode} {device}: "
                                     f"tokens differ: {toks} vs {ref}")
            if spec is not None and not stats["drafted_rows"]:
                raise AssertionError(f"{mode} {device}: nothing drafted")
            if device == "cuda" and spec is not None and (
                    stats["verify_steps_eager_without_prompt"]
                    or not stats["verify_steps_replayed"]):
                raise AssertionError(f"{mode}: verify steps did not replay "
                                     f"graphs: {stats}")
            if mode == "DRAFT_TARGET" and stats["drafts_accepted"] <= \
                    0.9 * stats["drafts_proposed"]:
                raise AssertionError(f"DRAFT_TARGET on itself accepted "
                                     f"too little: {stats}")
            out[f"{mode}_{device}"] = r
    return out


# depth cuts of serving runs for the script's time budget: full width,
# fewer layers
HOST_SPEC_TARGET_LAYERS = 16
KV_SERVING_LAYERS = 16


def host_spec_serving_phase() -> dict:
    """Llama-3-8B at full width and 16 of its 32 layers
    (``HOST_SPEC_TARGET_LAYERS``, a depth cut for the script's time
    budget) on a bf16 pool (seeded random weights), 32 prompts of 512 tokens (a seeded 128-token segment
    repeated 4 times) -> 128 greedy tokens, ``LLM`` defaults but prefix
    reuse off (tools/serving_profile.py ``--geometry llama3-8b-copy``):
    without speculation and with DRAFT_TARGET (d = 4) drafting with
    Llama-3.2-1B (published config, seeded random weights); NGRAM
    (``--spec NGRAM``) is left out for the script's time budget. Each
    run: ``measure`` (warm-up, timed pass with the launch counters
    zeroed right before and read right after, profiled pass), peak
    allocated memory; the spec run also the drafter's counters, verify
    steps replayed and run eagerly, K1 / K2 launches of target and
    drafter, and its greedy streams against the run without speculation
    (``_compare_streams``, top-2 logprobs of that run: the run without
    speculation decodes in K-step windows, the spec run in single steps
    and verify steps, whose bf16 sums round in another order). Fails on a
    short output, an eager verify step without prompt tokens, a kernel
    the target or the drafter never launched, or a parting the run
    without speculation decides by more than max(3e-2, twice the
    measured logprob drift) (``unexplained_partings``)."""
    import gc

    import torch
    from tensorrt_llm_tpu_torch import LLM, SamplingParams
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    cfg, kwargs, prompts, sp = sprof.workload(geometry="llama3-8b-copy")
    cfg.num_hidden_layers = HOST_SPEC_TARGET_LAYERS
    sp_lp = SamplingParams(max_tokens=sp.max_tokens, top_k=1,
                           ignore_eos=True, logprobs=2)
    runs, streams = {}, {}
    for label, mode in (("none", None), ("DRAFT_TARGET", "DRAFT_TARGET")):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        extra = {} if mode is None else dict(
            speculative_config=sprof.spec_config(mode, 4))
        llm = LLM(cfg, dtype="bfloat16", **kwargs, **extra)
        build_s = time.monotonic() - t0
        try:
            eng = llm.engine
            # the drafting run without a profiled pass (time budget)
            res = sprof.measure(llm, prompts, sp, profile=mode is None)
            outs = llm.generate(prompts[:8], sp_lp if mode is None else sp)
            streams[label] = ([o.outputs[0].token_ids for o in outs],
                              [o.outputs[0].logprobs for o in outs])
            drafter = llm.executor.host_drafter
            res.update(engine_build_s=build_s, graphs=_graph_stats(eng),
                       graph_pool_reserve_bytes=eng.graph_pool_reserve(),
                       kv_pages=eng.num_kv_pages,
                       drafter_device_bytes=getattr(
                           drafter, "device_bytes", 0))
        finally:
            llm.shutdown()
        res.update(run=label, model="Llama-3-8B", draft_len=4 if mode else 0,
                   draft_model="Llama-3.2-1B" if mode == "DRAFT_TARGET"
                   else None, peak_allocated_bytes=torch.cuda
                   .max_memory_allocated())
        del llm, eng, drafter
        if mode is not None:
            res["streams_vs_none"] = _compare_streams(streams["none"],
                                                      streams[label])
        emit({"phase": "host_spec_serving", **res})
        if res["output_tokens"] != len(prompts) * sp.max_tokens:
            raise AssertionError(f"host_spec_serving {label}: short outputs")
        if res["nonfinite_logprobs"]:
            raise AssertionError(f"host_spec_serving {label}: NaN logprobs")
        if mode is not None:
            if res["verify_steps_eager_without_prompt"] or \
                    not res["verify_steps_replayed"]:
                raise AssertionError(f"{label}: verify steps without prompt "
                                     f"tokens ran eagerly: {res}")
            if res["streams_vs_none"]["unexplained_partings"]:
                raise AssertionError(f"{label}: streams part where the run "
                                     f"without speculation decides by more "
                                     f"than the measured noise allows: "
                                     f"{res['streams_vs_none']}")
        if mode == "DRAFT_TARGET":
            for who in ("launches_target", "launches_drafter"):
                if min(res[who][k] for k in ("paged_decode_attention",
                                             "ragged_prefill_attention")) <= 0:
                    raise AssertionError(f"DRAFT_TARGET: {who} lacks K1 or "
                                         f"K2: {res[who]}")
        _check_reserve(res)
        runs[label] = res
    return runs["DRAFT_TARGET"]


def host_spec_kernel_phase(results: dict) -> None:
    """K1 and K2 at the shapes host_spec_serving gives them: the target's
    verify step (``verify_host_8b``: K2, 32 sequences x 5 queries at
    513-640 KV, Llama-3-8B's 32 x 128 q heads over 8, the engine's
    128-column page table) and the drafter's chained steps
    (``decode_draft_1b``: K1, 32 rows at 513-640 KV, Llama-3.2-1B's 32 x
    64 over 8, its 128-column page table); each against its plain version
    (2e-2), its bound and one SDPA call on the gathered KV
    (``_attention_case``)."""
    import torch
    kvs = [513 + (127 * i) // 31 for i in range(32)]
    for name, kind, q, hd, seed in (
            ("verify_host_8b", "prefill", 5, 128, 96),
            ("decode_draft_1b", "decode", 1, 64, 97)):
        results[name] = _attention_case(
            name, kind, [q] * 32, [k - q for k in kvs], 32, 8, None, None,
            torch.bfloat16, seed, pages_per_seq=PAGES_8B, timed=True, hd=hd)


def _surface_runs(llm, sync: bool) -> dict:
    """surface_parity's requests through one ``LLM``: (tokens, prompt
    logprobs, beam hypotheses) by case."""
    import numpy as np
    from tensorrt_llm_tpu_torch import SamplingParams
    prompts = [list(b"def forward(self, x):\n    return "),
               list(b"abcabcabcabcabc"), list(b"import numpy as np\nimport ")]
    V = llm.model.vocab_size
    bias = np.random.default_rng(0).standard_normal(V).astype(np.float32)
    cases = dict(
        ngram=dict(no_repeat_ngram_size=2),
        bias=dict(embedding_bias=bias * 3),
        bad=dict(bad_token_ids=[32, 101, 10, 115]),
        combined=dict(no_repeat_ngram_size=3, embedding_bias=bias,
                      bad_token_ids=[32, 40]))
    out = {}
    for name, kw in cases.items():
        outs = llm.generate(prompts, SamplingParams(
            max_tokens=24, top_k=1, ignore_eos=True, **kw))
        out[name] = [o.outputs[0].token_ids for o in outs]
    for name, kw in (("n3_greedy", dict(top_k=1)),
                     ("n3_seeded", dict(temperature=0.8, seed=11))):
        o = llm.generate(prompts[0], SamplingParams(
            max_tokens=16, n=3, ignore_eos=True, **kw))
        out[name] = [x.token_ids for x in o.outputs]
    o = llm.generate(prompts[2], SamplingParams(max_tokens=4, top_k=1,
                                                prompt_logprobs=3))
    out["prompt_logprobs"] = o.prompt_logprobs
    if sync:
        def force(logits):
            logits[:] = -1e9
            logits[33] = 0.0
            return logits

        def shift(logits):
            logits[[40, 41, 42]] += 2.0
            return logits
        out["processor_force"] = llm.generate(prompts[0], SamplingParams(
            max_tokens=6, top_k=1, logits_processor=force,
            ignore_eos=True)).outputs[0].token_ids
        out["processor_sampled"] = llm.generate(prompts[1], SamplingParams(
            max_tokens=12, temperature=0.9, top_k=20, seed=3,
            logits_processor=shift, ignore_eos=True)).outputs[0].token_ids
        out["beam"] = [[(h.token_ids, h.cumulative_logprob)
                        for h in r.outputs]
                       for r in llm.generate(prompts, SamplingParams(
                           max_tokens=12, use_beam_search=True, best_of=4,
                           n=3, length_penalty=0.0))]
    return out


def surface_parity_phase(repo: Path) -> dict:
    """The sampling surface on the parity checkpoint
    (tests/assets/tinycode-llama, float32), the card against the CPU, on
    the overlap scheduler (K = 8) and the sync one (``max_beam_width=4``):
    tokens identical, prompt logprobs within 1e-4 (same keys), beam
    hypotheses identical, scores within 1e-4."""
    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig
    ckpt = repo / "tests" / "assets" / "tinycode-llama"
    res = {}
    for sched, extra in (("overlap", {}), ("sync", dict(max_beam_width=4))):
        runs = {}
        for device in ("cuda", "cpu"):
            llm = LLM(ckpt, device=device, dtype="float32",
                      skip_tokenizer_init=True, max_batch_size=8,
                      max_input_len=128, max_seq_len=256, max_num_tokens=512,
                      kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                                    max_tokens=8192),
                      **extra)
            try:
                runs[device] = _surface_runs(llm, sched == "sync")
                if device == "cuda":
                    graphs = llm.engine.graphs.num_graphs
                    replays = llm.engine.graphs.replays
            finally:
                llm.shutdown()
        got, want = runs["cuda"], runs["cpu"]
        tok_cases = [k for k in want if k not in ("prompt_logprobs", "beam")]
        bad = [k for k in tok_cases if got[k] != want[k]]
        plp_err = 0.0
        for g, w in zip(got["prompt_logprobs"][1:],
                        want["prompt_logprobs"][1:]):
            if set(g) != set(w):
                bad.append("prompt_logprobs_keys")
                break
            plp_err = max([plp_err] + [abs(g[k] - w[k]) for k in w])
        beam_err = 0.0
        for g, w in zip(got.get("beam", []), want.get("beam", [])):
            if [t for t, _ in g] != [t for t, _ in w]:
                bad.append("beam_tokens")
            beam_err = max([beam_err] + [abs(a[1] - b[1])
                                         for a, b in zip(g, w)])
        r = dict(scheduler=sched, cases=sorted(want), mismatched=bad,
                 prompt_logprobs_max_abs_err=plp_err,
                 beam_score_max_abs_err=beam_err, graphs_captured=graphs,
                 graph_replays=replays)
        emit({"phase": "surface_parity", **r})
        if bad or plp_err > 1e-4 or beam_err > 1e-4 or not replays:
            raise AssertionError(f"surface_parity {sched}: {r}")
        res[sched] = r
    return res


def surface_serving_phase() -> dict:
    """Llama-3-8B at full width and depth (seeded random bf16), one
    ``LLM`` with ``max_beam_width=4`` (the sync scheduler), prefix reuse
    on, serving tools/serving_profile.py's ``surface_workload`` mixed
    batch through ``measure_surface`` (warm-up, timed pass with the launch
    counters zeroed right before and read right after, profiled pass).
    Fails unless every class returns its full length, every prompt-logprob
    dict holds its prompt token, the no-repeat-ngram class has no bad word
    and no repeated 3-gram, the processor class no banned token, and K1
    and K2 launched."""
    import gc

    import torch
    from tensorrt_llm_tpu_torch import LLM
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    cfg, kwargs, prompts, sps, classes, ids = sprof.surface_workload()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    llm = LLM(cfg, dtype="bfloat16", **kwargs)
    build_s = time.monotonic() - t0
    try:
        # without a profiled pass (time budget)
        res, outs = sprof.measure_surface(llm, prompts, sps, classes,
                                          profile=False)
        res.update(engine_build_s=build_s, model="Llama-3-8B",
                   layers=cfg.num_hidden_layers,
                   kv_pages=llm.engine.num_kv_pages,
                   surface_state_bytes=llm.engine.surface_state_bytes())
    finally:
        llm.shutdown()
    del llm
    faults = []
    bad, banned = set(ids["bad_token_ids"]), set(ids["banned"])
    for p, sp, c, o in zip(prompts, sps, classes, outs):
        toks = [x.token_ids for x in o.outputs]
        if any(len(t) != sp.max_tokens for t in toks) or \
                len(toks) != sp.n:
            faults.append(f"{c}: lengths {[len(t) for t in toks]}")
        if c == "prompt_logprobs":
            plp = o.prompt_logprobs
            if plp is None or plp[0] is not None or len(plp) != len(p) or \
                    any(p[i] not in plp[i] for i in range(1, len(p))):
                faults.append("prompt_logprobs: a dict lacks its token")
        if c == "ngram_bias_bad":
            seq = p + toks[0]
            grams = [tuple(seq[j:j + 3]) for j in range(len(seq) - 2)]
            if bad & set(toks[0]):
                faults.append("ngram_bias_bad: a bad word was emitted")
            if any(grams[j] in grams[:j] for j in range(len(p) - 2,
                                                        len(grams))):
                faults.append("ngram_bias_bad: a 3-gram repeats")
        if c == "processor" and banned & set(toks[0]):
            faults.append("processor: a banned token was emitted")
    if min(res["launches"][k] for k in ("paged_decode_attention",
                                        "ragged_prefill_attention")) <= 0:
        faults.append(f"K1 or K2 never launched: {res['launches']}")
    res["faults"] = faults
    emit({"phase": "surface_serving", **res})
    if faults:
        raise AssertionError(f"surface_serving: {faults}")
    return res


GUIDED_SPEC = {"structures": [{"begin": "<f>", "content_regex": "[0-9]+",
                                "end": "</f>"}], "triggers": ["<f>"]}


def _guided_params(kind: str):
    """A ``GuidedDecodingParams`` of each grammar kind guided_parity
    serves (the grammars of tools/serving_profile.py's guided_workload,
    and a structural tag)."""
    from tensorrt_llm_tpu_torch import GuidedDecodingParams
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    return GuidedDecodingParams(**dict(
        regex=dict(regex=sprof.GUIDED_REGEX),
        json=dict(json=sprof.GUIDED_SCHEMA),
        json_object=dict(json_object=True),
        ebnf=dict(grammar=sprof.GUIDED_EBNF),
        structural=dict(structural_tag=json.dumps(GUIDED_SPEC)))[kind])


def _guided_walk(tokens, gp, factory):
    """(alive, accepted, ended_on_eos) of byte-level ``tokens`` under the
    grammar of ``gp``: its DFA walked over the bytes up to the first EOS
    (token 0); ``alive``: the walk never died, ``accepted``: it ends in an
    accepting state."""
    _, dfa = factory.compile_dfa(gp)
    state = dfa.start
    eos = 0 in tokens
    for t in tokens[:tokens.index(0) if eos else len(tokens)]:
        if t >= 256:
            return False, False, eos
        state = int(dfa.table[state, t])
        if state < 0:
            return False, False, eos
    return True, bool(dfa.accepting[state]), eos


def _guided_factory():
    from tensorrt_llm_tpu_torch.guided.grammar_matcher import (
        MatcherFactory, TokenTable)
    return MatcherFactory(TokenTable([bytes([i]) for i in range(256)],
                                     eos_token_id=0))


def _guided_runs(llm, device_backend: bool) -> dict:
    """guided_parity's requests through one ``LLM``: tokens by case. Every
    grammar kind over 3 prompts, a mixed batch of guided and unguided
    rows queued before admission, and on the device backend one batch
    holding a request aborted mid-window and one whose grammar cannot fit
    the pool beside 3 guided requests; on the host backend (sync) one
    batch holding a request whose logits processor raises beside 3
    guided requests."""
    from tensorrt_llm_tpu_torch import SamplingParams
    from tensorrt_llm_tpu_torch.runtime.error_isolation import RequestError
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    prompts = [list(b"def forward(self, x):\n    return "),
               list(b'{"name": '), list(b"x = 1\ny = ")]
    kinds = ("regex", "json", "json_object", "ebnf", "structural")

    def sp(kind=None, **kw):
        return SamplingParams(max_tokens=48, top_k=1, end_id=0,
                              ignore_eos=kind is None,
                              guided_decoding=_guided_params(kind)
                              if kind else None, **kw)
    out = {k: [o.outputs[0].token_ids
               for o in llm.generate(prompts, sp(k))] for k in kinds}
    mixed = [sp("regex"), sp(), sp("json"), sp(), sp("ebnf"), sp()]
    out["mixed"] = _queued_generate(llm, prompts * 2, mixed)
    side = [sp("json"), sp("regex"), sp("ebnf")]
    ends = {}
    if device_backend:
        from tensorrt_llm_tpu_torch import GuidedDecodingParams
        futs = [llm.generate_async(p, s) for p, s in zip(prompts, side)]
        long = llm.generate_async(prompts[0], SamplingParams(
            max_tokens=200, top_k=1, ignore_eos=True))
        big = llm.generate_async(prompts[1], SamplingParams(
            max_tokens=8, top_k=1, end_id=0, guided_decoding=
            GuidedDecodingParams(regex=sprof.GUIDED_OVERSIZE)))
        while long._result.request.num_output_tokens < 8 and \
                not long.finished:
            time.sleep(0.001)
        llm.abort_request(long.request_id)
        r = long.result(timeout=600)
        ends["aborted"] = (r.outputs[0].finish_reason,
                           len(r.outputs[0].token_ids))
        try:
            big.result(timeout=600)
            ends["oversize"] = "finished"
        except Exception as e:
            ends["oversize"] = f"{type(e).__name__}: {e}"[:200]
    else:
        def poison(*a, **kw):
            raise ValueError("poison processor")
        futs = [llm.generate_async(p, s) for p, s in zip(prompts, side)]
        bad = llm.generate_async(prompts[2], SamplingParams(
            max_tokens=8, top_k=1, logits_processor=poison))
        try:
            bad.result(timeout=600)
            ends["poison"] = "finished"
        except RequestError as e:
            ends["poison"] = f"RequestError: {e}"[:200]
    out["side"] = [f.result(timeout=600).outputs[0].token_ids for f in futs]
    out["ends"] = ends
    return out


def guided_parity_phase(repo: Path) -> dict:
    """Guided decoding on the parity checkpoint (tests/assets/tinycode-llama,
    float32, ``guided_token_bytes="byte"``, ``end_id=0``), the card
    against the CPU: the device backend on the overlap scheduler (K = 8,
    windows replayed) and the host backend (``dfa-host``, the sync
    scheduler), each over regex, JSON schema, ``json_object``, EBNF and a
    structural tag, a mixed batch with unguided rows, and one batch with
    a request aborted mid-window and one whose grammar cannot fit the
    pool (device) or whose logits processor raises (host). The pool holds
    16,384 states (``json_object`` needs 10,976). Tokens must be
    identical card/CPU and backend/backend, every guided output a live
    prefix of its grammar (accepted where it ended on EOS), guided
    windows replayed on the card, and the aborted, oversize and poison
    requests must end alone (CANCELLED; an error naming the pool; a
    ``RequestError``) while the requests beside them finish."""
    import os

    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    ckpt = repo / "tests" / "assets" / "tinycode-llama"
    os.environ["TLLM_TPU_GUIDED_POOL_STATES"] = str(sprof.GUIDED_POOL_STATES)
    runs, stats = {}, {}
    for backend in ("dfa", "dfa-host"):
        for device in ("cuda", "cpu"):
            llm = LLM(ckpt, device=device, dtype="float32",
                      skip_tokenizer_init=True, max_batch_size=8,
                      max_input_len=128, max_seq_len=320,
                      max_num_tokens=512, guided_decoding_backend=backend,
                      guided_token_bytes="byte",
                      disable_overlap_scheduler=backend == "dfa-host",
                      kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                                    max_tokens=8192))
            try:
                _zero_launches()
                runs[backend, device] = _guided_runs(llm, backend == "dfa")
                if device == "cuda":
                    eng = llm.engine
                    stats[backend] = dict(
                        launches=_read_launches(),
                        graph_replays=eng.graphs.replays,
                        guided_window_replays=sprof._guided_window_replays(
                            eng),
                        guided_windows=eng.guided_windows,
                        guided_single_steps=eng.guided_steps,
                        overlap=llm.executor.enable_overlap,
                        stats_len=len(llm.get_stats()))
            finally:
                llm.shutdown()
    factory = _guided_factory()
    faults = []
    ref = runs["dfa", "cpu"]
    for key, got in runs.items():
        for case in ("regex", "json", "json_object", "ebnf", "structural",
                     "mixed", "side"):
            if got[case] != ref[case]:
                faults.append(f"{key} {case}: tokens differ from dfa/cpu")
    for case in ("regex", "json", "json_object", "ebnf", "structural"):
        for toks in ref[case]:
            alive, acc, eos = _guided_walk(toks, _guided_params(case),
                                           factory)
            if not alive or (eos and not acc):
                faults.append(f"{case}: {bytes(t for t in toks if t < 256)}"
                              " is not accepted by its grammar")
    for (backend, device), got in runs.items():
        e = got["ends"]
        if backend == "dfa":
            if e["aborted"][0] != "cancelled" or e["aborted"][1] >= 200:
                faults.append(f"{device}: abort did not cancel: {e}")
            if "pool" not in e["oversize"]:
                faults.append(f"{device}: oversize grammar: {e}")
        elif not e["poison"].startswith("RequestError"):
            faults.append(f"{device}: poison processor: {e}")
    s = stats["dfa"]
    if not s["overlap"] or not s["guided_window_replays"]:
        faults.append(f"device backend: no guided window replayed: {s}")
    if stats["dfa-host"]["overlap"]:
        faults.append("host backend on the overlap scheduler")
    r = dict(cases=["regex", "json", "json_object", "ebnf", "structural",
                    "mixed", "side"], ends={f"{b}/{d}": v["ends"]
                                            for (b, d), v in runs.items()},
             card=stats, faults=faults)
    emit({"phase": "guided_parity", **r})
    if faults:
        raise AssertionError(f"guided_parity: {faults}")
    return r


def _json_fields(text: bytes):
    """(the parsed JSON value, escapes the grammar admitted that JSON does
    not). The JSON grammars' strings admit a backslash before any byte
    (``\\.``, the JAX package's ``_STRING``), so such escapes are doubled
    before ``json.loads``; bytes are read as latin-1, one char each."""
    import re
    s = text.decode("latin-1")
    bad = 0

    def fix(m):
        nonlocal bad
        if m.group(1) in '"\\/bfnrt' or re.fullmatch(r"u[0-9a-fA-F]{4}",
                                                      m.group(0)[1:]):
            return m.group(0)
        bad += 1
        return "\\\\" + m.group(0)[1:]
    s = re.sub(r'\\(u[0-9a-fA-F]{4}|.)', fix, s, flags=re.S)
    return json.loads(s), bad


def _guided_faults(outs, sps, classes) -> tuple:
    """guided_serving's checks of each output: one that ended on EOS
    matches its grammar in full (JSON schema: ``json.loads`` and the
    schema's fields; regex and EBNF: ``re.fullmatch`` of the pattern;
    ``json_object``: ``json.loads`` gives an object), one that hit
    max_tokens is a live prefix of it; the regex class ends on EOS;
    ``aborted`` ends CANCELLED, ``oversize`` fails naming the pool, the
    rest finish. Returns (faults, invalid JSON escapes seen)."""
    import re

    from tensorrt_llm_tpu_torch.guided.ebnf import ebnf_to_regex
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    factory = _guided_factory()
    faults, escapes = [], 0
    schema = sprof.GUIDED_SCHEMA["properties"]
    for o, sp, c in zip(outs, sps, classes):
        if c == "oversize":
            if not isinstance(o, Exception) or "pool" not in str(o):
                faults.append(f"oversize: {o!r}"[:200])
            continue
        if isinstance(o, Exception):
            faults.append(f"{c}: failed: {o!r}"[:200])
            continue
        out = o.outputs[0]
        if c == "aborted":
            if out.finish_reason != "cancelled":
                faults.append(f"aborted: ended {out.finish_reason}")
            continue
        if out.finish_reason not in ("end_id", "length"):
            faults.append(f"{c}: ended {out.finish_reason}")
        gp = sp.guided_decoding
        if gp is None:
            continue
        toks = out.token_ids
        alive, acc, eos = _guided_walk(toks, gp, factory)
        if not alive or (eos and not acc):
            faults.append(f"{c}: not a live prefix / not accepted")
            continue
        if c == "regex" and not eos:
            faults.append("regex: did not end on EOS")
        if not eos:
            continue
        text = bytes(toks[:toks.index(0)])
        try:
            if c == "regex":
                ok = re.fullmatch(sprof.GUIDED_REGEX, text.decode("latin-1"))
            elif c == "ebnf":
                ok = re.fullmatch(ebnf_to_regex(sprof.GUIDED_EBNF),
                                  text.decode("latin-1"), flags=re.S)
            else:
                val, bad = _json_fields(text)
                escapes += bad
                ok = isinstance(val, dict)
                if c == "json_schema":
                    ok = ok and set(val) == set(schema) and \
                        isinstance(val["name"], str) and \
                        isinstance(val["age"], int) and \
                        val["color"] in schema["color"]["enum"] and \
                        isinstance(val["ids"], list) and \
                        all(isinstance(x, int) for x in val["ids"])
        except ValueError as e:
            ok, text = False, f"{text!r}: {e}"
        if not ok:
            faults.append(f"{c}: {text!r} does not match"[:200])
    return faults, escapes


def guided_serving_phase() -> dict:
    """Llama-3-8B at full width, its first ``GUIDED_SERVING_LAYERS`` (8)
    of 32 layers for the script's time limit, on a bf16 pool (seeded
    random weights), one ``LLM`` with ``guided_decoding_backend="dfa"``,
    ``guided_token_bytes="byte"``, a 16,384-state pool, prefix reuse off
    and otherwise defaults (overlap depth 4, K = 8, 64 rows), serving
    tools/serving_profile.py's ``guided_workload`` through
    ``measure_guided`` (warm-up, timed pass with the launch counters
    zeroed right before and read right after, profiled pass). Fails
    unless every output passes ``_guided_faults``, free KV blocks return
    to their count before the pass, every pool segment's refcount is 0,
    guided rows ran in replayed windows, and K1 and K2 launched."""
    import gc
    import os

    import torch
    from tensorrt_llm_tpu_torch import LLM
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    cfg, kwargs, pool, prompts, sps, classes = sprof.guided_workload("dfa")
    cfg.num_hidden_layers = GUIDED_SERVING_LAYERS
    os.environ["TLLM_TPU_GUIDED_POOL_STATES"] = str(pool)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    llm = LLM(cfg, dtype="bfloat16", **kwargs)
    build_s = time.monotonic() - t0
    try:
        # without a profiled pass (time budget)
        res, outs = sprof.measure_guided(llm, prompts, sps, classes,
                                         profile=False)
        res.update(engine_build_s=build_s, model="Llama-3-8B",
                   layers=cfg.num_hidden_layers,
                   kv_pages=llm.engine.num_kv_pages,
                   guided_pool_bytes=sum(t.nbytes for t in (
                       llm.engine.g_byte_table, llm.engine.g_mask_bits,
                       llm.engine.g_eos_ok, llm.engine.g_state)))
    finally:
        llm.shutdown()
    del llm
    faults, escapes = _guided_faults(outs, sps, classes)
    res["invalid_json_escapes"] = escapes
    if res["free_blocks_after"] != res["free_blocks_before"]:
        faults.append("free KV blocks did not return")
    if any(res["segment_refs"]):
        faults.append(f"segments still referenced: {res['segment_refs']}")
    if not res["guided_window_replays"]:
        faults.append("no replayed window carried guided rows")
    if min(res["launches"][k] for k in ("paged_decode_attention",
                                        "ragged_prefill_attention")) <= 0:
        faults.append(f"K1 or K2 never launched: {res['launches']}")
    res["faults"] = faults
    emit({"phase": "guided_serving", **res})
    if faults:
        raise AssertionError(f"guided_serving: {faults}")
    return res


# --------------------------------------------------------------------- #
# Weights quantized at load (FP8, FP8 block, SmoothQuant, W4A8) and the
# Llama-derived dense families
# --------------------------------------------------------------------- #
# Llama-3-8B's projections (fused q|k|v and gate|up, as the port runs
# them): (name, K, N, fused)
LLAMA3_8B_PROJ = (("qkv", 4096, 6144, True), ("o", 4096, 4096, False),
                  ("gate_up", 4096, 28672, True),
                  ("down", 14336, 4096, False))


def quant_linear_kernel_phase(results: dict) -> None:
    """K3's e4m3 body at Llama-3-8B's projection shapes, at 64 rows (a
    decode step) and one row, with FP8 per-tensor scales (a fused
    projection holds each part's scale over its columns: [N]) and with
    128 x 128 block scales: each case against the plain version on the
    same inputs (2e-2, and 2e-2 x max |plain|), its time warm and cold
    (rotating over weight copies past the L2 cache), the byte bound (K x
    N e4m3 bytes + scales + x + out at 3.35 TB/s; the bf16 wgmma
    operations at 989 TFLOP/s), ``F.linear`` on the bf16 weight (warm and
    cold), the per-call-upcast route (the FP8 methods' route above 128
    rows: the weight widened to bf16 on every call, then one float32-out
    product, times the scale) and the plain version's time. Then
    SmoothQuant's and W4A8's whole ``apply`` (smoothing, per-token int8,
    ``torch._int_mm``, epilogue) at the same shapes and rows."""
    import torch
    import torch.nn.functional as F
    from tensorrt_llm_tpu_torch import QuantAlgo, QuantConfig
    from tensorrt_llm_tpu_torch.models.modeling_utils import quantize_linear
    from tensorrt_llm_tpu_torch.ops import linear as L
    from tensorrt_llm_tpu_torch.ops import quant as Q
    from tensorrt_llm_tpu_torch.ops.cuda import quant_matmul as qmm
    from tensorrt_llm_tpu_torch.tools.card_timing import time_ms

    for proj, K, N, fused in LLAMA3_8B_PROJ:
        g = torch.Generator(device="cuda").manual_seed(K + N)
        w = torch.randn((K, N), generator=g, device="cuda") * 0.02
        wb = w.t().to(torch.bfloat16).contiguous()          # F.linear's
        forms = {}
        q, s = Q.quantize_weight_fp8(w)
        forms["fp8"] = (q, s.expand(N).contiguous() if fused else s)
        forms["fp8_block"] = Q.quantize_weight_fp8_blockwise(w)
        int8 = {}
        smooth = torch.rand(K, generator=g, device="cuda") + 0.5
        for algo in ("W8A8_SQ_PER_CHANNEL", "W4A8_AWQ"):
            m = L.make_linear_method(QuantConfig(
                quant_algo=QuantAlgo[algo], exclude_modules=[]))
            int8[algo] = (m, quantize_linear(m, w, device="cuda",
                                             smooth=smooth))
        del w
        wbs = _copies([wb])
        for M in (64, 1):
            x = torch.randn((M, K), generator=g, device="cuda",
                            dtype=torch.bfloat16)
            library_ms = time_ms(lambda: F.linear(x, wb), 30)
            library_cold = time_ms(_rotate(lambda i: F.linear(x, wbs[i][0]),
                                           len(wbs)), 30)
            for form, (q, s) in forms.items():
                name = f"e4m3_{form}_{proj}_m{M}"
                got = qmm.e4m3_dequant_matmul(x, q, s)
                ref = qmm.e4m3_dequant_matmul_plain(x, q, s)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                top = ref.float().abs().max().item()
                if err > TOL * max(1.0, top):
                    raise AssertionError(f"{name}: kernel != plain (max "
                                         f"{err}, |plain| {top})")
                ms = time_ms(lambda: qmm.e4m3_dequant_matmul(x, q, s), 30)
                qs = _copies([q, s])
                ms_cold = time_ms(_rotate(
                    lambda i: qmm.e4m3_dequant_matmul(x, *qs[i]), len(qs)),
                    30)
                del qs
                if form == "fp8":
                    def upcast():
                        return (L.dot_f32(x, q.to(torch.bfloat16).t())
                                * s).to(torch.bfloat16)
                else:
                    def upcast():
                        return L.dot_f32(x, Q.dequantize_fp8_blockwise(
                            q, s).to(torch.bfloat16).t()).to(torch.bfloat16)
                upcast_ms = time_ms(upcast, 10)
                plain_ms = time_ms(
                    lambda: qmm.e4m3_dequant_matmul_plain(x, q, s), 10)
                io_bytes = K * N + s.numel() * 4 + x.numel() * 2 + M * N * 2
                res = dict(shape=dict(M=M, K=K, N=N, scales=list(s.shape)),
                           max_abs_err=err, max_abs_plain=top, ms=ms,
                           ms_cold=ms_cold, plain_ms=plain_ms,
                           library_ms=library_ms,
                           library_ms_cold=library_cold,
                           upcast_ms=upcast_ms, bytes=io_bytes,
                           flops=2 * M * K * N,
                           **_bound(io_bytes, 2 * M * K * N))
                res["bound_share_cold"] = res["bound_ms"] / ms_cold
                results[name] = res
                emit({"phase": "quant_linear_kernels", "case": name, **res})
            for algo, (m, p) in int8.items():
                name = f"int8_{algo}_{proj}_m{M}"
                out = m.apply(p, x)
                torch.cuda.synchronize()
                if not torch.isfinite(out).all():
                    raise AssertionError(f"{name}: non-finite output")
                res = dict(shape=dict(M=M, K=K, N=N),
                           ms=time_ms(lambda: m.apply(p, x), 30),
                           library_ms=library_ms,
                           library_ms_cold=library_cold)
                results[name] = res
                emit({"phase": "quant_linear_kernels", "case": name, **res})
        del forms, int8, wb, wbs
        torch.cuda.empty_cache()


# the algorithms of quant_parity / quant_serving: (label, QuantAlgo name,
# group size, calibrated on an inline module)
QUANT_RUNS = (("fp8", "FP8", 128, False),
              ("fp8_block", "FP8_BLOCK_SCALES", 128, False),
              ("w8a8_sq", "W8A8_SQ_PER_CHANNEL", 128, True),
              ("w4a8", "W4A8_AWQ", 128, False))


def quant_load_parity_phase(repo: Path) -> dict:
    """tests/assets/tinycode-llama in float32 under FP8 per-tensor, FP8
    block, SmoothQuant W8A8 (through the inline-model entry: the same
    ``transformers`` module, on the CPU, given to both runs, so both
    calibrate the same smoothing scales) and W4A8 (group 16: 688 is 43
    groups of 16), through ``LLM.generate`` on the card and on the CPU.
    FP8 block, SmoothQuant and W4A8 run the CPU's arithmetic on the card
    in float32 (the weights quantized there to the same bytes): greedy
    tokens identical. FP8 per-tensor multiplies through K3's e4m3 body
    (float32 out) wherever K is a multiple of 128, which scales each
    group's partial sum where the CPU scales the whole sum: tokens
    identical wherever the CPU run decides by more than 3e-2 in
    log-probability (``_compare_streams``), and the body must launch.
    Every run's failures are gathered and raised together."""
    from transformers import LlamaForCausalLM
    from tensorrt_llm_tpu_torch import (LLM, KvCacheConfig, QuantAlgo,
                                        QuantConfig, SamplingParams)
    from tensorrt_llm_tpu_torch.ops.cuda import quant_matmul as qmm
    ckpt = repo / "tests" / "assets" / "tinycode-llama"
    module = LlamaForCausalLM.from_pretrained(ckpt).float().eval()
    prompts = [list(b"def forward(self, x):\n    return "),
               list(b"import torch\n"), list(range(32, 120))]
    n_out = 32
    res, failures = {}, []
    for label, algo, _, inline in QUANT_RUNS:
        group = 16 if algo == "W4A8_AWQ" else 128
        runs, launches = {}, {}
        for dev in ("cpu", "cuda"):
            qmm.LAUNCHES_E4M3 = 0
            llm = LLM(module if inline else ckpt, device=dev,
                      dtype="float32", skip_tokenizer_init=True,
                      max_batch_size=8, max_input_len=128, max_seq_len=256,
                      max_num_tokens=512, quant_config=QuantConfig(
                          quant_algo=QuantAlgo[algo], group_size=group),
                      kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                                    max_tokens=4096))
            _zero_launches()
            try:
                outs = llm.generate(prompts, SamplingParams(
                    max_tokens=n_out, top_k=1, logprobs=2))
                apart = "q" in llm.engine.params["layers"][0]
            finally:
                llm.shutdown()
            runs[dev] = ([o.outputs[0].token_ids for o in outs],
                         [o.outputs[0].logprobs for o in outs])
            launches[dev] = dict(_read_launches(), e4m3=qmm.LAUNCHES_E4M3)
        cmp = _compare_streams(runs["cpu"], runs["cuda"])
        identical = runs["cuda"][0] == runs["cpu"][0]
        strict = algo != "FP8"
        if (strict and not identical) or cmp["unexplained_partings"]:
            failures.append(f"{label}: card {runs['cuda'][0]} != cpu "
                            f"{runs['cpu'][0]} ({cmp})")
        if any(len(t) != n_out for t in runs["cuda"][0]):
            failures.append(f"{label}: short outputs")
        if algo == "FP8" and not launches["cuda"]["e4m3"]:
            failures.append("fp8: K3's e4m3 body never launched")
        if inline and not apart:
            failures.append("w8a8_sq: smoothed q/k/v were fused")
        res[label] = dict(quant_algo=algo, group_size=group, inline=inline,
                          identical=identical, strict=strict,
                          prompts=len(prompts), tokens_each=n_out,
                          launches=launches["cuda"], qkv_apart=apart, **cmp)
        emit({"phase": "quant_parity", "run": label, **res[label]})
    if failures:
        raise AssertionError("quant_parity: " + "; ".join(failures))
    return res


def quant_serving_phase() -> dict:
    """Weights quantized at load: Llama-3-8B at its published width and
    depth (32 layers; seeded random weights drawn in bf16 and quantized
    at load) with FP8 per-tensor weights and a bf16 KV cache, 64 requests of 512
    prompt tokens -> 128 greedy tokens with ``ignore_eos``, ``LLM``
    defaults (64 rows, K = 8 windows, depth 4, CUDA graphs) but prefix
    reuse off (tools/serving_profile.py ``--geometry llama3-8b-quant
    --quant FP8``): tok/s, TTFT, TPOT, idle share, GPU time by class,
    weight bytes, peak allocated memory, launches (K3's e4m3 body apart).
    Every window step's 4 x 32 projections must go through K3's e4m3
    body (no weight is widened in memory on a decode step). Beside it,
    one short pass each at full width and 8 layers (64 x 512 -> 64): bf16,
    FP8 per-tensor, FP8 block, SmoothQuant W8A8 (calibrated on an inline
    ``transformers`` module built on the card in bf16) and W4A8 (group
    128), with the same figures but the profiled ones (idle share, GPU
    time by class), left out for the script's time budget."""
    import gc
    failures = []

    import torch
    from tensorrt_llm_tpu_torch import LLM
    from tensorrt_llm_tpu_torch.llmapi.llm_args import QuantConfig
    from tensorrt_llm_tpu_torch.ops.cuda import quant_matmul as qmm
    from tensorrt_llm_tpu_torch.quantization.mode import QuantAlgo
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    runs = [("fp8_32l", "FP8", 32, 128, False)] + [
        (f"{label}_8l", algo, 8, 64, inline)
        for label, algo, _, inline in (("bf16", "NO_QUANT", 128, False),
                                       ("fp8", "FP8", 128, False),
                                       *QUANT_RUNS[1:])]
    out = {}
    for label, algo, layers, n_out, inline in runs:
        t_run = time.monotonic()
        cfg, kwargs, prompts, sp = sprof.workload(geometry="llama3-8b-quant")
        cfg.num_hidden_layers = layers
        sp.max_tokens = n_out
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        model = sprof.inline_module(cfg) if inline else cfg
        # only the full-depth FP8 run is profiled (the script's time
        # budget)
        profile = layers == 32
        llm = LLM(model, dtype="bfloat16", quant_config=QuantConfig(
            quant_algo=QuantAlgo[algo]), **kwargs)
        del model
        gc.collect()
        build_s = time.monotonic() - t0
        try:
            eng = llm.engine
            weights_bytes = sum(t.numel() * t.element_size()
                                for t in _tensors(eng.params))
            res = sprof.measure(llm, prompts, sp, profile=profile)
            graphs = _graph_stats(eng)
            reserve = eng.graph_pool_reserve()
        finally:
            llm.shutdown()
        peak = torch.cuda.max_memory_allocated()
        del llm, eng
        gc.collect()
        torch.cuda.empty_cache()
        res.update(run=label, quant_algo=algo, layers=layers,
                   model="Llama-3-8B", inline=inline, engine_build_s=build_s,
                   weights_bytes=weights_bytes, peak_allocated_bytes=peak,
                   graph_pool_reserve_bytes=reserve, graphs=graphs,
                   run_s=time.monotonic() - t_run)
        emit({"phase": "quant_serving", **res})
        if res["output_tokens"] != len(prompts) * n_out \
                or res["min_output_tokens"] != n_out:
            failures.append(f"quant_serving {label}: short outputs")
        if res["nonfinite_logprobs"] or not res["logprobs_recorded"]:
            failures.append(f"quant_serving {label}: non-finite "
                                 "logprobs")
        if min(res["launches"][k] for k in ("paged_decode_attention",
                                            "ragged_prefill_attention")) <= 0:
            failures.append(f"quant_serving {label}: K1 or K2 never "
                                 f"launched: {res['launches']}")
        if algo.startswith("FP8"):
            k3 = res["launches_e4m3"]
            if k3 < 4 * layers * res["window_steps"] or not k3:
                failures.append(
                    f"quant_serving {label}: {k3} e4m3 launches for "
                    f"{res['window_steps']} window steps of {layers} "
                    "layers: a decode step left K3")
        try:
            _check_reserve(res)
        except AssertionError as e:
            failures.append(f"quant_serving {label}: {e}")
        out[label] = res
    if failures:
        raise AssertionError("; ".join(failures))
    return out


def _save_tiny_family(path: Path, name: str) -> None:
    """A tiny random ``transformers`` model of family ``name`` (hidden
    256, 4 q heads over 2 KV heads of 64, intermediate 512, vocab 512; 2
    layers, 4 for EXAONE 4 (window 32 on three of four) and SmolLM3 (a
    NoPE fourth layer)) saved to ``path``, its norms and biases redrawn
    so that they matter."""
    import torch
    import transformers as tf
    base = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, head_dim=64,
                max_position_embeddings=512, tie_word_embeddings=False,
                pad_token_id=0, eos_token_id=1, bos_token_id=2)
    extra = {"granite": dict(embedding_multiplier=12.0,
                             attention_multiplier=0.03,
                             residual_multiplier=0.22, logits_scaling=8.0),
             "glm": dict(partial_rotary_factor=0.5, attention_bias=True),
             "glm4": dict(partial_rotary_factor=0.5, attention_bias=True),
             "exaone4": dict(num_hidden_layers=4, sliding_window=32,
                             layer_types=["sliding_attention"] * 3
                             + ["full_attention"]),
             "smollm3": dict(num_hidden_layers=4,
                             no_rope_layers=[1, 1, 1, 0])}.get(name, {})
    cls_name = {"olmo2": "Olmo2", "phi3": "Phi3", "glm": "Glm",
                "glm4": "Glm4", "exaone4": "Exaone4", "smollm3": "SmolLM3",
                "helium": "Helium", "arcee": "Arcee",
                "granite": "Granite"}[name]
    cfg = getattr(tf, cls_name + "Config")(**{**base, **extra})
    torch.manual_seed(41)
    model = getattr(tf, cls_name + "ForCausalLM")(cfg).float()
    gen = torch.Generator().manual_seed(42)
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if pname.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
            elif "norm" in pname:
                p.copy_(1 + torch.randn(p.shape, generator=gen) * 0.1)
    model.save_pretrained(path)


def families_parity_phase() -> dict:
    """The nine Llama-derived families. (1) A tiny seeded float32
    checkpoint of each (``_save_tiny_family``) through ``LLM.generate`` on
    the card and on the CPU: greedy tokens identical, K1 and K2 launched
    on the card. (2) One bf16 run of each at a published model's width
    (tools/serving_profile.py ``FAMILIES``; 2 layers, 4 for EXAONE-4.0-32B
    and SmolLM3-3B so that a global and a NoPE layer run; seeded random
    weights), 16 x 256 -> 32 greedy tokens through graphs
    (``--family NAME``): K1 and K2 launched, windows replayed, every
    returned logprob finite."""
    import gc
    failures = []

    import torch
    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig, SamplingParams
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    prompts = [list(range(3, 90)), [5, 17, 99, 3, 64, 12, 7] * 6,
               [101, 2, 33, 400, 7]]
    n_out = 32
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in sprof.FAMILIES:
            path = Path(tmp) / name
            _save_tiny_family(path, name)
            toks = {}
            for dev in ("cpu", "cuda"):
                llm = LLM(str(path), device=dev, dtype="float32",
                          skip_tokenizer_init=True, max_batch_size=4,
                          max_input_len=128, max_seq_len=256,
                          max_num_tokens=256,
                          kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                                        max_tokens=4096))
                _zero_launches()
                try:
                    outs = llm.generate(prompts, SamplingParams(
                        max_tokens=n_out, top_k=1, ignore_eos=True))
                    launches = _read_launches()
                finally:
                    llm.shutdown()
                toks[dev] = [o.outputs[0].token_ids for o in outs]
            if toks["cuda"] != toks["cpu"]:
                failures.append(f"families_parity {name}: card "
                                     f"{toks['cuda']} != cpu {toks['cpu']}")
            if min(launches["paged_decode_attention"],
                   launches["ragged_prefill_attention"]) <= 0:
                failures.append(f"families_parity {name}: K1 or K2 "
                                     f"never launched: {launches}")
            res[name] = dict(tiny=dict(identical=True, tokens_each=n_out,
                                       launches=launches))
    for name, (_, _, layers, source) in sprof.FAMILIES.items():
        cfg, kwargs, prompts, sp = sprof.family_workload(name)
        gc.collect()
        torch.cuda.empty_cache()
        llm = LLM(cfg, dtype="bfloat16", enable_warmup=False, **kwargs)
        try:
            run = sprof.measure(llm, prompts, sp, profile=False)
            graphs = _graph_stats(llm.engine)
        finally:
            llm.shutdown()
        del llm
        if min(run["launches"][k] for k in ("paged_decode_attention",
                                            "ragged_prefill_attention")) <= 0:
            failures.append(f"families_parity {name} at width: K1 or "
                                 f"K2 never launched: {run['launches']}")
        if not graphs["graph_replays"]:
            failures.append(f"families_parity {name}: no graph replay")
        if run["nonfinite_logprobs"] or not run["logprobs_recorded"] or \
                run["min_output_tokens"] != sp.max_tokens:
            failures.append(f"families_parity {name} at width: short "
                                 "outputs or non-finite logprobs")
        res[name]["width"] = dict(
            source=source, layers=layers, hidden=cfg.hidden_size,
            heads=cfg.num_attention_heads,
            output_tok_per_s=run["output_tok_per_s"],
            tpot_ms_median=run["tpot_ms_median"],
            ttft_ms_median=run["ttft_ms_median"],
            launches=run["launches"], graph_replays=graphs["graph_replays"],
            logprobs_recorded=run["logprobs_recorded"])
        emit({"phase": "families_parity", "family": name, **res[name]})
    if failures:
        raise AssertionError("; ".join(failures))
    return res


# --------------------------------------------------------------------- #
# The GPT families and GPT-OSS: K1 and K2 at hd 80 / 96, groups
# above 64, sinks with windows, ALiBi
# --------------------------------------------------------------------- #
# the engines' page-table widths over pages of 32: gptoss_serving's
# max_seq_len 640, gpt_families' 512
PAGES_GPTOSS, PAGES_FAMILY = 20, 16


def gpt_kernel_phase(results: dict) -> None:
    """K1 and K2 at the shapes this slice's runs launch them with, each
    held against its plain version (``_attention_case``: bf16 2e-2, and
    the plain version without the case's option must fail that check),
    timed beside it, its bound, and one SDPA call where one computes the
    same function (none with sinks): gpt-oss-20b's sliding layers (64 x
    64 heads over 8, sinks, window 128; 64 rows at 513-640 KV, one
    prefill step of 16 fresh 512-token prompts), bloom-7b1 (32 x 128 MHA,
    ALiBi), GPT-NeoX-20B (64 x 96 MHA), StableLM-3B-4E1T (32 x 80 MHA)
    and Falcon-7B (71 x 64 over one KV head), the families at
    gpt_families' shapes (16 rows at 257-288 KV, 16 fresh 256-token
    prompts). q is unscaled (scores of order one) so that the sinks and
    slopes weigh."""
    import torch
    bf = torch.bfloat16
    oss = [513 + (127 * i) // 63 for i in range(64)]
    fam = [257 + (31 * i) // 15 for i in range(16)]
    dec_fam = ([1] * 16, [k - 1 for k in fam])
    pre_fam = ([256] * 16, [0] * 16)
    for name, kind, (q_lens, ctx), qh, kvh, hd, window, opts, pages in [
            ("decode_gptoss", "decode", ([1] * 64, [k - 1 for k in oss]),
             64, 8, 64, 128, dict(sinks=True), PAGES_GPTOSS),
            ("prefill_gptoss", "prefill", ([512] * 16, [0] * 16), 64, 8, 64,
             128, dict(sinks=True), PAGES_GPTOSS),
            ("decode_alibi_bloom", "decode", dec_fam, 32, 32, 128, None,
             dict(alibi=True), PAGES_FAMILY),
            ("prefill_alibi_bloom", "prefill", pre_fam, 32, 32, 128, None,
             dict(alibi=True), PAGES_FAMILY),
            ("decode_hd96", "decode", dec_fam, 64, 64, 96, None, {},
             PAGES_FAMILY),
            ("prefill_hd96", "prefill", pre_fam, 64, 64, 96, None, {},
             PAGES_FAMILY),
            ("decode_hd80", "decode", dec_fam, 32, 32, 80, None, {},
             PAGES_FAMILY),
            ("decode_falcon7b", "decode", dec_fam, 71, 1, 64, None, {},
             PAGES_FAMILY),
            ("prefill_falcon7b", "prefill", pre_fam, 71, 1, 64, None, {},
             PAGES_FAMILY)]:
        results[name] = _attention_case(
            name, kind, q_lens, ctx, qh, kvh, window, None, bf,
            seed=60 + len(results), pages_per_seq=pages, hd=hd, q_scale=1.0,
            **opts)


# tiny float32 checkpoints of the GPT families for gpt_parity: the
# transformers config class and its fields beside GPT_TINY_BASE (head dim
# 64; GPT-NeoX at 96 and StableLM at 80, Falcon's 8 heads over one KV
# head, windows of 32 that the prompts outgrow)
GPT_TINY_BASE = dict(vocab_size=512, pad_token_id=0, eos_token_id=1,
                     bos_token_id=2)
GPT_TINY = {
    "gpt2": ("GPT2", dict(n_embd=256, n_head=4, n_layer=2,
                          n_positions=512)),
    "gpt_neox": ("GPTNeoX", dict(hidden_size=384, intermediate_size=768,
                                 num_hidden_layers=2, num_attention_heads=4,
                                 rotary_pct=0.25,
                                 max_position_embeddings=512,
                                 tie_word_embeddings=False)),
    "gptj": ("GPTJ", dict(n_embd=256, n_head=4, n_layer=2, rotary_dim=16,
                          n_positions=512, tie_word_embeddings=False)),
    "falcon": ("Falcon", dict(hidden_size=512, num_hidden_layers=2,
                              num_attention_heads=8, multi_query=True,
                              parallel_attn=True, bias=False,
                              new_decoder_architecture=False,
                              max_position_embeddings=512,
                              tie_word_embeddings=False)),
    "starcoder2": ("Starcoder2", dict(
        hidden_size=256, intermediate_size=512, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=512, sliding_window=32,
        tie_word_embeddings=False)),
    "cohere": ("Cohere", dict(hidden_size=256, intermediate_size=512,
                              num_hidden_layers=2, num_attention_heads=4,
                              num_key_value_heads=2,
                              max_position_embeddings=512, logit_scale=0.25,
                              use_qk_norm=False)),
    "nemotron": ("Nemotron", dict(
        hidden_size=256, intermediate_size=512, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=64,
        max_position_embeddings=512, partial_rotary_factor=0.5,
        tie_word_embeddings=False)),
    "cohere2": ("Cohere2", dict(
        hidden_size=256, intermediate_size=512, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, head_dim=64,
        sliding_window=32, sliding_window_pattern=4, logit_scale=0.25,
        max_position_embeddings=512)),
    "stablelm": ("StableLm", dict(
        hidden_size=320, intermediate_size=640, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=4,
        partial_rotary_factor=0.25, max_position_embeddings=512,
        tie_word_embeddings=False)),
    "bloom": ("Bloom", dict(hidden_size=256, n_head=4, n_layer=2)),
    "mpt": ("Mpt", dict(d_model=256, n_heads=4, n_layers=2,
                        expansion_ratio=2, max_seq_len=512)),
    "opt": ("OPT", dict(hidden_size=256, ffn_dim=512, num_hidden_layers=2,
                        num_attention_heads=4, max_position_embeddings=512,
                        word_embed_proj_dim=256,
                        do_layer_norm_before=True)),
}


def _save_tiny_gpt(path: Path, name: str) -> None:
    """A tiny random ``transformers`` model of GPT family ``name``
    (``GPT_TINY``) saved to ``path``, its norms and biases redrawn and its
    matrices scaled by 4 so that they matter (at the 0.02 of the
    families' own initialisation most greedy streams repeat one
    token)."""
    import torch
    import transformers as tf
    cls_name, fields = GPT_TINY[name]
    cfg = getattr(tf, cls_name + "Config")(**GPT_TINY_BASE, **fields)
    torch.manual_seed(51)
    model = getattr(tf, {"GPT2": "GPT2LMHead"}.get(cls_name, cls_name)
                    + ("Model" if cls_name == "GPT2" else "ForCausalLM"))(
        cfg).float()
    gen = torch.Generator().manual_seed(52)
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if pname.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
            elif "norm" in pname or "ln" in pname.split(".")[-2]:
                p.copy_(1 + torch.randn(p.shape, generator=gen) * 0.1)
            elif p.dim() == 2:
                p.mul_(4.0)
    model.save_pretrained(path)


def _save_tiny_gpt_oss_mxfp4(path: Path) -> None:
    """A tiny GPT-OSS checkpoint in the release layout, written from
    numpy (hidden 256, 4 q heads of 64 over 2 with sinks, windows of 32
    on the even layers, 4 experts top 2 whose gate|up and down weights
    are MXFP4 blocks and scales made by the port's ``quantize_mxfp4``; the
    other weights float32)."""
    import numpy as np
    import transformers as tf
    from safetensors.numpy import save_file
    from tensorrt_llm_tpu_torch.quantization.mxfp4 import quantize_mxfp4
    H, I, E, nq, nkv, hd, V, L = 256, 256, 4, 4, 2, 64, 512, 2
    cfg = tf.GptOssConfig(
        hidden_size=H, intermediate_size=I,
        num_hidden_layers=L, num_attention_heads=nq,
        num_key_value_heads=nkv, head_dim=hd, num_local_experts=E,
        num_experts_per_tok=2, sliding_window=32,
        layer_types=["sliding_attention", "full_attention"],
        rope_scaling=None, rope_theta=150000.0, max_position_embeddings=512,
        rms_norm_eps=1e-5, swiglu_limit=7.0, attention_bias=True,
        tie_word_embeddings=False, **GPT_TINY_BASE)
    rng = np.random.default_rng(53)

    def mat(*shape, std=0.05):
        return (rng.standard_normal(shape) * std).astype(np.float32)
    sd = {"model.embed_tokens.weight": mat(V, H, std=1.0),
          "model.norm.weight": 1 + mat(H, std=0.1),
          "lm_head.weight": mat(V, H)}
    for i in range(L):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": 1 + mat(H, std=0.1),
                   p + "post_attention_layernorm.weight": 1 + mat(H, std=0.1),
                   p + "self_attn.sinks": mat(nq, std=1.0),
                   p + "mlp.router.weight": mat(E, H, std=0.2),
                   p + "mlp.router.bias": mat(E, std=0.1),
                   p + "mlp.experts.gate_up_proj_bias": mat(E, 2 * I,
                                                            std=0.1),
                   p + "mlp.experts.down_proj_bias": mat(E, H, std=0.1)})
        for n, o in (("q", nq * hd), ("k", nkv * hd), ("v", nkv * hd)):
            sd[p + f"self_attn.{n}_proj.weight"] = mat(o, H)
            sd[p + f"self_attn.{n}_proj.bias"] = mat(o, std=0.1)
        sd[p + "self_attn.o_proj.weight"] = mat(H, nq * hd)
        sd[p + "self_attn.o_proj.bias"] = mat(H, std=0.1)
        # the release layout: [E, out, in] as blocks and scales
        for n, (o, k) in (("gate_up_proj", (2 * I, H)),
                          ("down_proj", (H, I))):
            blocks, scales = quantize_mxfp4(mat(E, o, k))
            sd[p + f"mlp.experts.{n}_blocks"] = blocks
            sd[p + f"mlp.experts.{n}_scales"] = scales
    path.mkdir(parents=True, exist_ok=True)
    cfg.save_pretrained(path)
    save_file(sd, str(path / "model.safetensors"))


def gpt_parity_phase() -> dict:
    """Each GPT family's tiny float32 checkpoint (``_save_tiny_gpt``) and
    a tiny GPT-OSS whose experts are MXFP4 blocks and scales
    (``_save_tiny_gpt_oss_mxfp4``) through ``LLM.generate`` on the card
    and on the CPU: greedy tokens identical, K1 and K2 launched on the
    card (with sinks for GPT-OSS, ALiBi for BLOOM and MPT)."""
    import torch  # noqa: F401
    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig, SamplingParams
    from tensorrt_llm_tpu_torch.ops.cuda import decode_attention as dec
    from tensorrt_llm_tpu_torch.ops.cuda import prefill_attention as pre
    prompts = [list(range(3, 90)), [5, 17, 99, 3, 64, 12, 7] * 6,
               [101, 2, 33, 400, 7]]
    n_out = 32
    failures, res = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in list(GPT_TINY) + ["gpt_oss_mxfp4"]:
            path = Path(tmp) / name
            if name == "gpt_oss_mxfp4":
                _save_tiny_gpt_oss_mxfp4(path)
            else:
                _save_tiny_gpt(path, name)
            toks = {}
            for dev in ("cpu", "cuda"):
                llm = LLM(str(path), device=dev, dtype="float32",
                          skip_tokenizer_init=True, max_batch_size=4,
                          max_input_len=128, max_seq_len=256,
                          max_num_tokens=256,
                          kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                                        max_tokens=4096))
                _zero_launches()
                for mod in (dec, pre):
                    mod.LAUNCHES_SINKS = mod.LAUNCHES_ALIBI = 0
                try:
                    outs = llm.generate(prompts, SamplingParams(
                        max_tokens=n_out, top_k=1, ignore_eos=True))
                    launches = _read_launches()
                finally:
                    llm.shutdown()
                toks[dev] = [o.outputs[0].token_ids for o in outs]
            opt = dict(sinks=[dec.LAUNCHES_SINKS, pre.LAUNCHES_SINKS],
                       alibi=[dec.LAUNCHES_ALIBI, pre.LAUNCHES_ALIBI])
            if toks["cuda"] != toks["cpu"]:
                failures.append(f"gpt_parity {name}: card {toks['cuda']} "
                                f"!= cpu {toks['cpu']}")
            if min(launches["paged_decode_attention"],
                   launches["ragged_prefill_attention"]) <= 0:
                failures.append(f"gpt_parity {name}: K1 or K2 never "
                                f"launched: {launches}")
            need = {"gpt_oss_mxfp4": "sinks", "bloom": "alibi",
                    "mpt": "alibi"}.get(name)
            if need and min(opt[need]) <= 0:
                failures.append(f"gpt_parity {name}: no K1 / K2 launch "
                                f"with {need}: {opt}")
            res[name] = dict(identical=toks["cuda"] == toks["cpu"],
                             tokens_each=n_out, launches=launches,
                             launches_with=opt)
            emit({"phase": "gpt_parity", "family": name, **res[name]})
    if failures:
        raise AssertionError("; ".join(failures))
    return res


def gpt_families_phase() -> dict:
    """Each GPT family at a published model's width
    (tools/serving_profile.py ``GPT_FAMILIES``: 2 layers, 4 for
    Command-R7B so that its global NoPE layer runs; seeded random bf16
    weights), 16 x 256 -> 32 greedy tokens through graphs (``--family
    NAME``): K1 and K2 launched (with ALiBi for bloom-7b1 and MPT-7B),
    windows replayed, every returned logprob finite. A smoke of the
    widths (hd 80, 96 and 256, 71 heads over one KV head, 256,000-token
    vocabularies), not a cell."""
    import gc
    import torch
    from tensorrt_llm_tpu_torch import LLM
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    failures, res = [], {}
    for name, (_, _, layers, source) in sprof.GPT_FAMILIES.items():
        cfg, kwargs, prompts, sp = sprof.family_workload(name)
        gc.collect()
        torch.cuda.empty_cache()
        llm = LLM(cfg, dtype="bfloat16", enable_warmup=False, **kwargs)
        try:
            eng = llm.engine
            run = sprof.measure(llm, prompts, sp, profile=False)
            graphs = _graph_stats(eng)
            spec = eng.model.attn_spec
        finally:
            llm.shutdown()
        del llm, eng
        if min(run["launches"][k] for k in ("paged_decode_attention",
                                            "ragged_prefill_attention")) <= 0:
            failures.append(f"gpt_families {name}: K1 or K2 never "
                            f"launched: {run['launches']}")
        if spec.alibi_slopes and min(run["launches_alibi"].values()) <= 0:
            failures.append(f"gpt_families {name}: no launch with ALiBi")
        if not graphs["graph_replays"]:
            failures.append(f"gpt_families {name}: no graph replay")
        if run["nonfinite_logprobs"] or not run["logprobs_recorded"] or \
                run["min_output_tokens"] != sp.max_tokens:
            failures.append(f"gpt_families {name}: short outputs or "
                            "non-finite logprobs")
        res[name] = dict(
            source=source, layers=layers, hidden=spec.num_heads
            * spec.head_dim, heads=spec.num_heads, kv_heads=spec.num_kv_heads,
            head_dim=spec.head_dim, output_tok_per_s=run["output_tok_per_s"],
            tpot_ms_median=run["tpot_ms_median"],
            ttft_ms_median=run["ttft_ms_median"], launches=run["launches"],
            launches_alibi=run["launches_alibi"],
            graph_replays=graphs["graph_replays"],
            logprobs_recorded=run["logprobs_recorded"])
        emit({"phase": "gpt_families", "family": name, **res[name]})
    if failures:
        raise AssertionError("; ".join(failures))
    return res


def gptoss_serving_phase() -> dict:
    """gpt-oss-20b at its published width and depth (24 layers, hidden
    2,880, 64 x 64 q heads over 8 with sinks, windows of 128 on the even
    layers, 32 experts top 4; seeded random bf16 weights, ~41.8 GB), 64
    requests of 512 prompt tokens -> 128 greedy tokens with
    ``ignore_eos``, one bf16 KV pool, ``LLM`` defaults (64 rows, K = 8
    windows, depth 4, CUDA graphs), prefix reuse off
    (tools/serving_profile.py ``--geometry gpt-oss-20b``): a warm-up, a
    timed pass (tok/s, TTFT and TPOT median and max, K1 / K2 launches
    and those that carried sinks) and a profiled pass (device idle share,
    GPU time by class: grouped expert products, K1, K2, library GEMMs,
    the rest), weights and peak memory. Fails if a request comes back
    short or out of the vocabulary, if K1 and K2 did not launch with
    sinks, if no window replayed K1, or if the graph pool outgrew its
    reserve."""
    import gc

    import torch
    from tensorrt_llm_tpu_torch import LLM
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    cfg, kwargs, prompts, sp = sprof.workload(geometry="gpt-oss-20b")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    llm = LLM(cfg, dtype="bfloat16", **kwargs)
    build_s = time.monotonic() - t0
    try:
        eng = llm.engine
        weights_bytes = sum(t.numel() * t.element_size()
                            for t in _tensors(eng.params))
        replayed0 = eng.graphs.replayed_launches()
        res = sprof.measure(llm, prompts, sp)
        graphs = _graph_stats(eng)
        graphs["replayed_launches"] = {
            k: v - replayed0[_kernel_counts()[k].__name__]
            for k, v in graphs["replayed_launches"].items()}
        reserve = eng.graph_pool_reserve()
        pages = eng.num_kv_pages
        kv_bytes_per_token = eng.bytes_per_kv_block // eng.page_size
        outs = llm.generate(prompts[:4], sp)
    finally:
        llm.shutdown()
    peak = torch.cuda.max_memory_allocated()
    del llm, eng
    gc.collect()
    torch.cuda.empty_cache()
    V = cfg.vocab_size
    for o in outs:
        toks = o.outputs[0].token_ids
        if len(toks) != sp.max_tokens or not all(0 <= t < V for t in toks):
            raise AssertionError(f"gptoss_serving: bad output {toks}")
    if res["output_tokens"] != len(prompts) * sp.max_tokens or \
            res["nonfinite_logprobs"]:
        raise AssertionError(f"gptoss_serving: {res['output_tokens']} "
                             "tokens, or non-finite logprobs")
    res.update(model="gpt-oss-20b", layers=cfg.num_hidden_layers,
               experts=cfg.num_local_experts,
               top_k=cfg.num_experts_per_tok, engine_build_s=build_s,
               weights_bytes=weights_bytes, peak_allocated_bytes=peak,
               kv_pool_pages=pages, kv_bytes_per_token=kv_bytes_per_token,
               graph_pool_reserve_bytes=reserve, graphs=graphs)
    emit({"phase": "gptoss_serving", **res})
    if not graphs["graph_replays"] or not \
            graphs["replayed_launches"]["paged_decode_attention"]:
        raise AssertionError(f"gptoss_serving: no window replayed K1: "
                             f"{graphs}")
    if min(res["launches_sinks"].values()) <= 0 or \
            res["launches_sinks"] != {k: res["launches"][k]
                                      for k in res["launches_sinks"]}:
        raise AssertionError(f"gptoss_serving: K1 / K2 launches without "
                             f"sinks: {res['launches']} "
                             f"{res['launches_sinks']}")
    _check_reserve(res)
    return res


# --------------------------------------------------------------------- #
# The DeepSeek-style families: MLA over a latent pool, routed MoE
# --------------------------------------------------------------------- #
def _save_tiny_deepseek(path: Path, kind: str) -> None:
    """A tiny DeepSeek checkpoint written from a seeded numpy generator
    (config.json and model.safetensors under the published names, so that
    no ``transformers`` module layout enters): hidden 256, 4 MLA heads over
    a latent of 64 + 32, 3 layers (one dense), 8 experts top 2 of width
    128, one shared expert, vocab 512; "v3" with ``q_lora_rank`` 96 and a
    correction bias, "v2" group-limited (2 groups, 1 kept) without
    ``q_lora_rank``. Routers at std 0.5 so that top-k choices are
    decisive, norms near 1."""
    import numpy as np
    from safetensors.numpy import save_file
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    H, nh, lora, rope, nope, vd, E, Im, I, V, L = \
        256, 4, 64, 32, 64, 64, 8, 128, 512, 512, 3
    fields = dict(vocab_size=V, hidden_size=H, intermediate_size=I,
                  moe_intermediate_size=Im, num_hidden_layers=L,
                  num_attention_heads=nh, num_key_value_heads=nh,
                  n_routed_experts=E, num_experts_per_tok=2,
                  n_shared_experts=1, kv_lora_rank=lora,
                  qk_rope_head_dim=rope, qk_nope_head_dim=nope,
                  v_head_dim=vd, first_k_dense_replace=1,
                  max_position_embeddings=1024, rms_norm_eps=1e-6,
                  tie_word_embeddings=False)
    if kind == "v3":
        fields.update(q_lora_rank=96, n_group=1, topk_group=1,
                      norm_topk_prob=True, routed_scaling_factor=2.5)
        cfg = sprof._config("DeepseekV3Config", "deepseek_v3", fields)
    else:
        fields.update(q_lora_rank=None, topk_method="group_limited_greedy",
                      n_group=2, topk_group=1, routed_scaling_factor=1.0)
        cfg = sprof._config("DeepseekV2Config", "deepseek_v2", fields)
    cfg.save_pretrained(path)
    rng = np.random.default_rng(31 if kind == "v3" else 32)

    def mat(*shape, std=0.05):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def norm(n):
        return (1 + rng.standard_normal(n) * 0.1).astype(np.float32)

    sd = {"model.embed_tokens.weight": mat(V, H, std=1.0),
          "model.norm.weight": norm(H), "lm_head.weight": mat(V, H)}
    for i in range(L):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        sd.update({p + "input_layernorm.weight": norm(H),
                   p + "post_attention_layernorm.weight": norm(H),
                   a + "kv_a_proj_with_mqa.weight": mat(lora + rope, H),
                   a + "kv_a_layernorm.weight": norm(lora),
                   a + "kv_b_proj.weight": mat(nh * (nope + vd), lora),
                   a + "o_proj.weight": mat(H, nh * vd)})
        if kind == "v3":
            sd.update({a + "q_a_proj.weight": mat(96, H),
                       a + "q_a_layernorm.weight": norm(96),
                       a + "q_b_proj.weight": mat(nh * (nope + rope), 96)})
        else:
            sd[a + "q_proj.weight"] = mat(nh * (nope + rope), H)
        m = p + "mlp."
        if i == 0:
            sd.update({m + "gate_proj.weight": mat(I, H),
                       m + "up_proj.weight": mat(I, H),
                       m + "down_proj.weight": mat(H, I)})
            continue
        sd[m + "gate.weight"] = mat(E, H, std=0.5)
        if kind == "v3":
            sd[m + "gate.e_score_correction_bias"] = mat(E, std=0.1)
        for e in range(E):
            x = f"{m}experts.{e}."
            sd.update({x + "gate_proj.weight": mat(Im, H),
                       x + "up_proj.weight": mat(Im, H),
                       x + "down_proj.weight": mat(H, Im)})
        sd.update({m + "shared_experts.gate_proj.weight": mat(Im, H),
                   m + "shared_experts.up_proj.weight": mat(Im, H),
                   m + "shared_experts.down_proj.weight": mat(H, Im)})
    save_file(sd, str(path / "model.safetensors"))


def deepseek_parity_phase() -> dict:
    """Tiny DeepSeek-V3 (with ``q_lora_rank``) and DeepSeek-V2
    (group-limited) checkpoints (``_save_tiny_deepseek``) through
    ``LLM.generate`` in float32, card against the port's CPU path: every
    request queued before admission (so the schedule follows from the
    workload), 4 rows for 7 requests of differing lengths, K = 4 windows
    with rider chunks of 32 tokens (``mixed_window_ctx``): greedy tokens
    identical, the windows taking the absorbed MLA path and the rider
    windows and prefill steps the decompressed one on both devices; then
    the card run again without graphs, tokens identical to the replays.
    Fails otherwise, or if no window was replayed, no rider window ran or
    either path was never taken."""
    import numpy as np
    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig, SamplingParams
    from tensorrt_llm_tpu_torch.models import deepseek
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    rng = np.random.default_rng(33)
    lens = (40, 9, 57, 23, 70, 31, 12)
    prompts = [rng.integers(1, 511, n).tolist() for n in lens]
    sps = [SamplingParams(max_tokens=n, top_k=1, ignore_eos=True)
           for n in (24, 6, 30, 12, 20, 16, 8)]
    kw = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
              max_input_len=96, max_seq_len=160, max_num_tokens=128,
              decode_multi_step=4, mixed_window_ctx=32,
              kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                            max_tokens=4096))
    res, failures = {}, []

    def run(path, device, capture=None):
        llm = LLM(str(path), device=device,
                  enable_warmup=capture is not False, **kw)
        if capture is not None:
            llm.engine.graphs.capture = capture
        a0, d0 = deepseek.MLA_ABSORBED, deepseek.MLA_DECOMPRESSED
        try:
            toks = _queued_generate(llm, prompts, sps)
            eng = llm.engine
            stats = dict(mixed_windows=eng.mixed_windows_dispatched,
                         absorbed=deepseek.MLA_ABSORBED - a0,
                         decompressed=deepseek.MLA_DECOMPRESSED - d0)
            if device == "cuda":
                stats.update(graph_replays=eng.graphs.replays,
                             mla_graph_calls=sprof.mla_graph_calls(eng))
        finally:
            llm.shutdown()
        return toks, stats

    with tempfile.TemporaryDirectory() as tmp:
        for kind in ("v3", "v2"):
            path = Path(tmp) / kind
            path.mkdir()
            _save_tiny_deepseek(path, kind)
            cpu, cpu_stats = run(path, "cpu")
            card, card_stats = run(path, "cuda")
            eager, _ = run(path, "cuda", capture=False)
            r = dict(kind=kind, identical=card == cpu,
                     graph_equals_eager=eager == card, cpu=cpu_stats,
                     card=card_stats)
            emit({"phase": "deepseek_parity", **r})
            if card != cpu or eager != card:
                failures.append(f"deepseek_parity {kind}: card {card} / "
                                f"eager {eager} != cpu {cpu}")
            if [len(t) for t in card] != [sp.max_tokens for sp in sps]:
                failures.append(f"deepseek_parity {kind}: short outputs")
            for dev, st in (("cpu", cpu_stats), ("cuda", card_stats)):
                if not (st["mixed_windows"] and st["absorbed"] and
                        st["decompressed"]):
                    failures.append(f"deepseek_parity {kind} {dev}: a path "
                                    f"or the rider window never ran: {st}")
            windows = card_stats["mla_graph_calls"].get("multi", {})
            if not card_stats["graph_replays"] or not windows.get(
                    "absorbed") or windows.get("decompressed"):
                failures.append(f"deepseek_parity {kind}: replayed windows "
                                f"not all absorbed: {card_stats}")
            res[kind] = r
    if failures:
        raise AssertionError("; ".join(failures))
    return res


def deepseek_serving_phase() -> dict:
    """DeepSeek-V2-Lite at its published width, its first 9 of 27 layers
    (``DEEPSEEK_SERVING_LAYERS``, for the script's time limit; hidden
    2,048, 16 MLA heads over one latent row of 512 + 64 a token, 64
    experts top 6 and 2 shared after one dense layer, yarn factor 40;
    seeded random bf16 weights, ~31.4 GB at full depth), 64 requests of
    512 prompt tokens -> 128 greedy tokens with ``ignore_eos``, one bf16
    latent pool,
    ``LLM`` defaults (64 rows, K = 8 windows, depth 4, CUDA graphs) but
    8,192 tokens a prefill step and prefix reuse off
    (tools/serving_profile.py ``--geometry deepseek-v2-lite``): a
    warm-up, a timed pass (tok/s, TTFT and TPOT median and max, MLA calls
    by path) and a profiled pass (device idle share, GPU time by class:
    MLA's float32 einsums, grouped expert products, library GEMMs, the
    rest), weights, peak memory, the latent pool's bytes a token, and the
    MLA calls of graph replays by graph kind. Then a second engine of the
    same model built for 16,384 positions a sequence serves a
    long-context stage (``_deepseek_long_context``): 16 requests of 512
    -> 32 decoding while two prompts of 12,288 tokens prefill beside them
    -> 16, whose mixed steps decompress every sequence's latents over up
    to 12,288 positions in chunks; on it the decompressed path at the
    model's widths (8 sequences of 64 query tokens over 4,096 positions,
    layer 0's ``kv_b``) runs in chunks of 512 positions against one
    chunk (``_mla_chunking_check``). Fails if a
    request comes back short, out of the vocabulary or with a non-finite
    logprob, if no window was replayed, if a replayed window (without
    riders) took the decompressed path or none took the absorbed one, if
    the prefill steps took no decompressed call, if the chunked path
    parts from one chunk by more than 1e-4, or if the graph pool outgrew
    its reserve."""
    import gc

    import torch
    from tensorrt_llm_tpu_torch import LLM
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    _, kwargs, prompts, sp = sprof.workload(geometry="deepseek-v2-lite")
    cfg = sprof.deepseek_v2_lite_config(DEEPSEEK_SERVING_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    llm = LLM(cfg, dtype="bfloat16", **kwargs)
    build_s = time.monotonic() - t0
    try:
        eng = llm.engine
        weights_bytes = sum(t.numel() * t.element_size()
                            for t in _tensors(eng.params))
        res = sprof.measure(llm, prompts, sp)
        graphs = _graph_stats(eng)
        graphs["mla_calls"] = sprof.mla_graph_calls(eng)
        reserve = eng.graph_pool_reserve()
        pages = eng.num_kv_pages
        kv_bytes_per_token = eng.bytes_per_kv_block // eng.page_size
        pool_shape = list(eng.kv_pages.shape)
        outs = llm.generate(prompts[:4], sp)
    finally:
        llm.shutdown()
    peak = torch.cuda.max_memory_allocated()
    del llm, eng
    gc.collect()
    torch.cuda.empty_cache()
    long_ctx = _deepseek_long_context(cfg, kwargs)
    V = cfg.vocab_size
    for o in outs:
        toks = o.outputs[0].token_ids
        if len(toks) != sp.max_tokens or not all(0 <= t < V for t in toks):
            raise AssertionError(f"deepseek_serving: bad output {toks}")
    if res["output_tokens"] != len(prompts) * sp.max_tokens or \
            res["nonfinite_logprobs"]:
        raise AssertionError(f"deepseek_serving: {res['output_tokens']} "
                             "tokens, or non-finite logprobs")
    res.update(model="DeepSeek-V2-Lite", layers=cfg.num_hidden_layers,
               experts=cfg.n_routed_experts, top_k=cfg.num_experts_per_tok,
               engine_build_s=build_s, weights_bytes=weights_bytes,
               peak_allocated_bytes=peak, kv_pool_pages=pages,
               kv_pool_shape=pool_shape,
               kv_bytes_per_token=kv_bytes_per_token,
               graph_pool_reserve_bytes=reserve, graphs=graphs,
               long_context=long_ctx)
    emit({"phase": "deepseek_serving", **res})
    windows = graphs["mla_calls"].get("multi", {})
    if not graphs["graph_replays"] or not windows.get("absorbed") or \
            windows.get("decompressed"):
        raise AssertionError(f"deepseek_serving: replayed windows not all "
                             f"absorbed: {graphs['mla_calls']}")
    if not res["mla_calls"]["decompressed"]:
        raise AssertionError(f"deepseek_serving: no decompressed MLA call "
                             f"in the prefill steps: {res['mla_calls']}")
    if not long_ctx["mla_chunking"]["max_abs_err"] <= 1e-4:
        raise AssertionError(f"deepseek_serving: the decompressed path in "
                             f"chunks parts from one chunk: "
                             f"{long_ctx['mla_chunking']}")
    if long_ctx["bad_outputs"] or not long_ctx["mla_calls"]["decompressed"]:
        raise AssertionError(f"deepseek_serving: long-context stage: "
                             f"{long_ctx}")
    _check_reserve(res)
    _check_reserve(long_ctx)
    return res


def _mla_chunking_check(eng) -> dict:
    """The decompressed MLA path at the served model's widths (layer 0's
    ``kv_b``, seeded random latents and queries of the model's type):
    8 sequences of 64 query tokens ending at 4,096 positions, in chunks
    of 512 positions (``MLA_CHUNK_BYTES`` cut to 8 x 512 positions' keys
    and values) against one chunk; float32, TF32 off. Returns the max abs
    difference and each version's time (CUDA events, median of 3) beside
    the host's time to issue it (the median's run)."""
    import torch
    from tensorrt_llm_tpu_torch.models import deepseek
    from tensorrt_llm_tpu_torch.ops.attention import AttentionMetadata
    model, dev = eng.model, eng.device
    S, q, N, ps = 8, 64, 4096, eng.page_size
    nh, nope, rope = model.num_heads, model.qk_nope, model.qk_rope
    lora = model.kv_lora_rank
    g = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(model.dtype)
    q_nope, q_pe = rnd(S * q, nh, nope), rnd(S * q, nh, rope)
    c_all, kpe = rnd(S, N, lora), rnd(S, N, rope)
    cu = torch.arange(S + 1, device=dev, dtype=torch.int32) * q
    md = AttentionMetadata(
        kv_lens=torch.full((S,), N, dtype=torch.int32, device=dev),
        page_indices=torch.arange(S * N // ps, dtype=torch.int32,
                                  device=dev).view(S, -1),
        cu_q_lens=cu, num_seqs=torch.tensor([S], device=dev),
        slot_mapping=torch.zeros(S * q, dtype=torch.int32, device=dev),
        positions=torch.zeros(S * q, dtype=torch.int32, device=dev),
        logits_indices=cu[1:] - 1, max_q_len=q, max_kv_len=N)
    ctx = model._mla_context(md, S * q, ps, absorbed=False)
    kv_b = eng.params["layers"][0]["kv_b"]

    def run():
        return model._decompressed(q_nope, q_pe, c_all, kpe,
                                   lambda c: model.m_lin.apply(kv_b, c), ctx)
    budget = deepseek.MLA_CHUNK_BYTES
    width = nh * (nope + model.v_dim)
    outs, ms, host = {}, {}, {}
    try:
        for label, b in (("one_chunk", 1 << 40),
                         ("chunked", S * width * 6 * 512)):
            deepseek.MLA_CHUNK_BYTES = b
            times = []
            for _ in range(3):
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                h0 = time.perf_counter()
                t0.record()
                outs[label] = run()
                t1.record()
                h1 = time.perf_counter()
                torch.cuda.synchronize()
                times.append((t0.elapsed_time(t1), (h1 - h0) * 1e3))
            ms[label], host[label] = sorted(times)[1]
    finally:
        deepseek.MLA_CHUNK_BYTES = budget
    err = (outs["chunked"] - outs["one_chunk"]).abs().max().item()
    return dict(sequences=S, query_tokens=S * q, positions=N,
                chunk_positions=512, max_abs_err=err,
                finite=bool(torch.isfinite(outs["chunked"]).all()),
                one_chunk_ms=ms["one_chunk"], chunked_ms=ms["chunked"],
                one_chunk_host_ms=host["one_chunk"],
                chunked_host_ms=host["chunked"])


def _deepseek_long_context(cfg, kwargs: dict, long_len: int = 12288,
                           **engine) -> dict:
    """An ``LLM`` of ``cfg`` with ``kwargs`` but built for 16,384
    positions a sequence (``engine`` overrides the LLM arguments): the
    chunking check on its engine (``_mla_chunking_check``), then 16
    requests of 512 seeded tokens -> 32 greedy tokens, and two of
    ``long_len`` tokens -> 16 that arrive once the first short one has a
    token, so that their chunks prefill in mixed steps beside the decode
    rows (the decompressed path over every sequence at up to
    ``long_len`` positions). Returns the wall time, the long requests'
    TTFT, MLA calls by path, peak allocated memory, the engine's KV pages,
    graph pool and its reserve, and the outputs that came back short, out
    of the vocabulary or with a non-finite logprob."""
    import gc

    import torch
    from tensorrt_llm_tpu_torch import LLM, SamplingParams
    V = cfg.vocab_size
    gen = torch.Generator().manual_seed(3)
    short = torch.randint(0, V, (16, 512), generator=gen).tolist()
    long = torch.randint(0, V, (2, long_len), generator=gen).tolist()
    sps = [SamplingParams(max_tokens=32, top_k=1, ignore_eos=True),
           SamplingParams(max_tokens=16, top_k=1, ignore_eos=True)]
    torch.cuda.reset_peak_memory_stats()
    llm = LLM(cfg, **{**kwargs, "max_input_len": long_len,
                      "max_seq_len": 16384, "dtype": "bfloat16", **engine})
    try:
        res = _long_context_pass(llm, short, long, sps)
        res.update(mla_chunking=_mla_chunking_check(llm.engine),
                   kv_pool_pages=llm.engine.num_kv_pages,
                   max_seq_len=llm.engine.max_seq_len,
                   graph_pool_reserve_bytes=llm.engine.graph_pool_reserve(),
                   graphs=_graph_stats(llm.engine))
    finally:
        llm.shutdown()
    res["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    del llm
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _long_context_pass(llm, short, long, sps) -> dict:
    """The long-context stage's requests through ``llm`` (see
    ``_deepseek_long_context``)."""
    from tensorrt_llm_tpu_torch.models import deepseek
    V = llm.engine.model.vocab_size
    a0, d0 = deepseek.MLA_ABSORBED, deepseek.MLA_DECOMPRESSED
    t0 = time.monotonic()
    futs = [llm.generate_async(p, sps[0]) for p in short]
    deadline = time.monotonic() + 300
    while not futs[0]._result.request.output_token_ids:
        if time.monotonic() > deadline:
            raise AssertionError("deepseek_serving: no first token")
        time.sleep(0.005)
    futs += [llm.generate_async(p, sps[1]) for p in long]
    outs = [f.result(600) for f in futs]
    wall = time.monotonic() - t0
    bad = []
    for i, o in enumerate(outs):
        toks = o.outputs[0].token_ids
        lps = [v for d in (o.outputs[0].logprobs or []) for v in d.values()]
        n = sps[i >= len(short)].max_tokens
        if len(toks) != n or not all(0 <= t < V for t in toks) or \
                not all(math.isfinite(v) for v in lps):
            bad.append(i)
    perf = [o._result.request.perf for o in outs[len(short):]]
    return dict(requests=len(outs), long_prompt_tokens=len(long[0]),
                wall_ms=wall * 1e3,
                long_ttft_ms=[(p.first_token_time - p.arrival_time) * 1e3
                              for p in perf],
                mla_calls=dict(absorbed=deepseek.MLA_ABSORBED - a0,
                               decompressed=deepseek.MLA_DECOMPRESSED - d0),
                bad_outputs=bad)


def moe_families_phase() -> dict:
    """Each family of this slice at a published model's width
    (tools/serving_profile.py ``MOE_FAMILIES``: GLM-4.5-Air,
    ERNIE-4.5-21B-A3B, Hunyuan-A13B, Granite-3.1-3B-A800M, DeepSeek-V3
    with one dense layer before one MoE layer, Hunyuan-7B, Seed-OSS-36B,
    ERNIE-4.5-0.3B, Apertus-8B; 2 layers; seeded random bf16 weights),
    16 x 256 -> 32 greedy tokens through graphs (``--family NAME``): K1
    and K2 launched (MLA instead for DeepSeek-V3: absorbed calls replayed
    in windows, decompressed ones in prefill), windows replayed, every
    returned logprob finite. A smoke of the widths, not a cell."""
    import gc
    import torch
    from tensorrt_llm_tpu_torch import LLM
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    failures, res = [], {}
    for name, (_, _, layers, source) in sprof.MOE_FAMILIES.items():
        cfg, kwargs, prompts, sp = sprof.family_workload(name)
        gc.collect()
        torch.cuda.empty_cache()
        llm = LLM(cfg, dtype="bfloat16", enable_warmup=False, **kwargs)
        try:
            eng = llm.engine
            run = sprof.measure(llm, prompts, sp, profile=False)
            graphs = _graph_stats(eng)
            spec = getattr(eng.model, "attn_spec", None)
            mla = sprof.mla_graph_calls(eng) if spec is None else None
        finally:
            llm.shutdown()
        del llm, eng
        if spec is None:
            windows = mla.get("multi", {})
            if not windows.get("absorbed") or windows.get("decompressed") \
                    or not run["mla_calls"]["decompressed"]:
                failures.append(f"moe_families {name}: MLA paths {mla} "
                                f"{run['mla_calls']}")
        elif min(run["launches"][k] for k in ("paged_decode_attention",
                                              "ragged_prefill_attention")) \
                <= 0:
            failures.append(f"moe_families {name}: K1 or K2 never "
                            f"launched: {run['launches']}")
        if not graphs["graph_replays"]:
            failures.append(f"moe_families {name}: no graph replay")
        if run["nonfinite_logprobs"] or not run["logprobs_recorded"] or \
                run["min_output_tokens"] != sp.max_tokens:
            failures.append(f"moe_families {name}: short outputs or "
                            "non-finite logprobs")
        res[name] = dict(
            source=source, layers=layers, hidden=cfg.hidden_size,
            heads=cfg.num_attention_heads,
            kv_heads=None if spec is None else spec.num_kv_heads,
            head_dim=None if spec is None else spec.head_dim,
            output_tok_per_s=run["output_tok_per_s"],
            tpot_ms_median=run["tpot_ms_median"],
            ttft_ms_median=run["ttft_ms_median"], launches=run["launches"],
            mla_calls=run.get("mla_calls"), mla_graph_calls=mla,
            graph_replays=graphs["graph_replays"],
            logprobs_recorded=run["logprobs_recorded"])
        emit({"phase": "moe_families", "family": name, **res[name]})
    if failures:
        raise AssertionError("; ".join(failures))
    return res


# tiny float32 checkpoints of the recurrent families for recurrent_parity:
# the transformers config class and its fields (vocab 512, attention at
# head dim 64 where the family has attention, SSD chunks of 16 tokens so
# that the prompts cross chunks)
RECURRENT_TINY = {
    "mamba": ("Mamba", dict(hidden_size=256, num_hidden_layers=2,
                            state_size=16, conv_kernel=4, expand=2,
                            time_step_rank=16)),
    "falcon_mamba": ("FalconMamba", dict(
        hidden_size=256, num_hidden_layers=2, state_size=16, conv_kernel=4,
        expand=2, time_step_rank=16)),
    "mamba2": ("Mamba2", dict(
        hidden_size=256, num_hidden_layers=2, state_size=32, conv_kernel=4,
        expand=2, num_heads=8, head_dim=64, n_groups=2, chunk_size=16)),
    "bamba": ("Bamba", dict(
        hidden_size=256, intermediate_size=512, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2,
        attn_layer_indices=[1, 3], mamba_n_heads=8, mamba_d_head=64,
        mamba_d_state=32, mamba_n_groups=2, mamba_expand=2, mamba_d_conv=4,
        mamba_chunk_size=16)),
    "granitemoehybrid": ("GraniteMoeHybrid", dict(
        hidden_size=256, intermediate_size=128, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
        num_experts_per_tok=2,
        layer_types=["mamba", "attention", "mamba", "attention"],
        mamba_n_heads=8, mamba_d_head=64, mamba_d_state=32,
        mamba_n_groups=2, mamba_expand=2, mamba_d_conv=4,
        mamba_chunk_size=16, shared_intermediate_size=256,
        embedding_multiplier=2.0, residual_multiplier=0.5,
        attention_multiplier=0.125, logits_scaling=3.0)),
    "zamba2": ("Zamba2", dict(
        hidden_size=128, intermediate_size=256, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=4, mamba_d_state=32,
        mamba_ngroups=1, mamba_expand=2, mamba_d_conv=4, n_mamba_heads=4,
        chunk_size=16,
        layers_block_type=["mamba", "hybrid", "mamba", "hybrid"],
        num_mem_blocks=2, use_mem_rope=True,
        use_shared_attention_adapter=True, adapter_rank=8)),
    "jamba": ("Jamba", dict(
        hidden_size=256, intermediate_size=256, num_hidden_layers=8,
        num_attention_heads=4, num_key_value_heads=2, num_experts=4,
        num_experts_per_tok=2, mamba_d_state=16, mamba_d_conv=4,
        mamba_expand=2, mamba_dt_rank=16, use_mamba_kernels=False)),
    "lfm2": ("Lfm2", dict(
        hidden_size=256, intermediate_size=512, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, conv_L_cache=3,
        layer_types=["conv", "full_attention", "conv", "full_attention"])),
    "qwen3_next": ("Qwen3Next", dict(
        hidden_size=256, intermediate_size=256, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, head_dim=64,
        linear_num_value_heads=4, linear_num_key_heads=2,
        linear_key_head_dim=32, linear_value_head_dim=32,
        linear_conv_kernel_dim=4, num_experts=4, num_experts_per_tok=2,
        moe_intermediate_size=64, shared_expert_intermediate_size=64,
        decoder_sparse_step=1)),
    "minimax": ("MiniMax", dict(
        hidden_size=256, intermediate_size=256, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, head_dim=64,
        num_local_experts=4, num_experts_per_tok=2, block_size=16,
        layer_types=["linear_attention", "full_attention"] * 2)),
}
HYBRIDS = ("bamba", "granitemoehybrid", "zamba2", "jamba", "lfm2",
           "qwen3_next", "minimax")


def _save_tiny_recurrent(path: Path, name: str) -> None:
    """A tiny seeded float32 ``transformers`` model of recurrent family
    ``name`` (``RECURRENT_TINY``), its norms and biases redrawn, saved to
    ``path`` (the release layout's names)."""
    import torch
    import transformers
    stem, fields = RECURRENT_TINY[name]
    cfg = getattr(transformers, stem + "Config")(
        vocab_size=512, max_position_embeddings=512,
        tie_word_embeddings=False, **fields)
    torch.manual_seed(41)
    model = getattr(transformers, stem + "ForCausalLM")(cfg).float()
    gen = torch.Generator().manual_seed(42)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith(".bias") and "conv1d" not in n:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
            elif "norm" in n and p.dim() == 1:
                p.copy_(p + torch.randn(p.shape, generator=gen) * 0.1)
            elif n.endswith("gate.weight") or "router" in n:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    model.save_pretrained(path)


def _bamba_module(kinds, dtype):
    """A ``transformers`` Bamba of Bamba-9B's widths with the layers
    ``kinds`` and seeded random weights (``RandomCheckpoint``, drawn on
    the card), its tensors on the host: both devices' ``LLM`` read the
    same numbers from it."""
    import torch
    import transformers
    from tensorrt_llm_tpu_torch.models.recurrent import (RandomCheckpoint,
                                                         meta_shapes)
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    cfg = sprof.bamba_9b_config(kinds=kinds)
    shapes = meta_shapes(transformers.BambaForCausalLM, cfg)
    ckpt = RandomCheckpoint(shapes, "cuda", dtype, seed=5)
    with torch.device("meta"):
        model = transformers.BambaForCausalLM(cfg)
    model.load_state_dict({k: ckpt[k].cpu() for k in shapes}, assign=True)
    return model.eval()


def recurrent_parity_phase() -> dict:
    """Each recurrent family's tiny float32 checkpoint
    (``_save_tiny_recurrent``) through ``LLM.generate``, the card against
    the port's CPU path: every request queued before admission, 4 rows for
    7 requests of differing lengths (later ones take recycled slots), K =
    4 windows: greedy tokens identical card against CPU and graph replays
    against the card run eagerly, and K1 and K2 launched on the card for
    the hybrids. Then Bamba-9B's widths at 2 layers (one Mamba2, one
    attention; seeded random float32 weights, ``_bamba_module``): 4
    prompts of 96 tokens -> 8 greedy tokens, the card against the CPU,
    identical wherever the CPU decides by more than 3e-2 in
    log-probability. Fails otherwise."""
    import numpy as np
    import torch
    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig, SamplingParams
    rng = np.random.default_rng(43)
    lens = (40, 9, 57, 23, 70, 31, 12)
    prompts = [rng.integers(3, 509, n).tolist() for n in lens]
    sps = [SamplingParams(max_tokens=n, top_k=1, ignore_eos=True)
           for n in (24, 6, 30, 12, 20, 16, 8)]
    kw = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
              max_input_len=96, max_seq_len=160, max_num_tokens=256,
              decode_multi_step=4,
              kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                            max_tokens=4096))
    res, failures = {}, []

    def run(path, device, capture=None):
        llm = LLM(str(path), device=device,
                  enable_warmup=capture is not False, **kw)
        if capture is not None:
            llm.engine.graphs.capture = capture
        if device == "cuda":
            _zero_launches()
        try:
            toks = _queued_generate(llm, prompts, sps)
            stats = {}
            if device == "cuda":
                stats = dict(launches=_read_launches(),
                             graph_replays=llm.engine.graphs.replays)
        finally:
            llm.shutdown()
        return toks, stats

    with tempfile.TemporaryDirectory() as tmp:
        for name in RECURRENT_TINY:
            path = Path(tmp) / name
            path.mkdir()
            _save_tiny_recurrent(path, name)
            try:
                cpu, _ = run(path, "cpu")
                card, st = run(path, "cuda")
                eager, _ = run(path, "cuda", capture=False)
            except Exception as e:        # the next family still runs
                failures.append(f"recurrent_parity {name}: {e!r}")
                emit({"phase": "recurrent_parity", "family": name,
                      "error": repr(e)})
                continue
            r = dict(family=name, identical=card == cpu,
                     graph_equals_eager=eager == card, **st)
            emit({"phase": "recurrent_parity", **r})
            if card != cpu or eager != card:
                failures.append(f"recurrent_parity {name}: card {card} / "
                                f"eager {eager} != cpu {cpu}")
            if [len(t) for t in card] != [sp.max_tokens for sp in sps]:
                failures.append(f"recurrent_parity {name}: short outputs")
            if not st["graph_replays"]:
                failures.append(f"recurrent_parity {name}: no replay")
            if name in HYBRIDS and min(
                    st["launches"][k] for k in ("paged_decode_attention",
                                                "ragged_prefill_attention")
                    ) <= 0:
                failures.append(f"recurrent_parity {name}: K1 or K2 never "
                                f"launched: {st['launches']}")
            res[name] = r
    # Bamba-9B's widths at 2 layers, float32
    model = _bamba_module(["mamba", "attention"], torch.float32)
    gen = torch.Generator().manual_seed(44)
    bp = torch.randint(3, 128000, (4, 96), generator=gen).tolist()
    bkw = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
               max_input_len=96, max_seq_len=128, max_num_tokens=512,
               kv_cache_config=KvCacheConfig(enable_block_reuse=False))
    streams = {}
    for device in ("cpu", "cuda"):
        llm = LLM(model, device=device, enable_warmup=device == "cuda",
                  **bkw)
        try:
            outs = llm.generate(bp, SamplingParams(
                max_tokens=8, top_k=1, ignore_eos=True, logprobs=2))
        finally:
            llm.shutdown()
        streams[device] = ([o.outputs[0].token_ids for o in outs],
                           [o.outputs[0].logprobs for o in outs])
    del model
    cmp = _compare_streams(streams["cpu"], streams["cuda"])
    r = dict(family="bamba-9b-2-layers", identical=streams["cpu"][0] ==
             streams["cuda"][0], cpu=streams["cpu"][0],
             card=streams["cuda"][0], **cmp)
    emit({"phase": "recurrent_parity", **r})
    if cmp["unexplained_partings"]:
        failures.append(f"recurrent_parity bamba-9b: {r}")
    res["bamba_9b_2_layers"] = r
    if failures:
        raise AssertionError("; ".join(failures))
    return res


def recurrent_kernel_phase(results: dict) -> None:
    """K1 and K2 at the shapes bamba_serving launches them with (32 x 128
    q heads over 8 KV heads): 64 decode rows at 513-640 KV and one prefill
    step of 16 fresh 512-token prompts, each held against its plain
    version (``_attention_case``: bf16 2e-2), timed beside it, its bound
    and one SDPA call."""
    import torch
    rows = [513 + (127 * i) // 63 for i in range(64)]
    for name, kind, (q_lens, ctx) in [
            ("decode_bamba", "decode", ([1] * 64, [k - 1 for k in rows])),
            ("prefill_bamba", "prefill", ([512] * 16, [0] * 16))]:
        results[name] = _attention_case(
            name, kind, q_lens, ctx, 32, 8, None, None, torch.bfloat16,
            seed=90 + len(results), pages_per_seq=PAGES_GPTOSS, hd=128,
            q_scale=1.0)


def _ragged_md(lens, starts):
    """``AttentionMetadata`` on the card of one ragged step of the scans:
    row i holds ``lens[i]`` tokens from position ``starts[i]`` in slot
    i."""
    import torch
    from tensorrt_llm_tpu_torch.ops.attention import AttentionMetadata
    i32 = dict(dtype=torch.int32, device="cuda")
    S = len(lens)
    cu = torch.zeros(S + 1, **i32)
    cu[1:] = torch.cumsum(torch.tensor(lens, **i32), 0)
    pos = torch.cat([torch.arange(s, s + n, **i32)
                     for s, n in zip(starts, lens)])
    return AttentionMetadata(
        kv_lens=torch.tensor([s + n for s, n in zip(starts, lens)], **i32),
        page_indices=torch.zeros(S, 1, **i32), cu_q_lens=cu,
        num_seqs=torch.tensor([S], **i32),
        slot_mapping=torch.zeros(len(pos), **i32), positions=pos,
        logits_indices=cu[1:].long() - 1, max_q_len=max(lens),
        seq_slots=torch.arange(S, **i32))


def _delta_rule_cost() -> dict:
    """Qwen3-Next-80B-A3B's gated delta rule (``RECURRENT_FAMILIES``'
    widths: 32 value heads, keys and values of 128, float32 states)
    timed alone with CUDA events (median of 10): a prefill step's 16
    fresh prompts of 256 tokens (the loop over positions, 256 iterations
    of all rows at once) and a decode step's 64 continuing rows (one
    iteration); and the loop against the plain form (one token at a time
    over the flat axis) on 4 prompts of 16 tokens, float32, 1e-4."""
    import torch
    from tensorrt_llm_tpu_torch.ops import ssm
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    from tensorrt_llm_tpu_torch.tools.card_timing import time_ms
    f = sprof.RECURRENT_FAMILIES["qwen3_next"][1]
    vh, dk, dv = (f["linear_num_value_heads"], f["linear_key_head_dim"],
                  f["linear_value_head_dim"])
    gen = torch.Generator(device="cuda").manual_seed(9)

    def inputs(T, S):
        r = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
        q, k = r(T, vh, dk), r(T, vh, dk)
        q = q / q.norm(dim=-1, keepdim=True) / dk ** 0.5
        k = k / k.norm(dim=-1, keepdim=True)
        return (q, k, r(T, vh, dv), -r(T, vh).abs() * 0.1,
                torch.sigmoid(r(T, vh)),
                r(S + 1, vh, dk, dv) * 0.1)

    out = {}
    for shape, lens, starts in (("prefill_16x256", [256] * 16, [0] * 16),
                                ("decode_64", [1] * 64, [300] * 64)):
        meta = _ragged_md(lens, starts)
        q, k, v, g, b, state = inputs(sum(lens), len(lens))
        ms = time_ms(lambda: ssm.gated_delta_scan(q, k, v, g, b, state,
                                                  meta), 10)
        out[shape] = dict(tokens=sum(lens), rows=len(lens),
                          iterations=max(lens), ms=ms,
                          ms_per_iteration=ms / max(lens))
    meta = _ragged_md([16] * 4, [0] * 4)
    q, k, v, g, b, state = inputs(64, 4)
    ys = []
    for form in ("plain", "bounded"):
        st = state.clone()
        ys.append((ssm.gated_delta_scan(q, k, v, g, b, st, meta, form=form),
                   st[:4]))
    err = max((ys[0][0] - ys[1][0]).abs().max().item(),
              (ys[0][1] - ys[1][1]).abs().max().item())
    out["loop_vs_plain_max_abs_err"] = err
    if not err <= 1e-4:
        raise AssertionError(f"recurrent_families: the delta rule's loop "
                             f"parts from its plain form by {err}")
    return out


def _ssm_components(eng) -> dict:
    """One Mamba2 layer of the served Bamba-9B (its first, on seeded
    inputs of the model's type) timed alone with CUDA events (median of
    10): the SSD scan, the conv and the whole mixer at a prefill step's
    shape (16 fresh prompts of 512 tokens, the bounded form) and at a
    decode step's (64 continuing rows, the one-step update), with the
    bounded form's peak memory beside the bytes the per-token states of
    the plain form would take; and the bounded form against the plain one
    on 4 prompts of 64 tokens (float32, 1e-3)."""
    import torch
    from tensorrt_llm_tpu_torch.models.mamba2 import mamba2_mixer
    from tensorrt_llm_tpu_torch.ops import ssm
    from tensorrt_llm_tpu_torch.tools.card_timing import time_ms
    m = eng.model
    g = m.geom
    i0 = m.block_types.index("mamba")
    layer = eng.params["layers"][i0]
    dev, dt = "cuda", m.dtype
    gen = torch.Generator(device=dev).manual_seed(7)
    md = _ragged_md

    def pools(S):
        shapes = g.state_shapes(1)
        return {k: torch.randn((S + 1,) + shape, generator=gen,
                               device=dev) * 0.1
                for k, (_, shape) in shapes.items()}

    def inputs(T):
        r = lambda *sh: torch.randn(sh, generator=gen, device=dev)
        return dict(x=r(T, g.num_heads, g.head_dim).to(dt),
                    dt=torch.rand(T, g.num_heads, generator=gen,
                                  device=dev) * 0.1 + 0.01,
                    B=r(T, g.n_groups, g.state_size).to(dt),
                    C=r(T, g.n_groups, g.state_size).to(dt),
                    xbc=r(T, g.conv_dim).to(dt), h=r(T, m.hidden_size).to(dt))

    A = -torch.exp(layer["A_log"].float())
    out = {}
    for shape, lens, starts in (("prefill_16x512", [512] * 16, [0] * 16),
                                ("decode_64", [1] * 64, [600] * 64)):
        meta = md(lens, starts)
        S, T = len(lens), sum(lens)
        st = pools(S)
        a = inputs(T)
        scan = lambda: ssm.ssd_scan(a["x"], a["dt"], A, a["B"], a["C"],
                                    layer["D"], st["ssm_state"], meta,
                                    chunk=g.chunk)
        conv = lambda: ssm.causal_conv1d(a["xbc"], layer["conv_w"],
                                         layer["conv_b"], st["conv_state"],
                                         meta)
        mixer = lambda: mamba2_mixer(layer, a["h"], st["conv_state"],
                                     st["ssm_state"], meta, g,
                                     m._method("mlp"), dt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        scan()
        torch.cuda.synchronize()
        out[shape] = dict(
            tokens=T, rows=S, form="bounded" if max(lens) > 1 else "step",
            ssd_ms=time_ms(scan, 10), conv_ms=time_ms(conv, 10),
            mixer_ms=time_ms(mixer, 10),
            ssd_peak_bytes=torch.cuda.max_memory_allocated() - base,
            plain_form_state_bytes=3 * T * 4 * g.num_heads * g.head_dim
            * g.state_size)
    # the bounded form against the plain one at the model's widths
    meta = md([64] * 4, [0] * 4)
    a = inputs(256)
    ys = []
    for form in ("plain", "bounded"):
        st = pools(4)
        st["ssm_state"].zero_()
        ys.append((ssm.ssd_scan(a["x"].float(), a["dt"], A, a["B"].float(),
                                a["C"].float(), layer["D"], st["ssm_state"],
                                meta, form=form, chunk=g.chunk).float(),
                   st["ssm_state"][:4].clone()))
    err = max((ys[0][0] - ys[1][0]).abs().max().item(),
              (ys[0][1] - ys[1][1]).abs().max().item())
    out["bounded_vs_plain_max_abs_err"] = err
    if not err <= 1e-3:
        raise AssertionError(f"bamba_serving: the chunked SSD parts from "
                             f"the plain form by {err}")
    return out


def _eager_step_ms(llm, prompts, sp) -> list:
    """One more pass of the workload, each eager step (a step with
    prompt tokens) timed on the device by CUDA events around its launch:
    [(rows, tokens, ms)]."""
    import torch
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    eng = llm.engine
    real = eng.forward_step
    marks = []

    def spy(batch, *a, **kw):
        if not batch.context_requests:
            return real(batch, *a, **kw)
        e0, e1 = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        e0.record()
        outs = real(batch, *a, **kw)
        e1.record()
        n = len(batch.context_requests) + len(batch.generation_requests)
        marks.append((n, sum(r.context_len for r in batch.context_requests),
                      e0, e1))
        return outs
    eng.forward_step = spy
    try:
        sprof._generate(llm, prompts, sp)
    finally:
        del eng.forward_step
    torch.cuda.synchronize()
    return [(n, t, e0.elapsed_time(e1)) for n, t, e0, e1 in marks]


def bamba_serving_phase() -> dict:
    """Bamba-9B at its published width, its first
    ``BAMBA_SERVING_LAYERS`` (19) of 32 layers for the script's time
    limit (17 Mamba2 layers of 128 heads x 64 over a state of 128,
    attention at layers 9 and 18 through K1/K2; seeded random bf16
    weights), 64 requests of 512 prompt tokens -> 128 greedy tokens
    with ``ignore_eos``, ``LLM`` defaults (64 rows, K = 8 windows, depth
    4, CUDA graphs) but 8,192 tokens a prefill step and prefix reuse off
    (tools/serving_profile.py ``--geometry bamba-9b``): a warm-up, a timed
    pass (tok/s, TTFT and TPOT median and max, K1 / K2 launches) and a
    profiled pass (device idle share, GPU time by kernel class), weights,
    the state pools' and the peak bytes; one more pass with each eager
    prefill step timed (``_eager_step_ms``); one Mamba2 layer's SSD scan,
    conv and mixer timed alone at a prefill step's and a decode step's
    shapes, and the bounded SSD against the plain one at the model's
    widths (``_ssm_components``). Fails if a request comes back short, out
    of the vocabulary or with a non-finite logprob, if K1 or K2 never
    launched or no window was replayed, or if the graph pool outgrew its
    reserve."""
    import gc

    import torch
    from tensorrt_llm_tpu_torch import LLM
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    cfg, kwargs, prompts, sp = sprof.workload(geometry="bamba-9b")
    cfg = sprof.bamba_9b_config(BAMBA_SERVING_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    llm = LLM(cfg, dtype="bfloat16", **kwargs)
    try:
        eng = llm.engine
        weights_bytes = sum(t.numel() * t.element_size()
                            for t in _tensors(eng.params))
        res = sprof.measure(llm, prompts, sp)
        graphs = _graph_stats(eng)
        reserve = eng.graph_pool_reserve()
        state_bytes = eng.recurrent_state_bytes()
        pages = eng.num_kv_pages
        steps = _eager_step_ms(llm, prompts, sp)
        outs = llm.generate(prompts[:4], sp)
        peak = torch.cuda.max_memory_allocated()
        comp = _ssm_components(eng)
    finally:
        llm.shutdown()
    del llm, eng
    gc.collect()
    torch.cuda.empty_cache()
    V = cfg.vocab_size
    for o in outs:
        toks = o.outputs[0].token_ids
        if len(toks) != sp.max_tokens or not all(0 <= t < V for t in toks):
            raise AssertionError(f"bamba_serving: bad output {toks}")
    if res["output_tokens"] != len(prompts) * sp.max_tokens or \
            res["nonfinite_logprobs"]:
        raise AssertionError(f"bamba_serving: {res['output_tokens']} "
                             "tokens, or non-finite logprobs")
    mamba_layers = sum(k == "mamba" for k in cfg.layers_block_type)
    res.update(model="Bamba-9B", layers=cfg.num_hidden_layers,
               mamba_layers=mamba_layers,
               attention_layers=cfg.num_hidden_layers - mamba_layers,
               weights_bytes=weights_bytes,
               state_pool_bytes=state_bytes,
               state_bytes_per_slot=state_bytes // (kwargs["max_batch_size"]
                                                    + 1),
               peak_allocated_bytes=peak, kv_pool_pages=pages,
               graph_pool_reserve_bytes=reserve, graphs=graphs,
               eager_steps=[dict(rows=n, prompt_tokens=t, ms=ms)
                            for n, t, ms in steps],
               ssm_components=comp,
               ssd_ms_per_prefill_step_est=mamba_layers * comp[
                   "prefill_16x512"]["ssd_ms"],
               ssd_ms_per_decode_step_est=mamba_layers * comp[
                   "decode_64"]["ssd_ms"],
               conv_ms_per_decode_step_est=mamba_layers * comp[
                   "decode_64"]["conv_ms"])
    emit({"phase": "bamba_serving", **res})
    if min(res["launches"][k] for k in ("paged_decode_attention",
                                        "ragged_prefill_attention")) <= 0:
        raise AssertionError(f"bamba_serving: K1 or K2 never launched: "
                             f"{res['launches']}")
    if not graphs["graph_replays"]:
        raise AssertionError("bamba_serving: no graph replay")
    _check_reserve(res)
    return res


def recurrent_families_phase() -> dict:
    """Each recurrent family at a published model's width
    (tools/serving_profile.py ``RECURRENT_FAMILIES``: Mamba-2.8B,
    Falcon-Mamba-7B, Mamba2-2.7B, Granite-4.0-H-Tiny, Zamba2-1.2B,
    Jamba-v0.1 (one period of 8 layers), LFM2-1.2B, Qwen3-Next-80B-A3B (4
    layers), MiniMax-Text-01 (one linear and one full attention layer);
    every kind of layer at least once; seeded random bf16 weights), 16 x
    256 -> 32 greedy tokens through graphs (``--family NAME``): K1 and K2
    launched for the hybrids, windows replayed, every returned logprob
    finite. A smoke of the widths, not a cell. Then the cost of
    Qwen3-Next's delta rule alone (``_delta_rule_cost``)."""
    import gc
    import torch
    from tensorrt_llm_tpu_torch import LLM
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    failures, res = [], {}
    for name, (_, _, layers, source) in sprof.RECURRENT_FAMILIES.items():
        cfg, kwargs, prompts, sp = sprof.family_workload(name)
        gc.collect()
        torch.cuda.empty_cache()
        try:
            llm = LLM(cfg, dtype="bfloat16", enable_warmup=False, **kwargs)
        except Exception as e:            # the next family still runs
            failures.append(f"recurrent_families {name}: {e!r}")
            emit({"phase": "recurrent_families", "family": name,
                  "error": repr(e)})
            continue
        try:
            eng = llm.engine
            run = sprof.measure(llm, prompts, sp, profile=False)
            graphs = _graph_stats(eng)
            kinds = list(eng.model.block_types)
            state = eng.recurrent_state_bytes()
            attn = eng.model.n_attn
        finally:
            llm.shutdown()
        del llm, eng
        if attn and min(run["launches"][k] for k in (
                "paged_decode_attention", "ragged_prefill_attention")) <= 0:
            failures.append(f"recurrent_families {name}: K1 or K2 never "
                            f"launched: {run['launches']}")
        if not graphs["graph_replays"]:
            failures.append(f"recurrent_families {name}: no graph replay")
        if run["nonfinite_logprobs"] or not run["logprobs_recorded"] or \
                run["min_output_tokens"] != sp.max_tokens:
            failures.append(f"recurrent_families {name}: short outputs or "
                            "non-finite logprobs")
        res[name] = dict(
            source=source, layers=layers, kinds=kinds,
            hidden=cfg.hidden_size, state_pool_bytes=state,
            output_tok_per_s=run["output_tok_per_s"],
            tpot_ms_median=run["tpot_ms_median"],
            ttft_ms_median=run["ttft_ms_median"], launches=run["launches"],
            graph_replays=graphs["graph_replays"],
            logprobs_recorded=run["logprobs_recorded"])
        emit({"phase": "recurrent_families", "family": name, **res[name]})
    emit({"phase": "recurrent_families",
          "delta_rule_cost": _delta_rule_cost()})
    if failures:
        raise AssertionError("; ".join(failures))
    return res


# --------------------------------------------------------------------- #
# MTP speculation on the MLA targets, LongCat-Flash's shortcut MoE
# --------------------------------------------------------------------- #
def mtp_parity_phase() -> dict:
    """Tiny float32 DeepSeek-V3 and DeepSeek-V2 checkpoints
    (``_save_tiny_deepseek``) with MTP (d = 2, the JAX package's seeded
    random module, ``speculative.mtp.synth_state_dict``) through
    ``LLM.generate``, in the fused window and on the host path, the card
    against the port's CPU path: 7 requests queued before admission on 4
    rows (later ones in recycled slots and head slots), greedy tokens
    identical card against CPU and against the run without speculation,
    drafts proposed and accepted equal on both devices, the windows
    replayed from graphs on the card. Fails otherwise."""
    import numpy as np
    from tensorrt_llm_tpu_torch import (LLM, KvCacheConfig, SamplingParams,
                                        SpeculativeConfig)
    rng = np.random.default_rng(35)
    lens = (40, 9, 57, 23, 70, 31, 12)
    prompts = [rng.integers(1, 511, n).tolist() for n in lens]
    sps = [SamplingParams(max_tokens=n, top_k=1, ignore_eos=True)
           for n in (24, 6, 30, 12, 20, 16, 8)]
    kw = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
              max_input_len=96, max_seq_len=160, max_num_tokens=128,
              decode_multi_step=4,
              kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                            max_tokens=4096))
    res, failures = {}, []

    def run(path, device, window):
        spec = None if window is None else SpeculativeConfig(
            mode="MTP", max_draft_len=2, device_window=window)
        llm = LLM(str(path), device=device, speculative_config=spec, **kw)
        try:
            toks = _queued_generate(llm, prompts, sps)
            eng, ex = llm.engine, llm.executor
            st = {}
            if window:
                dr = eng.sd.drafter
                st = dict(windows=eng.sd.windows,
                          accepted=dr.accepted_total, steps=dr.steps_total,
                          nonspec_rows=ex.nonspec_decode_rows)
            elif window is not None:
                st = dict(proposed=ex.drafts_proposed,
                          accepted=ex.drafts_accepted,
                          drafted_rows=ex.drafted_rows)
            if device == "cuda":
                st["graph_replays"] = eng.graphs.replays
        finally:
            llm.shutdown()
        return toks, st

    with tempfile.TemporaryDirectory() as tmp:
        for kind in ("v3", "v2"):
            path = Path(tmp) / kind
            path.mkdir()
            _save_tiny_deepseek(path, kind)
            plain, _ = run(path, "cpu", None)
            for window in (True, False):
                cpu, cpu_st = run(path, "cpu", window)
                card, card_st = run(path, "cuda", window)
                path_name = "window" if window else "host"
                stats = {k: v for k, v in card_st.items()
                         if k != "graph_replays"}
                r = dict(kind=kind, path=path_name, identical=card == cpu,
                         equals_plain=card == plain,
                         stats_equal=stats == cpu_st, cpu=cpu_st,
                         card=card_st)
                emit({"phase": "mtp_parity", **r})
                if card != cpu or card != plain or stats != cpu_st:
                    failures.append(f"mtp_parity {kind} {path_name}: {r}, "
                                    f"card {card} cpu {cpu} plain {plain}")
                if window and not (card_st["windows"] and
                                   card_st["graph_replays"]):
                    failures.append(f"mtp_parity {kind}: no window replayed")
                if not window and not card_st["proposed"]:
                    failures.append(f"mtp_parity {kind}: no drafts")
                res[f"{kind}_{path_name}"] = r
    if failures:
        raise AssertionError("; ".join(failures))
    return res


def _mtp_iteration_ms(eng, pos: int = 640, reps: int = 3) -> dict:
    """One spec-window iteration's two parts at mtp_serving's shape,
    outside the window (eager, CUDA events, median of ``reps`` after a
    warm call; every write to an out-of-range slot, so nothing changes):
    the MTP head's catch-up over d + 1 rows a sequence of all 64 slots
    (MLA decompressed) with its d - 1 chained steps and the draft argmax,
    and the target's verify over the same rows (decompressed MLA over
    ``pos`` positions, logits and hidden rows, argmax)."""
    import torch
    from tensorrt_llm_tpu_torch.ops.attention import AttentionMetadata
    from tensorrt_llm_tpu_torch.speculative.one_model import head_step
    sd, dev = eng.sd, eng.device
    dr, rows, Dp = sd.drafter, eng.max_batch_size, sd.d + 1
    i32 = dict(dtype=torch.int32, device=dev)
    T = rows * Dp
    gen = torch.Generator(device=dev).manual_seed(7)
    feats = torch.randn(T, eng.model.hidden_size, generator=gen, device=dev
                        ).to(eng.model.dtype)
    toks = torch.randint(0, eng.model.vocab_size, (T,), generator=gen,
                         device=dev)
    positions = (pos - Dp + torch.arange(Dp, device=dev)).repeat(rows) \
        .to(torch.int32)
    last = torch.arange(rows, device=dev) * Dp + Dp - 1
    common = dict(kv_lens=torch.full((rows,), pos, **i32),
                  cu_q_lens=torch.arange(rows + 1, **i32) * Dp,
                  num_seqs=torch.full((1,), rows, **i32),
                  positions=positions, max_q_len=Dp)
    hpages = (torch.arange(rows, device=dev)[:, None] * sd.P_h
              + torch.arange(sd.P_h, device=dev)[None]).to(torch.int32)
    hbound = eng.head_kv_bound(pos + sd.d)
    head_md = AttentionMetadata(
        page_indices=hpages, logits_indices=last, max_kv_len=hbound,
        slot_mapping=torch.full((T,), sd.kv.shape[0] * sd.ps_h, **i32),
        **common)
    P = eng.pages_per_seq
    tpages = (torch.arange(rows * P, device=dev).reshape(rows, P)
              % eng.num_kv_pages).to(torch.int32)
    verify_md = AttentionMetadata(
        page_indices=tpages, logits_indices=torch.arange(T, device=dev),
        max_kv_len=eng._kv_bound(pos),
        slot_mapping=torch.full((T,), eng.num_kv_pages * eng.page_size,
                                **i32), **common)

    def head():
        h, f = head_step(dr, feats, toks, sd.kv, head_md)
        h, tok = h[last], dr.draft_argmax(f[last])
        for t in range(sd.d - 1):
            p = torch.full((rows,), pos + t, **i32)
            h, f = head_step(dr, h, tok, sd.kv, AttentionMetadata(
                kv_lens=p + 1, page_indices=hpages,
                cu_q_lens=torch.arange(rows + 1, **i32),
                num_seqs=common["num_seqs"],
                slot_mapping=torch.full((rows,), sd.kv.shape[0] * sd.ps_h,
                                        **i32),
                positions=p, logits_indices=torch.arange(rows, device=dev),
                max_q_len=1, max_kv_len=hbound))
            tok = dr.draft_argmax(f)

    def verify():
        logits, _ = eng._forward(toks, verify_md, collect_hidden=True)
        torch.argmax(logits, -1)

    out = {}
    with torch.no_grad():
        for name, fn in (("head", head), ("verify", verify)):
            fn()
            times = []
            for _ in range(reps):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                fn()
                e1.record()
                torch.cuda.synchronize()
                times.append(e0.elapsed_time(e1))
            out[f"{name}_ms"] = statistics.median(times)
    out.update(rows=rows, query_rows=T, positions=pos)
    return out


def mtp_serving_phase() -> dict:
    """DeepSeek-V3 at its published width (hidden 7,168, 128 MLA heads,
    256 experts top 8 and 1 shared), its first 4 layers (3 dense, 1 MoE)
    and its MTP module (seeded random bf16 weights made on the card,
    ~53.4 GB with the module; tools/serving_profile.py ``--geometry
    deepseek-v3-mtp``), 64 requests of 512 prompt tokens -> 128 greedy
    tokens with ``ignore_eos``, ``LLM`` defaults (64 rows, K = 8, depth
    4, CUDA graphs) but 8,192 tokens a prefill step and prefix reuse off,
    served three times: without speculation, with MTP (d = 1, the one
    token the published module is trained for) in the fused window
    (4 iterations a window), and with MTP on the host path. Each: a
    warm-up, a timed pass (tok/s, TTFT and TPOT median and max, MLA calls
    by path, K1 / K2 / K3 launches, drafts proposed and accepted) and,
    but on the host path, a profiled pass (GPU time by class, idle
    share); weights (the module's too) and peak memory; for the window,
    one iteration's head and verify ms at the served shape
    (``_mtp_iteration_ms``). The run without speculation serves the
    prompts once more with top-2 logprobs (single steps), against which
    the spec runs' timed streams (each token's logprob recorded) must
    agree, bf16 partings only where it decides by a near-tie
    (``_compare_streams``). Fails otherwise, if a request comes back
    short, out of the vocabulary or with a non-finite logprob, if no
    window replayed, if the host path proposed nothing, or if a graph
    pool outgrew its reserve."""
    import gc

    import torch
    from tensorrt_llm_tpu_torch import LLM, SamplingParams
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    cfg, kwargs, prompts, sp = sprof.workload(geometry="deepseek-v3-mtp")
    sp_lp = SamplingParams(max_tokens=sp.max_tokens, top_k=1,
                           ignore_eos=True, logprobs=2)
    runs, streams = {}, {}
    V = cfg.vocab_size
    for name, window in (("plain", None), ("window", True),
                         ("host", False)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kw = dict(kwargs)
        if window is not None:
            kw["speculative_config"] = sprof.spec_config("MTP", 1, cfg,
                                                         window)
        t0 = time.monotonic()
        llm = LLM(cfg, dtype="bfloat16", **kw)
        build_s = time.monotonic() - t0
        try:
            eng = llm.engine
            head = eng.sd.drafter if window else \
                llm.executor.host_drafter if window is False else None
            weights = sum(t.numel() * t.element_size()
                          for t in _tensors(eng.params))
            head_bytes = 0 if head is None else sum(
                t.numel() * t.element_size() for t in _tensors(head.params))
            outs = []
            res = sprof.measure(llm, prompts, sp, profile=name != "host",
                                outputs=outs)
            graphs = _graph_stats(eng)
            graphs["mla_calls"] = sprof.mla_graph_calls(eng)
            if window:
                res["iteration"] = _mtp_iteration_ms(eng)
            reserve = eng.graph_pool_reserve()
            if window is None:
                # the reference stream: top-2 logprobs a token (single
                # steps); the others record the chosen token's
                outs = llm.generate(prompts, sp_lp)
        finally:
            llm.shutdown()
        peak = torch.cuda.max_memory_allocated()
        del llm, eng, head
        streams[name] = ([o.outputs[0].token_ids for o in outs],
                         [o.outputs[0].logprobs for o in outs])
        for toks in streams[name][0]:
            if len(toks) != sp.max_tokens or not all(0 <= t < V
                                                     for t in toks):
                raise AssertionError(f"mtp_serving {name}: bad output "
                                     f"{toks}")
        if res["output_tokens"] != len(prompts) * sp.max_tokens or \
                res["nonfinite_logprobs"]:
            raise AssertionError(f"mtp_serving {name}: "
                                 f"{res['output_tokens']} tokens, or "
                                 "non-finite logprobs")
        res.update(run=name, model="DeepSeek-V3",
                   layers=cfg.num_hidden_layers,
                   dense_layers=cfg.first_k_dense_replace,
                   experts=cfg.n_routed_experts,
                   top_k=cfg.num_experts_per_tok, engine_build_s=build_s,
                   weights_bytes=weights, head_weights_bytes=head_bytes,
                   peak_allocated_bytes=peak,
                   graph_pool_reserve_bytes=reserve, graphs=graphs)
        emit({"phase": "mtp_serving", **res})
        runs[name] = res
        _check_reserve(res)
    cmp = {k: _compare_streams(streams["plain"], streams[k])
           for k in ("window", "host")}
    identical = streams["plain"][0] == streams["window"][0] == \
        streams["host"][0]
    emit({"phase": "mtp_serving", "run": "compare", "identical": identical,
          **{f"{k}_vs_plain": v for k, v in cmp.items()}})
    if any(c["unexplained_partings"] for c in cmp.values()):
        raise AssertionError(f"mtp_serving: token streams part beyond "
                             f"near-ties: {cmp}")
    if not runs["window"]["spec_windows"] or \
            not runs["window"]["graphs"]["graph_replays"]:
        raise AssertionError("mtp_serving: no spec window replayed")
    if not runs["host"]["drafts_proposed"]:
        raise AssertionError("mtp_serving: the host path proposed nothing")
    return dict(runs=runs, identical=identical, compare=cmp)


def _save_tiny_longcat(path: Path) -> None:
    """A tiny LongCat-Flash checkpoint written from a seeded numpy
    generator under the published names (config.json and
    model.safetensors; ``checkpoint_shapes``, so that no transformers
    module layout enters): hidden 256, 2 pairs of MLA (4 heads over a latent
    of 64 + 32, q_lora 96) + dense MLP (512), 8 experts of 128 and 4 zero
    experts, top 3, vocab 512. The router at std 0.5 so that rows pick by
    their scores, zero experts among them; norms near 1."""
    import numpy as np
    import torch
    from safetensors.numpy import save_file
    from tensorrt_llm_tpu_torch.models import ModelConfig, get_model_class
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    cfg = sprof._config("LongcatFlashConfig", "longcat_flash", dict(
        vocab_size=512, hidden_size=256, ffn_hidden_size=512,
        expert_ffn_hidden_size=128, num_layers=2, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=4, head_dim=32,
        q_lora_rank=96, kv_lora_rank=64, qk_nope_head_dim=64,
        qk_rope_head_dim=32, v_head_dim=64, n_routed_experts=8,
        zero_expert_num=4, moe_topk=3, routed_scaling_factor=2.0,
        max_position_embeddings=1024, rms_norm_eps=1e-5,
        tie_word_embeddings=False))
    cfg.save_pretrained(path)
    rng = np.random.default_rng(37)
    sd = {}
    model = get_model_class("longcat_flash")(ModelConfig(
        hf_config=cfg, dtype=torch.float32, device="cpu"))
    for name, shape in model.checkpoint_shapes().items():
        if "norm" in name and len(shape) == 1:
            a = 1 + rng.standard_normal(shape) * 0.1
        elif name.endswith("e_score_correction_bias"):
            a = rng.standard_normal(shape) * 0.1
        else:
            std = 1.0 if "embed" in name else \
                0.5 if "classifier" in name else 0.05
            a = rng.standard_normal(shape) * std
        sd[name] = a.astype(np.float32)
    save_file(sd, str(path / "model.safetensors"))


def _greedy_forward(model, params, prompts, n: int) -> tuple:
    """Greedy tokens of each prompt by the model's forward alone, one
    sequence at a time over a fresh pool of page 32 (prefill, then one
    token a step): (tokens, per token {top-2 ids: log-probabilities})."""
    import torch
    from tensorrt_llm_tpu_torch.ops.attention import AttentionMetadata
    dev = model.device
    ps = 32
    i32 = dict(dtype=torch.int32, device=dev)
    toks_all, lps_all = [], []
    with torch.no_grad():
        for prompt in prompts:
            P = -(-(len(prompt) + n) // ps)
            pool = model.make_kv_pages(P + 1, ps)
            pages = torch.arange(P, **i32)[None]
            seq, toks, lps = list(prompt), [], []
            start = 0
            for _ in range(n):
                T = len(seq) - start
                pos = torch.arange(start, len(seq), **i32)
                logits, _ = model.forward(
                    params, torch.tensor(seq[start:], device=dev), pool,
                    AttentionMetadata(
                        kv_lens=torch.tensor([len(seq)], **i32),
                        page_indices=pages,
                        cu_q_lens=torch.tensor([0, T], **i32),
                        num_seqs=torch.tensor([1], **i32),
                        slot_mapping=pos, positions=pos,
                        logits_indices=torch.tensor([T - 1], device=dev),
                        max_q_len=T, max_kv_len=len(seq)))
                lp = torch.log_softmax(logits[0].float(), -1)
                top = torch.topk(lp, 2)
                tok = int(top.indices[0])
                toks.append(tok)
                lps.append({int(i): float(v)
                            for i, v in zip(top.indices, top.values)})
                start = len(seq)
                seq.append(tok)
            toks_all.append(toks)
            lps_all.append(lps)
    return toks_all, lps_all


def longcat_serving_phase() -> dict:
    """LongCat-Flash at its published width (hidden 6,144, 64 MLA heads,
    dense MLPs of 12,288, 512 experts top 12 of 2,048 beside 256 zero
    experts; tools/serving_profile.py ``--geometry longcat-flash``) at 1
    of its 28 pairs (two MLA + dense sublayers and one shortcut MoE;
    seeded random bf16 weights made on the card, ~43.1 GB), 64 requests
    of 512 prompt tokens -> 128 greedy tokens with ``ignore_eos``, ``LLM``
    defaults (64 rows, K = 8, depth 4, CUDA graphs) but 8,192 tokens a
    prefill step and prefix reuse off: a warm-up, a timed pass (tok/s,
    TTFT and TPOT median and max, MLA calls by path, K1 / K2 / K3
    launches) and a profiled pass (idle share, GPU time by class), weights
    and peak memory. Then 2 prompts of 64 tokens -> 8 with top-2
    logprobs on the card, and the weights copied to the host for
    longcat_parity's CPU run. Fails if a request comes back short, out of
    the vocabulary or with a non-finite logprob, if no window replayed,
    or if the graph pool outgrew its reserve. Returns (results, what
    longcat_parity needs)."""
    import gc

    import torch
    from tensorrt_llm_tpu_torch import LLM, SamplingParams
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    cfg, kwargs, prompts, sp = sprof.workload(geometry="longcat-flash")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    llm = LLM(cfg, dtype="bfloat16", **kwargs)
    build_s = time.monotonic() - t0
    short = [p[:64] for p in prompts[:2]]
    try:
        eng = llm.engine
        weights = sum(t.numel() * t.element_size()
                      for t in _tensors(eng.params))
        res = sprof.measure(llm, prompts, sp)
        graphs = _graph_stats(eng)
        graphs["mla_calls"] = sprof.mla_graph_calls(eng)
        reserve = eng.graph_pool_reserve()
        pages = eng.num_kv_pages
        kv_bytes_per_token = eng.bytes_per_kv_block // eng.page_size
        outs = llm.generate(prompts[:4], sp)
        card = llm.generate(short, SamplingParams(
            max_tokens=8, top_k=1, ignore_eos=True, logprobs=2))
        t1 = time.monotonic()
        host_params = _tree_to(eng.params, "cpu")
        copy_s = time.monotonic() - t1
    finally:
        llm.shutdown()
    peak = torch.cuda.max_memory_allocated()
    del llm, eng
    gc.collect()
    torch.cuda.empty_cache()
    V = cfg.vocab_size
    for o in outs:
        toks = o.outputs[0].token_ids
        if len(toks) != sp.max_tokens or not all(0 <= t < V for t in toks):
            raise AssertionError(f"longcat_serving: bad output {toks}")
    if res["output_tokens"] != len(prompts) * sp.max_tokens or \
            res["nonfinite_logprobs"]:
        raise AssertionError(f"longcat_serving: {res['output_tokens']} "
                             "tokens, or non-finite logprobs")
    res.update(model="LongCat-Flash", pairs=cfg.num_layers,
               experts=cfg.n_routed_experts,
               zero_experts=cfg.zero_expert_num, top_k=cfg.moe_topk,
               engine_build_s=build_s, weights_bytes=weights,
               peak_allocated_bytes=peak, kv_pool_pages=pages,
               kv_bytes_per_token=kv_bytes_per_token,
               graph_pool_reserve_bytes=reserve, graphs=graphs,
               host_copy_s=copy_s)
    emit({"phase": "longcat_serving", **res})
    if not graphs["graph_replays"] or not graphs["mla_calls"].get(
            "multi", {}).get("absorbed"):
        raise AssertionError(f"longcat_serving: no absorbed window "
                             f"replayed: {graphs}")
    _check_reserve(res)
    full = dict(cfg=cfg, params=host_params, prompts=short,
                card=([o.outputs[0].token_ids for o in card],
                      [o.outputs[0].logprobs for o in card]))
    return res, full


def _tree_to(tree, device):
    """A parameter tree with every tensor moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device) if hasattr(tree, "to") else tree


def longcat_parity_phase(full) -> dict:
    """A tiny float32 LongCat-Flash checkpoint (``_save_tiny_longcat``)
    through ``LLM.generate``, the card against the port's CPU path: 7
    requests queued before admission on 4 rows, K = 4 windows with rider
    chunks of 32 tokens: greedy tokens identical card against CPU and
    graphs against eager, zero experts picked. Then LongCat-Flash's
    published width at one pair (longcat_serving's weights, bf16, copied
    to the host): the card's served tokens of 2 prompts of 64 tokens -> 8
    against the CPU model's forward (``_greedy_forward``), identical
    wherever the CPU decides by more than 3e-2 in log-probability, and
    the share of the CPU run's expert picks that fell on zero experts.
    Fails otherwise."""
    import numpy as np
    import torch
    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig, SamplingParams
    from tensorrt_llm_tpu_torch.models import ModelConfig, get_model_class
    rng = np.random.default_rng(39)
    lens = (40, 9, 57, 23, 70, 31, 12)
    prompts = [rng.integers(1, 511, n).tolist() for n in lens]
    sps = [SamplingParams(max_tokens=n, top_k=1, ignore_eos=True)
           for n in (24, 6, 30, 12, 20, 16, 8)]
    kw = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
              max_input_len=96, max_seq_len=160, max_num_tokens=128,
              decode_multi_step=4, mixed_window_ctx=32,
              kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                            max_tokens=4096))
    res, failures = {}, []

    def count_zero_picks(model):
        """Count the shortcut MoE's picks, the zero experts' among them
        and the routed experts each call touched, over every eager call
        (not while a graph is captured: a count reads the device; graph
        replays run no Python)."""
        seen = {"calls": 0, "picks": 0, "zero": 0, "experts_touched": 0}
        route = model.sc_route

        def counted(pair, x):
            w, idx = route(pair, x)
            if not torch.cuda.is_current_stream_capturing():
                real = idx[idx < model.num_experts]
                seen["calls"] += 1
                seen["picks"] += idx.numel()
                seen["zero"] += idx.numel() - real.numel()
                seen["experts_touched"] += int(real.unique().numel())
            return w, idx
        model.sc_route = counted
        return seen

    def run(path, device, capture=None):
        llm = LLM(str(path), device=device,
                  enable_warmup=capture is not False, **kw)
        if capture is not None:
            llm.engine.graphs.capture = capture
        seen = count_zero_picks(llm.model)
        try:
            toks = _queued_generate(llm, prompts, sps)
            st = dict(mixed_windows=llm.engine.mixed_windows_dispatched,
                      **seen)
            if device == "cuda":
                st["graph_replays"] = llm.engine.graphs.replays
        finally:
            llm.shutdown()
        return toks, st

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "longcat"
        path.mkdir()
        _save_tiny_longcat(path)
        cpu, cpu_st = run(path, "cpu")
        card, card_st = run(path, "cuda")
        eager, _ = run(path, "cuda", capture=False)
    r = dict(kind="tiny", identical=card == cpu,
             graph_equals_eager=eager == card, cpu=cpu_st, card=card_st)
    emit({"phase": "longcat_parity", **r})
    if card != cpu or eager != card:
        failures.append(f"longcat_parity tiny: card {card} / eager {eager} "
                        f"!= cpu {cpu}")
    if not (card_st["graph_replays"] and card_st["mixed_windows"] and
            cpu_st["zero"]):
        failures.append(f"longcat_parity tiny: no replay, rider window or "
                        f"zero-expert pick: {card_st} {cpu_st}")
    res["tiny"] = r
    if full is not None:
        t0 = time.monotonic()
        model = get_model_class("longcat_flash")(ModelConfig(
            hf_config=full["cfg"], dtype=torch.bfloat16, device="cpu"))
        seen = count_zero_picks(model)
        cpu_stream = _greedy_forward(model, full["params"], full["prompts"],
                                     8)
        cmp = _compare_streams(cpu_stream, full["card"])
        r = dict(kind="full_width_one_pair", identical=cpu_stream[0] ==
                 full["card"][0], cpu=cpu_stream[0], card=full["card"][0],
                 zero_pick_share=seen["zero"] / max(1, seen["picks"]),
                 experts_touched_per_call=seen["experts_touched"] / max(
                     1, seen["calls"]), routing=seen,
                 cpu_s=time.monotonic() - t0, **cmp)
        emit({"phase": "longcat_parity", **r})
        if cmp["unexplained_partings"] or not seen["picks"]:
            failures.append(f"longcat_parity full width: {r}")
        res["full_width"] = r
        del model
    if failures:
        raise AssertionError("; ".join(failures))
    return res


# --------------------------------------------------------------------- #
# BERT, the evaluate harness (K1/K2 at hd 48), the prompt-embedding path
# and LLaVA
# --------------------------------------------------------------------- #
ASSETS = Path(__file__).resolve().parent / "tests" / "assets"
PASSKEY_CKPT = str(ASSETS / "tinypasskey-llama")
CODE_CKPT = str(ASSETS / "tinycode-llama")
PASSKEY_CTX = 3072
# eval_accuracy's engine: max_seq_len 3,072 + 96 over pages of 32
PAGES_PASSKEY = -(-(PASSKEY_CTX + 96) // 32)


def hd48_kernel_phase(results: dict) -> None:
    """K1 and K2 at head dim 48 (tinypasskey-llama: 4 x 48 q heads over 4
    KV heads; the kernels stage it as 64-wide tiles) at eval_accuracy's
    shapes: ``decode_hd48`` 2 rows at 250 and 3,072 positions,
    ``prefill_hd48`` one fresh 3,072-token prompt, each also on an e4m3
    pool (``_kv_e4m3``, the FP8-KV run's), held against the plain version
    (``_attention_case``: bf16 2e-2), timed beside it, its bound
    (max(bytes / 3.35 TB/s, FLOPs / 989 TFLOP/s)) and SDPA on the KV
    gathered to the longest row. q is unscaled (scores of order one)."""
    import torch
    bf = torch.bfloat16
    dec_rows = ([1, 1], [249, PASSKEY_CTX - 1])
    prompt = ([PASSKEY_CTX], [0])
    for name, kind, (q_lens, ctx), kv8 in [
            ("decode_hd48", "decode", dec_rows, None),
            ("prefill_hd48", "prefill", prompt, None),
            ("decode_hd48_kv_e4m3", "decode", dec_rows, "e4m3"),
            ("prefill_hd48_kv_e4m3", "prefill", prompt, "e4m3")]:
        results[name] = _attention_case(
            name, kind, q_lens, ctx, 4, 4, None, None, bf,
            seed=80 + len(results), pages_per_seq=PAGES_PASSKEY, hd=48,
            q_scale=1.0, kv8=kv8)


def eval_accuracy_phase() -> dict:
    """The port's first accuracy on trained weights (evaluate/tasks.py
    through ``LLM.generate``): ``PasskeyRetrieval(style="marker")`` on
    tests/assets/tinypasskey-llama (4 x 48 heads: K1 and K2 at hd 48) at
    the JAX test's settings (context 250, depths 0.2 / 0.5 / 0.8, 2 keys)
    and at context 3,072 (depths 0.15 to 0.9, 2 keys), each served three
    ways: bf16, an FP8 KV pool (scales calibrated at build) and FP8
    weights (per-tensor e4m3: the q/k/v, o and gate/up products, K =
    192, take the FP8 method's dequantize-then-matmul, the down product,
    K = 512, takes K3's e4m3 body at up to 128 rows). Then
    ``HumanEval(byte_prompts=True)`` on tests/assets/tinycode-llama in
    bf16. Each run's accuracy, per-depth accuracy and the kernels'
    launches (counts zeroed right before it, read right after). Fails if
    bf16 at context 250 retrieves less than the JAX test's 80 %, or if a
    passkey run did not launch K1 and K2."""
    import torch
    from tensorrt_llm_tpu_torch import KvCacheConfig, LLM, QuantConfig
    from tensorrt_llm_tpu_torch.evaluate.tasks import (HumanEval,
                                                       PasskeyRetrieval)
    from tensorrt_llm_tpu_torch.ops.cuda import quant_matmul as qmm
    from tensorrt_llm_tpu_torch.quantization.mode import (KvCacheQuantAlgo,
                                                          QuantAlgo)
    settings = (("ctx250", 250, (0.2, 0.5, 0.8)),
                ("ctx3072", PASSKEY_CTX, (0.15, 0.35, 0.55, 0.75, 0.9)))
    modes = (("bf16", QuantConfig()),
             ("fp8_kv", QuantConfig(
                 kv_cache_quant_algo=KvCacheQuantAlgo.FP8)),
             ("fp8_weights", QuantConfig(quant_algo=QuantAlgo.FP8)))
    kw = dict(dtype="bfloat16", skip_tokenizer_init=True, max_batch_size=16,
              max_input_len=PASSKEY_CTX + 64,
              max_seq_len=PASSKEY_CTX + 96, max_num_tokens=8192,
              kv_cache_config=KvCacheConfig(tokens_per_block=32,
                                            enable_block_reuse=False))
    runs = {}
    for mode, qc in modes:
        llm = LLM(PASSKEY_CKPT, quant_config=qc, **kw)
        try:
            for name, ctx, depths in settings:
                _zero_launches()
                qmm.LAUNCHES_E4M3 = 0
                t0 = time.monotonic()
                r = PasskeyRetrieval(context_len=ctx, depths=depths,
                                     num_keys=2, style="marker"
                                     ).evaluate(llm)
                runs[f"{mode}_{name}"] = dict(
                    task="passkey", mode=mode, context=ctx,
                    accuracy=r["accuracy"], per_depth=r["per_depth"],
                    num_samples=r["num_samples"],
                    seconds=time.monotonic() - t0,
                    launches=_read_launches(),
                    launches_e4m3=qmm.LAUNCHES_E4M3)
                emit({"phase": "eval_accuracy", "run": f"{mode}_{name}",
                      **runs[f"{mode}_{name}"]})
        finally:
            llm.shutdown()
        torch.cuda.empty_cache()
    llm = LLM(CODE_CKPT, dtype="bfloat16", skip_tokenizer_init=True,
              max_batch_size=2, max_input_len=512, max_seq_len=768,
              max_num_tokens=768)
    try:
        _zero_launches()
        r = HumanEval(byte_prompts=True, max_tokens=48,
                      timeout_s=5).evaluate(llm)
        runs["humaneval_bf16"] = dict(
            task="humaneval", mode="bf16", pass_at_1=r["pass@1"],
            accuracy=r["accuracy"], num_samples=r["num_samples"],
            launches=_read_launches())
        emit({"phase": "eval_accuracy", "run": "humaneval_bf16",
              **runs["humaneval_bf16"]})
    finally:
        llm.shutdown()
    bad = [k for k, v in runs.items() if v["task"] == "passkey" and not (
        v["launches"]["paged_decode_attention"] and
        v["launches"]["ragged_prefill_attention"])]
    if bad or runs["bf16_ctx250"]["accuracy"] < 80.0:
        raise AssertionError(f"eval_accuracy: K1/K2 not launched in {bad}, "
                             f"or bf16 at 250 below 80 %: "
                             f"{runs['bf16_ctx250']}")
    return runs


def _tiny_bert(num_labels: int = 3):
    import torch
    from transformers import BertConfig, BertForSequenceClassification
    torch.manual_seed(0)
    return BertForSequenceClassification(BertConfig(
        vocab_size=96, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=128, num_labels=num_labels)).eval()


def bert_parity_phase() -> dict:
    """``LLM.classify`` in float32, the card against the port's CPU path:
    a tiny seeded ``transformers`` BERT (3 labels; also against
    ``transformers``) on a ragged batch of pairs with token types, and
    BERT-large at its published width (``serving_profile.BERT_LARGE``,
    one label; seeded random weights drawn on the card and copied to the
    host) on 4 pairs of 100-120 tokens (bucket 128). Logits held to 2e-4
    (rtol and atol). Fails otherwise."""
    import numpy as np
    import torch
    from tensorrt_llm_tpu_torch import LLM
    from tensorrt_llm_tpu_torch.models import ModelConfig, get_model_class
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    res, failures = {}, []
    tm = _tiny_bert()
    prompts = [[2, 5, 9, 23, 40, 41], [7, 11, 13], list(range(3, 40))]
    tts = [[0, 0, 0, 1, 1, 1], [0, 0, 1], [0] * 10 + [1] * 27]
    outs = {}
    for dev in ("cuda", "cpu"):
        llm = LLM(tm, device=dev, dtype="float32", skip_tokenizer_init=True)
        outs[dev] = llm.classify(prompts, token_type_ids=tts)
        llm.shutdown()
    with torch.no_grad():
        ref = np.stack([tm(input_ids=torch.tensor([p]),
                           token_type_ids=torch.tensor([t])
                           ).logits[0].numpy()
                        for p, t in zip(prompts, tts)])
    for name, a, b in (("tiny_card_vs_cpu", outs["cuda"], outs["cpu"]),
                       ("tiny_card_vs_transformers", outs["cuda"], ref)):
        err = float(np.abs(a - b).max())
        res[name] = err
        if not np.allclose(a, b, rtol=2e-4, atol=2e-4):
            failures.append(f"{name}: {err}")
    cfg = sprof.bert_large_config()
    ids, types = sprof.bert_pairs(4, 100, 120, seed=1)
    llm = LLM(cfg, dtype="float32")
    try:
        card = llm.classify(ids, token_type_ids=types)
        params = _tree_to(llm._encoder_params, "cpu")
    finally:
        llm.shutdown()
    t0 = time.monotonic()
    model = get_model_class("bert")(ModelConfig(
        hf_config=cfg, dtype=torch.float32, device="cpu"))
    cpu = model.classify(params, ids, types)
    err = float(np.abs(card - cpu).max())
    res.update(bert_large_card_vs_cpu=err, bert_large_cpu_s=time.monotonic()
               - t0, bert_large_logits=card[:, 0].tolist())
    if not (np.isfinite(card).all() and
            np.allclose(card, cpu, rtol=2e-4, atol=2e-4)):
        failures.append(f"bert-large card vs cpu: {err}")
    del params, model
    emit({"phase": "bert_parity", **res})
    if failures:
        raise AssertionError("bert_parity: " + "; ".join(failures))
    return res


def bert_serving_phase() -> dict:
    """BERT-large at its published width and depth as a cross-encoder
    reranker (``serving_profile.BERT_LARGE``: 24 layers, 1,024 wide, 16
    heads, MLP 4,096, vocab 30,522, one label; seeded random bf16
    weights), 128 query-passage pairs of 200-512 tokens with token types
    (``bert_pairs``; the batch pads to the 512 bucket) scored by one
    ``LLM.classify`` call a batch: a warm-up, then 5 timed batches
    (host clock around each call, which ends in the logits' copy to the
    host): pairs/s, ms a batch (median, max), peak memory, weights. No
    kernel of the port runs here (the JAX package leaves the encoder to
    XLA). Fails on logits that are not finite or of the wrong shape."""
    import numpy as np
    import torch
    from tensorrt_llm_tpu_torch import LLM
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    ids, types = sprof.bert_pairs(128)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    llm = LLM(sprof.bert_large_config(), dtype="bfloat16")
    try:
        weights = sum(t.numel() * t.element_size()
                      for t in _tensors(llm._encoder_params))
        out = llm.classify(ids, token_type_ids=types)
        _zero_launches()
        ms = []
        for _ in range(5):
            t0 = time.monotonic()
            out = llm.classify(ids, token_type_ids=types)
            ms.append((time.monotonic() - t0) * 1e3)
        launches = _read_launches()
    finally:
        llm.shutdown()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    res = dict(model="bert-large-uncased (1 label)", pairs=len(ids),
               tokens=sum(map(len, ids)), bucket=512,
               ms_per_batch_median=statistics.median(ms),
               ms_per_batch_max=max(ms), ms_per_batch=ms,
               pairs_per_s=len(ids) / (statistics.median(ms) / 1e3),
               weights_bytes=weights, peak_allocated_bytes=peak,
               launches=launches, score_range=[float(out.min()),
                                               float(out.max())])
    emit({"phase": "bert_serving", **res})
    if out.shape != (len(ids), 1) or not np.isfinite(out).all():
        raise AssertionError(f"bert_serving: logits {out.shape}")
    return res


class _Checkpoint:
    """A ``transformers`` config and a state dict in the form ``LLM``
    takes an inline model: ``.config`` and ``.state_dict()``."""

    def __init__(self, config, sd):
        self.config, self.sd = config, sd

    def state_dict(self):
        return self.sd


def _tiny_llava():
    import torch
    from transformers import (CLIPVisionConfig, LlamaConfig, LlavaConfig,
                              LlavaForConditionalGeneration)
    torch.manual_seed(0)
    vc = CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                          num_hidden_layers=2, num_attention_heads=4,
                          image_size=16, patch_size=8)
    # head dim 64: the trunk's attention is K1 / K2 on the card
    tc = LlamaConfig(vocab_size=128, hidden_size=128, intermediate_size=256,
                     num_hidden_layers=2, num_attention_heads=2,
                     num_key_value_heads=1, max_position_embeddings=256)
    return LlavaForConditionalGeneration(LlavaConfig(
        vision_config=vc, text_config=tc, image_token_index=120,
        vision_feature_layer=-2, vision_feature_select_strategy="default")
    ).eval()


def llava_parity_phase() -> dict:
    """LLaVA through ``LLM.generate`` with image prompts, float32, the
    card against the port's CPU path: the tiny seeded ``transformers``
    LLaVA (3 prompts of 4 image + 3-30 text tokens -> 8, greedy tokens
    identical), then LLaVA-1.5-7B's full-width tower (CLIP ViT-L/14 at
    336 px) and projector over 2 of its 32 text layers at full width
    (seeded random float32 weights drawn on the card and copied to the
    host; 2 prompts of one 336 x 336 image and 32 text tokens -> 8):
    greedy tokens identical wherever the CPU decides by more than 3e-2
    in log-probability (``_compare_streams``). Fails otherwise."""
    import numpy as np
    import torch
    from tensorrt_llm_tpu_torch import KvCacheConfig, LLM, SamplingParams
    from tensorrt_llm_tpu_torch.models.recurrent import (RandomCheckpoint,
                                                         meta_shapes)
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    res, failures = {}, []
    hf = _tiny_llava()
    rng = np.random.default_rng(5)
    prompts = [{"prompt_token_ids": [5, 9, 120] + rng.integers(
        3, 110, n).tolist(), "multi_modal_data": {"image": [
            rng.standard_normal((3, 16, 16)).astype(np.float32)]}}
        for n in (3, 12, 30)]
    sp = SamplingParams(max_tokens=8, top_k=1, ignore_eos=True)
    kw = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
              max_input_len=64, max_seq_len=128,
              kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                            max_tokens=2048))
    toks = {}
    for dev in ("cuda", "cpu"):
        llm = LLM(hf, device=dev, **kw)
        try:
            toks[dev] = [o.outputs[0].token_ids
                         for o in llm.generate(prompts, sp)]
            if dev == "cuda":
                res["tiny_embed_steps"] = llm.engine.embed_steps
        finally:
            llm.shutdown()
    res["tiny_identical"] = toks["cuda"] == toks["cpu"]
    res["tiny_tokens"] = toks["cuda"]
    if not res["tiny_identical"]:
        failures.append(f"tiny: card {toks['cuda']} != cpu {toks['cpu']}")
    cfg = sprof.llava_15_7b_config(text_layers=2)
    from transformers import LlavaForConditionalGeneration as HF
    shapes = meta_shapes(HF, cfg)
    rand = RandomCheckpoint(shapes, "cuda", torch.float32, seed=3)
    card_sd = {k: rand[k] for k in shapes}
    prompts = sprof.llava_prompts(2, 32, seed=4)
    sp = SamplingParams(max_tokens=8, top_k=1, ignore_eos=True, logprobs=2)
    kw.update(max_input_len=640, max_seq_len=704, max_num_tokens=2048,
              kv_cache_config=KvCacheConfig(tokens_per_block=32,
                                            max_tokens=4096))
    streams = {}
    for dev in ("cuda", "cpu"):
        sd = card_sd if dev == "cuda" else {k: v.cpu()
                                            for k, v in card_sd.items()}
        t0 = time.monotonic()
        llm = LLM(_Checkpoint(cfg, sd), device=dev, **kw)
        try:
            outs = llm.generate(prompts, sp)
        finally:
            llm.shutdown()
        del sd
        streams[dev] = ([o.outputs[0].token_ids for o in outs],
                        [o.outputs[0].logprobs for o in outs])
        res[f"full_width_{dev}_s"] = time.monotonic() - t0
    del card_sd
    torch.cuda.empty_cache()
    cmp = _compare_streams(streams["cpu"], streams["cuda"])
    res.update(full_width=dict(identical=streams["cpu"][0] ==
                               streams["cuda"][0], cpu=streams["cpu"][0],
                               card=streams["cuda"][0], **cmp))
    if cmp["unexplained_partings"]:
        failures.append(f"full width: {res['full_width']}")
    emit({"phase": "llava_parity", **res})
    if failures:
        raise AssertionError("llava_parity: " + "; ".join(failures))
    return res


# llava_serving's profiled pass: the first 16 of its 64 requests
PROFILED_REQUESTS = 16


def _reused_blocks(llm, prompts, sp) -> int:
    """KV blocks the prompts' requests took from the reuse tree (the
    first one alone, so that its blocks are stored before the rest)."""
    mgr = llm.kv_cache_manager
    before = mgr.get_stats().reused_blocks
    llm.generate(prompts[:1], sp)
    llm.generate(prompts[1:], sp)
    return mgr.get_stats().reused_blocks - before


def llava_serving_phase() -> dict:
    """LLaVA-1.5-7B at its published width and depth
    (tools/serving_profile.py ``--geometry llava-1.5-7b``: CLIP ViT-L/14
    at 336 px, its layer -2 features without the class token, a GELU
    projector to 4,096, Vicuna-7B's 32 layers of 32 heads; seeded random
    bf16 weights drawn on the card, ~14.1 GB), 64 requests of one 336 x
    336 image and 64 text tokens (640 prompt tokens) -> 128 greedy tokens
    with ``ignore_eos``, ``LLM`` defaults (64 rows, K = 8 windows, CUDA
    graphs) but 8,192 tokens a prefill step and prefix reuse off: the
    tower and projector run once per request on the caller's thread
    (the features stay on the card), the trunk's prefill steps are eager
    K2 steps with the embedding rows, decode is K1 in replayed windows. A
    warm-up, a timed pass (tok/s, TTFT and TPOT median and max, K1 / K2
    launches, eager steps with embedding rows), then 16 of the requests
    unprofiled and under the profiler (``PROFILED_REQUESTS``: device idle
    share, GPU time by class), weights and peak memory, the
    tower and projector's ms per image (CUDA events, one image at a time,
    the serving call), then with prefix reuse on: the blocks reused by 16
    requests of one text beside 16 different images (must be none) and
    by 16 of one text and one image (each but the first reuses its
    prompt's full blocks). Fails if a request comes back short or out of
    the vocabulary, if K1 or K2 did not launch, if no window replayed, if
    the reuse counts are not so, or if the graph pool outgrew its
    reserve."""
    import gc

    import torch
    from tensorrt_llm_tpu_torch import LLM, SamplingParams
    from tensorrt_llm_tpu_torch.tools import serving_profile as sprof
    from tensorrt_llm_tpu_torch.tools.card_timing import time_ms
    cfg, kwargs, prompts, sp = sprof.workload(geometry="llava-1.5-7b")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    llm = LLM(cfg, dtype="bfloat16", **kwargs)
    build_s = time.monotonic() - t0
    try:
        eng = llm.engine
        weights_bytes = sum(t.numel() * t.element_size()
                            for t in _tensors(eng.params))
        vision_bytes = sum(t.numel() * t.element_size() for t in _tensors(
            [llm.model.vision_params, llm.model.projector]))
        embed0 = eng.embed_steps
        t1 = time.monotonic()
        res = sprof.measure(llm, prompts, sp, profile=False)
        # the profiled pass: 16 of the 64 requests (tracing every pass's
        # 1.3 M kernels cost ~45 s of the script's time), its idle share
        # against an unprofiled pass of the same 16
        wall16, _ = sprof._generate(llm, prompts[:PROFILED_REQUESTS], sp)
        res.update(sprof._profiled(llm, prompts[:PROFILED_REQUESTS], sp,
                                   wall16),
                   profiled_requests=PROFILED_REQUESTS,
                   profiled_plain_wall_ms=wall16 * 1e3)
        measure_s = time.monotonic() - t1
        graphs = _graph_stats(eng)
        res["embed_steps_all_passes"] = eng.embed_steps - embed0
        reserve = eng.graph_pool_reserve()
        pages = eng.num_kv_pages
        kv_bytes_per_token = eng.bytes_per_kv_block // eng.page_size
        image = prompts[0]["multi_modal_data"]["image"][0][None]
        tower_ms = time_ms(lambda: llm.model.encode_images(image), 20)
        outs = llm.generate(prompts[:4], sp)
        short = SamplingParams(max_tokens=1, top_k=1, ignore_eos=True)
        llm.kv_cache_manager.enable_block_reuse = True
        text = prompts[0]["prompt_token_ids"]
        other = sprof.llava_prompts(16, 64, seed=9)
        reuse_images = _reused_blocks(llm, [
            {"prompt_token_ids": text, "multi_modal_data": p[
                "multi_modal_data"]} for p in other], short)
        reuse_both = _reused_blocks(llm, [prompts[0]] * 16, short)
        rest_s = time.monotonic() - t1 - measure_s
    finally:
        llm.shutdown()
    peak = torch.cuda.max_memory_allocated()
    del llm, eng
    gc.collect()
    torch.cuda.empty_cache()
    V = cfg.text_config.vocab_size
    for o in outs:
        toks = o.outputs[0].token_ids
        if len(toks) != sp.max_tokens or not all(0 <= t < V for t in toks):
            raise AssertionError(f"llava_serving: bad output {toks}")
    if res["output_tokens"] != len(prompts) * sp.max_tokens or \
            res["nonfinite_logprobs"]:
        raise AssertionError(f"llava_serving: {res['output_tokens']} "
                             "tokens, or non-finite logprobs")
    full_blocks = (len(outs[0].prompt_token_ids) - 1) // 32
    res.update(model="LLaVA-1.5-7B", text_layers=cfg.text_config
               .num_hidden_layers, prompt_tokens=len(outs[0].prompt_token_ids),
               engine_build_s=build_s, measure_s=measure_s,
               tower_timing_and_reuse_s=rest_s,
               weights_bytes=weights_bytes,
               vision_weights_bytes=vision_bytes,
               peak_allocated_bytes=peak, kv_pool_pages=pages,
               kv_bytes_per_token=kv_bytes_per_token,
               tower_projector_ms_per_image=tower_ms,
               reused_blocks_same_text_other_images=reuse_images,
               reused_blocks_same_text_and_image=reuse_both,
               reused_blocks_expected=15 * full_blocks,
               graph_pool_reserve_bytes=reserve, graphs=graphs)
    emit({"phase": "llava_serving", **res})
    if not (res["launches"]["paged_decode_attention"] and
            res["launches"]["ragged_prefill_attention"]):
        raise AssertionError(f"llava_serving: K1/K2 not launched: "
                             f"{res['launches']}")
    if not graphs["graph_replays"] or not res["embed_steps_all_passes"]:
        raise AssertionError(f"llava_serving: no replayed window or no "
                             f"embedding step: {graphs}")
    if reuse_images or reuse_both != 15 * full_blocks:
        raise AssertionError(f"llava_serving: reuse {reuse_images} / "
                             f"{reuse_both}, want 0 / {15 * full_blocks}")
    _check_reserve(res)
    return res


def main() -> int:
    here = Path(__file__).resolve().parent
    if not (here / "tensorrt_llm_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: tensorrt_llm_tpu_torch/ not found beside "
              "this script; run it from a checkout", file=sys.stderr)
        return 3
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(here))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    from tensorrt_llm_tpu_torch.ops.cuda import _build
    t0 = time.monotonic()
    _build.build_all()
    emit({"phase": "build", "kernels": list(_build.KERNELS),
          "seconds": time.monotonic() - t0})

    seconds = {}
    # --only a,b: run just those phases (a development run: it prints no
    # kernels line and no result line)
    only = None
    if len(sys.argv) > 2 and sys.argv[1] == "--only":
        only = set(sys.argv[2].split(","))

    def timed(name, fn, *a):
        if only is not None and name not in only:
            return None
        t = time.monotonic()
        out = fn(*a)
        seconds[name] = time.monotonic() - t
        emit({"phase_seconds": name, "seconds": seconds[name]})
        return out

    kern = timed("kernels", kernel_phase)
    timed("moe_block", moe_block_phase)
    timed("parity", parity_phase, here)
    timed("parity_quantized", quant_parity_phase)
    timed("graphs", graph_phase, here)
    timed("spec_parity", spec_parity_phase, here)
    timed("moe_parity", moe_parity_phase)
    timed("serving", serving_phase)
    serving_q = timed("serving_quantized", serving_phase, "W4A16_AWQ")
    bench = timed("serving_bench_settings", bench_serving_phase)
    spec_runs = timed("spec_serving", spec_serving_phase)
    timed("gemma_kernels", gemma_kernel_phase, kern)
    timed("gemma_parity", gemma_parity_phase)
    gemma_runs = timed("gemma_serving", gemma_serving_phase)
    timed("gemma_steps", lambda: gemma_step_phase(
        kern, {k: v["eager_steps"] for k, v in gemma_runs.items()}))
    moe = timed("moe_serving", moe_serving_phase)
    timed("kv_quant_parity", kv_quant_parity_phase, here)
    kv_runs = timed("kv_serving", kv_serving_phase)
    timed("kv_quant_kernels", lambda: kv_quant_kernel_phase(
        kern, kv_runs["fp8"]["eager_steps"][0]))
    timed("host_spec_parity", host_spec_parity_phase, here)
    host = timed("host_spec_serving", host_spec_serving_phase)
    timed("host_spec_kernels", host_spec_kernel_phase, kern)
    timed("surface_parity", surface_parity_phase, here)
    surface = timed("surface_serving", surface_serving_phase)
    timed("guided_parity", guided_parity_phase, here)
    guided = timed("guided_serving", guided_serving_phase)
    e4m3 = {}
    timed("quant_linear_kernels", quant_linear_kernel_phase, e4m3)
    timed("quant_parity", quant_load_parity_phase, here)
    quant = timed("quant_serving", quant_serving_phase)
    timed("families_parity", families_parity_phase)
    timed("gpt_kernels", gpt_kernel_phase, {} if kern is None else kern)
    timed("gpt_parity", gpt_parity_phase)
    gpt_fams = timed("gpt_families", gpt_families_phase)
    gptoss = timed("gptoss_serving", gptoss_serving_phase)
    timed("deepseek_parity", deepseek_parity_phase)
    deepseek = timed("deepseek_serving", deepseek_serving_phase)
    moe_fams = timed("moe_families", moe_families_phase)
    timed("recurrent_kernels", recurrent_kernel_phase,
          {} if kern is None else kern)
    timed("recurrent_parity", recurrent_parity_phase)
    bamba = timed("bamba_serving", bamba_serving_phase)
    rec_fams = timed("recurrent_families", recurrent_families_phase)
    timed("mtp_parity", mtp_parity_phase)
    mtp = timed("mtp_serving", mtp_serving_phase)
    longcat = timed("longcat_serving", longcat_serving_phase)
    timed("longcat_parity", lambda: longcat_parity_phase(
        None if longcat is None else longcat[1]))
    if longcat is not None:
        longcat[1].clear()          # the host copy of the weights
    timed("hd48_kernels", hd48_kernel_phase, {} if kern is None else kern)
    evals = timed("eval_accuracy", eval_accuracy_phase)
    timed("bert_parity", bert_parity_phase)
    bert = timed("bert_serving", bert_serving_phase)
    timed("llava_parity", llava_parity_phase)
    llava = timed("llava_serving", llava_serving_phase)
    emit({"phase": "timing", "seconds": seconds,
          "total": sum(seconds.values())})
    if only is not None:
        return 0
    spec, gemma = spec_runs["spec"], gemma_runs["vswa"]

    kernels = []
    for name, case, group, src, replaces, run in [
            ("paged_decode_attention", "decode_bench", ("decode",),
             "tensorrt_llm_tpu_torch/csrc/decode_attention.cu",
             "tensorrt_llm_tpu/ops/pallas/decode_attention.py:164", bench),
            ("ragged_prefill_attention", "prefill_bench",
             ("prefill", "mixed", "rider", "verify"),
             "tensorrt_llm_tpu_torch/csrc/prefill_attention.cu",
             "tensorrt_llm_tpu/ops/pallas/prefill_attention.py:250", bench),
            ("groupwise_dequant_matmul", "qmm_gate_up", ("qmm",),
             "tensorrt_llm_tpu_torch/csrc/quant_matmul.cu",
             "tensorrt_llm_tpu/ops/pallas/quant_matmul.py:105", serving_q)]:
        r = kern[case]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=run["launches"][name],
            launches_in=run.get("quant_algo", "bench_settings"),
            launches_spec_serving=spec["launches"][name],
            launches_moe_serving=moe["launches"][name],
            launches_gemma_serving=gemma["launches"][name],
            launches_kv_serving=kv_runs["fp8"]["launches"][name],
            launches_host_spec=dict(target=host["launches_target"][name],
                                    drafter=host["launches_drafter"][name]),
            launches_surface_serving=surface["launches"][name],
            launches_guided_serving=guided["launches"][name],
            launches_gptoss_serving=gptoss["launches"][name],
            launches_gptoss_serving_with_sinks=gptoss["launches_sinks"].get(
                name, 0),
            launches_gpt_families=sum(f["launches"][name]
                                      for f in gpt_fams.values()),
            launches_deepseek_serving=deepseek["launches"][name],
            launches_moe_families={f: v["launches"][name]
                                   for f, v in moe_fams.items()},
            launches_bamba_serving=bamba["launches"][name],
            launches_recurrent_families={f: v["launches"][name]
                                         for f, v in rec_fams.items()},
            launches_mtp_serving={k: v["launches"][name]
                                  for k, v in mtp["runs"].items()},
            launches_longcat_serving=longcat[0]["launches"][name],
            launches_eval_accuracy={k: v["launches"][name]
                                    for k, v in evals.items()},
            launches_bert_serving=bert["launches"][name],
            launches_llava_serving=llava["launches"][name],
            max_abs_err=max(v["max_abs_err"] for c, v in kern.items()
                            if c.startswith(group)),
            max_abs_err_kv8=max((v["max_abs_err"] for c, v in kern.items()
                                 if c.startswith(group) and "_kv_" in c),
                                default=None),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["shape"],
            **{k: r[k] for k in ("ms_cold", "library_ms_cold", "splits")
               if k in r}))
    # K1 and K2 at head dim 48: eval_accuracy's shapes
    for row, kind in zip(kernels[:2], ("decode", "prefill")):
        row["hd48"] = {c: {k: kern[c][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")} for c in (f"{kind}_hd48", f"{kind}_hd48_kv_e4m3")}
    # K3's e4m3 body: its cases and its launches in quant_serving's runs
    kernels[-1].update(
        max_abs_err_e4m3=max(v["max_abs_err"] for c, v in e4m3.items()
                             if c.startswith("e4m3")),
        e4m3_cases={c: {k: v[k] for k in (
            "ms", "ms_cold", "bound_ms", "bound_share_cold", "library_ms",
            "library_ms_cold", "upcast_ms", "plain_ms", "max_abs_err")}
            for c, v in e4m3.items() if c.startswith("e4m3")},
        launches_quant_serving={k: v["launches_e4m3"]
                                for k, v in quant.items()},
        launches_e4m3_eval_accuracy={k: v["launches_e4m3"]
                                     for k, v in evals.items()
                                     if "launches_e4m3" in v})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
