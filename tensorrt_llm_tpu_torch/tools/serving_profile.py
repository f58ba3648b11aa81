"""Where the serving path's time goes on the card.

Runs the chip_smoke.py serving workload (TinyLlama-1.1B geometry, seeded
random bf16 weights, 16 requests of 128 prompt tokens and 64 output
tokens, ``LLM.generate`` with default arguments) once to warm up, once
timed without the profiler and once under ``torch.profiler``, then prints
one JSON line: both wall times, the summed GPU kernel time, the device's
idle share (kernel time over the unprofiled wall time; the profiler
itself slows the host several-fold), the kernel time by class (the two
attention kernels, the dequant-matmul kernel, library GEMMs, everything
else), kernel launches per output step, and the top kernels by GPU time.
``--quant ALGO`` quantizes the weights at load (``--group-size`` for the
group-wise algorithms).

    python -m tensorrt_llm_tpu_torch.tools.serving_profile
    python -m tensorrt_llm_tpu_torch.tools.serving_profile --quant W4A16_AWQ
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile


_DECODE = ("decode_tc_kernel", "decode_f32_simple_kernel",
           "decode_merge_kernel")
_PREFILL = ("prefill_wgmma_kernel", "prefill_f32_simple_kernel")


def _class(name: str) -> str:
    if any(k in name for k in _DECODE):
        return "decode_attention"
    if any(k in name for k in _PREFILL):
        return "prefill_attention"
    if "quant_matmul_kernel" in name:
        return "quant_matmul"
    low = name.lower()
    if any(k in low for k in ("gemm", "cutlass", "xmma", "nvjet")):
        return "gemm"
    return "other"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quant", default="NO_QUANT",
                    help="QuantAlgo name, e.g. W4A16_AWQ, W8A16, MXFP4")
    ap.add_argument("--group-size", type=int, default=128)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from transformers import LlamaConfig

    from tensorrt_llm_tpu_torch import LLM, SamplingParams
    from tensorrt_llm_tpu_torch.llmapi.llm_args import QuantConfig
    from tensorrt_llm_tpu_torch.ops.cuda import decode_attention as dec
    from tensorrt_llm_tpu_torch.quantization.mode import QuantAlgo
    cfg = LlamaConfig(vocab_size=32000, hidden_size=2048,
                      intermediate_size=5632, num_hidden_layers=22,
                      num_attention_heads=32, num_key_value_heads=4,
                      max_position_embeddings=4096)
    gen = torch.Generator().manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (16, 128),
                            generator=gen).tolist()
    sp = SamplingParams(max_tokens=64, top_k=1)
    llm = LLM(cfg, dtype="bfloat16", quant_config=QuantConfig(
        quant_algo=QuantAlgo[args.quant], group_size=args.group_size))
    try:
        llm.generate(prompts, sp)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        llm.generate(prompts, sp)
        torch.cuda.synchronize()
        plain_wall = time.monotonic() - t0
        dec.LAUNCHES = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            llm.generate(prompts, sp)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
    finally:
        llm.shutdown()
    by_class: dict = {}
    kernels = []
    launches = 0
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = e.cuda_time_total
        if dev_us <= 0 or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        launches += e.count
        c = _class(e.key)
        by_class[c] = by_class.get(c, 0.0) + dev_us / 1e3
        kernels.append((dev_us / 1e3, e.count, e.key[:90]))
    kernels.sort(reverse=True)
    busy_ms = sum(by_class.values())
    # one wrapper call per layer per decode step, whatever the KV splits
    steps = max(1, dec.LAUNCHES // cfg.num_hidden_layers)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(),
        "quant_algo": args.quant,
        "wall_ms": plain_wall * 1e3, "profiled_wall_ms": wall * 1e3,
        "gpu_kernel_ms": busy_ms,
        "idle_share": max(0.0, 1.0 - busy_ms / (plain_wall * 1e3)),
        "profiled_idle_share": max(0.0, 1.0 - busy_ms / (wall * 1e3)),
        "kernel_ms_by_class": by_class,
        "kernel_launches": launches,
        "decode_steps": steps,
        "launches_per_output_step": launches / steps,
        "top_kernels": [{"ms": ms, "count": n, "name": k}
                        for ms, n, k in kernels[:12]]}))


if __name__ == "__main__":
    main()
