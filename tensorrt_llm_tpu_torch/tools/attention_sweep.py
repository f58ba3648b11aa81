"""Build report and split sweep of the paged attention kernels on the card.

    python -m tensorrt_llm_tpu_torch.tools.attention_sweep [--build-only]
    python -m tensorrt_llm_tpu_torch.tools.attention_sweep \
        --k2-against PATH

Prints, one JSON object per line:

- ``build``: what ``nvcc -Xptxas -v`` says about every kernel of
  ``csrc/decode_attention.cu`` and ``csrc/prefill_attention.cu``
  (registers, spills, static shared memory), with the build time;
- ``decode_splits``: the decode kernel's time at every forced number of KV
  splits next to the number ``choose_splits`` picks, per shape (CUDA
  events, median of 30 launches queued behind a device sleep), each result
  checked against the plain version at 2e-2;
- ``prefill_scale``: the prefill kernel's time against the number of
  equal prompts (1 to 32) at three prompt lengths, and at four prompts of
  2,048 tokens and one of 8,192 for both head dims, beside
  ``scaled_dot_product_attention`` on the gathered KV (PyTorch's pick of backend, and its FlashAttention and
  cuDNN backends one by one): what one CTA's chain of dependent steps
  costs, and what a full card sustains;
- ``device``: the card's name and power limit as nvidia-smi gives them;
- ``k2_against`` (``--k2-against PATH``, alone): this tree's prefill
  kernel without image groups against the one another checkout at PATH
  builds from its ``csrc/prefill_attention.cu`` (an entry point without
  the three image-group arguments, as before them), on the same inputs
  and in turns (other, this, this, other; median of 30 launches each),
  at the bench-settings step (128 x 128, 16 x 128 heads), Qwen2.5-VL's
  (8 x 640, 28 x 128 over 4) and Gemma-3-4B's text rows (8 x 320, 8 x
  256 over 4, and on a window of 1,024 behind 960 positions): whether
  the causal path moved.

It needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def build_report() -> None:
    from ..ops.cuda import _build
    names = ("decode_attention", "prefill_attention")
    t0 = time.monotonic()
    logs = _build.build_all(names)
    seconds = time.monotonic() - t0
    for name in names:
        kernels = []
        cur = None
        for line in logs.get(name, "").splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                cur = dict(entry=m.group(1))
                kernels.append(cur)
            elif cur is not None and "spill" in line:
                cur["spill"] = line.split("info    :")[-1].strip()
            elif cur is not None and "registers" in line:
                cur["resources"] = line.split("info    :")[-1].strip()
        _emit({"phase": "build", "source": f"csrc/{name}.cu",
               "seconds": seconds, "kernels": kernels})


def decode_split_sweep() -> None:
    import torch
    from ..ops.cuda import decode_attention as dec
    from .card_timing import make_case, time_ms
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, S, kv_len, qh, kvh, hd in [
            ("decode_hd64", 64, 1024, 32, 4, 64),
            ("decode_hd128", 64, 1024, 16, 4, 128),
            ("decode_serving_rows", 64, 160, 32, 4, 64),
            ("decode_rows16", 16, 1024, 32, 4, 64),
            ("decode_long", 4, 16384, 32, 4, 64),
            ("decode_hbm", 64, 4096, 32, 4, 64)]:
        q, pool, kv_lens, pt, _ = make_case([1] * S, [kv_len - 1] * S, qh,
                                            kvh, hd, seed=len(name))
        kw = dict(sm_scale=hd ** -0.5)
        ref = dec.paged_decode_attention_plain(q, pool, kv_lens, pt, **kw)
        chosen = dec.choose_splits(S, kvh, kv_len, sms, qh // kvh)
        times = {}
        for n in sorted({1, 2, 3, 4, 6, 8, 12, 16, 24, 32, chosen}):
            if n > max(1, kv_len // 32):
                continue
            got = dec.paged_decode_attention(q, pool, kv_lens, pt,
                                             num_splits=n, **kw)
            torch.cuda.synchronize()
            if not torch.allclose(got.float(), ref.float(), atol=2e-2,
                                  rtol=2e-2):
                raise AssertionError(f"{name}: {n} splits != plain")
            times[n] = time_ms(lambda: dec.paged_decode_attention(
                q, pool, kv_lens, pt, num_splits=n, **kw))
        _emit({"phase": "decode_splits", "case": name,
               "shape": dict(seqs=S, kv_len=kv_len, qh=qh, kvh=kvh, hd=hd),
               "chosen": chosen, "ms_by_splits": times})
        del q, pool, kv_lens, pt, ref
        torch.cuda.empty_cache()


def prefill_scale_sweep() -> None:
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from ..ops.cuda import prefill_attention as pre
    from .card_timing import dense_kv, make_case, time_ms
    cases = [(L, S, 32, 4, 64) for L in (64, 128, 512)
             for S in (1, 2, 4, 8, 16, 32)]
    cases += [(2048, 4, 32, 4, 64), (2048, 4, 32, 8, 128),
              (8192, 1, 32, 4, 64), (8192, 1, 32, 8, 128)]
    for L, S, qh, kvh, hd in cases:
        q, pool, kv_lens, pt, cu = make_case([L] * S, [0] * S, qh, kvh, hd,
                                             seed=L + S)
        kw = dict(sm_scale=hd ** -0.5, max_q_len=L)
        ms = time_ms(lambda: pre.ragged_prefill_attention(
            q, pool, kv_lens, pt, cu, **kw))
        k, v = dense_kv(pool, pt, kvh, hd, L)
        q4 = q.reshape(S, L, qh, hd).transpose(1, 2).contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(
                q4, k, v, is_causal=True, scale=kw["sm_scale"],
                enable_gqa=True)
        lib = {"default": time_ms(sdpa, 20)}
        if L >= 2048 or (L, S) == (512, 8):
            for name, backend in (("flash", SDPBackend.FLASH_ATTENTION),
                                  ("cudnn", SDPBackend.CUDNN_ATTENTION)):
                try:
                    with sdpa_kernel(backend):
                        lib[name] = time_ms(sdpa, 20)
                except RuntimeError:
                    lib[name] = None
        flops = 4 * qh * hd * S * L * (L + 1) // 2
        _emit({"phase": "prefill_scale",
               "shape": dict(prompt=L, seqs=S, qh=qh, kvh=kvh, hd=hd),
               "ctas": S * kvh * -(-L // (64 // (qh // kvh))), "ms": ms,
               "tflops": flops / ms / 1e9, "sdpa_ms": lib})


def k2_against(other: str) -> None:
    import ctypes
    from pathlib import Path

    import torch
    from ..ops.cuda import _build
    from ..ops.cuda import prefill_attention as pre
    from .card_timing import make_case, time_ms
    out = _build.BUILD_DIR / "libprefill_attention-against.so"
    cmd = _build._nvcc_cmd("prefill_attention", out)
    cmd[-1] = str(Path(other) / "tensorrt_llm_tpu_torch" / "csrc"
                  / "prefill_attention.cu")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run(cmd, check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).ragged_prefill_attention
    P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P_] * 8 + [I_] * 8 + [F_, I_, F_, I_, I_, P_, P_, P_]
    fn.restype = I_
    for name, q_lens, ctx, qh, kvh, hd, window in [
            ("prefill_bench", [128] * 128, [0] * 128, 16, 4, 128, None),
            ("prefill_group7", [640] * 8, [0] * 8, 28, 4, 128, None),
            ("gemma3_4b_text", [320] * 8, [0] * 8, 8, 4, 256, None),
            ("gemma3_4b_window", [320] * 8, [960] * 8, 8, 4, 256, 1024)]:
        q, pool, kv_lens, pt, cu = make_case(q_lens, ctx, qh, kvh, hd,
                                             seed=len(name))
        kw = dict(sm_scale=hd ** -0.5, sliding_window=window,
                  max_q_len=max(q_lens))

        def this():
            return pre.ragged_prefill_attention(q, pool, kv_lens, pt, cu,
                                                **kw)

        def against():
            o = torch.zeros_like(q)
            err = fn(q.data_ptr(), pool.data_ptr(), kv_lens.data_ptr(),
                     pt.data_ptr(), cu.data_ptr(), None, None, o.data_ptr(),
                     len(q_lens), qh, kvh, hd, pool.shape[1], pool.shape[0],
                     pt.shape[1], max(q_lens), kw["sm_scale"], window or 0,
                     0.0, 1, 0, None, None,
                     torch.cuda.current_stream().cuda_stream)
            _build.check(err, "ragged_prefill_attention (against)")
            return o
        same = torch.equal(this(), against())
        turns = [("against", against), ("this", this), ("this", this),
                 ("against", against)]
        times = {"against": [], "this": []}
        for who, f in turns:
            times[who].append(time_ms(f, 30))
        _emit({"phase": "k2_against", "case": name, "other": other,
               "shape": dict(seqs=len(q_lens), q_len=q_lens[0], ctx=ctx[0],
                             qh=qh, kvh=kvh, hd=hd, window=window),
               "bits_equal": same, "ms_this": times["this"],
               "ms_against": times["against"]})
        del q, pool, kv_lens, pt, cu
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--k2-against", default=None, metavar="PATH",
                    help="time K2 without groups against another "
                    "checkout's prefill kernel")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("attention_sweep: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    _emit({"phase": "device", "nvidia_smi": smi})
    if args.k2_against:
        k2_against(args.k2_against)
        return 0
    build_report()
    if not args.build_only:
        decode_split_sweep()
        prefill_scale_sweep()
    return 0


if __name__ == "__main__":
    sys.exit(main())
