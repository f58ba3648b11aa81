"""Guards of the PyTorch port: it never imports JAX or the JAX package,
it builds and serves on the CPU with JAX unimportable, and it refuses to
fall back to the CPU when CUDA is missing and no device was asked for."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "tensorrt_llm_tpu_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "tensorrt_llm_tpu") or \
        top.startswith("jax")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("quant", ["NO_QUANT", "W4A16_AWQ", "MXFP4"])
def test_port_serves_with_jax_unimportable(quant):
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["tensorrt_llm_tpu"] = None
        import tensorrt_llm_tpu_torch as t
        from transformers import LlamaConfig
        cfg = LlamaConfig(vocab_size=64, hidden_size=64,
                          intermediate_size=96, num_hidden_layers=2,
                          num_attention_heads=2, num_key_value_heads=1,
                          max_position_embeddings=128)
        llm = t.LLM(cfg, device="cpu", dtype="float32", max_batch_size=2,
                    max_input_len=16, max_seq_len=32, max_num_tokens=64,
                    quant_config=t.QuantConfig(
                        quant_algo=t.QuantAlgo[sys.argv[1]], group_size=16),
                    kv_cache_config=t.KvCacheConfig(tokens_per_block=16,
                                                    max_tokens=256))
        out = llm.generate([1, 2, 3], t.SamplingParams(max_tokens=4,
                                                       top_k=1))
        llm.shutdown()
        assert len(out.outputs[0].token_ids) == 4
        assert not any(m == "jax" or m.startswith("jax.")
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code, quant], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_llm_without_cuda_raises(monkeypatch):
    from transformers import LlamaConfig

    from tensorrt_llm_tpu_torch import LLM
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=96,
                      num_hidden_layers=1, num_attention_heads=2,
                      num_key_value_heads=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LLM(cfg, dtype="float32")


def test_cpu_tensors_take_the_plain_path_uncounted():
    """A wrapper runs its plain version only for CPU tensors, and counts
    only kernel launches."""
    from tensorrt_llm_tpu_torch.ops.cuda import decode_attention as dec
    from tensorrt_llm_tpu_torch.ops.cuda import prefill_attention as pre
    from tensorrt_llm_tpu_torch.ops.cuda import quant_matmul as qmm
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 64), generator=g)
    w = torch.randint(-128, 128, (32, 10), generator=g).to(torch.int8)
    sc = torch.rand((2, 10), generator=g)
    launches = qmm.LAUNCHES
    got = qmm.groupwise_dequant_matmul(x, w, sc, group_size=32, bits=4)
    assert torch.equal(got, qmm.groupwise_dequant_matmul_plain(
        x, w, sc, group_size=32, bits=4))
    assert qmm.LAUNCHES == launches
    q = torch.randn((2, 4, 64), generator=g)
    pool = torch.randn((4, 16, 4, 64), generator=g)
    kvl = torch.tensor([5, 17], dtype=torch.int32)
    pt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    cu = torch.tensor([0, 1, 2], dtype=torch.int32)
    before = (dec.LAUNCHES, pre.LAUNCHES)
    a = dec.paged_decode_attention(q, pool, kvl, pt, sm_scale=0.125)
    b = pre.ragged_prefill_attention(q, pool, kvl, pt, cu, sm_scale=0.125)
    torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
    assert (dec.LAUNCHES, pre.LAUNCHES) == before


def test_kernel_build_names_track_sources(tmp_path, monkeypatch):
    """A built library is keyed by its sources' hash: an edited kernel
    gets a new file name (and is rebuilt), an unchanged one is reused."""
    from tensorrt_llm_tpu_torch.ops.cuda import _build
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").exists()
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    first = _build._lib_path("k")
    assert first == _build._lib_path("k")
    (src / "k.cu").write_text("// v2\n")
    assert _build._lib_path("k") != first
