"""Greedy tokens of the port's ``LLM`` against the JAX package's on tiny
GPT-family checkpoints (float32, CPU), one family per knob of
models/gpt_family.py: the parallel block with one shared norm (Falcon),
ALiBi with the embedding LayerNorm (BLOOM), learned positions (OPT at
offset 2, GPT-2), and sliding layers with NoPE global ones (Cohere2, whose
window of 8 the prompts outgrow). The JAX models run with their two
reference faults corrected (tests/test_torch_gpt_family.py ``_correct``:
the rotary style and the exact GELU), which Cohere2 and Falcon would
otherwise show."""
import pytest

from tests.test_torch_dense_families import greedy_both
from tests.test_torch_gpt_family import _configs, _correct, save_random


@pytest.fixture
def corrected_jax(monkeypatch):
    """Every JAX LayerNorm-family model built in the test is corrected."""
    from tensorrt_llm_tpu.models import gpt_family as jgf
    init = jgf.LnFamilyModel.__init__

    def corrected(self, model_config):
        init(self, model_config)
        _correct(self, monkeypatch)
    monkeypatch.setattr(jgf.LnFamilyModel, "__init__", corrected)


@pytest.mark.parametrize("knob", ["falcon", "bloom", "opt", "gpt2",
                                  "cohere2"])
def test_llm_greedy_matches_jax(tmp_path, knob, corrected_jax):
    config = None
    if knob == "falcon":
        # the JAX Falcon loader needs the head stored apart
        # (test_torch_gpt_family.py::test_jax_falcon_cannot_load_a_tied_checkpoint)
        config = _configs()["falcon"][0]
        config.tie_word_embeddings = False
    save_random(tmp_path, knob, seed=3, config=config)
    out = greedy_both(str(tmp_path))
    assert [len(t) for t in out["torch"]] == [12] * 3
    assert out["torch"] == out["jax"]
