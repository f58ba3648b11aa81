"""The port's BERT classify path (tensorrt_llm_tpu_torch/models/bert.py,
``LLM.classify``) against ``transformers`` and the JAX ``LLM`` on the CPU,
float32, logits to 2e-4 (the tolerance of tests/test_bert.py): plain
rows, sentence pairs with token types in a ragged batch, every length
bucket, seeded random weights from a bare config, and the refusals."""
import numpy as np
import pytest
import torch

import tensorrt_llm_tpu as J
import tensorrt_llm_tpu_torch as T

TOL = dict(rtol=2e-4, atol=2e-4)


def _bert(num_labels, seed, max_pos=128):
    from transformers import BertConfig, BertForSequenceClassification
    torch.manual_seed(seed)
    cfg = BertConfig(vocab_size=96, hidden_size=64, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=128,
                     max_position_embeddings=max_pos, num_labels=num_labels)
    return BertForSequenceClassification(cfg).eval()


def _hf_rows(tm, prompts, tts=None):
    out = []
    with torch.no_grad():
        for i, p in enumerate(prompts):
            kw = {} if tts is None else {
                "token_type_ids": torch.tensor([tts[i]])}
            out.append(tm(input_ids=torch.tensor([p]),
                          attention_mask=torch.ones(1, len(p),
                                                    dtype=torch.long),
                          **kw).logits[0].numpy())
    return np.stack(out)


def _both(tm, prompts, tts=None):
    j = J.LLM(model=tm, skip_tokenizer_init=True, dtype="float32")
    try:
        want = np.asarray(j.classify(prompts, token_type_ids=tts))
    finally:
        j.shutdown()
    t = T.LLM(tm, device="cpu", skip_tokenizer_init=True, dtype="float32")
    try:
        got = t.classify(prompts, token_type_ids=tts)
        assert t.executor is None and t.engine is None
    finally:
        t.shutdown()
    return got, want


def test_classify_matches_transformers_and_jax():
    tm = _bert(3, 0)
    prompts = [[2, 5, 9, 23], [7, 11, 13, 17, 19, 23]]
    got, want = _both(tm, prompts)
    assert got.shape == (2, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, _hf_rows(tm, prompts), **TOL)
    np.testing.assert_allclose(got, want, **TOL)


def test_token_types_and_padding():
    """Sentence pairs in a ragged batch: padded keys take no weight."""
    tm = _bert(2, 1)
    prompts = [[2, 5, 9, 23, 40, 41], [7, 11, 13]]
    tts = [[0, 0, 0, 1, 1, 1], [0, 0, 1]]
    got, want = _both(tm, prompts, tts)
    np.testing.assert_allclose(got, _hf_rows(tm, prompts, tts), **TOL)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("length,bucket", [(5, 32), (40, 128), (300, 512)])
def test_length_buckets(length, bucket):
    """A batch pads to the first bucket that holds its longest row (32,
    128, 512); the logits do not depend on the padding."""
    from tensorrt_llm_tpu_torch.models.bert import \
        BertForSequenceClassification
    rng = np.random.default_rng(length)
    prompts = [rng.integers(1, 96, size=length).tolist(),
               rng.integers(1, 96, size=3).tolist()]
    ids, mask, _ = BertForSequenceClassification.pad_batch(prompts)
    assert ids.shape == (2, bucket) and mask.sum() == length + 3
    tm = _bert(1, 2, max_pos=512)
    got, want = _both(tm, prompts)
    np.testing.assert_allclose(got, _hf_rows(tm, prompts), **TOL)
    np.testing.assert_allclose(got, want, **TOL)


def test_random_weights_from_a_bare_config():
    """A bare config serves seeded random weights: finite logits, the same
    for the same seed, one row or a batch alike (a single list is one
    row)."""
    cfg = _bert(4, 0).config
    a = T.LLM(cfg, device="cpu", dtype="float32")
    b = T.LLM(cfg, device="cpu", dtype="float32")
    try:
        one = a.classify([3, 4, 5])
        batch = a.classify([[3, 4, 5], [6, 7]])
        again = b.classify([[3, 4, 5], [6, 7]])
    finally:
        a.shutdown()
        b.shutdown()
    assert one.shape == (1, 4) and np.isfinite(batch).all()
    np.testing.assert_allclose(one[0], batch[0], **TOL)
    np.testing.assert_array_equal(batch, again)


def test_refusals():
    from tensorrt_llm_tpu_torch.llmapi.llm_args import QuantConfig
    from tensorrt_llm_tpu_torch.quantization.mode import QuantAlgo
    tm = _bert(2, 0)
    with pytest.raises(NotImplementedError, match="quant_config on a bert"):
        T.LLM(tm, device="cpu", dtype="float32",
              quant_config=QuantConfig(quant_algo=QuantAlgo.W8A16))
    llm = T.LLM("tests/assets/tinycode-llama", device="cpu",
                dtype="float32", skip_tokenizer_init=True,
                max_batch_size=2, max_input_len=32, max_seq_len=64)
    try:
        with pytest.raises(ValueError, match="encoder-only"):
            llm.classify([[1, 2, 3]])
    finally:
        llm.shutdown()
