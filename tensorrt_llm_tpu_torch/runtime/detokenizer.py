"""Incremental detokenization for streaming.

Port of ``tensorrt_llm_tpu/runtime/detokenizer.py``: text is decoded
from every token so far and only the new suffix is handed out, so that a
tokenizer whose decode depends on the preceding tokens gives the same
text as one decode of the whole sequence; a suffix that ends in the
replacement character (an incomplete multi-byte sequence) is held back
until the bytes that complete it arrive.
"""
from __future__ import annotations

from typing import List

_REPLACEMENT = "�"


class IncrementalDetokenizer:
    def __init__(self, tokenizer, skip_special_tokens: bool = True,
                 context_window: int = 8):
        self.tokenizer = tokenizer
        self.skip_special_tokens = skip_special_tokens
        self.context_window = context_window
        self._tokens: List[int] = []
        self._emitted_text_len = 0

    def put(self, token_ids: List[int]) -> str:
        """Add tokens; returns the newly decodable text (empty while a
        multi-byte sequence is incomplete)."""
        self._tokens.extend(token_ids)
        text = self._decode(self._tokens)
        if text.endswith(_REPLACEMENT):
            return ""
        new = text[self._emitted_text_len:]
        self._emitted_text_len = len(text)
        return new

    def finish(self) -> str:
        """The text not handed out yet, whatever it ends in."""
        text = self._decode(self._tokens)
        new = text[self._emitted_text_len:]
        self._emitted_text_len = len(text)
        return new

    @property
    def full_text(self) -> str:
        return self._decode(self._tokens)

    def _decode(self, ids: List[int]) -> str:
        if self.tokenizer is None:
            return ""
        try:
            return self.tokenizer.decode(
                ids, skip_special_tokens=self.skip_special_tokens)
        except Exception:  # a tokenizer fault yields no text, not an error
            return ""
