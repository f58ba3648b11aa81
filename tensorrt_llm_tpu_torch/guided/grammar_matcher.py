"""Grammar matchers: per-request constraint state machines.

Port of ``tensorrt_llm_tpu/guided/grammar_matcher.py``, unchanged.

Role of the reference GrammarMatcher wrappers over xgrammar/llguidance
(reference: tensorrt_llm/_torch/pyexecutor/grammar_matcher.py). Matchers
are built from SamplingParams.guided_decoding (GuidedDecodingParams:
json / regex / json_object / grammar) and expose:

    fill_next_token_bitmask() -> bool[V]
    accept_token(token_id) -> bool
    is_terminated() -> bool
    rollback(n)   (draft-token rejection; guided_decoder.py:373)

JSON support compiles a depth-capped JSON grammar to a regex (depth 4 —
covers typical structured outputs; the cap is the price of the pure-DFA
engine and is documented user-facing).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from .regex_dfa import DFA, TokenMaskCache, compile_regex

# bounded repetitions (xgrammar-style canonical output): unbounded
# ws/content classes let a degenerate model loop inside the grammar
# forever; the caps force termination within a known byte budget while
# accepting any typical structured output. The generic nested-value
# grammar keeps unbounded strings (bounding every string position
# multiplies DFA states past the cap at depth>=3); schema-typed string
# LEAVES use the bounded form, so schema-guided generation always
# terminates.
_WS = "[ \\t\\n\\r]{0,2}"
_STRING = '"([^"\\\\\\x00-\\x1f]|\\\\.)*"'
_STRING_BOUNDED = '"([^"\\\\\\x00-\\x1f]|\\\\.){0,64}"'
_NUMBER = "-?(0|[1-9][0-9]{0,15})(\\.[0-9]{1,12})?([eE][+-]?[0-9]{1,3})?"


def json_value_regex(depth: int = 4) -> str:
    scalar = f"({_STRING}|{_NUMBER}|true|false|null)"
    value = scalar
    for _ in range(depth):
        obj = (f"\\{{{_WS}({_STRING}{_WS}:{_WS}{value}"
               f"({_WS},{_WS}{_STRING}{_WS}:{_WS}{value})*)?{_WS}\\}}")
        arr = f"\\[{_WS}({value}({_WS},{_WS}{value})*)?{_WS}\\]"
        value = f"({scalar}|{obj}|{arr})"
    return value


def json_object_regex(depth: int = 3) -> str:
    inner = json_value_regex(depth)
    return (f"\\{{{_WS}({_STRING}{_WS}:{_WS}{inner}"
            f"({_WS},{_WS}{_STRING}{_WS}:{_WS}{inner})*)?{_WS}\\}}")


def schema_to_regex(schema: dict, depth: int = 3) -> str:
    """Compile a (flat-ish) JSON schema to a regex. Supports: object with
    properties/required, string (+enum), number/integer, boolean, array of
    simple items. Unknown constructs fall back to the generic value."""
    t = schema.get("type")
    if "enum" in schema and t != "string":
        # bare enum (no/any type): alternation of JSON-encoded literals
        opts = "|".join(_regex_escape(json.dumps(v))
                        for v in schema["enum"])
        return f"({opts})"
    if t == "object" or "properties" in schema:
        props = schema.get("properties", {})
        required = schema.get("required", list(props))
        parts = []
        for i, (name, sub) in enumerate(props.items()):
            if name not in required:
                continue  # optional props omitted in round 1
            key = '"' + _regex_escape(name) + '"'
            parts.append(f"{key}{_WS}:{_WS}{schema_to_regex(sub, depth - 1)}")
        body = f"{_WS},{_WS}".join(parts)
        return f"\\{{{_WS}{body}{_WS}\\}}"
    if t == "string":
        if "enum" in schema:
            opts = "|".join('"' + _regex_escape(v) + '"'
                            for v in schema["enum"])
            return f"({opts})"
        return _STRING_BOUNDED
    if t == "integer":
        return "-?(0|[1-9][0-9]{0,15})"
    if t == "number":
        return _NUMBER
    if t == "boolean":
        return "(true|false)"
    if t == "null":
        return "null"
    if t == "array":
        item = schema_to_regex(schema.get("items", {}), depth - 1) \
            if depth > 0 else json_value_regex(1)
        min_items = int(schema.get("minItems", 0) or 0)
        max_items = schema.get("maxItems")
        if max_items is not None:
            extra = max(0, int(max_items) - max(min_items, 1))
            rep = f"({_WS},{_WS}{item}){{0,{extra}}}"
        else:
            rep = f"({_WS},{_WS}{item})*"
        body = f"{item}{rep}"
        if min_items < 1:
            body = f"({body})?"
        return f"\\[{_WS}{body}{_WS}\\]"
    return json_value_regex(max(depth, 1))


def _regex_escape(s: str) -> str:
    out = []
    for ch in s:
        if ch in "\\^$.|?*+()[]{}":
            out.append("\\" + ch)
        else:
            out.append(ch)
    return "".join(out)


class TokenTable:
    """Vocab token byte matrix shared by all matchers of one tokenizer."""

    def __init__(self, token_strings: List, eos_token_id: int):
        V = len(token_strings)
        enc = [s if isinstance(s, bytes) else s.encode("utf-8")
               for s in token_strings]
        Lmax = max((len(b) for b in enc), default=1)
        self.token_bytes = np.zeros((V, Lmax), np.uint8)
        self.token_lens = np.zeros(V, np.int32)
        for i, b in enumerate(enc):
            self.token_lens[i] = len(b)
            self.token_bytes[i, :len(b)] = np.frombuffer(b, np.uint8)
        self.eos_token_id = eos_token_id
        self.vocab_size = V

    @classmethod
    def from_tokenizer(cls, tokenizer) -> "TokenTable":
        V = getattr(tokenizer, "vocab_size", None) or len(tokenizer)
        strings = []
        for i in range(V):
            try:
                s = tokenizer.decode([i])
            except Exception:
                s = ""
            strings.append(s)
        return cls(strings, getattr(tokenizer, "eos_token_id", 0) or 0)


class GrammarMatcher:
    """DFA-backed matcher instance (one per guided request)."""

    def __init__(self, dfa: DFA, table: TokenTable):
        self.dfa = dfa
        self.table = table
        self.cache = TokenMaskCache(dfa, table.token_bytes,
                                    table.token_lens)
        self.state = dfa.start
        self.history: List[int] = [self.state]

    def fill_next_token_bitmask(self) -> np.ndarray:
        mask = self.cache.mask(self.state).copy()
        if self.dfa.accepting[self.state]:
            mask[self.table.eos_token_id] = True
        elif not mask.any():
            # dead-end safety valve: allow EOS rather than deadlock
            mask[self.table.eos_token_id] = True
        return mask

    def accept_token(self, token_id: int) -> bool:
        if token_id == self.table.eos_token_id:
            self.history.append(self.state)
            return bool(self.dfa.accepting[self.state])
        nxt = int(self.cache.final_states(self.state)[token_id])
        if nxt < 0:
            return False
        self.state = nxt
        self.history.append(nxt)
        return True

    def rollback(self, n: int) -> None:
        """Undo the last n accepted tokens (draft rejection;
        reference: guided_decoder.py:373)."""
        for _ in range(n):
            if len(self.history) > 1:
                self.history.pop()
        self.state = self.history[-1]

    def is_terminated(self) -> bool:
        return bool(self.dfa.accepting[self.state]) and \
            not self.cache.mask(self.state).any()


class MatcherFactory:
    """Builds matchers from GuidedDecodingParams, caching compiled DFAs."""

    def __init__(self, token_table: TokenTable):
        self.table = token_table
        self._dfa_cache: Dict[str, DFA] = {}

    def compile_dfa(self, params):
        """(cache_key, DFA) for the request's grammar, or None when the
        params carry no constraint. The key identifies the compiled
        grammar — device-pool segments are shared/refcounted by it."""
        if params is None:
            return None
        if params.structural_tag:
            spec = params.structural_tag
            key = spec if isinstance(spec, str) else json.dumps(
                spec, sort_keys=True)
            if key not in self._dfa_cache:
                self._dfa_cache[key] = self._build_structural(spec)
            return key, self._dfa_cache[key]
        if params.regex:
            pattern = params.regex
        elif params.json is not None:
            if isinstance(params.json, dict):
                pattern = schema_to_regex(params.json)
            elif isinstance(params.json, str) and params.json.strip():
                pattern = schema_to_regex(json.loads(params.json))
            else:
                pattern = json_value_regex()
        elif params.json_object:
            pattern = json_object_regex()
        elif params.grammar:
            from .ebnf import ebnf_to_regex
            pattern = ebnf_to_regex(params.grammar)
        else:
            return None
        if pattern not in self._dfa_cache:
            self._dfa_cache[pattern] = compile_regex(pattern)
        return pattern, self._dfa_cache[pattern]

    def create(self, params) -> Optional[GrammarMatcher]:
        compiled = self.compile_dfa(params)
        if compiled is None:
            return None
        return GrammarMatcher(compiled[1], self.table)

    def _build_structural(self, spec):
        """xgrammar structural-tag spec: {"structures": [{"begin",
        "schema"|"content_regex", "end"}], "triggers": [...]} (triggers
        are implied by the begin literals in the DFA engine)."""
        from .regex_dfa import build_structural_dfa
        obj = json.loads(spec) if isinstance(spec, str) else spec
        triples = []
        for st in obj["structures"]:
            if "content_regex" in st:
                content = st["content_regex"]
            elif st.get("schema"):
                content = schema_to_regex(st["schema"])
            else:
                content = None
            triples.append((st["begin"], content, st["end"]))
        return build_structural_dfa(triples)
