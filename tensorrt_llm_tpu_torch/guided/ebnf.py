"""EBNF (GBNF-style) grammar support for guided decoding.

Port of ``tensorrt_llm_tpu/guided/ebnf.py``, unchanged.

Behavioral reference: the reference vendors xgrammar for EBNF
(tensorrt_llm/_torch/pyexecutor/grammar_matcher.py GrammarConfig
ebnf path; llguidance backend). This repo's pure-DFA engine handles
EBNF by BOUNDED EXPANSION: rule references inline recursively up to
``max_depth``; at the cap, a recursive rule falls back to its
non-recursive alternatives (or fails if none exist). That makes
regular and finitely-nested grammars exact, and unbounded recursion a
documented depth-capped approximation — the same honest trade the
JSON-schema path makes (grammar_matcher.py json_value_regex).

Grammar syntax (llama.cpp GBNF):
    root  ::= "yes" | "no" | answer
    answer ::= [a-z]+ ("," ws [a-z]+)*
    ws    ::= [ \\t]*
Literals in double quotes, char classes in brackets, grouping with
(), alternation |, postfix * + ?, and # comments.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

_TOKEN_RE = re.compile(r'''
    (?P<name>[A-Za-z][A-Za-z0-9_-]*)
  | (?P<assign>::=)
  | (?P<literal>"(?:\\.|[^"\\])*")
  | (?P<cls>\[(?:\\.|[^\]\\])*\])
  | (?P<op>[()|*+?])
''', re.VERBOSE)

_REGEX_SPECIAL = set("\\^$.|?*+()[]{}")


def _escape_literal(s: str) -> str:
    # unescape GBNF string escapes, then re-escape for our regex engine
    out = []
    i = 0
    while i < len(s):
        ch = s[i]
        if ch == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            ch = {"n": "\n", "t": "\t", "r": "\r",
                  '"': '"', "\\": "\\"}.get(nxt, nxt)
            i += 2
        else:
            i += 1
        if ch in _REGEX_SPECIAL:
            out.append("\\" + ch)
        else:
            out.append(ch)
    return "".join(out)


class _Rule:
    """Parsed rule body: nested list structure of ("lit", s) /
    ("cls", s) / ("ref", name) / ("group", alternatives) each with an
    optional postfix op."""

    def __init__(self, alternatives):
        self.alternatives = alternatives  # list of lists of (atom, op)


def parse_ebnf(grammar: str) -> Dict[str, _Rule]:
    rules: Dict[str, _Rule] = {}
    # strip comments
    lines = []
    for line in grammar.splitlines():
        if "#" in line:
            line = line[:line.index("#")]
        lines.append(line)
    text = "\n".join(lines)

    # split into rule definitions on NAME ::=
    tokens: List[Tuple[str, str]] = []
    i = 0
    while i < len(text):
        if text[i].isspace():
            i += 1
            continue
        m = _TOKEN_RE.match(text, i)
        if not m:
            raise ValueError(f"EBNF syntax error at {text[i:i+20]!r}")
        kind = m.lastgroup
        tokens.append((kind, m.group()))
        i = m.end()

    # group tokens per rule
    defs: List[Tuple[str, List[Tuple[str, str]]]] = []
    j = 0
    while j < len(tokens):
        if j + 1 < len(tokens) and tokens[j][0] == "name" \
                and tokens[j + 1][0] == "assign":
            defs.append((tokens[j][1], []))
            j += 2
        elif defs:
            defs[-1][1].append(tokens[j])
            j += 1
        else:
            raise ValueError("grammar must start with `name ::=`")

    for name, body in defs:
        rules[name] = _parse_body(body)
    if "root" not in rules:
        raise ValueError("EBNF grammar needs a `root` rule")
    return rules


def _parse_body(tokens: List[Tuple[str, str]]) -> _Rule:
    pos = 0

    def alternation():
        nonlocal pos
        alts = [sequence()]
        while pos < len(tokens) and tokens[pos] == ("op", "|"):
            pos += 1
            alts.append(sequence())
        return alts

    def sequence():
        nonlocal pos
        items = []
        while pos < len(tokens) and tokens[pos] not in (
                ("op", "|"), ("op", ")")):
            items.append(atom())
        return items

    def atom():
        nonlocal pos
        kind, val = tokens[pos]
        pos += 1
        if kind == "literal":
            node = ("lit", _escape_literal(val[1:-1]))
        elif kind == "cls":
            node = ("cls", val)
        elif kind == "name":
            node = ("ref", val)
        elif (kind, val) == ("op", "("):
            inner = alternation()
            if pos >= len(tokens) or tokens[pos] != ("op", ")"):
                raise ValueError("unbalanced ( in grammar")
            pos += 1
            node = ("group", inner)
        else:
            raise ValueError(f"unexpected {val!r} in rule body")
        op = None
        if pos < len(tokens) and tokens[pos][0] == "op" \
                and tokens[pos][1] in "*+?":
            op = tokens[pos][1]
            pos += 1
        return (node, op)

    alts = alternation()
    if pos != len(tokens):
        raise ValueError(f"trailing tokens in rule: {tokens[pos:]}")
    return _Rule(alts)


def ebnf_to_regex(grammar: str, max_depth: int = 6) -> str:
    """Expand the grammar from ``root`` into one regex (bounded
    recursion — see module docstring)."""
    rules = parse_ebnf(grammar)

    def is_recursive_alt(name, alt, seen) -> bool:
        for (node, _op) in alt:
            if node[0] == "ref":
                if node[1] == name or node[1] in seen:
                    return True
            elif node[0] == "group":
                for a in node[1]:
                    if is_recursive_alt(name, a, seen):
                        return True
        return False

    def expand(name: str, depth: int, stack: Tuple[str, ...]) -> str:
        if name not in rules:
            raise ValueError(f"undefined rule {name!r}")
        rule = rules[name]
        alts = rule.alternatives
        if depth <= 0 or name in stack and depth <= 1:
            base = [a for a in alts
                    if not is_recursive_alt(name, a, set(stack))]
            if not base:
                raise ValueError(
                    f"rule {name!r}: unbounded recursion exceeds the "
                    f"DFA engine's depth cap and has no base case")
            alts = base
        parts = [seq_to_regex(a, name, depth, stack) for a in alts]
        return "(" + "|".join(parts) + ")" if len(parts) > 1 else parts[0]

    def seq_to_regex(alt, name, depth, stack) -> str:
        out = []
        for (node, op) in alt:
            if node[0] == "lit":
                r = node[1]
                if op and len(r) > 1:
                    r = f"({r})"
            elif node[0] == "cls":
                r = node[1]
            elif node[0] == "ref":
                r = expand(node[1], depth - 1, stack + (name,))
                if op:
                    r = f"({r})"
            else:  # group
                parts = [seq_to_regex(a, name, depth, stack)
                         for a in node[1]]
                r = "(" + "|".join(parts) + ")"
            if op:
                r = r + op
            out.append(r)
        return "".join(out) if out else ""

    return expand("root", max_depth, ())
