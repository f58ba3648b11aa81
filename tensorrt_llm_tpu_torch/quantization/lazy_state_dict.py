"""Lazy, memory-mapped state dict over (sharded) safetensors.

Port of ``tensorrt_llm_tpu/quantization/lazy_state_dict.py``:
``safetensors.safe_open(framework="pt")`` maps each shard, and a tensor
is read when its name is looked up, so that a loader that builds its
parameters one by one holds one checkpoint tensor (and what it makes of
it) at a time, never the whole checkpoint. A directory of
``*.safetensors`` files and a sharded checkpoint with
``model.safetensors.index.json`` are both read.

``RenamedStateDict`` is a view of another state dict under other names,
with entries computed on lookup: the loaders that rename or convert
checkpoint entries (prefixes stripped, prequantized weights unpacked,
MXFP4 blocks dequantized) read through it instead of building a dict.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, Mapping, Optional

import torch


class LazyStateDict(Mapping):
    """name -> torch.Tensor, read from its shard on each lookup."""

    def __init__(self, path):
        from safetensors import safe_open
        self.path = Path(path)
        self._handles: Dict[str, Any] = {}      # file -> safe_open handle
        self._where: Dict[str, str] = {}        # tensor name -> file
        index = self.path / "model.safetensors.index.json"
        if index.exists():
            weight_map = json.loads(index.read_text())["weight_map"]
            for fname in sorted(set(weight_map.values())):
                self._handles[fname] = safe_open(str(self.path / fname),
                                                 framework="pt")
            self._where = dict(weight_map)
        else:
            files = sorted(self.path.glob("*.safetensors"))
            if not files:
                raise FileNotFoundError(f"no *.safetensors under {self.path}")
            for f in files:
                h = safe_open(str(f), framework="pt")
                self._handles[f.name] = h
                for name in h.keys():
                    self._where[name] = f.name

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._handles[self._where[name]].get_tensor(name)

    def __contains__(self, name) -> bool:
        return name in self._where

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)


class RenamedStateDict(Mapping):
    """A view of ``base``: ``names`` maps each name of the view to the
    base's name, and ``computed`` maps a name to a function that builds
    its tensor (from the base) when it is looked up; nothing is read
    before a lookup."""

    def __init__(self, base: Mapping[str, Any], names: Mapping[str, str],
                 computed: Optional[Mapping[str, Callable[[], Any]]] = None):
        self.base = base
        self.names = dict(names)
        self.computed = dict(computed or {})

    def __getitem__(self, name: str):
        fn = self.computed.get(name)
        if fn is not None:
            return fn()
        return self.base[self.names[name]]

    def __contains__(self, name) -> bool:
        return name in self.computed or name in self.names

    def __iter__(self) -> Iterator[str]:
        yield from self.names
        yield from (k for k in self.computed if k not in self.names)

    def __len__(self) -> int:
        return len(self.names) + sum(k not in self.names
                                     for k in self.computed)


def strip_prefix(sd: Mapping[str, Any], prefix: str) -> RenamedStateDict:
    """``sd`` with ``prefix`` taken off the names that have it."""
    return RenamedStateDict(sd, {
        k[len(prefix):] if k.startswith(prefix) else k: k for k in sd})
