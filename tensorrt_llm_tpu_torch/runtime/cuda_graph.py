"""CUDA graphs per step shape: the port's counterpart of bucketed jit.

The JAX engine pads every step to a (token bucket, row bucket) pair and
jits it, so that each step replays a cached executable
(``tensorrt_llm_tpu/runtime/model_engine.py:1-10``, the role of the
reference's ``cuda_graph_runner.py``). Here a step is a callable over
static device inputs, captured into a CUDA graph once per key and
replayed (``GraphRunner``):

- inputs: every host array of a step is a 4-byte type (int32 or
  float32). They are packed into one int32 buffer that goes up in one
  pinned, non-blocking copy into the key's static device buffer, and the
  callable reads views of it. The caller rewrites every field on every
  dispatch, padding included, so nothing of an earlier, larger batch is
  read;
- outputs: the tensors the callable returned at capture are the graph's
  static outputs. The caller copies them out (``HostFuture``) before the
  next replay of the key, which is queued after that copy on the same
  stream, can overwrite them;
- memory: every graph captures into one shared pool
  (``torch.cuda.graph_pool_handle``); the steps replay one after another
  on one stream, so their intermediates can share it;
- random numbers: the engine's generator is registered with each graph,
  so every replay draws fresh noise for unseeded sampled rows;
- launches: the kernel launches recorded at capture are counted once per
  replay (``ops/cuda/_build.py``).

Before a capture the callable runs once eagerly, on a side stream and on
inputs that change nothing (all rows inactive), so that lazy
initialisation happens outside the capture. A capture that fails raises
("CUDA graph capture failed", which the executor treats as fatal) and
leaves no entry for its key: no step is served by an unrecorded path. With ``capture`` off (the CPU,
or a CUDA engine run eagerly for comparison) the same static buffers are
filled and the callable runs eagerly on them.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Counter, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.cuda._build import add_launches, tally_launches

Inputs = Dict[str, np.ndarray]
Views = Dict[str, torch.Tensor]
Body = Callable[[Views], Tuple[torch.Tensor, ...]]
Layout = Tuple[Tuple[str, Tuple[int, ...], np.dtype], ...]

_TORCH_DTYPES = {np.dtype(np.int32): torch.int32,
                 np.dtype(np.float32): torch.float32}


def layout_of(inputs: Inputs) -> Layout:
    """Names, shapes and types of a step's host inputs, in order."""
    out = []
    for name, a in inputs.items():
        if a.dtype not in _TORCH_DTYPES:
            raise TypeError(f"step input {name}: {a.dtype} is not a "
                            "4-byte type")
        out.append((name, a.shape, a.dtype))
    return tuple(out)


def _pack(inputs: Inputs, out: np.ndarray) -> None:
    o = 0
    for a in inputs.values():
        n = a.size
        out[o:o + n] = np.ascontiguousarray(a).reshape(-1).view(np.int32)
        o += n


def _views(buf: torch.Tensor, layout: Layout) -> Views:
    views, o = {}, 0
    for name, shape, dtype in layout:
        n = int(np.prod(shape, dtype=np.int64))
        views[name] = buf[o:o + n].view(_TORCH_DTYPES[dtype]).view(shape)
        o += n
    return views


def _size(layout: Layout) -> int:
    return sum(int(np.prod(shape, dtype=np.int64)) for _, shape, _ in layout)


def copy_in(inputs: Inputs, buf: torch.Tensor) -> None:
    """Pack ``inputs`` into the device buffer ``buf`` without blocking
    the host (through pinned memory on CUDA)."""
    host = torch.empty(buf.numel(), dtype=torch.int32,
                       pin_memory=buf.device.type == "cuda")
    _pack(inputs, host.numpy())
    buf.copy_(host, non_blocking=True)


def upload(inputs: Inputs, device: torch.device) -> Views:
    """A step's host inputs in a fresh device buffer (an eager step)."""
    layout = layout_of(inputs)
    buf = torch.empty(_size(layout), dtype=torch.int32, device=device)
    copy_in(inputs, buf)
    return _views(buf, layout)


class _Step:
    """One key: its static input buffer and, once captured, its graph,
    static outputs and launches per replay."""

    def __init__(self, layout: Layout, device: torch.device):
        self.layout = layout
        self.buf = torch.zeros(_size(layout), dtype=torch.int32,
                               device=device)
        self.views = _views(self.buf, layout)
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.outputs: Tuple[torch.Tensor, ...] = ()
        # (wrapper module, counter) -> launches recorded at capture
        self.launches: Counter[Tuple[str, str]] = collections.Counter()
        self.replays = 0


class GraphRunner:
    """Captured steps by key, and what they cost: ``capture_seconds`` and
    ``pool_bytes`` (what the caching allocator reserved while
    capturing)."""

    def __init__(self, device: torch.device, generator: torch.Generator,
                 capture: bool):
        self.device = device
        self.generator = generator
        self.capture = capture
        self.pool = torch.cuda.graph_pool_handle() if capture else None
        self.steps: Dict[tuple, _Step] = {}
        self.capture_seconds = 0.0
        self.pool_bytes = 0
        # held while a graph is captured: work another thread launches on
        # the device (a multimodal request's vision tower, on the caller's
        # thread) takes it, so that no capture sees it
        self.lock = threading.Lock()

    @property
    def num_graphs(self) -> int:
        return sum(s.graph is not None for s in self.steps.values())

    @property
    def replays(self) -> int:
        return sum(s.replays for s in self.steps.values())

    def replayed_launches(self, kind: Optional[str] = None) -> Counter[str]:
        """Kernel launches made by graph replays, by wrapper module (of the
        keys whose first field is ``kind``, or of every key)."""
        total: Counter[str] = collections.Counter()
        for key, s in self.steps.items():
            if kind is not None and key[0] != kind:
                continue
            for (module, counter), n in s.launches.items():
                if counter == "LAUNCHES":
                    total[module] += n * s.replays
        return total

    def ensure(self, key: tuple, inert: Inputs, body: Body) -> _Step:
        """The step of ``key``, captured now if it is new (``inert``:
        inputs of the key's layout that change no device state)."""
        step = self.steps.get(key)
        if step is None:
            step = _Step(layout_of(inert), self.device)
            if self.capture:
                try:
                    self._capture(step, inert, body)
                except Exception as e:
                    # fatal to the executor (runtime/error_isolation.py);
                    # the half-built step never enters the cache
                    raise RuntimeError(f"CUDA graph capture failed for "
                                       f"step {key}: {e}") from e
            self.steps[key] = step
        return step

    def run(self, key: tuple, inputs: Inputs, body: Body,
            inert: Callable[[], Inputs]) -> Tuple[torch.Tensor, ...]:
        """Dispatch one step: copy ``inputs`` into the key's buffer, then
        replay its graph (or run ``body`` eagerly on the buffer)."""
        step = self.steps.get(key) or self.ensure(key, inert(), body)
        if layout_of(inputs) != step.layout:
            raise ValueError(f"step {key}: inputs do not match the "
                             "captured layout")
        copy_in(inputs, step.buf)
        if step.graph is not None:
            step.graph.replay()
            step.replays += 1
            add_launches(step.launches)
            return step.outputs
        with tally_launches() as counts:
            outputs = body(step.views)
        add_launches(counts)
        return outputs

    def _capture(self, step: _Step, inert: Inputs, body: Body) -> None:
        with self.lock:
            self._capture_locked(step, inert, body)

    def _capture_locked(self, step: _Step, inert: Inputs,
                        body: Body) -> None:
        copy_in(inert, step.buf)
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            body(step.views)              # warm-up on inert inputs
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        with tally_launches() as counts, torch.cuda.graph(
                graph, pool=self.pool, capture_error_mode="thread_local"):
            outputs = body(step.views)
        self.capture_seconds += time.perf_counter() - t0
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        step.graph, step.outputs, step.launches = graph, outputs, counts
