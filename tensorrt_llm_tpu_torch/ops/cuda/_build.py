"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. Builds
happen at first use (never at import), into ``_build/`` beside ``csrc/``,
under a file name that carries a hash of the sources, so an edited kernel
is rebuilt and an unchanged one is reused. ``build_all`` starts one
``nvcc`` per source at once and waits for all of them.

Each wrapper module keeps ``LAUNCHES``, the number of times its kernel
ran (and may keep other counters of the same kind, such as a body's own),
and counts through ``count_launch``. A launch recorded into a CUDA
graph is not a run: while ``tally_launches`` is open on the thread, the
launch goes into its tally instead, and whoever replays the graph adds
the tally once per replay (``add_launches``; runtime/cuda_graph.py).
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Counter, Dict, Iterator, List, Tuple

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# prefill_groups: prefill_attention.cu again with the image-group or-mask
KERNELS = ("decode_attention", "prefill_attention", "prefill_groups",
           "quant_matmul")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_tally = threading.local()      # .counts: the open tally of this thread


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def _lib_path(name: str) -> Path:
    """The library of ``name`` under a hash of every source in csrc/ (a
    source may include another's .cu: prefill_groups.cu)."""
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _nvcc_cmd(name: str, out: Path) -> List[str]:
    return [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names=KERNELS) -> Dict[str, str]:
    """Compile every kernel not yet built, one nvcc process per source,
    all started together. Returns the compiler's output per kernel
    (``-Xptxas -v``: registers, shared memory, spills). Raises on any
    failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}:\n{text}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all((name,))
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def count_launch(module: str, counter: str = "LAUNCHES") -> None:
    """One launch of the kernel wrapped by ``module`` (its ``__name__``):
    into the thread's open tally if there is one, else onto the module's
    ``counter``."""
    counts = getattr(_tally, "counts", None)
    if counts is not None:
        counts[module, counter] += 1
    else:
        mod = sys.modules[module]
        setattr(mod, counter, getattr(mod, counter) + 1)


@contextlib.contextmanager
def tally_launches() -> Iterator[Counter[Tuple[str, str]]]:
    """Record this thread's launches by (module, counter) instead of
    counting them (a capture records what each replay will launch)."""
    prev = getattr(_tally, "counts", None)
    _tally.counts = collections.Counter()
    try:
        yield _tally.counts
    finally:
        _tally.counts = prev


def add_launches(counts: Counter[Tuple[str, str]]) -> None:
    """Count a recorded tally once (one replay of a graph)."""
    for (module, counter), n in counts.items():
        mod = sys.modules[module]
        setattr(mod, counter, getattr(mod, counter) + n)
