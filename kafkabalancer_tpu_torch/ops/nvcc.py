"""Build and load the port's CUDA sources (``kafkabalancer_tpu_torch/csrc``).

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, and loaded with
``ctypes``. Libraries are cached in ``kafkabalancer_tpu_torch/_build/``
under a digest of the source, the headers it includes from ``csrc/`` and
the flags, and written with an atomic rename, so concurrent builds see all
or nothing and an edited header rebuilds every source that includes it.

Nothing here runs at import: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # the plain versions round after every multiply and add; contraction
    # into FMAs would change the kernels' bits
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_count_lock = threading.Lock()
_tally = threading.local()
# nvcc's output (resource usage with -Xptxas -v) and seconds of the last
# build of each source, by file name
build_logs: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels cannot be built"
    )


def _digest(name: str) -> str:
    """sha256 over the source, every ``csrc/`` header it includes
    (transitively) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    seen = set()
    todo = [name]
    while todo:
        cur = todo.pop()
        if cur in seen:
            continue
        seen.add(cur)
        with open(os.path.join(CSRC, cur), "rb") as fh:
            text = fh.read()
        h.update(cur.encode() + b"\0" + text + b"\0")
        todo.extend(
            inc.decode() for inc in _INCLUDE.findall(text)
            if os.path.exists(os.path.join(CSRC, inc.decode()))
        )
    return h.hexdigest()


def library_path(name: str) -> str:
    """Where the library built from ``csrc/<name>`` lives in the cache."""
    stem = os.path.splitext(name)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{_digest(name)[:16]}.so")


def build(names: Iterable[str], verbose: bool = False) -> List[str]:
    """Compile each ``csrc/<name>`` whose library is not cached yet, all at
    once (one ``nvcc`` process per source, started together); returns the
    library paths in order. ``verbose`` adds ``-Xptxas -v`` (registers,
    shared memory, spills) to a fresh build's log (:data:`build_logs`).
    Raises if any build fails."""
    names = list(names)
    paths = [library_path(n) for n in names]
    jobs: List[Tuple[str, str, str, subprocess.Popen, float]] = []
    os.makedirs(BUILD_DIR, exist_ok=True)
    for name, lib in zip(names, paths):
        if os.path.exists(lib):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS,
               *(["-Xptxas", "-v"] if verbose else []),
               "-I", CSRC, "-o", tmp, os.path.join(CSRC, name)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, lib, tmp, proc, time.perf_counter()))
    errors = []
    for name, lib, tmp, proc, t0 in jobs:
        out, _ = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        build_logs[name] = out
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed ({proc.returncode}) building {name}:\n{out}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(
    name: str, bind: Optional[Callable[[ctypes.CDLL], None]] = None
) -> ctypes.CDLL:
    """The library built from ``csrc/<name>``, built on first use and loaded
    once per process; ``bind`` sets its functions' ``argtypes`` and
    ``restype`` when it is first loaded."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[0])
            if bind is not None:
                bind(lib)
            _libs[name] = lib
    return lib


def count_launch(wrapper: Callable[..., object]) -> None:
    """Add one to a kernel wrapper's ``launches`` counter. Under a lock:
    the planning daemon's request threads launch kernels concurrently,
    and ``wrapper.launches += 1`` is a read-modify-write. A thread inside
    :func:`launch_tally` also counts the launch in its tally, by the
    wrapper's name."""
    with _count_lock:
        wrapper.launches += 1  # type: ignore[attr-defined]
    tally = getattr(_tally, "counts", None)
    if tally is not None:
        name = wrapper.__name__
        tally[name] = tally.get(name, 0) + 1


@contextlib.contextmanager
def launch_tally(counts: Dict[str, int]) -> Iterator[Dict[str, int]]:
    """Count into ``counts`` (wrapper name -> launches) the kernel
    launches the calling thread makes while the block runs — the daemon
    attributes its speculative and watch runs' launches this way."""
    prev = getattr(_tally, "counts", None)
    _tally.counts = counts
    try:
        yield counts
    finally:
        _tally.counts = prev
