"""Build and load the port's CUDA sources (``kafkabalancer_tpu_torch/csrc``).

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, and loaded with
``ctypes``. Libraries are cached in ``kafkabalancer_tpu_torch/_build/``
under a digest of the source, the headers it includes from ``csrc/`` and
the flags, so an edited header rebuilds every source that includes it.
Every check, build and removal of a cache entry holds an exclusive
``flock`` on ``_build/.lock``: processes that need one library at once
build it once, and none sees another's half-written library or seal.

The cache is this package's counterpart of the reference's AOT executable
store (``ops/aot.py``), under the same contract: a bad entry costs one
rebuild, never a wrong plan and never a switch to a plain version. Each
library is sealed when it is built: a ``.sha256`` file beside it holds
the digest of its bytes. A cached library whose bytes do not match its
seal (truncated, corrupt, or unsealed) is removed and built once more
before it is ever opened — opening a truncated library can crash the
process (the loader maps pages past the end of the file) — and a second
failure raises.

Nothing here runs at import: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
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
# cached libraries that did not match their seal and were rebuilt, by
# file name
rebuilds: Dict[str, int] = {}


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


@contextlib.contextmanager
def cache_lock() -> Iterator[None]:
    """Hold the cache's exclusive lock (``flock`` on ``BUILD_DIR/.lock``)
    across processes. Not reentrant: take it once per check-and-build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd = os.open(os.path.join(BUILD_DIR, ".lock"), os.O_RDWR | os.O_CREAT,
                 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)  # releases the lock


def build(names: Iterable[str], verbose: bool = False) -> List[str]:
    """Compile each ``csrc/<name>`` whose library is not cached yet, all at
    once (one ``nvcc`` process per source, started together), under
    :func:`cache_lock`; returns the library paths in order. ``verbose``
    adds ``-Xptxas -v`` (registers, shared memory, spills) to a fresh
    build's log (:data:`build_logs`). Raises if any build fails."""
    with cache_lock():
        return _compile(list(names), verbose)


def _compile(names: List[str], verbose: bool) -> List[str]:
    """:func:`build`'s body; the caller holds :func:`cache_lock`."""
    paths = [library_path(n) for n in names]
    jobs: List[Tuple[str, str, str, subprocess.Popen, float]] = []
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
        seal(tmp, lib)
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def seal(built: str, lib: str) -> None:
    """Write the seal of ``lib`` (``lib + ".sha256"``): the digest of the
    bytes of ``built``, the file about to be renamed into ``lib``. The
    seal goes in first; the caller holds :func:`cache_lock`, so no other
    process reads the pair between the two renames."""
    fd, tmp = tempfile.mkstemp(suffix=".sha256", dir=os.path.dirname(lib))
    with os.fdopen(fd, "w") as fh:
        fh.write(_sha256(built))
    os.replace(tmp, lib + ".sha256")


def intact(lib: str) -> bool:
    """True when ``lib`` exists and its bytes match its seal."""
    try:
        with open(lib + ".sha256") as fh:
            want = fh.read().strip()
        return _sha256(lib) == want
    except OSError:
        return False


def load(
    name: str, bind: Optional[Callable[[ctypes.CDLL], None]] = None
) -> ctypes.CDLL:
    """The library built from ``csrc/<name>``, built on first use and loaded
    once per process; ``bind`` sets its functions' ``argtypes`` and
    ``restype`` when it is first loaded. A cached library that does not
    match its seal is removed and rebuilt once (counted in
    :data:`rebuilds`); a second mismatch, or a library that does not
    load or bind, raises ``RuntimeError`` (the planning paths turn it
    into exit 3). The check, the rebuild and the open hold
    :func:`cache_lock`."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            with cache_lock():
                path = _compile([name], False)[0]
                if not intact(path):
                    for stale in (path, path + ".sha256"):
                        with contextlib.suppress(FileNotFoundError):
                            os.unlink(stale)
                    rebuilds[name] = rebuilds.get(name, 0) + 1
                    path = _compile([name], False)[0]
                    if not intact(path):
                        raise RuntimeError(
                            f"the rebuilt library {path} does not match its "
                            "seal"
                        )
                try:
                    lib = ctypes.CDLL(path)
                    if bind is not None:
                        bind(lib)
                except (OSError, AttributeError) as exc:
                    raise RuntimeError(
                        f"failed loading {path}: {exc}"
                    ) from exc
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
