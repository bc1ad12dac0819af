"""Cold start in the port: the warm thread (ops/coldstart.py), the prewarm
subcommand and ``-serve-prewarm`` (prewarm.py), and the nvcc library
cache's rebuild of a bad entry (ops/nvcc.py), on the CPU.

- Exit-1/2/3 error paths and the greedy path never import torch
  (subprocess pins, as tests/test_coldstart.py pins jax for the
  reference).
- ``-fused``, ``-solver=tpu`` and ``-solver=beam`` start exactly one warm
  thread; the greedy path and a process marked warm start none; the
  exit-time join is bounded; the thread never raises.
- ``prewarm -shapes`` parses the reference's grid syntax (the same
  shapes as ``kafkabalancer_tpu.prewarm._parse_shapes``), an invalid grid
  exits 1 as the reference's does, and on the CPU each bucket's torch
  session runs (and, with ``-verify``, equals its plain version).
- A cached library that does not match its seal (unsealed, truncated,
  or a byte changed) is removed and built once more; a second mismatch,
  or a sealed library that does not load, raises RuntimeError. ``build``
  is faked: this machine has no nvcc.
"""

import ctypes
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import pytest
import torch

from kafkabalancer_tpu import prewarm as jprewarm
from kafkabalancer_tpu_torch import cli as tcli
from kafkabalancer_tpu_torch import prewarm as tprewarm
from kafkabalancer_tpu_torch.ops import coldstart, nvcc
from torch_helpers import running_daemon

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "test.json")


@pytest.fixture(autouse=True)
def tracers_off():
    """Either CLI leaves its process-global tracer enabled after a
    ``-stats``, ``-metrics-json`` or ``-trace`` invocation until its next
    invocation resets it; the other test files of this worker expect it
    off, so each test here ends with both reset."""
    yield
    from kafkabalancer_tpu import obs as jobs
    from kafkabalancer_tpu_torch import obs as tobs

    jobs.begin_invocation()
    tobs.begin_invocation()


def run_cli(args, stdin="", **kw):
    out, err = io.StringIO(), io.StringIO()
    rc = tcli.run(io.StringIO(stdin), out, err, ["kafkabalancer"] + args, **kw)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture
def cold_process():
    """A process not marked warm, as a fresh CLI process is; whatever a
    test marks is cleared after it."""
    was = coldstart.process_warm()
    coldstart._process_warm.clear()
    yield
    coldstart._process_warm.clear()
    if was:
        coldstart.mark_process_warm()


# --- error paths and the greedy path never import torch --------------------


def assert_no_torch(args, stdin, want_rc):
    code = (
        "import io, sys\n"
        "from kafkabalancer_tpu_torch.cli import run\n"
        f"rc = run(io.StringIO({stdin!r}), io.StringIO(), io.StringIO(),\n"
        f"         ['kafkabalancer', '-no-daemon'] + {args!r})\n"
        f"assert rc == {want_rc}, f'exit {{rc}} != {want_rc}'\n"
        "bad = [m for m in sys.modules if m == 'torch' or m.startswith('torch.')]\n"
        "assert not bad, f'torch imported: {bad[:3]}'\n"
        "assert 'kafkabalancer_tpu_torch.solvers.scan' not in sys.modules\n"
        "assert 'kafkabalancer_tpu_torch.ops.coldstart' not in sys.modules\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.parametrize(
    "args,stdin,rc",
    [
        (["-input-json", "-solver=tpu", "-input=/nonexistent/x.json"], "", 1),
        (["-input-json", "-fused", "-input=/nonexistent/x.json"], "", 1),
        (["-input-json", "-solver=tpu", "-max-reassign=1"], "::malformed::", 2),
        (["-input-json", "-fused"], "::malformed::", 2),
        (["-input-json", "-solver=tpu", "-max-reassign=-1"], "", 3),
        (["-input-json", "-fused", "-fused-engine=bogus"], "", 3),
        (["-input-json", "-fused-shard"], "", 3),
        (["-input-json", "-solver=beam", "-broker-ids=x", "-stats",
          "-metrics-json=-"], "", 3),
        (["-input-json", f"-input={FIXTURE}", "-max-reassign=3"], "", 0),
        (["-input-json", f"-input={FIXTURE}", "-explain=-",
          "-metrics-json=-", "-stats"], "", 0),
    ],
    ids=["exit1-tpu", "exit1-fused", "exit2-tpu", "exit2-fused",
         "exit3-budget", "exit3-engine", "exit3-shard", "exit3-telemetry",
         "greedy", "greedy-telemetry"],
)
def test_error_exits_and_greedy_never_import_torch(args, stdin, rc):
    assert_no_torch(args, stdin, rc)


# --- the warm thread ---------------------------------------------------------


def count_warm_threads(monkeypatch):
    calls = []
    monkeypatch.setattr(
        coldstart, "warm_backend", lambda **kw: calls.append(kw)
    )
    return calls


@pytest.mark.parametrize(
    "flags",
    [["-fused", "-fused-batch=4"], ["-solver=tpu"], ["-solver=beam"],
     ["-fused", "-fused-shard"]],
    ids=["fused", "tpu", "beam", "shard"],
)
def test_device_paths_start_exactly_one_warm_thread(
    monkeypatch, cold_process, flags,
):
    calls = count_warm_threads(monkeypatch)
    rc, out, err = run_cli(["-input-json", f"-input={FIXTURE}", "-no-daemon"]
                           + flags, device="cpu")
    assert rc == 0, err
    tcli._join_warm(5.0)
    assert len(calls) == 1
    assert calls[0]["device"] == "cpu"


def test_greedy_and_warm_process_start_no_warm_thread(
    monkeypatch, cold_process,
):
    calls = count_warm_threads(monkeypatch)
    rc, _out, err = run_cli(["-input-json", f"-input={FIXTURE}",
                             "-no-daemon"], device="cpu")
    assert rc == 0, err
    coldstart.mark_process_warm()
    rc, _out, err = run_cli(["-input-json", f"-input={FIXTURE}", "-no-daemon",
                             "-fused"], device="cpu")
    assert rc == 0, err
    assert calls == []


def test_warm_thread_spans_on_their_own_track(tmp_path, cold_process):
    tpath = tmp_path / "t.json"
    rc, _out, err = run_cli(["-input-json", f"-input={FIXTURE}", "-no-daemon",
                             "-fused", f"-trace={tpath}"], device="cpu")
    assert rc == 0, err
    with open(tpath) as fh:
        evs = json.load(fh)["traceEvents"]
    xs = {ev["name"]: ev for ev in evs if ev["ph"] == "X"}
    assert xs["coldstart.warm"]["tid"] != xs["plan"]["tid"]
    assert "coldstart.torch_import" in xs
    # a CPU device needs no CUDA context
    assert "coldstart.cuda_context" not in xs


def test_exit_join_is_bounded(monkeypatch):
    stuck = threading.Event()
    t = threading.Thread(target=stuck.wait, daemon=True)
    t.start()
    monkeypatch.setattr(tcli, "_warm_threads", [t])
    t0 = time.perf_counter()
    tcli._join_warm(0.2)
    assert time.perf_counter() - t0 < 2.0
    assert t.is_alive()
    stuck.set()
    t.join(5)
    assert 0 < tcli.WARM_JOIN_S < 120


def test_tracked_warm_threads_drop_when_done(monkeypatch):
    monkeypatch.setattr(tcli, "_warm_threads", [])
    done = threading.Thread(target=lambda: None)
    done.start()
    done.join()
    tcli._track_warm_thread(done)
    live = threading.Event()
    t = threading.Thread(target=live.wait, daemon=True)
    t.start()
    tcli._track_warm_thread(t)
    assert tcli._warm_threads == [t]
    live.set()
    t.join(5)


def test_warm_backend_never_raises():
    from kafkabalancer_tpu_torch import obs

    obs.begin_invocation()
    # no card here: the CUDA context fails inside the thread, quietly
    coldstart.warm_backend(device="cuda")
    counters = obs.REGISTRY.snapshot()["counters"]
    assert counters["coldstart.warm_runs"] == 1
    assert counters["coldstart.warm_failures"] == 1
    coldstart.warm_backend(device="cpu")
    assert obs.REGISTRY.snapshot()["counters"]["coldstart.warm_failures"] == 1


# --- prewarm -------------------------------------------------------------------


@pytest.mark.parametrize(
    "spec",
    ["10000x100", "10000x100,50000x200", " 10000X100 , 20x3,", "1x1"],
)
def test_prewarm_grid_syntax_is_the_reference_s(spec):
    assert tprewarm._parse_shapes(spec) == jprewarm._parse_shapes(spec)


@pytest.mark.parametrize("spec", ["", ",", "abc", "10x", "x10"])
def test_prewarm_invalid_grid_exits_1_as_the_reference(spec, capsys):
    with pytest.raises(ValueError):
        jprewarm._parse_shapes(spec)
    assert tprewarm.run(["-shapes", spec], device="cpu") == 1
    assert "bad -shapes" in capsys.readouterr().err


def test_prewarm_without_a_card_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tprewarm.run(["-shapes", "200x12"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("verify", [False, True])
def test_prewarm_runs_the_torch_session_per_bucket_on_the_cpu(verify, capsys):
    args = ["-shapes", "200x12,120x10", "-batch", "4"]
    assert tprewarm.run(args + (["-verify"] if verify else []),
                        device="cpu") == 0
    out = capsys.readouterr().out
    doc = json.loads(out.strip().splitlines()[-1])
    assert doc["device"] == "cpu" and doc["failed"] == 0
    assert doc["kernels"] == 0  # no kernel library on the CPU
    names = [(k["shape"], k["name"]) for k in doc["keys"]]
    assert names == [("200x12", "session_xla"), ("200x12", "score_window"),
                     ("120x10", "session_xla"), ("120x10", "score_window")]
    assert doc["warmed"] == 4
    assert doc["verified"] == (2 if verify else 0)


def test_warm_store_counts_a_failed_entry_and_never_raises(monkeypatch):
    from kafkabalancer_tpu_torch.solvers import scan

    def broken(*a, **k):
        raise RuntimeError("launch failed: test")

    monkeypatch.setattr(scan, "_run_chunk", broken)
    details = []
    counts = tprewarm.warm_store("200x12", device="cpu", details=details)
    assert counts["failed"] == 1 and counts["warmed"] == 1
    assert details[0]["status"].startswith("failed")


def test_daemon_prewarm_on_its_warm_thread(cold_process):
    with running_daemon(warm=True, prewarm_shapes="200x12") as (sock, d, logs):
        assert d._warm_done.wait(120)
        assert d.prewarm_summary == {
            "kernels": 0, "warmed": 2, "failed": 0, "verified": 0,
        }, logs
        assert coldstart.process_warm()
        assert any("serve: prewarm 200x12" in line for line in logs)
        rc, out, err = run_cli(["-input-json", f"-input={FIXTURE}",
                                f"-serve-socket={sock}"])
        assert rc == 0, err
        assert d._requests == 1
    assert out == run_cli(["-input-json", f"-input={FIXTURE}", "-no-daemon"],
                          device="cpu")[1]


def test_serve_prewarm_flag_reaches_the_daemon(monkeypatch):
    from kafkabalancer_tpu_torch.serve import daemon

    seen = {}

    class Stub:
        def __init__(self, sock, **kw):
            seen.update(kw)

        def serve_forever(self):
            return 0

    monkeypatch.setattr(daemon, "Daemon", Stub)
    rc, _out, err = run_cli(["-serve", "-serve-prewarm=10000x100,20x3",
                             "-serve-socket=/nonexistent/kb.sock"])
    assert rc == 0, err
    assert seen["prewarm_shapes"] == "10000x100,20x3"


# --- the nvcc cache: a bad entry costs one rebuild ---------------------------


@pytest.fixture
def fake_cache(tmp_path, monkeypatch):
    """``nvcc.BUILD_DIR`` in a temporary directory, no library loaded, and
    ``build`` faked: a missing library is "compiled" by copying a shared
    object that loads (the ``_ctypes`` extension) and sealing it as
    ``build`` does — or, when the test says so, by writing garbage
    without a seal. Yields the fake's state (the names it compiled).
    ``build`` and ``load`` keep their own locking around the fake."""
    import _ctypes

    monkeypatch.setattr(nvcc, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(nvcc, "_libs", {})
    monkeypatch.setattr(nvcc, "rebuilds", {})
    os.makedirs(nvcc.BUILD_DIR)
    state = {"compiled": [], "garbage": False}

    def compile_(names, verbose=False):
        paths = [nvcc.library_path(n) for n in names]
        for name, lib in zip(names, paths):
            if os.path.exists(lib):
                continue
            state["compiled"].append(name)
            if state["garbage"]:
                with open(lib, "wb") as fh:
                    fh.write(b"\x7fELF truncated")
            else:
                shutil.copyfile(_ctypes.__file__, lib + ".tmp")
                nvcc.seal(lib + ".tmp", lib)
                os.replace(lib + ".tmp", lib)
        return paths

    monkeypatch.setattr(nvcc, "_compile", compile_)
    yield state


def test_an_unsealed_library_is_rebuilt_once(fake_cache):
    name = "shard_score.cu"
    path = nvcc.library_path(name)
    with open(path, "wb") as fh:
        fh.write(b"\x7fELF\x02\x01\x01")  # a truncated file, never sealed
    lib = nvcc.load(name)
    assert isinstance(lib, ctypes.CDLL)
    assert fake_cache["compiled"] == [name]
    assert nvcc.rebuilds == {name: 1}
    # loaded once per process: a second load neither builds nor reopens
    assert nvcc.load(name) is lib and fake_cache["compiled"] == [name]


@pytest.mark.parametrize("damage", ["truncate", "flip"])
def test_a_damaged_sealed_library_is_rebuilt_once(fake_cache, damage):
    name = "pallas_session.cu"
    path = nvcc.library_path(name)
    fake_cache["compiled"].clear()
    nvcc.build([name])  # a good, sealed entry
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        if damage == "truncate":
            fh.truncate(size // 8)
        else:  # the same size, one byte changed
            fh.seek(size // 2)
            b = fh.read(1)
            fh.seek(size // 2)
            fh.write(bytes([b[0] ^ 0xFF]))
    assert not nvcc.intact(path)
    nvcc.load(name)
    assert fake_cache["compiled"] == [name, name]
    assert nvcc.rebuilds == {name: 1}
    assert nvcc.intact(path) and os.path.getsize(path) == size


def test_a_second_failure_raises(fake_cache):
    name = "shard_score.cu"
    fake_cache["garbage"] = True
    with open(nvcc.library_path(name), "wb") as fh:
        fh.write(b"not a library")
    with pytest.raises(RuntimeError, match="does not match its seal"):
        nvcc.load(name)
    assert fake_cache["compiled"] == [name]
    assert nvcc.rebuilds == {name: 1}
    assert name not in nvcc._libs


def test_a_sealed_library_that_does_not_load_raises(fake_cache):
    """A library whose bytes match their seal but do not load (or lack a
    symbol) is not rebuilt again and again: it raises RuntimeError, which
    the planning paths turn into exit 3."""
    name = "shard_score.cu"
    path = nvcc.library_path(name)
    with open(path + ".tmp", "wb") as fh:
        fh.write(b"sealed garbage")
    nvcc.seal(path + ".tmp", path)
    os.replace(path + ".tmp", path)
    with pytest.raises(RuntimeError, match="failed loading"):
        nvcc.load(name)
    assert nvcc.rebuilds == {} and fake_cache["compiled"] == []
    with pytest.raises(RuntimeError, match="failed loading"):
        nvcc.load("pallas_session.cu", lambda lib: lib.no_such_symbol)


def test_a_good_cached_library_is_not_rebuilt(fake_cache):
    name = "shard_score.cu"
    nvcc.load(name)
    assert fake_cache["compiled"] == [name]
    nvcc._libs.clear()
    nvcc.load(name)  # a fresh process on a filled cache
    assert fake_cache["compiled"] == [name] and nvcc.rebuilds == {}


def test_build_seals_what_it_renames_into_place(tmp_path):
    lib = str(tmp_path / "libx.so")
    built = str(tmp_path / "built.so")
    with open(built, "wb") as fh:
        fh.write(b"bytes of a library")
    nvcc.seal(built, lib)
    os.replace(built, lib)
    assert nvcc.intact(lib)
    os.unlink(lib + ".sha256")
    assert not nvcc.intact(lib)


# a stand-in for nvcc: writes a shared object that loads (the _ctypes
# extension) with random bytes after it, so no two builds are alike, as
# nvcc's are not; logs each build and takes a while, so that processes
# started together all ask for the library before the first is done
FAKE_NVCC = """#!{python}
import os, shutil, sys, time
import _ctypes
out = sys.argv[sys.argv.index("-o") + 1]
with open({log!r}, "a") as fh:
    fh.write(str(os.getpid()) + "\\n")
time.sleep(0.5)
shutil.copyfile(_ctypes.__file__, out)
with open(out, "ab") as fh:
    fh.write(os.urandom(64))
"""

LOADER = (
    "import json, sys\n"
    "from kafkabalancer_tpu_torch.ops import nvcc\n"
    "nvcc.BUILD_DIR = sys.argv[1]\n"
    "nvcc.nvcc_path = lambda: sys.argv[2]\n"
    "nvcc.load('shard_score.cu')\n"
    "print(json.dumps({'rebuilds': nvcc.rebuilds,\n"
    "                  'intact': nvcc.intact(nvcc.library_path('shard_score.cu'))}))\n"
)


@pytest.mark.parametrize("procs", [2, 4])
def test_processes_loading_a_cold_cache_together_build_once(tmp_path, procs):
    """Processes that find no library and build it at once (a daemon's
    warm body beside a fresh CLI) each end up with an intact library:
    the cache lock makes one build and the others find it, so none sees
    another's library under its own seal, none rebuilds and none
    raises."""
    log = str(tmp_path / "builds.log")
    fake = tmp_path / "nvcc"
    fake.write_text(FAKE_NVCC.format(python=sys.executable, log=log))
    fake.chmod(0o755)
    cache = str(tmp_path / "_build")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    running = [
        subprocess.Popen([sys.executable, "-c", LOADER, cache, str(fake)],
                         cwd=ROOT, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
        for _ in range(procs)
    ]
    reports = []
    for proc in running:
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err[-2000:]
        reports.append(json.loads(out))
    assert reports == [{"rebuilds": {}, "intact": True}] * procs
    with open(log) as fh:
        assert len(fh.read().split()) == 1


def test_the_cache_lock_holds_across_processes(tmp_path, monkeypatch):
    """While another process holds the cache lock, ``build`` waits."""
    monkeypatch.setattr(nvcc, "BUILD_DIR", str(tmp_path / "_build"))
    held = tmp_path / "held"
    code = (
        "import sys, time\n"
        "from kafkabalancer_tpu_torch.ops import nvcc\n"
        "nvcc.BUILD_DIR = sys.argv[1]\n"
        "with nvcc.cache_lock():\n"
        "    open(sys.argv[2], 'w').close()\n"
        "    time.sleep(1.0)\n"
    )
    proc = subprocess.Popen([sys.executable, "-c", code, nvcc.BUILD_DIR,
                             str(held)], cwd=ROOT)
    try:
        deadline = time.monotonic() + 60
        while not held.exists():
            assert time.monotonic() < deadline and proc.poll() is None
            time.sleep(0.02)
        t0 = time.perf_counter()
        with nvcc.cache_lock():
            waited = time.perf_counter() - t0
    finally:
        proc.wait(60)
    assert proc.returncode == 0
    assert waited > 0.3
