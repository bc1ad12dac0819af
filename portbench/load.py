"""Closed-loop clients: fresh processes of the port's CLI.

Each client plans one cluster file through the daemon, as an operator's
automation does (``python -m kafkabalancer_tpu_torch <flags>
-input-json -input=<file> -serve-socket=<socket>``), and prints the
reassignment JSON. A round starts one request per client at once and ends
when the last has printed its plan; the next round starts then. The
daemon's admission hold makes the members of a round one fused batch, so
the clients of a round wait for each other in the daemon in any case.

A client writes its plan and its errors to files of the run's directory,
and the thread that started it only waits for it to exit: the load takes
no turn of the interpreter lock from the daemon it shares a process with.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence


class Plan:
    """One client process: its input, exit code, wall time and the files
    that hold its output."""

    def __init__(self, path: str, out_path: str) -> None:
        self.path = path
        self.out_path = out_path
        self.rc: Optional[int] = None
        self.t0 = 0.0
        self.t1 = 0.0

    @property
    def wall_s(self) -> float:
        return self.t1 - self.t0

    @property
    def out_bytes(self) -> int:
        try:
            return os.path.getsize(self.out_path)
        except OSError:
            return 0

    @property
    def stdout(self) -> str:
        return _read(self.out_path)

    @property
    def stderr(self) -> str:
        return _read(self.out_path + ".err")[-4000:]


def _read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


class Round:
    def __init__(self, plans: List[Plan]) -> None:
        self.plans = plans
        self.t0 = min(p.t0 for p in plans)
        self.t1 = max(p.t1 for p in plans)


class Clients:
    """Runs rounds of client processes; ``command`` is the program and its
    leading arguments (the port's CLI module by default)."""

    def __init__(self, flags: Sequence[str], sock: str, cwd: str,
                 env: Dict[str, str],
                 command: Optional[Sequence[str]] = None) -> None:
        self.command = list(command or [sys.executable, "-m",
                                        "kafkabalancer_tpu_torch"])
        self.flags = list(flags)
        self.sock = sock
        self.cwd = cwd
        self.env = env
        self.out_dir = os.path.join(cwd, "plans")
        os.makedirs(self.out_dir, exist_ok=True)
        self._sent = 0
        self._procs: List[subprocess.Popen] = []
        self._lock = threading.Lock()

    def _one(self, plan: Plan) -> None:
        argv = [*self.command, *self.flags, "-input-json",
                f"-input={plan.path}", f"-serve-socket={self.sock}"]
        with open(plan.out_path, "wb") as out, \
                open(plan.out_path + ".err", "wb") as err:
            plan.t0 = time.perf_counter()
            proc = subprocess.Popen(argv, stdout=out, stderr=err,
                                    stdin=subprocess.DEVNULL, cwd=self.cwd,
                                    env=self.env)
            with self._lock:
                self._procs.append(proc)
            plan.rc = proc.wait()
            plan.t1 = time.perf_counter()
        with self._lock:
            self._procs.remove(proc)

    def round(self, paths: Sequence[str]) -> Round:
        plans = []
        for p in paths:
            plans.append(Plan(p, os.path.join(self.out_dir,
                                              f"plan-{self._sent:04d}.json")))
            self._sent += 1
        threads = [threading.Thread(target=self._one, args=(p,),
                                    name=f"portbench-client-{k}")
                   for k, p in enumerate(plans)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return Round(plans)

    def kill(self) -> None:
        """End every client still running and wait for it."""
        with self._lock:
            procs = list(self._procs)
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
        for proc in procs:
            try:
                proc.wait(30)
            except subprocess.TimeoutExpired:
                pass


def client_env(root: str) -> Dict[str, str]:
    """The clients' environment: the benchmark's, with the checkout's root
    on ``PYTHONPATH`` so that ``-m kafkabalancer_tpu_torch`` finds the
    port from any working directory."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH", "")) if p)
    return env
