"""The system under test: the port's planning daemon in a thread of the
benchmark's process, started through the port's own ``-serve`` entry with
the cell's flags, so that its options are those an operator passes."""

from __future__ import annotations

import io
import threading
import time
from typing import Any, Dict, List, Optional


class DaemonThread:
    """``python -m kafkabalancer_tpu_torch -serve ...`` run as
    ``cli.run`` in a thread; its log goes to ``log_path``."""

    def __init__(self, sock: str, flags: List[str], log_path: str,
                 device: Any = None) -> None:
        self.sock = sock
        self.argv = ["kafkabalancer-tpu", "-serve", f"-serve-socket={sock}",
                     "-serve-idle-timeout=0", *flags]
        self.log_path = log_path
        self.device = device
        self.rc: List[int] = []
        self._log = open(log_path, "w")
        self._thread = threading.Thread(
            target=self._body, name="portbench-daemon", daemon=True)

    def _body(self) -> None:
        from kafkabalancer_tpu_torch import cli

        try:
            self.rc.append(cli.run(io.StringIO(), io.StringIO(), self._log,
                                   self.argv, device=self.device))
        except BaseException as exc:  # the waiter reports it
            self._log.write(f"daemon thread raised: {exc!r}\n")
            self.rc.append(-1)
            raise

    def start(self, timeout: float) -> None:
        """Start it and wait until it answers hello and its warm-up
        (kernel load, prewarm) is over."""
        from kafkabalancer_tpu_torch.serve import client

        self._thread.start()
        deadline = time.monotonic() + timeout
        while True:
            if not self._thread.is_alive():
                raise RuntimeError(f"the daemon exited with {self.rc}: "
                                   f"{self.log_tail()}")
            if time.monotonic() > deadline:
                raise RuntimeError("the daemon did not finish warming up "
                                   f"in {timeout:.0f} s: {self.log_tail()}")
            if client.daemon_alive(self.sock) is not None:
                doc = client.fetch_stats(self.sock)
                if doc is not None and not doc.get("warming", True):
                    return
            time.sleep(0.1)

    def stats(self) -> Dict[str, Any]:
        from kafkabalancer_tpu_torch.serve import client

        doc = client.fetch_stats(self.sock, timeout=60.0)
        if doc is None:
            raise RuntimeError("the daemon did not answer a stats scrape")
        return doc

    def stop(self, timeout: float = 120.0) -> Optional[int]:
        """Ask it to exit and wait; its exit code, None if it lives on."""
        from kafkabalancer_tpu_torch.serve import client

        if self._thread.is_alive():
            client.request_shutdown(self.sock)
            self._thread.join(timeout)
        if not self._log.closed:
            self._log.flush()
        if self._thread.is_alive():
            return None
        self._log.close()
        return self.rc[0] if self.rc else None

    def alive(self) -> bool:
        return self._thread.is_alive()

    def log_tail(self, n: int = 2000) -> str:
        try:
            self._log.flush()
            with open(self.log_path) as f:
                return f.read()[-n:]
        except (OSError, ValueError):
            return ""
