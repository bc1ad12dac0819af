"""Buffered stderr logging.

Reference: ``logbuf.BufferingWriter`` (logbuf/logbuf.go) — a mutex-guarded,
size- and time-triggered buffered writer with a background flusher. The Go
version flushes on a 100 ms ticker, asynchronously when the buffer passes
half-full (logbuf.go:68-71), and on garbage-collection notifications via
gcnotifier (logbuf.go:121-128) — flushing when the buffer is about to be
collected anyway. The Python rebuild mirrors all three triggers: the GC hook
uses :mod:`gc` callbacks (fires after each collection pass), which is the
CPython analog of Go's AfterGC notification.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import TextIO


class BufferingWriter:
    """Size/time/GC-flushed buffering writer (logbuf/logbuf.go:11-111)."""

    def __init__(
        self, w: TextIO, flush_time: float = 0.1, flush_size: int = 4096
    ):
        self._w = w
        self._flush_time = flush_time
        self._flush_size = flush_size
        self._buf: list = []  # list of strings; joined on flush
        self._buf_len = 0
        self._lock = threading.Lock()
        self._flush_req = False
        self._err = None
        self._closed = threading.Event()

        self._gc_cb = self._on_gc
        gc.callbacks.append(self._gc_cb)

        self._thread = None
        if flush_time > 0:
            self._thread = threading.Thread(
                target=self._run, name="logbuf-flusher", daemon=True
            )
            self._thread.start()

    # -- io.Writer ------------------------------------------------------
    def write(self, s: str) -> int:
        with self._lock:
            if self._err is not None:
                return 0
            if self._buf_len + len(s) >= self._flush_size:
                self._flush_locked(True)
                if self._err is not None:
                    return 0
                if len(s) >= self._flush_size:
                    self._writeall(s)
                    return len(s)
            self._buf.append(s)
            self._buf_len += len(s)
            if not self._flush_req and self._buf_len > self._flush_size // 2:
                # async flush once the buffer passes half-full (logbuf.go:68-71)
                self._flush_req = True
                threading.Thread(
                    target=self.flush, args=(True,), daemon=True
                ).start()
        return len(s)

    def flush(self, reuse_buf: bool = True) -> None:
        with self._lock:
            self._flush_locked(reuse_buf)

    def _flush_locked(self, _reuse_buf: bool) -> None:
        if self._err is not None:
            return
        data = "".join(self._buf)
        self._buf = []
        self._buf_len = 0
        self._flush_req = False
        if data:
            self._writeall(data)

    def _writeall(self, data: str) -> None:
        try:
            self._w.write(data)
            if hasattr(self._w, "flush"):
                try:
                    self._w.flush()
                except Exception:
                    pass
        except Exception as exc:
            self._err = exc

    def close(self) -> None:
        self._closed.set()
        try:
            gc.callbacks.remove(self._gc_cb)
        except ValueError:
            pass
        self.flush(False)

    # -- background triggers --------------------------------------------
    def _run(self) -> None:
        while not self._closed.wait(self._flush_time):
            self.flush(True)

    def _on_gc(self, phase: str, _info: dict) -> None:
        # Flush after each GC pass (gcnotifier analog, logbuf.go:121-128).
        if phase == "stop" and not self._closed.is_set():
            # never block the GC on the writer lock
            if self._lock.acquire(blocking=False):
                try:
                    self._flush_locked(False)
                finally:
                    self._lock.release()


class Logger:
    """Minimal Go-``log``-style logger: ``YYYY/MM/DD HH:MM:SS message``.

    The reference wires the stdlib logger to the buffering writer
    (kafkabalancer.go:73-75); messages gain a trailing newline if absent.
    """

    def __init__(self, w: "BufferingWriter"):
        self._w = w

    def printf(self, msg: str) -> None:
        stamp = time.strftime("%Y/%m/%d %H:%M:%S")
        if not msg.endswith("\n"):
            msg += "\n"
        self._w.write(f"{stamp} {msg}")
