"""Cold-invocation startup overlap: the warm thread of a fresh process.

The deployment unit is a stateless CLI process per move (the reference's
README), so a fresh process pays one-time costs a warm one never sees:
the torch import and the CUDA context of its card. The CLI overlaps them
with its own host work (the pipeline head, the repairs and the encode are
still to come once the input has parsed) by running :func:`warm_backend`
on a background thread.

There is no executable to prefetch in this package: the reference's AOT
store (``ops/aot.py``) has no torch counterpart. Its analogue is the nvcc
library cache, and the launch that needs a library loads it through its
wrapper's own loader (``parallel/shard_kernel._load``,
``solvers/pallas_session._load``); the warm thread loads none, so it
needs no copy of the solvers' choice of kernel. A long-lived process
(the daemon's warm body, prewarm) loads both with :func:`load_kernel`.

The thread decides nothing and never raises: whatever it fails at, the
planning path meets again and reports on its own (exit 3). Nothing falls
back to a plain version.

The planning daemon (serve/daemon.py) warms once at startup and then calls
:func:`mark_process_warm`; a warm process starts no warm thread per
request.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from kafkabalancer_tpu_torch import obs
from kafkabalancer_tpu_torch.obs.trace import SpanLike

# the kernel libraries of the package (ops/nvcc.py sources, by stem)
KERNELS = ("shard_score", "pallas_session")


def load_kernel(name: str) -> Any:
    """Build (when the cache has none) and load one kernel library through
    its launch wrapper's own loader."""
    if name == "shard_score":
        from kafkabalancer_tpu_torch.parallel import shard_kernel

        return shard_kernel._load()
    if name == "pallas_session":
        from kafkabalancer_tpu_torch.solvers import pallas_session

        return pallas_session._load()
    raise ValueError(f"unknown kernel {name!r}")


def warm_backend(
    device: Any = None, trace_parent: Optional[SpanLike] = None
) -> None:
    """Background-thread body: import torch and create the CUDA context of
    the resolved device (``device`` None: CUDA, as the planning entry
    points resolve it; a device that is not CUDA needs no context). Never
    raises: a failure here costs the overlap, not the plan.
    ``trace_parent`` links this thread's spans to the CLI span that
    launched it (cross-thread parenting, obs/trace.py)."""
    try:
        obs.metrics.count("coldstart.warm_runs")
        with obs.span("coldstart.warm", parent=trace_parent):
            with obs.span("coldstart.torch_import"):
                import torch
            dev = torch.device("cuda" if device is None else device)
            if dev.type == "cuda":
                with obs.span("coldstart.cuda_context"):
                    torch.zeros(1, device=dev)
                    torch.cuda.synchronize(dev)
    except Exception:
        # no card: the planning path reports its own error
        obs.metrics.count("coldstart.warm_failures")


# Set only by a long-lived serving process (serve/daemon.py) once its
# startup warm completed: a per-request warm thread is then redundant —
# the one-time costs it overlaps are paid already. The stateless CLI
# never sets this: its one invocation is the cold path the overlap is for.
_process_warm = threading.Event()


def mark_process_warm() -> None:
    """Declare this process durably warm (the daemon's warm hook)."""
    _process_warm.set()


def process_warm() -> bool:
    """True in a long-lived process whose startup warm completed."""
    return _process_warm.is_set()
