"""Rebalance configuration and the dtype policy.

Reference: ``RebalanceConfig`` / ``DefaultRebalanceConfig``
(balancer.go:12-32). CLI flag defaults are sourced from
:func:`default_rebalance_config` so library and CLI defaults cannot drift
(kafkabalancer.go:86-91).

Note: the reference's default ``MinUnbalance`` is 0.01 in code
(balancer.go:29); the reference README's claim of 1e-05 is stale
(SURVEY.md §2.4). ``complete_partition`` is carried in the config for flag
default purposes but — like the reference — is acted on by the CLI main loop,
not by any balancing step (kafkabalancer.go:212-220).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

# fused-session engines (solvers/scan.py plan()); lives here so the CLI
# can validate the flag without importing torch. "auto" and "xla" run the
# torch session with the hand-written scoring kernel; "pallas" runs the
# whole-session kernel (solvers/pallas_session.py) and "pallas-interpret"
# its plain torch version.
ENGINES: Tuple[str, ...] = ("auto", "xla", "pallas", "pallas-interpret")


# --- central dtype policy ------------------------------------------------
#
# Every float-precision decision routes through these accessors. torch is
# imported lazily so the greedy CLI path never pays the torch import.

# Host-side (numpy) float dtype for the oracle-parity arrays: the greedy
# oracle is float64 math, so tensorized weights/consumer counts carry f64
# on the host regardless of the device compute dtype. The string form is
# accepted by every numpy constructor and needs no numpy import here.
HOST_FLOAT_DTYPE = "float64"


def default_dtype(device: Any) -> Any:
    """The session compute dtype when the caller didn't pin one.

    float32 on a CUDA device, where the scoring kernel runs (it takes
    float32 only); float64 on the CPU, the oracle-parity mode that
    mirrors the reference package's x64 test configuration, so a CPU
    session can be compared move for move with it.
    """
    import torch

    return torch.float32 if str(device).startswith("cuda") else torch.float64


def kernel_dtype() -> Any:
    """The scoring kernel's float dtype: float32, by construction."""
    import torch

    return torch.float32


@dataclass
class RebalanceConfig:
    allow_leader_rebalancing: bool = False
    rebalance_leaders: bool = False
    min_replicas_for_rebalancing: int = 2
    min_unbalance: float = 0.01
    complete_partition: bool = True
    brokers: Optional[List[int]] = None

    # --- extensions beyond the reference CLI ---
    solver: str = "greedy"  # greedy | tpu | beam
    beam_width: int = 8  # beam solver: states kept per depth
    beam_depth: int = 4  # beam solver: lookahead moves per search
    beam_siblings: bool = False  # beam: also expand 2nd-best per target
    # same-topic anti-colocation penalty weight (0 = off, reference parity);
    # adds λ·Σ_broker,topic max(0, replicas_of_topic_on_broker − 1) to the
    # objective — the upstream's planned-but-never-built extension
    # (README.md:94-100)
    anti_colocation: float = 0.0


def default_rebalance_config() -> RebalanceConfig:
    """Reference ``DefaultRebalanceConfig()`` (balancer.go:24-32)."""
    return RebalanceConfig(
        allow_leader_rebalancing=False,
        rebalance_leaders=False,
        min_replicas_for_rebalancing=2,
        min_unbalance=0.01,
        complete_partition=True,
        brokers=None,
    )
