"""kafkabalancer_tpu_torch.replay — the fleet-churn replay harness.

Counterpart of the reference package's ``replay/``: a deterministic
seeded multi-tenant churn synthesizer (replay/synth.py, a copy of the
reference's) plus a closed-loop harness (replay/harness.py) that plans
every request through this package's REAL forwarding client against a
live daemon of this package, applies each emitted plan back to the
tenant's state, and reconciles client-side counts and tail latencies
against the daemon's per-tenant ``serve-stats/8`` scrape — Clipper's
continuously-measured-p99 methodology as a regression gate.

Entry points:

- ``python -m kafkabalancer_tpu_torch.replay`` — run a seeded replay,
  emitting the ``kafkabalancer-tpu.replay/5`` artifact (the reference's
  schema; ``--chaos``, ``--restart`` and ``--watch`` as there);
- :func:`run_replay` — the library seam.

The harness imports no torch: it is a protocol client plus the
in-process CLI for the ``-no-daemon`` oracles.
"""

from kafkabalancer_tpu_torch.replay.harness import (  # noqa: F401
    REPLAY_SCHEMA,
    REPLAY_SCHEMA_VERSION,
    ReplayConfig,
    ReplayError,
    render_summary,
    run_replay,
)
from kafkabalancer_tpu_torch.replay.synth import (  # noqa: F401
    FleetSynth,
    TenantState,
)
