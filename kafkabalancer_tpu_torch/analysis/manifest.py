"""The contract manifest: what the whole-program passes (R6–R9) check.

The analyzer is generic; THIS module is the port's declaration — which
modules must stay torch/numpy-free and which may never import jax or
the JAX package (R6), which thread roles exist and what each may never
reach (R8), which snapshot builders are pinned by which golden key sets
and where each schema family's version number lives (R9). Fixture tests
build their own ``ContractManifest`` against a throwaway tree; the
shipped tree is checked against ``default_manifest()``.

Declared members use exact module names or a ``pkg.sub.*`` glob (which
includes ``pkg.sub`` itself). Forbidden/boundary call patterns are
``fnmatch`` globs over dotted names (``torch.*``,
``…SessionStore._*``).

The README's port section (§ The port's static analyzer) describes the
vocabulary; the dataclasses are the reference manifest's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

#: the thread-role vocabulary ``# thread-role:`` comments may use
ROLES: Tuple[str, ...] = (
    "accept-loop",  # the socket accept loop and per-connection threads
    "request",      # serve-req-N per-request handler threads
    "lane-worker",  # per-device lane executor threads
    "warm",         # the startup warm/prewarm thread
    "speculate",    # the speculative plan-ahead worker
    "watch",        # the watch-mode controller thread
    "any",          # thread-agnostic utility (documentation only)
)


@dataclass(frozen=True)
class PuritySet:
    """Modules whose module-level import closure must not reach any of
    the ``forbidden`` top-level third-party modules."""

    name: str
    forbidden: Tuple[str, ...]
    members: Tuple[str, ...]


@dataclass(frozen=True)
class RoleRule:
    """Dotted-name call patterns a thread of ``role`` must never reach
    through the intra-package call graph."""

    role: str
    forbidden: Tuple[str, ...]
    why: str


@dataclass(frozen=True)
class Boundary:
    """A function key pattern role propagation does not descend into —
    a guarded seam whose body is allowed what its callers are not.
    Every boundary carries its justification."""

    pattern: str
    reason: str


@dataclass(frozen=True)
class BuilderSpec:
    """One snapshot-builder function whose emitted key set R9 collects:
    dict literals assigned to ``var`` (plus ``var["k"] = …``,
    ``var.update({...})`` and ``var.append({...})``), or — when ``var``
    is None — every dict literal the function returns."""

    path: str  # module path relative to the analyzed root
    qualname: str  # "Daemon._core_snapshot" / "Daemon._tenants_block.entry"
    var: Optional[str] = None


@dataclass(frozen=True)
class SchemaGolden:
    """One golden pin: the union of the named ``keysets`` in the golden
    JSON must equal the union of keys the ``builders`` emit."""

    golden: str  # path relative to the analyzed root
    keysets: Tuple[str, ...]
    builders: Tuple[BuilderSpec, ...]
    allowed_extra: Tuple[str, ...] = ()
    # golden keys the builders deliberately do not emit — a declared
    # departure, stated where the manifest declares it; a key listed
    # here that a builder emits again is a finding
    omitted: Tuple[str, ...] = ()


@dataclass(frozen=True)
class VersionAuthority:
    """Where a schema family's current version number is declared; every
    full ``kafkabalancer-tpu.<family>/<n>`` literal elsewhere must
    agree with it."""

    family: str  # "serve-stats"
    path: str  # module that declares the constant
    symbol: str  # integer constant name, e.g. "STATS_SCHEMA_VERSION"


@dataclass(frozen=True)
class FlagTableSpec:
    """README flag documentation vs the registered flag set: every flag
    the CLI registers (minus ``exempt``) must be named in the README
    section, and every table row's leading flag must be registered."""

    readme: str
    registrar: str  # module that registers flags on a FlagSet
    section_start: str
    section_end: str
    exempt: Tuple[str, ...] = ()


@dataclass(frozen=True)
class ContractManifest:
    package: str
    extra_files: Tuple[str, ...] = ()
    purity: Tuple[PuritySet, ...] = ()
    roles: Tuple[str, ...] = ROLES
    role_rules: Tuple[RoleRule, ...] = ()
    boundaries: Tuple[Boundary, ...] = ()
    goldens: Tuple[SchemaGolden, ...] = ()
    versions: Tuple[VersionAuthority, ...] = ()
    flag_table: Optional[FlagTableSpec] = None
    text_files: Tuple[str, ...] = ()  # extra docs scanned for version drift


_PKG = "kafkabalancer_tpu_torch"
_D = "kafkabalancer_tpu_torch/serve/daemon.py"

#: what no module of the port imports: the JAX stack and the reference
#: package (matched on the first dotted component, so the port's own
#: ``kafkabalancer_tpu_torch`` never counts as ``kafkabalancer_tpu``)
PORT_FORBIDDEN: Tuple[str, ...] = ("jax", "jaxlib", "kafkabalancer_tpu")


def default_manifest() -> ContractManifest:
    """The shipped port tree's contracts."""
    return ContractManifest(
        package=_PKG,
        extra_files=("chip_smoke.py",),
        purity=(
            # The static twin of tests/test_torch_cli.py's subprocess
            # pins: a forwarded invocation imports cli + serve.client and
            # touches neither torch nor numpy at module level (PERF.md §3:
            # "no torch, no numpy").
            PuritySet(
                name="client-path",
                forbidden=("torch", "numpy") + PORT_FORBIDDEN,
                members=(
                    _PKG,
                    f"{_PKG}.cli",
                    f"{_PKG}.serve",
                    f"{_PKG}.serve.client",
                    f"{_PKG}.serve.protocol",
                    f"{_PKG}.serve.state",
                ),
            ),
            # Host-side machinery that runs anywhere the repo checks out:
            # observability rendering, the analyzer itself, the flag
            # parser, the codecs, the models (whose dtype policy imports
            # torch inside its accessors), the session store and the warm
            # tier. obs/convergence's numpy stays function-local.
            PuritySet(
                name="host-pure",
                forbidden=("torch", "numpy") + PORT_FORBIDDEN,
                members=(
                    f"{_PKG}.obs.*",
                    f"{_PKG}.analysis.*",
                    f"{_PKG}.utils.flags",
                    f"{_PKG}.codecs.*",
                    f"{_PKG}.models.*",
                    f"{_PKG}.serve.sessions",
                    f"{_PKG}.serve.spill",
                ),
            ),
            # Every module of the port, and chip_smoke.py: no jax, no
            # jaxlib, nothing of the JAX package (only tests import both)
            PuritySet(
                name="port-wide",
                forbidden=PORT_FORBIDDEN,
                members=(f"{_PKG}.*", "chip_smoke"),
            ),
        ),
        role_rules=(
            RoleRule(
                role="accept-loop",
                forbidden=(
                    "torch.*",
                    f"{_PKG}.serve.devmem.*",
                    f"{_PKG}.ops.*",
                    f"{_PKG}.solvers.*",
                ),
                why=(
                    "accept/connection threads answer hello and stats "
                    "instantly; a torch import or CUDA attach on them "
                    "blocks every probe behind device init"
                ),
            ),
            RoleRule(
                role="request",
                # _[!_]* — single-underscore internals (_retire,
                # _spill_locked, _insert), NOT dunders: constructing a
                # store is not the bug class, holding its lock without
                # checkout is.
                forbidden=(f"{_PKG}.serve.sessions.SessionStore._[!_]*",),
                why=(
                    "SessionStore internals assume checkout ownership; "
                    "a request thread reaching them directly bypasses "
                    "the busy/generation protocol"
                ),
            ),
        ),
        boundaries=(
            Boundary(
                pattern=f"{_PKG}.serve.daemon.Daemon._memory_snapshot",
                reason=(
                    "the devmem query inside is latched on _warm_done and "
                    "reads torch.cuda only once CUDA is initialised "
                    "(never blocks on an unattached device)"
                ),
            ),
            Boundary(
                pattern=f"{_PKG}.serve.daemon.Daemon._make_dispatcher",
                reason=(
                    "the warm-off startup attach: serve_forever calls "
                    "it once before the accept loop starts accepting "
                    "(no probe exists yet to block); with -serve-warm "
                    "it runs on the warm thread instead"
                ),
            ),
            Boundary(
                pattern=f"{_PKG}.serve.sessions.SessionStore.[!_]*",
                reason=(
                    "the store's public API IS the checkout protocol — "
                    "internals it calls under its own lock are not a "
                    "caller-side bypass"
                ),
            ),
        ),
        goldens=(
            SchemaGolden(
                golden="tests/data/serve_stats_schema_v8.json",
                keysets=("top_level_keys", "lane_keys"),
                builders=(
                    BuilderSpec(_D, "Daemon._core_snapshot", var="out"),
                    BuilderSpec(_D, "Daemon._stats_doc", var="doc"),
                ),
            ),
            SchemaGolden(
                golden="tests/data/serve_stats_schema_v8.json",
                keysets=("tenants_keys",),
                builders=(
                    BuilderSpec(_D, "Daemon._tenants_block", var=None),
                ),
            ),
            SchemaGolden(
                golden="tests/data/serve_stats_schema_v8.json",
                keysets=("tenant_entry_keys",),
                builders=(
                    BuilderSpec(
                        _D, "Daemon._tenants_block.entry", var=None
                    ),
                ),
            ),
            SchemaGolden(
                golden="tests/data/serve_stats_schema_v8.json",
                keysets=("memory_keys",),
                builders=(
                    BuilderSpec(_D, "Daemon._memory_snapshot", var="out"),
                ),
            ),
            SchemaGolden(
                golden="tests/data/metrics_schema_v1.json",
                keysets=("top_level_keys",),
                builders=(
                    BuilderSpec(
                        f"{_PKG}/obs/export.py",
                        "metrics_payload",
                        var=None,
                    ),
                ),
            ),
        ),
        versions=(
            VersionAuthority(
                "serve-stats",
                f"{_PKG}/serve/protocol.py",
                "STATS_SCHEMA_VERSION",
            ),
            VersionAuthority(
                "metrics",
                f"{_PKG}/obs/metrics.py",
                "SCHEMA_VERSION",
            ),
            VersionAuthority(
                "explain",
                f"{_PKG}/obs/convergence.py",
                "EXPLAIN_SCHEMA_VERSION",
            ),
            VersionAuthority(
                "replay",
                f"{_PKG}/replay/harness.py",
                "REPLAY_SCHEMA_VERSION",
            ),
        ),
        flag_table=FlagTableSpec(
            readme="README.md",
            registrar=f"{_PKG}/cli.py",
            section_start="### Flags",
            section_end="Exit codes",
            exempt=("help", "h"),
        ),
        text_files=("README.md",),
    )
