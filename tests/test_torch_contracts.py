"""The port's whole-program contract analyzer (R6–R9 + SUP) held against
the reference's (kafkabalancer_tpu/analysis/) on the CPU.

The pins:

- differential: the reference's fixture trees and manifests (the same
  trees its tests/test_contracts.py builds) go through both packages'
  ``run_contracts``, the port's with each manifest rebuilt from its own
  dataclasses, and give equal findings, rule by rule; so do seeded
  violations in a copy of the reference's whole tree under its own
  default manifest;
- the prefix trap: ``kafkabalancer_tpu`` is a prefix of
  ``kafkabalancer_tpu_torch``, and an import of the port is never an
  import of the reference;
- the shipped port tree is clean under ``default_manifest()``, and
  seeded violations in a copy of it are found: a numpy import on the
  client path, a torch import in a host-pure module, a jax import
  anywhere, an accept-loop thread reaching torch, a builder key drifting
  from the golden, a declared omission emitted again;
- R6's verdict for the client path agrees with a subprocess that imports
  it (neither torch nor numpy loaded).

Pure stdlib under test: the analyzers import neither jax nor torch.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from kafkabalancer_tpu.analysis import contracts as jcontracts
from kafkabalancer_tpu.analysis import manifest as jmanifest
from kafkabalancer_tpu_torch.analysis import contracts as tcontracts
from kafkabalancer_tpu_torch.analysis import manifest as tmanifest
from kafkabalancer_tpu_torch.analysis.rules import CONTRACT_RULES, r6_import_purity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "kafkabalancer_tpu_torch"


def write_tree(root, files):
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return str(root)


def to_port(obj):
    """A reference manifest object rebuilt from the port's dataclasses of
    the same name (nested tuples and dataclasses mapped field by
    field)."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(tmanifest, type(obj).__name__)
        return cls(**{
            f.name: to_port(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        })
    if isinstance(obj, tuple):
        return tuple(to_port(x) for x in obj)
    return obj


def key(f):
    return (f.rule, f.path, f.line, f.col, f.message, f.snippet)


def by_rule(findings):
    out = {}
    for f in findings:
        out.setdefault(f.rule, []).append(key(f))
    return out


def both(root, jm):
    """The reference's and the port's findings on ``root``, by rule."""
    jf = jcontracts.run_contracts(root, jm)
    tf = tcontracts.run_contracts(root, to_port(jm))
    return by_rule(jf), by_rule(tf)


# ------------------------------------- the reference's fixture trees

PEP562_INIT = '''
def __getattr__(name):
    if name in ("heavy", "light"):
        from pkg import _impl
        return getattr(_impl, name)
    raise AttributeError(name)
'''

R7_CLASSES = """
import threading


class A:
    def __init__(self):
        self._lock = threading.Lock()


class B:
    def __init__(self):
        self._lock = threading.Lock()

"""

R7_SELF = """
import threading


class C:
    def __init__(self):
        self._lock = threading.{factory}()


def pair(x: C, y: C):
    with x._lock:
        with y._lock:
            pass
"""

ACCEPT_RULE = dict(
    role="accept-loop", forbidden=("jax.*",),
    why="accept threads must never attach the backend",
)

R9_GOLDEN = dict(
    golden="golden.json",
    keysets=("top_level_keys",),
    builders=(jmanifest.BuilderSpec("pkg/snap.py", "build", var="out"),),
)

R9_SNAP = """
def build():
    out = {}
    out["a"] = 1
    out["b"] = 2
    return out
"""

FLAG_CLI = """
class FlagSet:
    pass


fs = FlagSet()
fs.bool("foo", False, "")
fs.string("bar", "", "")
"""

FLAG_README = """
# tool

### Flags

| flag | meaning |
| ---- | ------- |
| `-foo` | does foo |
| `-baz` | ghost row |

Exit codes
"""


def _purity(name, forbidden, members):
    return jmanifest.PuritySet(name, forbidden, members)


# (files, manifest keyword arguments, the rules expected)
FIXTURES = {
    "r6_chain": (
        {"pkg/__init__.py": "", "pkg/client.py": "from pkg import core\n",
         "pkg/core.py": "import numpy as np\n"},
        dict(purity=(_purity("client", ("numpy",), ("pkg.client",)),)),
        ["R6"],
    ),
    "r6_function_local_import": (
        {"pkg/__init__.py": "", "pkg/client.py": "from pkg import core\n",
         "pkg/core.py": "def load():\n    import numpy\n    return numpy\n"},
        dict(purity=(_purity("client", ("numpy",), ("pkg.client",)),)),
        [],
    ),
    "r6_pep562": (
        {"pkg/__init__.py": PEP562_INIT,
         "pkg/_impl.py": "import numpy\nheavy = light = None\n",
         "pkg/clean.py": "import pkg\n",
         "pkg/client.py": "from pkg import heavy\n"},
        dict(purity=(_purity("clean", ("numpy",), ("pkg.clean",)),
                     _purity("client", ("numpy",), ("pkg.client",)))),
        ["R6"],
    ),
    "r6_star_import": (
        {"pkg/__init__.py": PEP562_INIT,
         "pkg/_impl.py": "import numpy\nheavy = light = None\n",
         "pkg/client.py": "from pkg import *\n"},
        dict(purity=(_purity("c", ("numpy",), ("pkg.client",)),)),
        ["R6"],
    ),
    "r6_unknown_member": (
        {"pkg/__init__.py": ""},
        dict(purity=(_purity("c", ("numpy",), ("pkg.ghost",)),)),
        ["R6"],
    ),
    "r6_suppressed": (
        {"pkg/__init__.py": "",
         "pkg/client.py": "import numpy  # jaxlint: disable=R6 — vendored shim\n"},
        dict(purity=(_purity("c", ("numpy",), ("pkg.client",)),)),
        [],
    ),
    "r7_lexical_cycle": (
        {"pkg/__init__.py": "", "pkg/mod.py": R7_CLASSES + """
def fwd(a: A, b: B):
    with a._lock:
        with b._lock:
            pass


def rev(a: A, b: B):
    with b._lock:
        with a._lock:
            pass
"""},
        {},
        ["R7"],
    ),
    "r7_consistent": (
        {"pkg/__init__.py": "", "pkg/mod.py": R7_CLASSES + """
def one(a: A, b: B):
    with a._lock:
        with b._lock:
            pass


def two(a: A, b: B):
    with a._lock:
        with b._lock:
            pass
"""},
        {},
        [],
    ),
    "r7_interprocedural": (
        {"pkg/__init__.py": "", "pkg/mod.py": R7_CLASSES + """
def fwd(a: A, b: B):
    with a._lock:
        with b._lock:
            pass


def helper(a: A):
    with a._lock:
        pass


def rev(a: A, b: B):
    with b._lock:
        helper(a)
"""},
        {},
        ["R7"],
    ),
    "r7_self_nesting": (
        {"pkg/__init__.py": "", "pkg/mod.py": R7_SELF.format(factory="Lock")},
        {},
        ["R7"],
    ),
    "r7_rlock": (
        {"pkg/__init__.py": "", "pkg/mod.py": R7_SELF.format(factory="RLock")},
        {},
        [],
    ),
    "r8_propagation": (
        {"pkg/__init__.py": "", "pkg/mod.py": """
import jax


# thread-role: accept-loop
def loop():
    helper()


# thread-role: any
def helper():
    attach()


def attach():
    jax.devices()
"""},
        dict(role_rules=(jmanifest.RoleRule(**ACCEPT_RULE),)),
        ["R8"],
    ),
    "r8_boundary": (
        {"pkg/__init__.py": "", "pkg/mod.py": """
import jax


# thread-role: accept-loop
def loop():
    attach()


def attach():
    jax.devices()
"""},
        dict(role_rules=(jmanifest.RoleRule(**ACCEPT_RULE),),
             boundaries=(jmanifest.Boundary("pkg.mod.attach", "latched"),)),
        [],
    ),
    "r8_thread_factory": (
        {"pkg/__init__.py": "", "pkg/mod.py": """
import threading

import jax


# thread-role: accept-loop
def loop():
    t = threading.Thread(target=worker)
    t.start()


def worker():
    jax.devices()
"""},
        dict(role_rules=(jmanifest.RoleRule(**ACCEPT_RULE),)),
        [],
    ),
    "r8_unknown_role": (
        {"pkg/__init__.py": "",
         "pkg/mod.py": "# thread-role: bogus-role\ndef f():\n    pass\n"},
        {},
        ["R8"],
    ),
    "r9_key_missing_from_golden": (
        {"pkg/__init__.py": "", "pkg/snap.py": R9_SNAP,
         "golden.json": json.dumps({"top_level_keys": ["a"]})},
        dict(goldens=(jmanifest.SchemaGolden(**R9_GOLDEN),)),
        ["R9"],
    ),
    "r9_golden_key_not_emitted": (
        {"pkg/__init__.py": "", "pkg/snap.py": R9_SNAP,
         "golden.json": json.dumps({"top_level_keys": ["a", "b", "c"]})},
        dict(goldens=(jmanifest.SchemaGolden(**R9_GOLDEN),)),
        ["R9"],
    ),
    "r9_matching_golden": (
        {"pkg/__init__.py": "", "pkg/snap.py": R9_SNAP,
         "golden.json": json.dumps({"top_level_keys": ["a", "b"]})},
        dict(goldens=(jmanifest.SchemaGolden(**R9_GOLDEN),)),
        [],
    ),
    "r9_version_drift": (
        {"pkg/__init__.py": "", "pkg/ver.py": "VER = 3\n",
         "pkg/mod.py": 'MSG = "kafkabalancer-tpu.stats/2"\n',
         "DOC.md": "emits kafkabalancer-tpu.stats/1 documents\n"},
        dict(versions=(jmanifest.VersionAuthority("stats", "pkg/ver.py",
                                                  "VER"),),
             text_files=("DOC.md",)),
        ["R9"],
    ),
    "r9_flag_table": (
        {"pkg/__init__.py": "", "pkg/cli.py": FLAG_CLI,
         "README.md": FLAG_README},
        dict(flag_table=jmanifest.FlagTableSpec(
            readme="README.md", registrar="pkg/cli.py",
            section_start="### Flags", section_end="Exit codes")),
        ["R9"],
    ),
    "sup_no_reason": (
        {"pkg/__init__.py": "", "pkg/mod.py": "X = 1  # jaxlint: disable=R6\n"},
        {},
        ["SUP"],
    ),
    "sup_unpunctuated": (
        {"pkg/__init__.py": "",
         "pkg/mod.py": "X = 1  # jaxlint: disable=R6 stale import\n"},
        {},
        ["SUP"],
    ),
    "sup_reasoned": (
        {"pkg/__init__.py": "",
         "pkg/mod.py": "X = 1  # jaxlint: disable=R6 — fixture exemption\n"},
        {},
        [],
    ),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_reference_fixture_gives_equal_findings(name, tmp_path):
    files, kw, rules = FIXTURES[name]
    root = write_tree(tmp_path, files)
    jf, tf = both(root, jmanifest.ContractManifest(package="pkg", **kw))
    assert sorted(jf) == rules
    assert tf == jf


# --------------------------- the reference's tree, seeded, both packages


@pytest.fixture(scope="module")
def reference_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("ref") / "tree"
    shutil.copytree(
        os.path.join(REPO, "kafkabalancer_tpu"), root / "kafkabalancer_tpu",
        ignore=shutil.ignore_patterns("__pycache__"),
    )
    shutil.copytree(os.path.join(REPO, "docs"), root / "docs")
    shutil.copytree(os.path.join(REPO, "tests", "data"),
                    root / "tests" / "data")
    shutil.copy(os.path.join(REPO, "bench.py"), root / "bench.py")
    shutil.copy(os.path.join(REPO, "README.md"), root / "README.md")
    return root


REF_SEEDS = {
    "clean": (None, None, []),
    "numpy_in_serve_state": (
        "kafkabalancer_tpu/serve/state.py", "prepend:import numpy\n", ["R6"],
    ),
    "reversed_lock_pair": (
        "kafkabalancer_tpu/obs/zfixture.py",
        "new:from kafkabalancer_tpu.obs.hist import HistFamily, StreamingHist"
        "\n\n\ndef reversed_pair(h: StreamingHist, fam: HistFamily):\n"
        "    with h._lock:\n        with fam._lock:\n            pass\n",
        ["R7"],
    ),
    "accept_loop_attach": (
        "kafkabalancer_tpu/serve/zfixture.py",
        "new:import jax\n\n\n# thread-role: accept-loop\ndef probe():\n"
        "    jax.devices()\n",
        ["R8"],
    ),
    "builder_key_drift": (
        "kafkabalancer_tpu/serve/daemon.py",
        "replace:out: Dict[str, Any] = {"
        "|out: Dict[str, Any] = {\n            \"zz_drift_probe\": 1,",
        ["R9"],
    ),
}


@pytest.mark.parametrize("seed", sorted(REF_SEEDS))
def test_reference_tree_seeded_gives_equal_findings(seed, reference_tree,
                                                    tmp_path):
    root = tmp_path / "tree"
    shutil.copytree(reference_tree, root)
    rel, edit, rules = REF_SEEDS[seed]
    if rel is not None:
        p = root / rel
        how, _, text = edit.partition(":")
        if how == "prepend":
            p.write_text(text + p.read_text())
        elif how == "new":
            p.write_text(text)
        elif how == "keep":
            pass
        else:
            old, _, new = text.partition("|")
            src = p.read_text()
            assert src.count(old) == 1
            p.write_text(src.replace(old, new))
    jf, tf = both(str(root), jmanifest.default_manifest())
    assert sorted(jf) == rules
    assert tf == jf


# ------------------------------------------------------- the prefix trap


PREFIX_FILES = {
    "pkg/__init__.py": "",
    "pkg/port.py": "import kafkabalancer_tpu_torch\n",
    "pkg/port_sub.py": "from kafkabalancer_tpu_torch.models import config\n",
    "pkg/ref.py": "import kafkabalancer_tpu.analysis\n",
}


@pytest.mark.parametrize("module,flagged", [
    ("pkg.port", False), ("pkg.port_sub", False), ("pkg.ref", True),
])
def test_prefix_is_not_an_import_of_the_reference(module, flagged, tmp_path):
    """``kafkabalancer_tpu`` is a prefix of ``kafkabalancer_tpu_torch``:
    R6 matches the first dotted component for equality."""
    root = write_tree(tmp_path, PREFIX_FILES)
    m = tmanifest.ContractManifest(
        package="pkg",
        purity=(tmanifest.PuritySet(
            "port-wide", tmanifest.PORT_FORBIDDEN, (module,)),),
    )
    fs = tcontracts.run_contracts(root, m)
    assert [f.rule for f in fs] == (["R6"] if flagged else [])
    if flagged:
        assert "'kafkabalancer_tpu'" in fs[0].message


def test_prefix_trap_inside_the_port_package(tmp_path):
    """With the port as the analyzed package its own modules are
    internal, and an import of the reference is external and forbidden
    port-wide."""
    root = write_tree(tmp_path, {
        f"{PKG}/__init__.py": "",
        f"{PKG}/a.py": f"from {PKG} import b\n",
        f"{PKG}/b.py": "import kafkabalancer_tpu_torch.c\n",
        f"{PKG}/c.py": "X = 1\n",
        f"{PKG}/d.py": "from kafkabalancer_tpu.models import config\n",
    })
    m = tmanifest.ContractManifest(
        package=PKG,
        purity=(tmanifest.PuritySet(
            "port-wide", tmanifest.PORT_FORBIDDEN, (f"{PKG}.*",)),),
    )
    fs = tcontracts.run_contracts(root, m)
    assert [(f.rule, f.path) for f in fs] == [("R6", f"{PKG}/d.py")]


# ------------------------------------------------- the port's own tree


@pytest.fixture(scope="module")
def port_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("port") / "tree"
    shutil.copytree(os.path.join(REPO, PKG), root / PKG,
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    shutil.copytree(os.path.join(REPO, "tests", "data"),
                    root / "tests" / "data")
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), root / "chip_smoke.py")
    shutil.copy(os.path.join(REPO, "README.md"), root / "README.md")
    return root


def test_shipped_port_tree_is_contract_clean():
    fs = tcontracts.run_contracts(REPO)
    assert fs == [], "\n".join(
        f"{f.path}:{f.line}: [{f.rule}] {f.message}" for f in fs
    )


PORT_SEEDS = {
    "clean": (None, None, []),
    "numpy_on_the_client_path": (
        f"{PKG}/serve/state.py", "prepend:import numpy\n", ["R6"],
    ),
    "torch_in_a_host_pure_module": (
        f"{PKG}/obs/hist.py", "prepend:import torch\n", ["R6"],
    ),
    "jax_in_a_solver": (
        f"{PKG}/solvers/leader.py", "prepend:import jax\n", ["R6"],
    ),
    "the_reference_in_chip_smoke": (
        "chip_smoke.py", "prepend:import kafkabalancer_tpu.models\n", ["R6"],
    ),
    "accept_loop_reaches_torch": (
        f"{PKG}/serve/zfixture.py",
        "new:import torch\n\n\n# thread-role: accept-loop\ndef probe():\n"
        "    torch.cuda.is_available()\n",
        ["R8"],
    ),
    "builder_key_drift": (
        f"{PKG}/serve/daemon.py",
        "replace:out: Dict[str, Any] = {"
        "|out: Dict[str, Any] = {\n            \"zz_drift_probe\": 1,",
        ["R9"],
    ),
    # the tree is unchanged; the manifest declares a key omitted that
    # the daemon emits (PORT_SEED_MANIFESTS)
    "omitted_key_emitted_again": (
        f"{PKG}/serve/daemon.py", "keep:", ["R9"],
    ),
    "unreasoned_device_loop_marker": (
        f"{PKG}/solvers/zfixture.py", "new:def f():  # device-loop:\n"
        "    pass\n", ["SUP"],
    ),
}


def _omit_residency(m):
    """The shipped manifest with the stats doc's ``residency`` key
    declared omitted again."""
    return dataclasses.replace(m, goldens=tuple(
        dataclasses.replace(g, omitted=("residency",))
        if "top_level_keys" in g.keysets and g.golden.endswith(
            "serve_stats_schema_v8.json")
        else g
        for g in m.goldens
    ))


PORT_SEED_MANIFESTS = {"omitted_key_emitted_again": _omit_residency}


@pytest.mark.parametrize("seed", sorted(PORT_SEEDS))
def test_port_tree_seeded_violation_is_found(seed, port_tree, tmp_path):
    root = tmp_path / "tree"
    shutil.copytree(port_tree, root)
    rel, edit, rules = PORT_SEEDS[seed]
    if rel is not None:
        p = root / rel
        how, _, text = edit.partition(":")
        if how == "prepend":
            p.write_text(text + p.read_text())
        elif how == "new":
            p.write_text(text)
        elif how == "keep":
            pass
        else:
            old, _, new = text.partition("|")
            src = p.read_text()
            assert src.count(old) == 1
            p.write_text(src.replace(old, new))
    manifest = None
    if seed in PORT_SEED_MANIFESTS:
        manifest = PORT_SEED_MANIFESTS[seed](tmanifest.default_manifest())
    fs = tcontracts.run_contracts(str(root), manifest=manifest)
    assert sorted({f.rule for f in fs}) == rules, [
        (f.path, f.line, f.message[:160]) for f in fs
    ]
    if rules:
        assert all(f.path == rel for f in fs if f.rule == rules[0])


def test_default_manifest_names_live_modules_and_seams():
    """Every purity member, boundary and builder of the shipped manifest
    exists in the port tree (R6/R9 report drift as ``<manifest>``
    findings; the boundaries are checked here)."""
    from fnmatch import fnmatchcase

    m = tmanifest.default_manifest()
    program = tcontracts.load_program(REPO, m)
    for b in m.boundaries:
        assert any(fnmatchcase(k, b.pattern) for k in program.functions), b
    roles = {fi.role for fi in program.functions.values() if fi.role}
    assert roles <= set(m.roles)
    assert {"accept-loop", "request", "lane-worker"} <= roles
    names = {p.name for p in m.purity}
    assert names == {"client-path", "host-pure", "port-wide"}


def test_client_path_verdict_agrees_with_a_subprocess():
    """R6's static torch/numpy-free verdict for the forwarding client
    agrees with a fresh process importing it."""
    program = tcontracts.load_program(REPO)
    m = tmanifest.default_manifest()
    static_clean = r6_import_purity.verdict(
        program, m, f"{PKG}.serve.client"
    )
    code = (
        "import sys\n"
        f"import {PKG}.cli, {PKG}.serve.client\n"
        "bad = [m for m in sys.modules if m in ('numpy', 'torch', 'jax')\n"
        "       or m.startswith(('torch.', 'jax.', 'kafkabalancer_tpu.'))]\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=120)
    assert static_clean == (proc.returncode == 0), proc.stderr[-2000:]
    assert static_clean


def test_contracts_cli_exits_zero_on_the_port():
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.analysis", "--contracts"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "clean" in proc.stdout


def test_contract_rule_registry_and_list_rules():
    assert sorted(CONTRACT_RULES) == ["R6", "R7", "R8", "R9"]
    out = {}
    for mode in ("lint", "contracts"):
        proc = subprocess.run(
            [sys.executable, "-m", f"{PKG}.analysis", "--list-rules", mode],
            capture_output=True, text=True, cwd=REPO, timeout=120,
        )
        assert proc.returncode == 0
        out[mode] = proc.stdout.split()
    assert out["lint"] == ["R1", "R2", "R3", "R4", "R5"]
    assert out["contracts"] == ["R6", "R7", "R8", "R9", "SUP"]
