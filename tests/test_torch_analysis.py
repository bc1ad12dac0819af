"""The port's device-aware linter (kafkabalancer_tpu_torch/analysis/, R1–R5)
and its machinery, held against the reference's on the CPU.

The pins:

- each rule's torch meaning on fixture sources: a hit, a clean case and a
  suppressed case, and device-loop code found by its ``# device-loop:``
  marker, by lexical nesting and by a same-module call (and not across
  modules, nor into another function's nested defs);
- differential machinery: the same ``Finding`` lists through both
  packages' ``format_json``, ``format_human``, ``write_baseline`` /
  ``load_baseline`` / ``subtract_baseline``, and the same sources through
  both suppression parsers, give equal output;
- the command line: ``python -m kafkabalancer_tpu_torch.analysis
  kafkabalancer_tpu_torch/ chip_smoke.py`` and ``--annotations`` over the
  typed subpackages exit 0 on the shipped tree, the reference's exit
  codes, and importing the analyzer imports neither torch nor numpy.
"""

import json
import os
import subprocess
import sys

import pytest

from kafkabalancer_tpu.analysis import context as jcontext
from kafkabalancer_tpu.analysis import jaxlint as jlint
from kafkabalancer_tpu_torch.analysis import (
    ALL_RULES,
    lint_paths,
    lint_source,
)
from kafkabalancer_tpu_torch.analysis import context as tcontext
from kafkabalancer_tpu_torch.analysis import jaxlint as tlint
from kafkabalancer_tpu_torch.analysis.annotations import check_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "kafkabalancer_tpu_torch"


def rules_of(findings):
    return sorted({f.rule for f in findings})


# ------------------------------------------------- the rules, by fixture
#
# (source, the rules it must report); "" means clean

CASES = {
    # R1: host coercion of a device value in device-loop code
    "r1_int_in_loop": ("""
def step(cnt):  # device-loop: one iteration
    return int(cnt)
""", ["R1"]),
    "r1_item_in_loop": ("""
def step(x):  # device-loop: one iteration
    return x.sum().item()
""", ["R1"]),
    "r1_bool_float_in_loop": ("""
def step(ok, su):  # device-loop: one iteration
    return bool(ok), float(su)
""", ["R1"]),
    "r1_static_shapes_clean": ("""
def step(x, n: int, lam: float):  # device-loop: one iteration
    a = int(x.shape[0]) + int(x.numel()) + int(len(x)) + int(x.size(1))
    return a * int(n) + float(lam) + int(True)
""", []),
    "r1_host_code_clean": ("""
def decode(packed):
    return int(packed[-1]), float(packed[0]), packed.item()
""", []),
    "r1_suppressed": ("""
def step(cnt):  # device-loop: one iteration
    # jaxlint: disable=R1 — the designed read
    return int(cnt)
""", []),
    # R2: ctypes wrappers bind their signature and count their launches
    "r2_bound_and_counted_clean": ("""
import ctypes

from kafkabalancer_tpu_torch.ops import nvcc


def _bind(lib):
    lib.k_launch.argtypes = [ctypes.c_void_p]
    lib.k_launch.restype = ctypes.c_int


def _load():
    return nvcc.load("k.cu", _bind)


def k(x):
    lib = _load()
    err = lib.k_launch(x.data_ptr())
    nvcc.count_launch(k)
    return err
""", []),
    "r2_unbound_entry_point": ("""
import ctypes

from kafkabalancer_tpu_torch.ops import nvcc


def _bind(lib):
    lib.k_launch.argtypes = [ctypes.c_void_p]
    lib.k_launch.restype = ctypes.c_int


def k(x):
    lib = nvcc.load("k.cu", _bind)
    n = lib.k_words(3)
    err = lib.k_launch(x.data_ptr())
    nvcc.count_launch(k)
    return err, n
""", ["R2"]),
    "r2_uncounted_launch": ("""
import ctypes

from kafkabalancer_tpu_torch.ops import nvcc


def _bind(lib):
    lib.k_launch.argtypes = [ctypes.c_void_p]
    lib.k_launch.restype = ctypes.c_int


def _load():
    return nvcc.load("k.cu", _bind)


def k(x):
    lib = _load()
    return lib.k_launch(x.data_ptr())
""", ["R2"]),
    "r2_load_without_bind": ("""
from kafkabalancer_tpu_torch.ops import nvcc


def _load():
    return nvcc.load("k.cu")
""", ["R2"]),
    "r2_torch_compile": ("""
import torch


def f(x):
    return x + 1


g = torch.compile(f)
""", ["R2"]),
    "r2_torch_jit_decorator": ("""
import torch


@torch.jit.script
def f(x):
    return x + 1
""", ["R2"]),
    "r2_suppressed": ("""
import torch

g = torch.compile(abs)  # jaxlint: disable=R2 — a fixture
""", []),
    # R3: host copies and explicit syncs in device-loop code
    "r3_cpu_numpy_tolist": ("""
def step(x):  # device-loop: one iteration
    return x.cpu(), x.numpy(), x.tolist()
""", ["R3"]),
    "r3_synchronize": ("""
import torch


def step(x, stream):  # device-loop: one iteration
    torch.cuda.synchronize()
    stream.synchronize()
    return x
""", ["R3"]),
    "r3_to_cpu": ("""
def step(x):  # device-loop: one iteration
    return x.to("cpu"), x.to(device="cpu")
""", ["R3"]),
    "r3_constant_into_a_tensor": ("""
import torch


def step(mem, ok, i, trash):  # device-loop: one iteration
    mem[torch.where(ok, i, trash)] = False
    mem[i] = 1.0
""", ["R3"]),
    "r3_tensor_into_a_tensor_clean": ("""
import torch


def step(mem, ok, i, trash, v):  # device-loop: one iteration
    mem[torch.where(ok, i, trash)] = v
    mem[i] = ~mem[i]
""", []),
    "r3_to_device_clean": ("""
def step(x, dev):  # device-loop: one iteration
    return x.to(dev), x.to("cuda:0")
""", []),
    "r3_host_code_clean": ("""
import torch


def decode(log):
    torch.cuda.synchronize()
    return log.cpu().numpy().tolist()
""", []),
    "r3_suppressed": ("""
def step(x):  # device-loop: one iteration
    return x.tolist()  # jaxlint: disable=R3 — the designed read
""", []),
    # R4: float dtypes through the policy module
    "r4_torch_attr": ("""
import torch


def f(x):
    return x.to(torch.float64)
""", ["R4"]),
    "r4_torch_aliases": ("""
import torch


def f(x):
    return torch.zeros(3, dtype=torch.double), x.to(torch.half)
""", ["R4"]),
    "r4_numpy_attr_and_string": ("""
import numpy as np


def f(x):
    return np.zeros(3, np.float32), x.astype("float64")
""", ["R4"]),
    "r4_conversion_method": ("""
def f(x):
    return x.double()
""", ["R4"]),
    "r4_from_import": ("""
from torch import float64


def f(x):
    return x.to(float64)
""", ["R4"]),
    "r4_policy_clean": ("""
import numpy as np
import torch

from kafkabalancer_tpu_torch.models.config import (
    HOST_FLOAT_DTYPE,
    default_dtype,
    kernel_dtype,
)


def f(x, flags):
    flags.float("min-unbalance", 0.01, "help")
    a = np.zeros(3, dtype=HOST_FLOAT_DTYPE)
    return a, x.to(default_dtype(x.device)), x.to(kernel_dtype()), x.to(torch.int32)
""", []),
    "r4_suppressed": ("""
import numpy as np

TIERS = (np.float32, np.float64)  # jaxlint: disable=R4 — tier ladder
""", []),
    # R5: data-dependent sizes in device-loop code
    "r5_mask_subscript": ("""
def step(x, m):  # device-loop: one iteration
    return x[x > 0], x[(x > 0) & (x < m)]
""", ["R5"]),
    "r5_nonzero_and_one_arg_where": ("""
import torch


def step(x):  # device-loop: one iteration
    return torch.nonzero(x), x.nonzero(), torch.where(x > 0)
""", ["R5"]),
    "r5_where_clean": ("""
import torch


def step(x):  # device-loop: one iteration
    return torch.where(x > 0, x, torch.zeros_like(x))
""", []),
    "r5_host_mask_clean": ("""
def f(x):
    return x[x > 0]
""", []),
    "r5_suppressed": ("""
import torch


def step(x):  # device-loop: one iteration
    # jaxlint: disable=R5 — the designed read
    return torch.nonzero(x)
""", []),
    # device-loop propagation
    "loop_by_nesting": ("""
def session(x):
    def step():  # device-loop: one iteration
        def inner(y):
            return float(y)
        return inner(x)
    return step()
""", ["R1"]),
    "loop_by_same_module_call": ("""
def helper(y):
    return y.tolist()


def step(x):  # device-loop: one iteration
    return helper(x)
""", ["R3"]),
    "loop_marker_on_line_above": ("""
# device-loop: the wrapper of every iteration
def step(
    x,
):
    return x.item()
""", ["R1"]),
    "loop_not_through_imports": ("""
from elsewhere import helper


def step(x):  # device-loop: one iteration
    return helper(x)
""", []),
    "loop_not_into_other_functions_locals": ("""
def other():
    def helper(y):
        return y.tolist()
    return helper


def step(x):  # device-loop: one iteration
    return helper(x)
""", []),
    "loop_caller_not_marked": ("""
def step(x):  # device-loop: one iteration
    return x + 1


def driver(x):
    while True:
        x = step(x)
        if int(x.sum()) > 3:
            return x.cpu()
""", []),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_rule_fixture(name):
    src, rules = CASES[name]
    assert rules_of(lint_source(src)) == rules


def test_r4_exempts_the_policy_module():
    src = "import torch\nDTYPE = torch.float64\n"
    assert lint_source(src, path=f"{PKG}/models/config.py") == []
    assert rules_of(lint_source(src, path="other.py")) == ["R4"]


def test_device_loop_lines_cover_marked_functions():
    src = (
        "def a():\n"
        "    return 1\n"
        "\n"
        "def b(x):  # device-loop: one iteration\n"
        "    return a()\n"
    )
    ctx = tcontext.parse_module(src, "m.py")
    assert ctx.device_loop_lines() == {1, 2, 4, 5}
    assert ctx.device_loop_marks == {4: "one iteration"}


def test_registry_covers_r1_to_r5():
    assert sorted(ALL_RULES) == ["R1", "R2", "R3", "R4", "R5"]


def test_syntax_error_reported_not_raised(tmp_path):
    p = tmp_path / "broken.py"
    p.write_text("def f(:\n")
    fs = lint_paths([str(p)])
    assert len(fs) == 1 and fs[0].rule == "E0"


# --------------------------------------------- machinery, differentially

FIELDS = [
    ("R1", "a/b.py", 3, 4, "one", "x = int(y)", 0),
    ("R4", "a\\c.py", 10, 0, "two", "", 12),
    ("R4", "a/c.py", 11, 2, "three", "np.float64", 0),
    ("R1", "a/b.py", 3, 4, "one", "x = int(y)", 0),
    ("E0", "broken.py", 1, 7, "syntax error: invalid syntax", "", 0),
]


def findings(mod, rows):
    return [mod.Finding(*r) for r in rows]


@pytest.mark.parametrize("n", [0, 1, 3, 5])
def test_formats_equal_the_reference(n):
    jf, tf = findings(jcontext, FIELDS[:n]), findings(tcontext, FIELDS[:n])
    assert tlint.format_json(tf) == jlint.format_json(jf)
    assert tlint.format_human(tf) == jlint.format_human(jf)


@pytest.mark.parametrize("keep", [0, 2, 5])
def test_baseline_equals_the_reference(keep, tmp_path):
    jp, tp = tmp_path / "j.json", tmp_path / "t.json"
    jlint.write_baseline(findings(jcontext, FIELDS[:keep]), str(jp))
    tlint.write_baseline(findings(tcontext, FIELDS[:keep]), str(tp))
    assert tp.read_text() == jp.read_text()
    jb, tb = jlint.load_baseline(str(jp)), tlint.load_baseline(str(tp))
    assert tb == jb
    jl = jlint.subtract_baseline(findings(jcontext, FIELDS), jb)
    tl = tlint.subtract_baseline(findings(tcontext, FIELDS), tb)
    assert [dataclass_row(f) for f in tl] == [dataclass_row(f) for f in jl]
    # the two packages read each other's baseline files the same way
    assert tlint.load_baseline(str(jp)) == jb


def dataclass_row(f):
    return (f.rule, f.path, f.line, f.col, f.message, f.snippet, f.end_line)


SUPPRESSION_SOURCES = [
    "x = 1  # jaxlint: disable=R2\n",
    "x = 1  # jaxlint: disable=R1,R3 — reason\n",
    "x = 1  # jaxlint: disable=R2 R4\n",
    "x = 1  #jaxlint:disable=all\n",
    "x = 1  # jaxlint: disable=r5 — lower case\n",
    "# jaxlint: skip-file\nx = 1\n",
    '"""# jaxlint: skip-file"""\nHELP = "# jaxlint: disable=all"\n',
    "\n" * 12 + "# jaxlint: skip-file\n",
    "def f():\n    # jaxlint: disable=R3 — above\n    return g()\n",
]


@pytest.mark.parametrize("i", range(len(SUPPRESSION_SOURCES)))
def test_suppression_parser_equals_the_reference(i):
    src = SUPPRESSION_SOURCES[i]
    j = jcontext.parse_module(src, "m.py")
    t = tcontext.parse_module(src, "m.py")
    assert t.suppressions == j.suppressions
    assert t.skip_file == j.skip_file
    for row in FIELDS[:3]:
        for line in range(1, src.count("\n") + 2):
            r = (row[0], "m.py", line, 0, "", "", 0)
            assert t.suppressed(tcontext.Finding(*r)) == j.suppressed(
                jcontext.Finding(*r)
            )


# ------------------------------------------------- the command line


def test_cli_exit_codes(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def step(x):  # device-loop: why\n    return x.item()\n")
    good = tmp_path / "good.py"
    good.write_text("def f(x):\n    return x\n")
    assert tlint.main([str(good)]) == 0
    assert tlint.main([str(bad)]) == 1
    assert tlint.main(["--select", "NOPE", str(bad)]) == 2
    assert tlint.main([]) == 2
    p = tmp_path / "utf.py"
    p.write_bytes(b"\xff\xfe invalid utf8 \xff")
    assert tlint.main([str(p)]) == 2
    assert tlint.main(["--annotations", str(p)]) == 2


def test_json_format_and_baseline_cli(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("def step(x):  # device-loop: why\n    return x.item()\n")
    assert tlint.main(["--format", "json", str(bad)]) == 1
    data = json.loads(capsys.readouterr().out)
    assert data["count"] == 1 and data["findings"][0]["rule"] == "R1"
    base = tmp_path / "base.json"
    assert tlint.main(["--write-baseline", str(base), str(bad)]) == 0
    assert tlint.main(["--baseline", str(base), str(bad)]) == 0


def test_annotation_checker_flags_and_passes(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def f(x):\n    return x\n")
    good = tmp_path / "good.py"
    good.write_text("def f(x: int) -> int:\n    return x\n")
    assert [f.rule for f in check_paths([str(bad)])] == ["ANN"]
    assert check_paths([str(good)]) == []


def run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", f"{PKG}.analysis", *args],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )


def test_the_shipped_port_lints_clean():
    proc = run_cli(f"{PKG}/", "chip_smoke.py")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "jaxlint: clean"


def test_the_typed_subpackages_have_full_annotation_coverage():
    proc = run_cli("--annotations", *(f"{PKG}/{d}" for d in
                                      ("models", "ops", "codecs", "analysis")))
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_designed_reads_are_marked_and_suppressed():
    """The session iteration's two designed reads sit in device-loop code
    and carry their R1 suppression (one read per iteration)."""
    path = os.path.join(REPO, PKG, "solvers", "scan.py")
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    ctx = tcontext.parse_module(src, path)
    lines = ctx.device_loop_lines()
    for text in ("return int(cnt)", "if not bool(accept):"):
        (line,) = [i for i, s in enumerate(ctx.lines, 1) if s.strip() == text]
        assert line in lines
        assert "R1" in ctx.suppressions[line - 1]


def test_importing_the_analyzer_imports_neither_torch_nor_numpy():
    code = (
        "import sys\n"
        f"import {PKG}.analysis, {PKG}.analysis.contracts\n"
        f"import {PKG}.analysis.annotations, {PKG}.analysis.program\n"
        f"from {PKG}.analysis.contracts import run_contracts\n"
        f"from {PKG}.analysis.jaxlint import lint_paths\n"
        f"lint_paths(['{PKG}/solvers/scan.py'])\n"
        "run_contracts('.')\n"
        "bad = [m for m in sys.modules if m in ('torch', 'numpy', 'jax')\n"
        "       or m.startswith(('torch.', 'numpy.', 'jax.',\n"
        "                        'kafkabalancer_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
