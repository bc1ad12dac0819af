"""R9 — schema drift: emitted shapes vs their pinned declarations.

Three drifts, each naming both sides:

- **Golden key sets**: the string-literal keys a snapshot builder emits
  (dict literals, ``doc["k"] = …`` subscripts, ``out.append({...})``)
  vs the golden ``tests/data/*_schema_v*.json`` key lists. A key added
  to the builder but not the golden fails here at lint time instead of
  in whichever integration test happens to scrape it; a golden key no
  builder emits any more fails symmetrically, unless the manifest
  declares it ``omitted`` (a departure stated where it is declared; an
  omitted key that a builder emits again fails too).
- **Version strings**: every full ``kafkabalancer-tpu.<family>/<n>``
  literal (docstrings, help text, comments, docs/*.md) vs the declared
  ``*_SCHEMA_VERSION`` authority — the PR-9 "stale serve-stats/1 help
  text" class. Bare historical markers ("since serve-stats/3") without
  the full prefix are deliberately NOT matched.
- **Flag table**: every flag the CLI registers must be named in the
  README Flags section, and every table row's leading flag must be a
  registered flag.
"""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Set, Tuple

from kafkabalancer_tpu_torch.analysis.context import Finding
from kafkabalancer_tpu_torch.analysis.manifest import (
    BuilderSpec,
    ContractManifest,
    SchemaGolden,
)
from kafkabalancer_tpu_torch.analysis.program import Program

RULE_ID = "R9"
TITLE = "emitted schemas must match their golden/declared pins"

_VERSION_RE = re.compile(r"kafkabalancer-tpu\.([a-z][a-z-]*)/(\d+)")
_BACKTICK_RE = re.compile(r"`([^`]+)`")
_FLAG_TOKEN_RE = re.compile(r"(?<![\w\[])-([a-z][a-z0-9-]*)")


def _manifest_finding(message: str) -> Finding:
    return Finding(
        rule=RULE_ID, path="<manifest>", line=0, col=0,
        message=message, snippet="",
    )


# ---- golden key sets ----------------------------------------------------


def builder_keys(
    program: Program, spec: BuilderSpec
) -> Optional[Dict[str, int]]:
    """Top-level string keys ``spec``'s function emits, with a witness
    line each; None when the builder cannot be found."""
    info = next(
        (m for m in program.modules.values() if m.path == spec.path), None
    )
    if info is None:
        return None
    fi = program.functions.get(f"{info.name}.{spec.qualname}")
    if fi is None:
        return None
    keys: Dict[str, int] = {}

    def dict_keys(d: ast.Dict) -> None:
        for k in d.keys:
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                keys.setdefault(k.value, k.lineno)
            # a None key is a **splat — covered by listing the splatted
            # builder in the same golden group

    def visit(node: ast.AST) -> None:
        if (
            isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node is not fi.node
        ):
            return  # nested builders get their own BuilderSpec
        if spec.var is None and isinstance(node, ast.Return):
            if isinstance(node.value, ast.Dict):
                dict_keys(node.value)
        if spec.var is not None:
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt = node.targets[0]
                if (
                    isinstance(tgt, ast.Name)
                    and tgt.id == spec.var
                    and isinstance(node.value, ast.Dict)
                ):
                    dict_keys(node.value)
                elif (
                    isinstance(tgt, ast.Subscript)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == spec.var
                    and isinstance(tgt.slice, ast.Constant)
                    and isinstance(tgt.slice.value, str)
                ):
                    keys.setdefault(tgt.slice.value, tgt.lineno)
            elif isinstance(node, ast.AnnAssign):
                if (
                    isinstance(node.target, ast.Name)
                    and node.target.id == spec.var
                    and isinstance(node.value, ast.Dict)
                ):
                    dict_keys(node.value)
            elif isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ):
                f = node.func
                if (
                    isinstance(f.value, ast.Name)
                    and f.value.id == spec.var
                ):
                    if f.attr in ("update", "append") and node.args:
                        if isinstance(node.args[0], ast.Dict):
                            dict_keys(node.args[0])
                    elif (
                        f.attr == "setdefault"
                        and node.args
                        and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)
                    ):
                        keys.setdefault(
                            node.args[0].value, node.args[0].lineno
                        )
        for child in ast.iter_child_nodes(node):
            visit(child)

    for st in fi.node.body:  # type: ignore[attr-defined]
        visit(st)
    return keys


def _check_golden(
    program: Program, root: str, g: SchemaGolden
) -> Iterator[Finding]:
    gp = Path(root) / g.golden
    if not gp.is_file():
        yield _manifest_finding(
            f"golden file '{g.golden}' not found — the manifest has "
            "drifted from the tree"
        )
        return
    try:
        doc = json.loads(gp.read_text(encoding="utf-8"))
    except ValueError as exc:
        yield _manifest_finding(f"golden '{g.golden}' unreadable: {exc}")
        return
    golden_keys: Set[str] = set()
    for ks in g.keysets:
        vals = doc.get(ks)
        if not isinstance(vals, list):
            yield _manifest_finding(
                f"golden '{g.golden}' has no key list '{ks}'"
            )
            return
        golden_keys.update(vals)

    emitted: Dict[str, Tuple[str, int]] = {}  # key -> (path, line)
    anchor: Optional[Tuple[str, int, str]] = None
    for spec in g.builders:
        keys = builder_keys(program, spec)
        if keys is None:
            yield _manifest_finding(
                f"builder {spec.path}:{spec.qualname} (golden "
                f"'{g.golden}') not found — the manifest has drifted"
            )
            return
        if anchor is None:
            info = next(
                m for m in program.modules.values() if m.path == spec.path
            )
            fi = program.functions[f"{info.name}.{spec.qualname}"]
            anchor = (spec.path, fi.lineno, info.ctx.snippet_at(fi.lineno))
        for k, line in keys.items():
            emitted.setdefault(k, (spec.path, line))

    names = ", ".join(s.qualname for s in g.builders)
    for k in sorted(set(emitted) - golden_keys - set(g.allowed_extra)):
        path, line = emitted[k]
        info = next(
            m for m in program.modules.values() if m.path == path
        )
        yield Finding(
            rule=RULE_ID,
            path=path,
            line=line,
            col=0,
            message=(
                f"builder emits key '{k}' absent from "
                f"{g.golden}:{'+'.join(g.keysets)} — bump the schema "
                "and regenerate the golden, or drop the key"
            ),
            snippet=info.ctx.snippet_at(line),
        )
    for k in sorted(set(g.omitted) & set(emitted)):
        path, line = emitted[k]
        info = next(
            m for m in program.modules.values() if m.path == path
        )
        yield Finding(
            rule=RULE_ID,
            path=path,
            line=line,
            col=0,
            message=(
                f"builder emits key '{k}' that the manifest declares "
                f"omitted from {g.golden} — drop it from the manifest's "
                "omitted keys"
            ),
            snippet=info.ctx.snippet_at(line),
        )
    missing = sorted(golden_keys - set(emitted) - set(g.omitted))
    if missing and anchor is not None:
        path, line, snippet = anchor
        yield Finding(
            rule=RULE_ID,
            path=path,
            line=line,
            col=0,
            message=(
                f"{g.golden}:{'+'.join(g.keysets)} pins key(s) "
                f"{', '.join(repr(m) for m in missing)} that no "
                f"configured builder ({names}) emits any more"
            ),
            snippet=snippet,
            end_line=line,
        )


# ---- version strings ----------------------------------------------------


def _authority_values(
    program: Program, manifest: ContractManifest
) -> Tuple[Dict[str, Tuple[int, str]], List[Finding]]:
    values: Dict[str, Tuple[int, str]] = {}
    problems: List[Finding] = []
    for va in manifest.versions:
        info = next(
            (m for m in program.modules.values() if m.path == va.path),
            None,
        )
        found = None
        if info is not None:
            for st in info.ctx.tree.body:
                if (
                    isinstance(st, ast.Assign)
                    and len(st.targets) == 1
                    and isinstance(st.targets[0], ast.Name)
                    and st.targets[0].id == va.symbol
                    and isinstance(st.value, ast.Constant)
                    and isinstance(st.value.value, int)
                ):
                    found = (st.value.value, f"{va.path}:{st.lineno}")
        if found is None:
            problems.append(
                _manifest_finding(
                    f"version authority {va.path}:{va.symbol} (family "
                    f"'{va.family}') not found — the manifest has "
                    "drifted"
                )
            )
        else:
            values[va.family] = found
    return values, problems


def _scan_lines_for_versions(
    lines: List[str],
    path: str,
    authorities: Dict[str, Tuple[int, str]],
) -> Iterator[Finding]:
    for lineno, text in enumerate(lines, start=1):
        for m in _VERSION_RE.finditer(text):
            family, n = m.group(1), int(m.group(2))
            auth = authorities.get(family)
            if auth is None or n == auth[0]:
                continue
            yield Finding(
                rule=RULE_ID,
                path=path,
                line=lineno,
                col=m.start(),
                message=(
                    f"stale schema version: this says "
                    f"'kafkabalancer-tpu.{family}/{n}' but {auth[1]} "
                    f"declares version {auth[0]}"
                ),
                snippet=text.strip(),
            )


def _check_versions(
    program: Program, root: str, manifest: ContractManifest
) -> Iterator[Finding]:
    authorities, problems = _authority_values(program, manifest)
    yield from problems
    for info in program.modules.values():
        yield from _scan_lines_for_versions(
            info.ctx.lines, info.path, authorities
        )
    rootp = Path(root)
    for entry in manifest.text_files:
        p = rootp / entry
        files = sorted(p.rglob("*.md")) if p.is_dir() else [p]
        for fp in files:
            if not fp.is_file():
                continue
            rel = fp.relative_to(rootp).as_posix()
            lines = fp.read_text(encoding="utf-8").splitlines()
            yield from _scan_lines_for_versions(lines, rel, authorities)


# ---- README flag table --------------------------------------------------


def _registered_flags(
    program: Program, registrar: str
) -> Tuple[Dict[str, int], List[Finding]]:
    info = next(
        (m for m in program.modules.values() if m.path == registrar), None
    )
    if info is None:
        return {}, [
            _manifest_finding(
                f"flag registrar '{registrar}' not found — the "
                "manifest has drifted"
            )
        ]
    # names bound to a FlagSet(...) anywhere in the module
    flagset_vars: Set[str] = set()
    for node in ast.walk(info.ctx.tree):
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Call)
        ):
            resolved = info.ctx.resolve(node.value.func) or ""
            if resolved.endswith("FlagSet") or (
                isinstance(node.value.func, ast.Name)
                and node.value.func.id == "FlagSet"
            ):
                flagset_vars.add(node.targets[0].id)
    flags: Dict[str, int] = {}
    for node in ast.walk(info.ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if (
            isinstance(f, ast.Attribute)
            and f.attr in ("bool", "int", "float", "string")
            and isinstance(f.value, ast.Name)
            and f.value.id in flagset_vars
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            flags.setdefault(node.args[0].value, node.lineno)
    return flags, []


def _check_flag_table(
    program: Program, root: str, manifest: ContractManifest
) -> Iterator[Finding]:
    spec = manifest.flag_table
    if spec is None:
        return
    flags, problems = _registered_flags(program, spec.registrar)
    yield from problems
    if not flags:
        return
    readme = Path(root) / spec.readme
    if not readme.is_file():
        yield _manifest_finding(
            f"flag-table README '{spec.readme}' not found"
        )
        return
    lines = readme.read_text(encoding="utf-8").splitlines()
    start = end = None
    for i, text in enumerate(lines):
        if start is None and spec.section_start in text:
            start = i
        elif start is not None and spec.section_end in text:
            end = i
            break
    if start is None:
        yield _manifest_finding(
            f"section '{spec.section_start}' not found in {spec.readme}"
        )
        return
    section = lines[start : end if end is not None else len(lines)]

    mentioned: Set[str] = set()
    for text in section:
        for span in _BACKTICK_RE.findall(text):
            mentioned.update(_FLAG_TOKEN_RE.findall(span))

    reg_info = next(
        m for m in program.modules.values() if m.path == spec.registrar
    )
    for name in sorted(set(flags) - mentioned - set(spec.exempt)):
        line = flags[name]
        yield Finding(
            rule=RULE_ID,
            path=spec.registrar,
            line=line,
            col=0,
            message=(
                f"flag '-{name}' is registered here but never named in "
                f"{spec.readme} § {spec.section_start.strip('# ')}"
            ),
            snippet=reg_info.ctx.snippet_at(line),
        )
    for offset, text in enumerate(section):
        if not text.startswith("|"):
            continue
        cells = text.split("|")
        if len(cells) < 2:
            continue
        first = cells[1]
        for span in _BACKTICK_RE.findall(first):
            m = _FLAG_TOKEN_RE.match(span)
            if m and m.group(1) not in flags:
                yield Finding(
                    rule=RULE_ID,
                    path=spec.readme,
                    line=start + offset + 1,
                    col=0,
                    message=(
                        f"{spec.readme} documents flag '-{m.group(1)}' "
                        f"but {spec.registrar} registers no such flag"
                    ),
                    snippet=text.strip()[:120],
                )

# ---- entry point --------------------------------------------------------


def check_program(
    program: Program, manifest: ContractManifest
) -> Iterator[Finding]:
    root = program.root
    for g in manifest.goldens:
        yield from _check_golden(program, root, g)
    yield from _check_versions(program, root, manifest)
    yield from _check_flag_table(program, root, manifest)
