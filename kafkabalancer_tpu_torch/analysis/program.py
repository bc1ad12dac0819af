"""Whole-program analysis core for the contract passes (R6–R9).

The per-file linter (rules R1–R5) sees one ``ModuleContext`` at a time;
the contract passes reason about the *program*: which module-level
import reaches which module, which function calls which, which locks
nest inside which. ``Program`` builds those graphs once — every
contract rule (``rules/r6_*.py`` … ``r9_*.py``) is a pure consumer.

Scope and honesty: the graphs are best-effort static approximations.

- The **import graph** is exact for module-level ``import`` /
  ``from … import`` statements (including ``try:`` / ``if:`` bodies and
  class bodies, which execute at import time) and deliberately EXCLUDES
  function-local imports — the lazy-import idiom is the sanctioned way
  to keep a heavy dependency off a pure path. ``if TYPE_CHECKING:``
  blocks never execute and are excluded. PEP-562 lazy re-exports are
  modeled: a package ``__init__`` whose ``__getattr__`` maps attribute
  names to deferred submodule imports contributes an edge only when
  another module does a module-level ``from package import <lazy name>``
  (or a star import, which reads ``__all__`` and triggers every lazy
  export) — exactly when the deferred import fires at import time.
- The **call graph** resolves ``self.m()``, methods through
  constructor-assigned and annotation-declared attribute/parameter
  types (``self.sessions = SessionStore(...)`` types ``self.sessions``),
  imported module functions, and dotted external names
  (``torch.cuda.device_count``). Unresolvable receivers contribute no edge —
  under-approximation, never a false edge.
  ``threading.Thread(target=f)`` is NOT a call edge: ``f`` runs on the
  new thread, whose role comes from its own ``# thread-role:``
  annotation.
- **Lock sites** are ``with <lock>:`` statements whose context
  expression resolves to a lock-named attribute (``self._lock``,
  ``sess.lock``, ``self._cv`` …) of a class the type analysis knows.
  Lexical nesting and calls made while holding a lock produce the
  ordering edges R7 consumes.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from kafkabalancer_tpu_torch.analysis.context import (
    Finding,
    ModuleContext,
    parse_module,
)

_ROLE_RE = re.compile(r"#\s*thread-role:\s*([A-Za-z][A-Za-z-]*)")

_LOCK_ATTRS = ("cv", "_cv", "cond", "_cond", "condition", "_condition")


@dataclass(frozen=True)
class ImportEdge:
    """One module-level import: ``src`` imports ``dest`` at ``line``.

    ``dest`` is an internal module name or ``ext:<top>`` for a
    third-party top-level module; ``line`` 0 marks the implicit edge to
    an ancestor package ``__init__`` (always executed first)."""

    src: str
    dest: str
    line: int


@dataclass(frozen=True)
class LockSite:
    lock: str  # "pkg.mod.Class.attr"
    line: int


@dataclass
class FuncInfo:
    key: str  # "pkg.mod.func" / "pkg.mod.Class.meth" / nested "a.b.inner"
    module: str
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    cls: Optional[str]  # enclosing class key, if a method (or nested in one)
    lineno: int
    role: Optional[str] = None
    role_line: int = 0
    # (callee key, line) — callee key may name a method the index never
    # saw (``Class.attr`` fallback); graph walks guard on membership
    internal_calls: List[Tuple[str, int]] = field(default_factory=list)
    external_calls: List[Tuple[str, int]] = field(default_factory=list)
    lock_sites: List[LockSite] = field(default_factory=list)
    # (held lock, inner lock, line) — lexical ``with A: … with B:``
    lock_nest: List[Tuple[str, str, int]] = field(default_factory=list)
    # (held lock, internal callee key, line) — call made under the lock
    calls_under_lock: List[Tuple[str, str, int]] = field(default_factory=list)


@dataclass
class ClassInfo:
    key: str  # "pkg.mod.Class"
    module: str
    node: ast.ClassDef
    methods: Dict[str, str] = field(default_factory=dict)  # name -> func key
    attr_types: Dict[str, str] = field(default_factory=dict)  # attr -> class key
    bases: List[str] = field(default_factory=list)  # internal class keys
    reentrant_locks: Set[str] = field(default_factory=set)  # RLock attr names


@dataclass
class ModuleInfo:
    name: str
    path: str  # posix, relative to the program root
    ctx: ModuleContext
    is_package: bool
    # PEP-562: lazily exported attribute name -> deferred source modules
    lazy_exports: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    import_edges: List[ImportEdge] = field(default_factory=list)
    role_comments: Dict[int, str] = field(default_factory=dict)


class Program:
    """The parsed package plus its import/call/lock graphs."""

    def __init__(
        self,
        root: str,
        package: str,
        extra_files: Sequence[str] = (),
    ) -> None:
        self.root = root
        self.package = package
        self.modules: Dict[str, ModuleInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}
        self.functions: Dict[str, FuncInfo] = {}
        self.errors: List[Finding] = []
        self._load(extra_files)
        for info in self.modules.values():
            self._collect_roles(info)
            self._collect_lazy_exports(info)
        for info in self.modules.values():
            info.import_edges = list(self._module_edges(info))
        for info in self.modules.values():
            self._index_defs(info)
        for ci in self.classes.values():
            self._type_class(ci)
        for fi in self.functions.values():
            self._analyze_body(fi)

    # ---- loading --------------------------------------------------------

    def _load(self, extra_files: Sequence[str]) -> None:
        rootp = Path(self.root)
        pkg_dir = rootp / self.package.replace(".", "/")
        files = sorted(pkg_dir.rglob("*.py")) if pkg_dir.is_dir() else []
        for fp in files:
            if "__pycache__" in fp.parts:
                continue
            rel = fp.relative_to(rootp).as_posix()
            parts = list(fp.relative_to(rootp).parts)
            if parts[-1] == "__init__.py":
                name = ".".join(parts[:-1])
                is_pkg = True
            else:
                name = ".".join(parts)[: -len(".py")]
                is_pkg = False
            self._add_module(name, rel, fp, is_pkg)
        for extra in extra_files:
            fp = rootp / extra
            if fp.is_file():
                name = Path(extra).stem
                self._add_module(name, Path(extra).as_posix(), fp, False)

    def _add_module(
        self, name: str, rel: str, fp: Path, is_pkg: bool
    ) -> None:
        source = fp.read_text(encoding="utf-8")
        ctx = parse_module(source, rel)
        if isinstance(ctx, Finding):
            self.errors.append(ctx)
            return
        self.modules[name] = ModuleInfo(name, rel, ctx, is_pkg)

    # ---- module helpers -------------------------------------------------

    def is_internal(self, name: str) -> bool:
        return name == self.package or name.startswith(self.package + ".")

    def _ancestors(self, name: str) -> List[str]:
        """Package ancestors of ``name`` (excluding itself) that exist."""
        out: List[str] = []
        parts = name.split(".")
        for i in range(1, len(parts)):
            anc = ".".join(parts[:i])
            if anc in self.modules:
                out.append(anc)
        return out

    def _collect_roles(self, info: ModuleInfo) -> None:
        try:
            tokens = tokenize.generate_tokens(
                io.StringIO(info.ctx.source).readline
            )
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _ROLE_RE.search(tok.string)
                if m:
                    info.role_comments[tok.start[0]] = m.group(1)
        except (tokenize.TokenError, IndentationError, SyntaxError):
            pass

    def _collect_lazy_exports(self, info: ModuleInfo) -> None:
        """Parse a package ``__getattr__`` for the PEP-562 idiom:
        ``if name in ("A", "B"): from pkg import mod; return …`` maps
        A/B to the modules imported inside that branch."""
        if not info.is_package:
            return
        getattr_def = None
        for st in info.ctx.tree.body:
            if isinstance(st, ast.FunctionDef) and st.name == "__getattr__":
                getattr_def = st
                break
        if getattr_def is None:
            return
        for branch in ast.walk(getattr_def):
            if not isinstance(branch, ast.If):
                continue
            names = self._lazy_branch_names(branch.test)
            if not names:
                continue
            targets: List[str] = []
            for sub in ast.walk(branch):
                if isinstance(sub, ast.Import):
                    for a in sub.names:
                        if self.is_internal(a.name):
                            targets.append(a.name)
                elif isinstance(sub, ast.ImportFrom):
                    base = self._resolve_from_base(info, sub)
                    if base and self.is_internal(base):
                        for a in sub.names:
                            cand = f"{base}.{a.name}"
                            targets.append(
                                cand if cand in self.modules else base
                            )
            if targets:
                for n in names:
                    info.lazy_exports[n] = tuple(dict.fromkeys(targets))

    @staticmethod
    def _lazy_branch_names(test: ast.AST) -> List[str]:
        # ``name in ("A", "B")`` / ``name == "A"``
        if isinstance(test, ast.Compare) and len(test.ops) == 1:
            op, right = test.ops[0], test.comparators[0]
            if isinstance(op, ast.In) and isinstance(
                right, (ast.Tuple, ast.List, ast.Set)
            ):
                return [
                    e.value
                    for e in right.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)
                ]
            if isinstance(op, ast.Eq) and isinstance(right, ast.Constant):
                if isinstance(right.value, str):
                    return [right.value]
        return []

    # ---- import graph ---------------------------------------------------

    @staticmethod
    def _is_type_checking(ctx: ModuleContext, test: ast.AST) -> bool:
        if isinstance(test, ast.Name) and test.id == "TYPE_CHECKING":
            return True
        return ctx.resolve(test) == "typing.TYPE_CHECKING"

    def _import_time_imports(
        self, info: ModuleInfo
    ) -> Iterator[ast.stmt]:
        """Import statements that execute when the module is imported —
        everything except function bodies and ``if TYPE_CHECKING:``."""

        def walk(stmts: Sequence[ast.stmt]) -> Iterator[ast.stmt]:
            for st in stmts:
                if isinstance(st, (ast.Import, ast.ImportFrom)):
                    yield st
                elif isinstance(st, ast.If):
                    if not self._is_type_checking(info.ctx, st.test):
                        yield from walk(st.body)
                    yield from walk(st.orelse)
                elif isinstance(st, ast.Try):
                    yield from walk(st.body)
                    for h in st.handlers:
                        yield from walk(h.body)
                    yield from walk(st.orelse)
                    yield from walk(st.finalbody)
                elif isinstance(st, (ast.With, ast.For, ast.While)):
                    yield from walk(st.body)
                    yield from walk(getattr(st, "orelse", []) or [])
                elif isinstance(st, ast.ClassDef):
                    yield from walk(st.body)

        yield from walk(info.ctx.tree.body)

    def _resolve_from_base(
        self, info: ModuleInfo, node: ast.ImportFrom
    ) -> Optional[str]:
        if not node.level:
            return node.module
        pkg = info.name if info.is_package else info.name.rpartition(".")[0]
        for _ in range(node.level - 1):
            pkg = pkg.rpartition(".")[0]
        if not pkg:
            return node.module
        return f"{pkg}.{node.module}" if node.module else pkg

    def _edges_to(
        self, info: ModuleInfo, dotted: str, line: int
    ) -> Iterator[ImportEdge]:
        if self.is_internal(dotted):
            for anc in self._ancestors(dotted):
                yield ImportEdge(info.name, anc, line)
            if dotted in self.modules:
                yield ImportEdge(info.name, dotted, line)
        else:
            yield ImportEdge(
                info.name, "ext:" + dotted.split(".", 1)[0], line
            )

    def _module_edges(self, info: ModuleInfo) -> Iterator[ImportEdge]:
        # the ancestor packages' __init__ always run first
        for anc in self._ancestors(info.name):
            yield ImportEdge(info.name, anc, 0)
        for node in self._import_time_imports(info):
            if isinstance(node, ast.Import):
                for a in node.names:
                    yield from self._edges_to(info, a.name, node.lineno)
                continue
            assert isinstance(node, ast.ImportFrom)
            base = self._resolve_from_base(info, node)
            if base is None:
                continue
            yield from self._edges_to(info, base, node.lineno)
            if not self.is_internal(base):
                continue
            base_info = self.modules.get(base)
            for a in node.names:
                if a.name == "*":
                    # a star import reads __all__, triggering EVERY
                    # PEP-562 lazy export of the target package
                    if base_info:
                        for targets in base_info.lazy_exports.values():
                            for t in targets:
                                yield from self._edges_to(
                                    info, t, node.lineno
                                )
                    continue
                cand = f"{base}.{a.name}"
                if cand in self.modules:
                    yield ImportEdge(info.name, cand, node.lineno)
                elif base_info and a.name in base_info.lazy_exports:
                    for t in base_info.lazy_exports[a.name]:
                        yield from self._edges_to(info, t, node.lineno)

    def import_closure(
        self, start: str
    ) -> Dict[str, Tuple[ImportEdge, ...]]:
        """Every module (and ``ext:*`` node) transitively imported at
        module level from ``start``, with one witness chain each."""
        chains: Dict[str, Tuple[ImportEdge, ...]] = {start: ()}
        queue = [start]
        while queue:
            cur = queue.pop(0)
            info = self.modules.get(cur)
            if info is None:
                continue
            for e in info.import_edges:
                if e.dest not in chains:
                    chains[e.dest] = chains[cur] + (e,)
                    if not e.dest.startswith("ext:"):
                        queue.append(e.dest)
        return chains

    # ---- definition index -----------------------------------------------

    def _role_for(
        self, info: ModuleInfo, node: ast.AST
    ) -> Tuple[Optional[str], int]:
        """A ``# thread-role:`` comment on the ``def`` line, any
        decorator line, the line above the construct, or the first body
        line annotates the function."""
        start = min(
            [node.lineno]
            + [d.lineno for d in getattr(node, "decorator_list", [])]
        )
        body = getattr(node, "body", [])
        stop = body[0].lineno if body else node.lineno + 1
        for line in range(start - 1, stop + 1):
            role = info.role_comments.get(line)
            if role is not None:
                return role, line
        return None, 0

    def _index_defs(self, info: ModuleInfo) -> None:
        def handle(
            stmts: Sequence[ast.stmt], prefix: str, cls_key: Optional[str]
        ) -> None:
            for st in stmts:
                if isinstance(
                    st, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    qual = prefix + st.name
                    key = f"{info.name}.{qual}"
                    fi = FuncInfo(
                        key=key,
                        module=info.name,
                        node=st,
                        cls=cls_key,
                        lineno=st.lineno,
                    )
                    fi.role, fi.role_line = self._role_for(info, st)
                    self.functions[key] = fi
                    if cls_key is not None:
                        ci = self.classes.get(cls_key)
                        if ci is not None and prefix.endswith(
                            ci.node.name + "."
                        ):
                            ci.methods[st.name] = key
                    # nested defs keep the enclosing class (closures
                    # capture ``self``)
                    handle(st.body, qual + ".", cls_key)
                elif isinstance(st, ast.ClassDef):
                    ckey = f"{info.name}.{prefix}{st.name}"
                    self.classes[ckey] = ClassInfo(
                        key=ckey, module=info.name, node=st
                    )
                    handle(st.body, prefix + st.name + ".", ckey)

        handle(info.ctx.tree.body, "", None)

    def class_key_from_dotted(self, dotted: Optional[str]) -> Optional[str]:
        if dotted and self.is_internal(dotted) and dotted in self.classes:
            return dotted
        return None

    def _resolve_class_expr(
        self, info: ModuleInfo, node: ast.AST
    ) -> Optional[str]:
        """Class key named by an annotation / base / constructor expr."""
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            # string annotation: "SessionStore"
            local = f"{info.name}.{node.value}"
            if local in self.classes:
                return local
            dotted = info.ctx.aliases.get(node.value)
            return self.class_key_from_dotted(dotted)
        if isinstance(node, ast.Name):
            local = f"{info.name}.{node.id}"
            if local in self.classes:
                return local
        if isinstance(node, (ast.Name, ast.Attribute)):
            return self.class_key_from_dotted(info.ctx.resolve(node))
        if isinstance(node, ast.Subscript):
            # Optional[X] / "X | None" style wrappers
            return self._resolve_class_expr(info, node.slice)
        return None

    def _type_class(self, ci: ClassInfo) -> None:
        info = self.modules[ci.module]
        for base in ci.node.bases:
            bk = self._resolve_class_expr(info, base)
            if bk:
                ci.bases.append(bk)
        for st in ast.walk(ci.node):
            if isinstance(st, ast.AnnAssign) and isinstance(
                st.target, ast.Attribute
            ):
                if (
                    isinstance(st.target.value, ast.Name)
                    and st.target.value.id == "self"
                ):
                    t = self._resolve_class_expr(info, st.annotation)
                    if t:
                        ci.attr_types[st.target.attr] = t
            elif isinstance(st, ast.Assign) and len(st.targets) == 1:
                tgt = st.targets[0]
                if (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                    and isinstance(st.value, ast.Call)
                ):
                    resolved = info.ctx.resolve(st.value.func)
                    if resolved in (
                        "threading.RLock",
                        "threading.Condition",
                    ):
                        if resolved == "threading.RLock":
                            ci.reentrant_locks.add(tgt.attr)
                        continue
                    t = self._resolve_class_expr(info, st.value.func)
                    if t:
                        ci.attr_types[tgt.attr] = t

    def lookup_method(self, cls_key: str, name: str) -> Optional[str]:
        seen: Set[str] = set()
        queue = [cls_key]
        while queue:
            ck = queue.pop(0)
            if ck in seen:
                continue
            seen.add(ck)
            ci = self.classes.get(ck)
            if ci is None:
                continue
            if name in ci.methods:
                return ci.methods[name]
            queue.extend(ci.bases)
        return None

    def attr_type(self, cls_key: str, attr: str) -> Optional[str]:
        seen: Set[str] = set()
        queue = [cls_key]
        while queue:
            ck = queue.pop(0)
            if ck in seen:
                continue
            seen.add(ck)
            ci = self.classes.get(ck)
            if ci is None:
                continue
            if attr in ci.attr_types:
                return ci.attr_types[attr]
            queue.extend(ci.bases)
        return None

    # ---- function bodies: calls and locks -------------------------------

    def _local_env(self, fi: FuncInfo, info: ModuleInfo) -> Dict[str, str]:
        env: Dict[str, str] = {}
        args = fi.node.args  # type: ignore[attr-defined]
        for a in (
            list(args.posonlyargs)
            + list(args.args)
            + list(args.kwonlyargs)
        ):
            if a.annotation is not None:
                t = self._resolve_class_expr(info, a.annotation)
                if t:
                    env[a.arg] = t
        for st in ast.walk(fi.node):
            if isinstance(st, ast.Assign) and len(st.targets) == 1:
                tgt = st.targets[0]
                if isinstance(tgt, ast.Name) and isinstance(
                    st.value, ast.Call
                ):
                    t = self._resolve_class_expr(info, st.value.func)
                    if t:
                        env[tgt.id] = t
            elif isinstance(st, ast.AnnAssign) and isinstance(
                st.target, ast.Name
            ):
                t = self._resolve_class_expr(info, st.annotation)
                if t:
                    env[st.target.id] = t
        return env

    def _lock_id(
        self,
        fi: FuncInfo,
        info: ModuleInfo,
        env: Dict[str, str],
        expr: ast.AST,
    ) -> Optional[str]:
        if not isinstance(expr, ast.Attribute):
            return None
        attr = expr.attr
        if not ("lock" in attr.lower() or attr in _LOCK_ATTRS):
            return None
        base = expr.value
        if isinstance(base, ast.Name):
            if base.id == "self" and fi.cls:
                return f"{fi.cls}.{attr}"
            t = env.get(base.id)
            if t:
                return f"{t}.{attr}"
        elif isinstance(base, ast.Attribute):
            if (
                isinstance(base.value, ast.Name)
                and base.value.id == "self"
                and fi.cls
            ):
                t = self.attr_type(fi.cls, base.attr)
                if t:
                    return f"{t}.{attr}"
        return None

    def lock_is_reentrant(self, lock: str) -> bool:
        cls_key, _, attr = lock.rpartition(".")
        ci = self.classes.get(cls_key)
        return bool(ci and attr in ci.reentrant_locks)

    def _resolve_call(
        self, fi: FuncInfo, info: ModuleInfo, env: Dict[str, str], call: ast.Call
    ) -> Tuple[Optional[str], Optional[str]]:
        """-> (internal callee key, external dotted name); at most one
        is non-None."""
        func = call.func
        if isinstance(func, ast.Name):
            nested = f"{fi.key}.{func.id}"
            if nested in self.functions:
                return nested, None
            mod_fn = f"{info.name}.{func.id}"
            if mod_fn in self.functions:
                return mod_fn, None
            local_cls = f"{info.name}.{func.id}"
            if local_cls in self.classes:
                init = self.lookup_method(local_cls, "__init__")
                return (init or f"{local_cls}.__init__"), None
            t = env.get(func.id)
            if t:  # calling an instance: __call__ — rare; skip
                return None, None
            resolved = info.ctx.resolve(func)
            if resolved is None:
                return None, None
            ck = self.class_key_from_dotted(resolved)
            if ck:
                init = self.lookup_method(ck, "__init__")
                return (init or f"{ck}.__init__"), None
            if self.is_internal(resolved):
                return (
                    resolved if resolved in self.functions else None
                ), None
            return None, resolved
        if isinstance(func, ast.Attribute):
            base, attr = func.value, func.attr
            recv: Optional[str] = None
            if isinstance(base, ast.Name):
                if base.id == "self" and fi.cls:
                    recv = fi.cls
                else:
                    recv = env.get(base.id)
            elif isinstance(base, ast.Attribute):
                if (
                    isinstance(base.value, ast.Name)
                    and base.value.id == "self"
                    and fi.cls
                ):
                    recv = self.attr_type(fi.cls, base.attr)
            if recv:
                target = self.lookup_method(recv, attr)
                return (target or f"{recv}.{attr}"), None
            resolved = info.ctx.resolve(func)
            if resolved is None:
                return None, None
            if self.is_internal(resolved):
                if resolved in self.functions:
                    return resolved, None
                ck = self.class_key_from_dotted(
                    resolved.rpartition(".")[0]
                )
                if ck:  # sessions.SessionStore.checkout style
                    target = self.lookup_method(
                        ck, resolved.rpartition(".")[2]
                    )
                    return (target or resolved), None
                return None, None
            return None, resolved
        return None, None

    _THREAD_FACTORIES = ("threading.Thread", "threading.Timer")

    def _analyze_body(self, fi: FuncInfo) -> None:
        info = self.modules[fi.module]
        env = self._local_env(fi, info)

        def visit(node: ast.AST, held: Tuple[str, ...]) -> None:
            if (
                isinstance(
                    node,
                    (
                        ast.FunctionDef,
                        ast.AsyncFunctionDef,
                        ast.Lambda,
                        ast.ClassDef,
                    ),
                )
                and node is not fi.node
            ):
                return  # separate FuncInfo / scope
            if isinstance(node, (ast.With, ast.AsyncWith)):
                acquired: List[str] = []
                for item in node.items:
                    visit(item.context_expr, held)
                    lid = self._lock_id(fi, info, env, item.context_expr)
                    if lid:
                        fi.lock_sites.append(
                            LockSite(lid, item.context_expr.lineno)
                        )
                        for outer in held + tuple(acquired):
                            fi.lock_nest.append(
                                (outer, lid, item.context_expr.lineno)
                            )
                        acquired.append(lid)
                inner = held + tuple(acquired)
                for st in node.body:
                    visit(st, inner)
                return
            if isinstance(node, ast.Call):
                callee, ext = self._resolve_call(fi, info, env, call=node)
                if ext is not None:
                    fi.external_calls.append((ext, node.lineno))
                if (
                    ext in self._THREAD_FACTORIES
                    or callee in self._THREAD_FACTORIES
                ):
                    # target= runs on the NEW thread, not this one:
                    # no call edge through a thread factory
                    for arg in node.args:
                        visit(arg, held)
                    for kw in node.keywords:
                        if kw.arg not in ("target", "function"):
                            visit(kw.value, held)
                    return
                if callee is not None:
                    fi.internal_calls.append((callee, node.lineno))
                    for lock in held:
                        fi.calls_under_lock.append(
                            (lock, callee, node.lineno)
                        )
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for st in fi.node.body:  # type: ignore[attr-defined]
            visit(st, ())

    # ---- call-graph queries ---------------------------------------------

    def transitive_acquires(self, key: str) -> Set[str]:
        """Locks acquired by ``key`` or anything it transitively calls."""
        out: Set[str] = set()
        seen: Set[str] = set()
        queue = [key]
        while queue:
            cur = queue.pop(0)
            if cur in seen:
                continue
            seen.add(cur)
            fi = self.functions.get(cur)
            if fi is None:
                continue
            out.update(s.lock for s in fi.lock_sites)
            queue.extend(c for c, _ in fi.internal_calls)
        return out

    def call_path(self, start: str, target: str) -> List[Tuple[str, int]]:
        """One witness call chain start→…→target as (callee key, line)
        hops; empty if unreachable."""
        parents: Dict[str, Tuple[str, int]] = {start: ("", 0)}
        queue = [start]
        while queue:
            cur = queue.pop(0)
            fi = self.functions.get(cur)
            if fi is None:
                continue
            for callee, line in fi.internal_calls:
                if callee not in parents:
                    parents[callee] = (cur, line)
                    if callee == target:
                        queue = []
                        break
                    queue.append(callee)
        if target not in parents:
            return []
        hops: List[Tuple[str, int]] = []
        cur = target
        while cur != start:
            prev, line = parents[cur]
            hops.append((cur, line))
            cur = prev
        return list(reversed(hops))
