"""A Go-``flag``-compatible command-line parser.

The reference uses a stdlib ``flag.FlagSet`` named "kafkabalancer" with
``ContinueOnError`` (kafkabalancer.go:77-98). Python's argparse differs in
visible ways (``-input=x`` handling, usage format, error text), so this
module re-implements the Go semantics the reference relies on:

- ``-name``, ``--name``, ``-name=value``, ``-name value`` all accepted;
- boolean flags never consume the next argument (``-b false`` leaves
  ``false`` positional); explicit values need ``-b=false``;
- parsing stops at the first non-flag argument or at ``--``;
- unknown flags produce ``flag provided but not defined: -x`` plus usage;
- ``-h``/``-help``, when not defined, print usage without the "not defined"
  error (Go's ErrHelp);
- ``PrintDefaults``-style usage: flags sorted by name, type word after the
  name (none for booleans), usage on the next line indented with four
  spaces and a tab, non-zero defaults appended as ``(default X)`` with
  strings quoted;
- on error, the error and usage are printed to the output writer and
  parsing stops — like ``ContinueOnError``, the caller may keep going with
  the flags parsed so far (the reference ignores ``Parse``'s return,
  kafkabalancer.go:98).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, TextIO

_GO_INT_RE = re.compile(r"^[+-]?[0-9]+$")
_GO_FLOAT_RE = re.compile(
    r"^[+-]?([0-9]+(\.[0-9]*)?|\.[0-9]+)([eE][+-]?[0-9]+)?$"
    r"|^[+-]?([iI][nN][fF](inity)?|[nN][aA][nN])$"
)


def go_atoi(s: str) -> int:
    """``strconv.Atoi`` semantics: no underscores, no surrounding whitespace."""
    if not _GO_INT_RE.match(s):
        raise ValueError(f"parsing {s!r}: invalid syntax")
    return int(s, 10)


def go_parse_float(s: str) -> float:
    """``strconv.ParseFloat`` semantics (decimal forms; no underscores or
    whitespace, Inf/NaN spellings accepted)."""
    if not _GO_FLOAT_RE.match(s):
        raise ValueError(f"parsing {s!r}: invalid syntax")
    return float(s)


class Flag:
    __slots__ = ("name", "kind", "default", "usage", "value")

    def __init__(self, name: str, kind: str, default: Any, usage: str):
        self.name = name
        self.kind = kind  # bool | int | float | string
        self.default = default
        self.usage = usage
        self.value = default


class FlagParseError(Exception):
    pass


def _parse_go_bool(s: str) -> bool:
    # strconv.ParseBool accepted forms
    if s in ("1", "t", "T", "TRUE", "true", "True"):
        return True
    if s in ("0", "f", "F", "FALSE", "false", "False"):
        return False
    raise ValueError(f"invalid boolean value {s!r}")


def _format_default(fl: Flag) -> str:
    if fl.kind == "string":
        return f'"{fl.default}"'
    if fl.kind == "bool":
        return "true" if fl.default else "false"
    if fl.kind == "float":
        # Go %v on float64 — reuse the JSON formatter's shortest form
        from kafkabalancer_tpu_torch.codecs.writer import format_go_float

        return format_go_float(fl.default)
    return str(fl.default)


class FlagSet:
    def __init__(self, name: str, output: Optional[TextIO] = None):
        self.name = name
        self.output = output
        self.flags: Dict[str, Flag] = {}
        self.args: List[str] = []  # positional remainder after parsing
        # names EXPLICITLY set by parse() — Go's flag.Visit equivalent:
        # "was this flag given?" is distinct from "does its value equal
        # the default?" (an explicit -serve-idle-timeout=900 must not
        # read as unset)
        self.seen: set = set()
        self.usage: Optional[Callable[[], None]] = None

    # --- definition -----------------------------------------------------
    def _add(self, name: str, kind: str, default: Any, usage: str) -> Flag:
        fl = Flag(name, kind, default, usage)
        self.flags[name] = fl
        return fl

    def bool(self, name: str, default: bool, usage: str) -> Flag:
        return self._add(name, "bool", default, usage)

    def int(self, name: str, default: int, usage: str) -> Flag:
        return self._add(name, "int", default, usage)

    def float(self, name: str, default: float, usage: str) -> Flag:
        return self._add(name, "float", default, usage)

    def string(self, name: str, default: str, usage: str) -> Flag:
        return self._add(name, "string", default, usage)

    # --- output ---------------------------------------------------------
    def _print(self, msg: str) -> None:
        if self.output is not None:
            self.output.write(msg)

    def print_defaults(self) -> None:
        for name in sorted(self.flags):
            fl = self.flags[name]
            type_word = "" if fl.kind == "bool" else f" {fl.kind}"
            line = f"  -{name}{type_word}\n    \t{fl.usage}"
            is_zero = (
                (fl.kind == "bool" and fl.default is False)
                or (fl.kind in ("int", "float") and fl.default == 0)
                or (fl.kind == "string" and fl.default == "")
            )
            if not is_zero:
                line += f" (default {_format_default(fl)})"
            self._print(line + "\n")

    def default_usage(self) -> None:
        self._print(f"Usage of {self.name}:\n")
        self.print_defaults()

    def _usage(self) -> None:
        if self.usage is not None:
            self.usage()
        else:
            self.default_usage()

    # --- parsing --------------------------------------------------------
    def parse(self, args: List[str]) -> bool:
        """Parse ``args``; returns False (after printing error + usage) on the
        first failure, mirroring ``ContinueOnError``."""
        self.args = list(args)
        while self.args:
            arg = self.args[0]
            if len(arg) < 2 or arg[0] != "-":
                return True  # first non-flag terminates parsing
            num_minuses = 1
            if arg[1] == "-":
                num_minuses = 2
                if len(arg) == 2:  # "--" terminates
                    self.args = self.args[1:]
                    return True
            name = arg[num_minuses:]
            if not name or name[0] == "-" or name[0] == "=":
                return self._fail(f"bad flag syntax: {arg}")
            self.args = self.args[1:]

            has_value = False
            value = ""
            if "=" in name:
                name, _, value = name.partition("=")
                has_value = True

            fl = self.flags.get(name)
            if fl is None:
                if name in ("help", "h"):  # Go's ErrHelp path
                    self._usage()
                    return False
                return self._fail(f"flag provided but not defined: -{name}")
            self.seen.add(name)

            if fl.kind == "bool":
                if has_value:
                    try:
                        fl.value = _parse_go_bool(value)
                    except ValueError:
                        return self._fail(
                            f'invalid boolean value "{value}" for -{name}: '
                            "parse error"
                        )
                else:
                    fl.value = True
                continue

            if not has_value:
                if not self.args:
                    return self._fail(f"flag needs an argument: -{name}")
                value = self.args[0]
                self.args = self.args[1:]

            try:
                if fl.kind == "int":
                    fl.value = go_atoi(value)
                elif fl.kind == "float":
                    fl.value = go_parse_float(value)
                else:
                    fl.value = value
            except ValueError:
                return self._fail(
                    f'invalid value "{value}" for flag -{name}: parse error'
                )
        return True

    def _fail(self, msg: str) -> bool:
        self._print(msg + "\n")
        self._usage()
        return False
