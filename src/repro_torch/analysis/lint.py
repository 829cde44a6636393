"""The port's lint (twin of repro.analysis.lint, `reprolint`): AST checks of
the hazards this PyTorch/CUDA port actually meets.

    python -m repro_torch.analysis.lint src/repro_torch chip_smoke.py

exits 0 when clean and 1 on violations.  One line is silenced with
`# reprolint: disable=<rule>[,<rule>...]` (or `disable=all`); the port's
own suppressions each give their reason on the line.

Rules:

    implicit-dtype        torch.zeros/ones/full/empty/arange/tensor/rand/randn
                          without dtype=: the port's tests run with a float64
                          default dtype, the card with float32, so the
                          tensor's dtype depends on who calls
    implicit-device       the same factories without device=: kernel routing
                          follows the tensor's device (kernels/_build.py
                          on_cpu), so a CPU tensor on a card path silently
                          runs the plain version
    host-call-in-capture  print/open/time.time/numpy.random or .item()/
                          .cpu()/.tolist()/.numpy() inside a
                          `with torch.cuda.graph(...)` block: the capture
                          records device work only, so a host effect runs
                          once at capture and never at a replay (and a copy
                          to the host breaks the capture)
    mutable-static-field  list/dict/set-typed fields of a frozen dataclass:
                          the specs are hashed and compared as cache keys
    registry-signature    @register_source/_partition/_topology/_codec
                          entries whose signature breaks the registry's
                          positional contract (the port's sources take a
                          dtype after the reference's four)
    foreign-import        jax or the JAX package (repro.*) imported by the
                          port or chip_smoke.py: the card machine has no jax

Two reference rules have no counterpart here.  `traced-branch` caught
Python control flow on traced values inside jit, lax loops and Pallas
kernels; PyTorch runs eagerly, so a Python `if` on a tensor reads its
value (a host sync, not a trace-time error), and the port's kernels are
CUDA C++ that no Python AST reaches.  `literal-carry` caught weak-typed
Python literals in a lax.scan/fori_loop/while_loop carry; the port's loops
are Python loops over tensors whose dtypes PyTorch promotes eagerly, and
there is no carry to type.  Detection is lexical, as in the reference: a
helper called from inside a capture block is not seen as captured.

The configuration is the module constant CONFIG (no pyproject section):
the paths the foreign-import rule holds to.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import os
import re
from typing import Dict, List, Sequence, Set, Tuple

__all__ = ["RULES", "Violation", "LintConfig", "CONFIG", "lint_source",
           "lint_file", "lint_paths"]

RULES: Dict[str, str] = {
    "implicit-dtype": (
        "torch.zeros/ones/full/empty/arange/tensor/rand/randn without "
        "dtype=: the default dtype is the caller's (float64 in the port's "
        "tests, float32 on the card) — pass dtype= explicitly"),
    "implicit-device": (
        "torch.zeros/ones/full/empty/arange/tensor/rand/randn without "
        "device=: kernels route by the tensor's device, so a CPU tensor on "
        "a card path runs the plain version — pass device= explicitly"),
    "host-call-in-capture": (
        "host effect (print, open, time.time, numpy.random, .item(), "
        ".cpu(), .tolist(), .numpy()) inside a `with torch.cuda.graph(...)` "
        "block: it runs once at capture, never at a replay — hoist it out"),
    "mutable-static-field": (
        "list/dict/set-typed field on a frozen dataclass: frozen specs are "
        "hashed as cache keys, and an unhashable field breaks them — use "
        "Tuple[...] instead"),
    "registry-signature": (
        "registered entry does not satisfy the registry's positional "
        "contract (source: (key, n, n_attrs, noise, dtype, **opts); "
        "partition: (n_attrs, n_agents, **opts); topology: (n_agents, "
        "**opts); codec: (**opts)); extra parameters must have defaults"),
    "foreign-import": (
        "jax or the JAX package (repro.*) imported by the port or "
        "chip_smoke.py: they run where jax is not installed — keep a copy "
        "of what is needed in repro_torch"),
}

_FACTORIES = ("zeros", "ones", "full", "empty", "arange", "tensor", "rand",
              "randn")

# registry name -> number of required positional (contract) parameters
_REGISTRY_CONTRACTS: Dict[str, Tuple[int, str]] = {
    "register_source": (5, "(key, n, n_attrs, noise, dtype, **options)"),
    "register_partition": (2, "(n_attrs, n_agents, **options)"),
    "register_topology": (1, "(n_agents, **options)"),
    "register_codec": (0, "(**options)"),
}

_HOST_CALLS = ("print", "open", "input", "time.time", "time.sleep",
               "time.perf_counter")
_HOST_PREFIXES = ("np.random.", "numpy.random.")
_HOST_METHODS = ("item", "cpu", "tolist", "numpy")

_MUTABLE_TYPES = {"list", "dict", "set", "List", "Dict", "Set",
                  "MutableMapping", "MutableSequence", "bytearray"}

# the rule list, then (for the port's own suppressions) its reason
_SUPPRESS_RE = re.compile(r"#\s*reprolint:\s*disable=([\w\-]+(?:\s*,\s*[\w\-]+)*)")


@dataclasses.dataclass(frozen=True)
class Violation:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


@dataclasses.dataclass(frozen=True)
class LintConfig:
    """`port`: the path segments (a directory or a file name) that put a
    file under foreign-import — the port's package and its chip script;
    every other rule holds everywhere."""

    port: Tuple[str, ...] = ()

    def is_port(self, path: str) -> bool:
        norm = "/" + path.replace(os.sep, "/") + "/"
        return any(f"/{seg}/" in norm for seg in self.port)


CONFIG = LintConfig(port=("repro_torch", "chip_smoke.py"))


def _dotted(node: ast.AST) -> str:
    """'torch.cuda.graph' for an Attribute/Name chain; '' when not one."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _suppressed(src_lines: Sequence[str], line: int, rule: str) -> bool:
    if 1 <= line <= len(src_lines):
        m = _SUPPRESS_RE.search(src_lines[line - 1])
        if m:
            rules = {r.strip() for r in m.group(1).split(",")}
            return rule in rules or "all" in rules
    return False


Raw = List[Tuple[int, int, str, str]]


# -------------------------------------------------------------------- rules


def _rule_factories(tree: ast.Module, out: Raw) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        if dotted.rsplit(".", 1)[0] != "torch" or \
                dotted.rsplit(".", 1)[-1] not in _FACTORIES:
            continue
        kws = {kw.arg for kw in node.keywords}
        if None in kws:                    # **options may carry both
            continue
        if "dtype" not in kws:
            out.append((node.lineno, node.col_offset, "implicit-dtype",
                        f"{dotted}(...) without dtype=: the default dtype "
                        f"is the caller's — pass dtype="))
        if "device" not in kws:
            out.append((node.lineno, node.col_offset, "implicit-device",
                        f"{dotted}(...) without device=: a CPU tensor on a "
                        f"card path runs the plain version — pass device="))


def _is_graph_capture(item: ast.withitem) -> bool:
    expr = item.context_expr
    return (isinstance(expr, ast.Call)
            and _dotted(expr.func) in ("torch.cuda.graph", "cuda.graph"))


def _host_call(node: ast.Call) -> str:
    dotted = _dotted(node.func)
    if dotted in _HOST_CALLS or dotted.startswith(_HOST_PREFIXES):
        return dotted
    if isinstance(node.func, ast.Attribute) and node.func.attr in _HOST_METHODS \
            and not node.args and not node.keywords:
        return "." + node.func.attr
    return ""


def _rule_host_call_in_capture(tree: ast.Module, out: Raw) -> None:
    seen: Set[int] = set()
    for node in ast.walk(tree):
        if not isinstance(node, (ast.With, ast.AsyncWith)) or \
                not any(_is_graph_capture(it) for it in node.items):
            continue
        for stmt in node.body:
            for sub in ast.walk(stmt):
                if not isinstance(sub, ast.Call) or id(sub) in seen:
                    continue
                what = _host_call(sub)
                if what:
                    seen.add(id(sub))
                    out.append((sub.lineno, sub.col_offset,
                                "host-call-in-capture",
                                f"host call {what}(...) inside a CUDA graph "
                                f"capture runs once at capture, never at a "
                                f"replay — hoist it out"))


def _is_frozen_dataclass(node: ast.ClassDef) -> bool:
    for deco in node.decorator_list:
        if isinstance(deco, ast.Call) and _dotted(deco.func) in (
                "dataclasses.dataclass", "dataclass"):
            for kw in deco.keywords:
                if kw.arg == "frozen" and isinstance(kw.value, ast.Constant) \
                        and kw.value.value is True:
                    return True
    return False


def _rule_mutable_static_field(tree: ast.Module, out: Raw) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef) or not _is_frozen_dataclass(node):
            continue
        for stmt in node.body:
            if not isinstance(stmt, ast.AnnAssign):
                continue
            ann = stmt.annotation
            head = ann.value if isinstance(ann, ast.Subscript) else ann
            name = _dotted(head).rsplit(".", 1)[-1]
            if name in _MUTABLE_TYPES:
                target = stmt.target
                fname = target.id if isinstance(target, ast.Name) else "?"
                out.append((stmt.lineno, stmt.col_offset,
                            "mutable-static-field",
                            f"frozen dataclass {node.name!r} field {fname!r} "
                            f"is {name}-typed: unhashable fields break its "
                            f"use as a cache key — use Tuple[...]"))


def _rule_registry_signature(tree: ast.Module, out: Raw) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for deco in node.decorator_list:
            if not isinstance(deco, ast.Call):
                continue
            reg = _dotted(deco.func).rsplit(".", 1)[-1]
            if reg not in _REGISTRY_CONTRACTS:
                continue
            required, contract = _REGISTRY_CONTRACTS[reg]
            args = node.args
            pos = args.posonlyargs + args.args
            n_defaults = len(args.defaults)
            n_required = len(pos) - n_defaults
            if len(pos) < required and args.vararg is None:
                out.append((node.lineno, node.col_offset,
                            "registry-signature",
                            f"@{reg} entry {node.name!r} takes {len(pos)} "
                            f"positional parameter(s); the registry calls it "
                            f"as {contract}"))
            elif n_required > required:
                extra = [a.arg for a in pos[required:len(pos) - n_defaults]]
                out.append((node.lineno, node.col_offset,
                            "registry-signature",
                            f"@{reg} entry {node.name!r}: parameter(s) "
                            f"{extra} beyond the {contract} contract must "
                            f"have defaults (they are passed as **options "
                            f"by name)"))


def _foreign(module: str) -> bool:
    return module.split(".", 1)[0] in ("jax", "jaxlib", "repro")


def _rule_foreign_import(tree: ast.Module, out: Raw) -> None:
    for node in ast.walk(tree):
        names: List[str] = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        for name in names:
            if _foreign(name):
                out.append((node.lineno, node.col_offset, "foreign-import",
                            f"import of {name!r}: the port and its chip "
                            f"script import neither jax nor the JAX package"))


# -------------------------------------------------------------- entry points


def lint_source(src: str, path: str = "<string>",
                config: LintConfig = CONFIG) -> List[Violation]:
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Violation(path=path, line=e.lineno or 0, col=e.offset or 0,
                          rule="syntax-error", message=str(e.msg))]
    raw: Raw = []
    _rule_factories(tree, raw)
    _rule_host_call_in_capture(tree, raw)
    _rule_mutable_static_field(tree, raw)
    _rule_registry_signature(tree, raw)
    if config.is_port(path):
        _rule_foreign_import(tree, raw)
    lines = src.splitlines()
    return [Violation(path=path, line=ln, col=col, rule=rule, message=msg)
            for ln, col, rule, msg in sorted(raw)
            if not _suppressed(lines, ln, rule)]


def lint_file(path: str, config: LintConfig = CONFIG) -> List[Violation]:
    with open(path, "r", encoding="utf-8") as fh:
        return lint_source(fh.read(), path, config)


def lint_paths(paths: Sequence[str],
               config: LintConfig = CONFIG) -> List[Violation]:
    """Lint files and directories (recursively, *.py)."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames.sort()
                for fname in sorted(filenames):
                    if fname.endswith(".py"):
                        files.append(os.path.join(dirpath, fname))
        else:
            files.append(p)
    out: List[Violation] = []
    for f in files:
        out.extend(lint_file(f, config))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="The port's lint: exit 0 when clean, 1 on violations.")
    ap.add_argument("paths", nargs="*", help="files and directories to lint")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}\n    {desc}")
        return 0
    if not args.paths:
        ap.error("no paths given (try: src/repro_torch chip_smoke.py)")
    violations = lint_paths(args.paths)
    for v in violations:
        print(v.format())
    n = len(violations)
    print(f"reprolint: {n} violation(s)" if n else "reprolint: clean")
    return 1 if n else 0


if __name__ == "__main__":
    raise SystemExit(main())
