"""The compile and capture auditor (twin of repro.analysis.recompile): count
the port's costly cache misses and hold them to a checked-in budget.

The port never calls torch.compile, so it has no retrace to count.  Its
cache misses cost seconds of their own, and each comes from one place:

    build:<source>    an nvcc build of csrc/<source>.cu (kernels/_build.py;
                      reused from build/ when its source is unchanged)
    load:<source>     the load of that library into the process
    capture:<site>    a CUDA graph capture (core/minimax.py records one per
                      (shape, dtype, delta, steps, lr, TF32) key)

A hook at each place calls `record(name)`: a Python counter, no device
operation.  Counting is on inside `count_compilations()`:

    with count_compilations() as log:
        run_the_workload()
    log.counts   # {"build:gram": 1, "capture:minimax._descend_graphed": 3, ...}
    log.total

`install_from_env(entry)` counts for the whole process when
REPRO_TORCH_RECOMPILE_AUDIT names a JSON path, and writes the audit there
at exit; `python -m repro_torch.analysis.recompile check <audit>` holds
audits against the budget file beside this module
(`recompile_budget.json`, the reference's format):

    {"entries": {"chip_smoke": {"max_compiles": 80}, ...}}
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import json
import os
import sys
from typing import Dict, Iterator, List, Optional

__all__ = ["CompilationLog", "count_compilations", "record",
           "install_from_env", "absorb_counts", "load_budget",
           "check_budget", "write_audit", "ENV_VAR", "BUDGET_PATH"]

ENV_VAR = "REPRO_TORCH_RECOMPILE_AUDIT"
BUDGET_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "recompile_budget.json")


@dataclasses.dataclass
class CompilationLog:
    """Counts of builds, loads and captures by name."""

    counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def total(self) -> int:
        return sum(self.counts.values())

    def record(self, name: str) -> None:
        self.counts[name] = self.counts.get(name, 0) + 1

    def by_kind(self, kind: str) -> Dict[str, int]:
        """The counts of one kind ("build", "load", "capture") by name."""
        pre = kind + ":"
        return {k[len(pre):]: v for k, v in sorted(self.counts.items())
                if k.startswith(pre)}

    def as_dict(self) -> Dict[str, object]:
        return {"total": self.total,
                "counts": dict(sorted(self.counts.items()))}


# the logs counting now, innermost last; every record reaches all of them
_active: List[CompilationLog] = []


def record(name: str) -> None:
    """Count one build, load or capture (the hooks' call)."""
    for log in _active:
        log.record(name)


@contextlib.contextmanager
def count_compilations() -> Iterator[CompilationLog]:
    """Count every build, load and capture in this process for the scope's
    extent; scopes nest, and an outer scope sees an inner one's counts."""
    log = CompilationLog()
    _active.append(log)
    try:
        yield log
    finally:
        _active.remove(log)


# ------------------------------------------------------------ process hook

# the log installed by `install_from_env`, if any: worker processes report
# their counts back through `absorb_counts`
_installed: Optional[CompilationLog] = None


def absorb_counts(counts: Dict[str, int]) -> None:
    """Fold a worker process's counts into this process's audit (no-op when
    auditing is off)."""
    if _installed is None:
        return
    for name, n in counts.items():
        _installed.counts[name] = _installed.counts.get(name, 0) + int(n)


def write_audit(path: str, entry: str, log: CompilationLog) -> None:
    payload = {"entry": entry, **log.as_dict()}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")


def install_from_env(entry: str, env_var: str = ENV_VAR
                     ) -> Optional[CompilationLog]:
    """Count for the process's lifetime when `env_var` names a JSON path,
    and write the audit there at exit, tagged `entry`.  Returns the live
    log, or None when auditing is off."""
    global _installed
    path = os.environ.get(env_var)
    if not path:
        return None
    ctx = count_compilations()
    log = ctx.__enter__()
    _installed = log

    def _finish() -> None:
        ctx.__exit__(None, None, None)
        write_audit(path, entry, log)

    atexit.register(_finish)
    return log


# ------------------------------------------------------------ budget checks


def load_budget(path: str = BUDGET_PATH) -> Dict[str, Dict[str, int]]:
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    entries = data.get("entries")
    if not isinstance(entries, dict):
        raise ValueError(f"budget file {path!r} needs an 'entries' mapping")
    return entries


def check_budget(entry: str, log_total: int,
                 budget: Dict[str, Dict[str, int]]) -> List[str]:
    """Violations (empty: within budget).  An entry the budget does not
    name is one: an audited process must declare its ceiling."""
    spec = budget.get(entry)
    if spec is None:
        return [f"audit entry {entry!r} has no budget; add it to the budget "
                f"file with a measured ceiling"]
    ceiling = int(spec["max_compiles"])
    if log_total > ceiling:
        return [f"{entry}: {log_total} builds, loads and captures exceed the "
                f"budget of {ceiling} — a cache key stopped hitting (a graph "
                f"captured per call, a library rebuilt); if the growth is "
                f"intentional, re-measure and update the budget file"]
    return []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.recompile",
        description="Check audit JSONs against the build/capture budget.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    chk = sub.add_parser("check", help="compare audit JSON(s) to the budget")
    chk.add_argument("audits", nargs="+", help="audit JSON files")
    chk.add_argument("--budget", default=BUDGET_PATH)
    args = ap.parse_args(argv)

    budget = load_budget(args.budget)
    failures: List[str] = []
    for path in args.audits:
        with open(path, "r", encoding="utf-8") as fh:
            audit = json.load(fh)
        entry, total = audit["entry"], int(audit["total"])
        ceiling = budget.get(entry, {}).get("max_compiles", "none")
        print(f"{entry}: {total} builds, loads and captures (budget {ceiling})")
        failures.extend(check_budget(entry, total, budget))
    for f in failures:
        print(f"BUDGET VIOLATION: {f}", file=sys.stderr)
    if not failures:
        print("recompile audit: within budget")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
