"""repro_torch.analysis — the port's analysis rail (twin of repro.analysis).

    sanitize   check sites on the solver's hot paths, off by default (no
               device operation), switched by BackendSpec.checks /
               ICOAConfig.checks; "raise" keeps an int32 error word on the
               device and raises CheckError naming the failing site
    recompile  the compile and capture auditor: counts nvcc builds, library
               loads and CUDA graph captures, and holds an audit to
               recompile_budget.json (REPRO_TORCH_RECOMPILE_AUDIT,
               `python -m repro_torch.analysis.recompile check <audit>`)
    lint       the port's AST lint (`python -m repro_torch.analysis.lint
               src/repro_torch chip_smoke.py`)

The names below load their module at first use, so each command line runs
its module without the others (lint and recompile import no torch).
"""
from __future__ import annotations

import importlib

_NAMES = {
    "lint": ("CONFIG", "RULES", "LintConfig", "Violation", "lint_file",
             "lint_paths", "lint_source"),
    "recompile": ("CompilationLog", "absorb_counts", "check_budget",
                  "count_compilations", "install_from_env", "load_budget",
                  "write_audit"),
    "sanitize": ("CHECK_MODES", "CheckError", "ErrorWord", "check_finite",
                 "check_in_bounds", "check_nonzero", "checked",
                 "checks_enabled", "error_scope", "sanitize_scope",
                 "validate_mode"),
}
_HOME = {name: mod for mod, names in _NAMES.items() for name in names}

__all__ = sorted(_HOME)


def __getattr__(name: str):
    mod = _HOME.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
