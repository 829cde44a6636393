"""The sanitizer rail (twin of repro.analysis.sanitize): the repo's silent
corruptions — NaN through a lossy codec, a singular Sherman–Morrison–Woodbury
(SMW) pivot dividing to inf, a trial index off the batch — made into errors
that name their site.

PyTorch has no checkify, so the port carries the functionalized error
itself: an int32 error word on the device, () for one run or (B,) for a
batch of B trials, 0 while every check held.  A check site folds its
predicate into the word,

    word = where((word == 0) & bad, code, word)

so the first failure of each trial is kept, as checkify keeps it, and no
site reads the device.  The host keeps the table from code to site message,
built as the sites are met.  The word is read where the caller already
waits on the device (once a sweep of `icoa.run`, once a resweep of the
stream) and once at the end of a checked run: a failure raises CheckError,
whose message is the reference's site message word for word (and, in a
batch, the first failing trial).

Off mode adds nothing: every site is a Python `if` on `checks_enabled()`,
so a run without checks performs exactly the device operations it
performed before, and a healthy checked run gives its bits (the sites only
read).  Where the JAX package reaches a Pallas kernel it checks nothing
inside it; the port checks nothing inside its kernels either, nor inside
their plain versions when those stand in for a kernel on the CPU.

    with error_scope("raise") as word:      # the rail of one run
        ...                                 # sites fold into `word`
    # leaving the scope reads the word and raises CheckError on a failure

Scopes nest: the innermost mode wins (`icoa.sweep` re-asserts its own
`cfg.checks`), and a raise scope inside another joins the outer word, which
its owner reads.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Callable, Iterator, List, Optional, Tuple, TypeVar

import numpy as np
import torch

__all__ = ["CHECK_MODES", "CheckError", "ErrorWord", "checks_enabled",
           "sanitize_scope", "error_scope", "checked", "check_finite",
           "check_nonzero", "check_in_bounds", "validate_mode"]

CHECK_MODES: Tuple[str, ...] = ("off", "raise")

_F = TypeVar("_F", bound=Callable[..., Any])

_state = threading.local()


class CheckError(RuntimeError):
    """A check site of a checked run failed.  The message is the site's,
    as the JAX package words it; `site` holds it alone, and `trial` the
    first failing trial of a batch (None for a single run)."""

    def __init__(self, site: str, trial: Optional[int] = None,
                 n_trials: Optional[int] = None):
        where = "" if trial is None else f" (trial {trial} of {n_trials})"
        super().__init__(site + where)
        self.site = site
        self.trial = trial
        self.n_trials = n_trials

    def __reduce__(self):
        # pickled by its fields (a distributed run's rank sends it back)
        return CheckError, (self.site, self.trial, self.n_trials)


def validate_mode(mode: str, where: str = "checks") -> str:
    if mode not in CHECK_MODES:
        raise ValueError(f"unknown {where} mode {mode!r}; "
                         f"pick one of {CHECK_MODES}")
    return mode


class ErrorWord:
    """The functionalized error of a checked run: an int32 word on the
    device (made at the first site, on its device), () or (trials,), and the
    host table of the sites' messages (code k is messages[k - 1])."""

    def __init__(self, trials: Optional[int] = None):
        self.trials = trials
        self.word: Optional[torch.Tensor] = None
        self.messages: List[str] = []

    def fold(self, bad: torch.Tensor, message: str) -> None:
        """Record `message` where `bad` holds, unless an earlier site
        failed there.  In a batch, `bad`'s leading axis is the trial's when
        it has the batch's length; any other shape counts for every trial."""
        if message not in self.messages:
            self.messages.append(message)
        code = self.messages.index(message) + 1
        if (self.trials is not None and bad.dim() >= 1
                and bad.shape[0] == self.trials):
            if bad.dim() > 1:
                bad = bad.flatten(1).any(dim=1)
        elif bad.dim() > 0:
            bad = bad.any()
        if self.word is None:
            shape = () if self.trials is None else (self.trials,)
            self.word = torch.zeros(shape, dtype=torch.int32, device=bad.device)
        self.word = torch.where((self.word == 0) & bad, code, self.word)

    def error(self) -> Optional[CheckError]:
        """The failure the word holds (one copy from the device), or None."""
        if self.word is None:
            return None
        codes = np.atleast_1d(self.word.cpu().numpy())
        failed = np.flatnonzero(codes)
        if failed.size == 0:
            return None
        t = int(failed[0])
        message = self.messages[int(codes[t]) - 1]
        if self.trials is None:
            return CheckError(message)
        return CheckError(message, t, self.trials)

    def throw(self) -> None:
        """Raise the failure the word holds, if any."""
        err = self.error()
        if err is not None:
            raise err


def checks_enabled() -> bool:
    """True inside an enabled scope: the guard of every check site."""
    return bool(getattr(_state, "enabled", False))


def _word() -> Optional[ErrorWord]:
    return getattr(_state, "word", None)


@contextlib.contextmanager
def sanitize_scope(mode: str) -> Iterator[None]:
    """Switch the check sites on ("raise") or off for the scope's extent;
    the innermost scope wins."""
    validate_mode(mode)
    prev = checks_enabled()
    _state.enabled = mode == "raise"
    try:
        yield
    finally:
        _state.enabled = prev


@contextlib.contextmanager
def error_scope(mode: str, trials: Optional[int] = None,
                word: Optional[ErrorWord] = None
                ) -> Iterator[Optional[ErrorWord]]:
    """The rail of one checked run.  "off": the sites are off for the
    extent, yields None.  "raise": the sites are on and fold into the
    thread's active word if there is one (the outer scope reads it),
    else into `word` (the caller's, read by the caller), else into a fresh
    word of `trials`, read as the scope exits.  A failure recorded in a
    word this scope holds is raised in place of any exception that leaves
    the scope: a NaN the sites caught usually breaks something downstream
    first.  Yields the word the sites fold into."""
    if validate_mode(mode) == "off":
        with sanitize_scope("off"):
            yield None
        return
    outer = _word()
    if outer is not None:
        with sanitize_scope("raise"):
            yield outer
        return
    own = word is None
    held = ErrorWord(trials) if own else word
    _state.word = held
    try:
        with sanitize_scope("raise"):
            yield held
    except Exception as exc:
        err = held.error()
        if err is not None:
            raise err from exc
        raise
    finally:
        _state.word = None
    if own:
        held.throw()


def checked(fn: _F, trials: Optional[int] = None) -> Callable[..., Any]:
    """`fn` with its check sites on, raising CheckError after it returns if
    one failed (inside another checked run it joins that run's word)."""

    @functools.wraps(fn)
    def run(*args: Any, **kwargs: Any) -> Any:
        with error_scope("raise", trials):
            return fn(*args, **kwargs)

    return run


def _fold(bad: torch.Tensor, message: str) -> None:
    word = _word()
    if word is None:
        raise RuntimeError(
            f"check site {message!r} ran under sanitize_scope('raise') "
            f"outside a checked run; use sanitize.error_scope or checked")
    word.fold(bad, message)


# ------------------------------------------------------------- check sites
# Each helper returns its input; with the sites on it also folds one
# predicate into the active error word, on the device.


def check_finite(x: torch.Tensor, site: str) -> torch.Tensor:
    """Every element of `x` is finite (no NaN or inf)."""
    if checks_enabled():
        _fold(~torch.isfinite(x), f"non-finite value in {site}")
    return x


def check_nonzero(x: torch.Tensor, site: str) -> torch.Tensor:
    """`x`, a divisor, is nowhere exactly zero."""
    if checks_enabled():
        _fold(x == 0, f"division by zero in {site}")
    return x


def check_in_bounds(idx: torch.Tensor, size: int, site: str) -> torch.Tensor:
    """Every index in `idx` lies in [0, size)."""
    if checks_enabled():
        _fold((idx < 0) | (idx >= size),
              f"index out of bounds [0, {size}) in {site}")
    return idx
