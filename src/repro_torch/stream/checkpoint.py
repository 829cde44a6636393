"""Elastic restarts: checkpoint/restore of live stream state (twin of
repro.stream.checkpoint).

A `StreamState` is one tree, so checkpoint/io.py covers it whole, in the
JAX package's layout: either package resumes the other's checkpoints.
The step number is the ingest count, which is what makes resumption
deterministic: the arrival stream is a pure function of (seed, chunk
index) (stream.source.ChunkSource), so a restarted process replays from
chunk `count / chunk` and every later record — ledger bytes included — is
the uninterrupted run's.

Schema evolution: `restore_stream` diffs the archive's stored keys against
the template first and raises `CheckpointError` naming the missing or
extra leaves (a checkpoint written before the `rounds` fault-round counter
existed lacks '.rounds').
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.stream.ingest import StreamState

__all__ = ["CheckpointError", "save_stream", "restore_stream",
           "latest_stream_step"]


class CheckpointError(RuntimeError):
    """A stream checkpoint cannot be restored into the current StreamState
    schema (missing or extra leaves — typically a checkpoint written by an
    older release; see README.md's 'Checkpoint migration' table)."""


def save_stream(directory: str, state: StreamState) -> str:
    """Save the live state at step = its own ingest count; returns the path."""
    return ckpt_io.save_checkpoint(directory, int(state.count), state)


def _check_schema(directory: str, step: int, like: StreamState) -> None:
    expected = set(ckpt_io.tree_keys(like))
    stored = set(ckpt_io.stored_keys(directory, step))
    missing = sorted(expected - stored)
    extra = sorted(stored - expected)
    if missing:
        raise CheckpointError(
            f"stream checkpoint step {step} in {directory!r} is missing "
            f"leaves {missing} required by the current StreamState schema "
            f"(it has {len(stored)} leaves, the template needs "
            f"{len(expected)}). It was most likely written by an older "
            f"release — e.g. checkpoints from before the fault layer lack "
            f"the 'rounds' fault-round counter. See README.md § "
            f"'Checkpoint migration' for the per-leaf backfill recipe.")
    if extra:
        raise CheckpointError(
            f"stream checkpoint step {step} in {directory!r} carries leaves "
            f"{extra} the current StreamState schema does not know — it was "
            f"written by a newer release; restore it with that release, or "
            f"see README.md § 'Checkpoint migration'.")


def restore_stream(directory: str, like: StreamState,
                   step: Optional[int] = None) -> Tuple[StreamState, int]:
    """Restore into the structure of `like` (an Ingestor.init_state
    template: its dtypes and device are the ones restored into).
    `step=None` picks the newest checkpoint.  Returns (state, step).
    Raises `CheckpointError` (naming the offending leaves) when the stored
    schema does not match the template."""
    if step is None:
        step = ckpt_io.latest_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"no stream checkpoint found in {directory!r}")
    _check_schema(directory, step, like)
    return ckpt_io.restore_checkpoint(directory, step, like), step


def latest_stream_step(directory: str) -> Optional[int]:
    return ckpt_io.latest_step(directory)
