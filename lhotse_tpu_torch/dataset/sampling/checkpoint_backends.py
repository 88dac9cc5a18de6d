"""
Resume strategies for streaming samplers (copied from
``lhotse_tpu/dataset/sampling/checkpoint_backends.py``): **seek** jumps
indexed sources to their saved positions in O(1); **replay** rebuilds the
epoch iterator and pulls the batches the checkpoint had consumed.
``plan_resume`` (and its builders under the JAX package's names) picks
seek when every source of the sampler has constant time access (indexed
Shar, an indexed JSONL manifest, the graphs over them) and replay
otherwise.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Optional

from lhotse_tpu_torch.dataset.sampling.base import EpochDiagnostics


class ResumeStateError(RuntimeError):
    """A seekable sampler's checkpoint lacked state required for O(1) resume."""


def _sources_are_seekable(sampler: Any) -> bool:
    srcs = getattr(sampler, "cuts", ())
    if not len(srcs):
        return False
    return all(getattr(s, "has_constant_time_access", False) for s in srcs)


def _saved_positions(sampler: Any) -> Optional[list]:
    """The per-source iterator-graph states captured at checkpoint time, if any."""
    positions = getattr(sampler, "_cuts_state", None)
    if positions is None or all(p is None for p in positions):
        return None
    return positions


@dataclass
class SeekResume:
    """O(1) resume: jump indexed sources to their saved positions."""

    sampler: Any
    kind: str  # "dynamic" | "bucketing"
    steps_done: int

    def restore(self) -> None:
        """Parity alias for :meth:`run` (the reference backends' entry point)."""
        self.run()

    def run(self) -> None:
        s = self.sampler
        positions = _saved_positions(s)
        if self.steps_done == 0:
            # Checkpointed before any batch was emitted: a fresh epoch
            # iterator is already the exact saved state. (A pristine capture
            # may also record the UNWRAPPED source graph — with shuffle=True
            # the epoch sources are shuffler-wrapped, so restoring those
            # positions would be a shape mismatch; the fresh epoch is both
            # correct and cheaper.)
            self._protected(self._seek_fresh_epoch)
            return
        if self.kind == "bucketing":
            rng_state = getattr(s, "_rng_state", None)
            bucket_state = getattr(s, "_bucketer_state", None)
            if positions is not None and rng_state is not None and bucket_state is not None:
                self._protected(self._seek_bucketing, positions, rng_state, bucket_state)
            else:
                raise ResumeStateError(self._describe_gap())
        else:
            if positions is None:
                raise ResumeStateError(self._describe_gap())
            self._protected(self._seek_dynamic, positions)

    def _protected(self, fn, *args) -> None:
        try:
            fn(*args)
        except ResumeStateError:
            raise
        except Exception as exc:
            raise ResumeStateError(
                f"Seek-based resume raised while restoring {type(self.sampler).__name__}: "
                f"{exc!r}. Seekable samplers must restore in O(1); refusing to fall back "
                f"to an O(N) replay."
            ) from exc

    def _clear_saved(self) -> None:
        s = self.sampler
        s._just_restored_state = False
        s._cuts_state = None
        for attr in ("_rng_state", "_bucketer_state"):
            if hasattr(s, attr):
                setattr(s, attr, None)
        s._skip_diagnostics_reset_once = True

    def _finish(self) -> None:
        s = self.sampler
        s._restore_transforms_state()
        s._just_restored_state = True

    def _seek_dynamic(self, positions: list) -> None:
        s = self.sampler
        s._restore_cuts_state(positions)
        self._clear_saved()
        s._initialize_epoch_iterator(rebuild_sources=False)
        self._finish()

    def _seek_bucketing(self, positions, rng_state, bucket_state) -> None:
        from lhotse_tpu_torch.checkpoint import _rng_state_from_json

        s = self.sampler
        s.rng = random.Random()
        s.rng.setstate(_rng_state_from_json(rng_state))
        s._restore_cuts_state(positions)
        self._clear_saved()
        iter(s)
        s._bucketer.set_state(bucket_state)
        self._finish()

    def _seek_fresh_epoch(self) -> None:
        self._clear_saved()
        iter(self.sampler)
        self._finish()

    def _describe_gap(self) -> str:
        s = self.sampler
        present = {
            "source_positions": _saved_positions(s) is not None,
            "rng_state": getattr(s, "_rng_state", None) is not None,
            "bucketer_state": getattr(s, "_bucketer_state", None) is not None}
        return (
            f"{type(s).__name__} reads from seekable (indexed) sources but its "
            f"checkpoint is incomplete for O(1) resume after {self.steps_done} "
            f"batch(es): {present}. This indicates a checkpoint produced by a "
            f"mismatched sampler configuration or a bug in state capture."
        )


@dataclass
class ReplayResume:
    """O(steps) resume: rebuild the epoch iterator and consume saved batches."""

    sampler: Any
    epoch: int
    steps_done: int

    def restore(self) -> None:
        """Parity alias for :meth:`run` (the reference backends' entry point)."""
        self.run()

    def run(self) -> None:
        s = self.sampler
        # The replayed batches would otherwise double-count in diagnostics.
        s.diagnostics.stats_per_epoch[self.epoch] = EpochDiagnostics(epoch=self.epoch)
        s._initialize_replay_iterator()
        for _ in range(self.steps_done):
            next(s)
        s._just_restored_state = True


def plan_resume(sampler: Any, kind: str, *, epoch: int, steps_done: int):
    """
    Choose the resume strategy for ``sampler``.

    :param kind: ``"dynamic"`` (DynamicCutSampler family) or ``"bucketing"``
        (DynamicBucketingSampler) — selects which state payload a seek needs.
    :param epoch: the epoch recorded in the checkpoint.
    :param steps_done: how many batches the checkpoint had already emitted.
    """
    if _sources_are_seekable(sampler):
        return SeekResume(sampler, kind, steps_done)
    return ReplayResume(sampler, epoch, steps_done)


# -- The JAX package's names for the two plans and their builders -------------
IndexedCheckpointBackend = SeekResume
ReplayCheckpointBackend = ReplayResume


def build_dynamic_cut_checkpoint_backend(
    sampler: Any, *, current_epoch: int, num_batches_to_iter: int
):
    """:func:`plan_resume` for a ``DynamicCutSampler``-family checkpoint."""
    return plan_resume(
        sampler, "dynamic", epoch=current_epoch, steps_done=num_batches_to_iter)


def build_dynamic_bucketing_checkpoint_backend(
    sampler: Any, *, current_epoch: int, num_batches_to_iter: int
):
    """:func:`plan_resume` for a ``DynamicBucketingSampler`` checkpoint."""
    return plan_resume(
        sampler, "bucketing", epoch=current_epoch, steps_done=num_batches_to_iter)
