"""
Test mixins that put real, decodable data on disk (copied from
``lhotse_tpu/testing/fixtures.py``; :mod:`lhotse_tpu_torch.testing.dummies`
mostly fabricates metadata). ``RandomCutTestCase`` registers its temporary
files on one :class:`contextlib.ExitStack` torn down after each test
method. Its fbank features are computed on ``RandomCutTestCase.device``,
the card unless a test class sets ``device = "cpu"``.
"""
import os
import random
from contextlib import ExitStack
from tempfile import NamedTemporaryFile, TemporaryDirectory
from typing import Dict, List

import numpy as np
import pytest

from lhotse_tpu_torch import (
    AudioSource, CutSet, Fbank, FbankConfig, MonoCut, NumpyFilesWriter, Recording,
    SupervisionSegment)
from lhotse_tpu_torch.array import seconds_to_frames
from lhotse_tpu_torch.audio.backend import save_audio
from lhotse_tpu_torch.features.io import default_features_storage_backend
from lhotse_tpu_torch.supervision import AlignmentItem
from lhotse_tpu_torch.utils import Seconds, uuid4


@pytest.fixture()
def with_dill_enabled():
    os.environ["LHOTSE_DILL_ENABLED"] = "1"


def random_cut_set(n_cuts=100) -> CutSet:
    """Metadata-only cuts with random offsets/durations over a fake 100 s recording."""
    SR = 16000
    phantom = lambda: Recording(  # noqa: E731
        id=uuid4(), sources=[], sampling_rate=SR, num_samples=100 * SR, duration=100.0
    )
    cuts = []
    for _ in range(n_cuts):
        begin_smp = random.randint(0, 5 * SR)
        len_smp = random.randint(3 * SR, 10 * SR)
        cuts.append(
            MonoCut(
                id=uuid4(),
                start=begin_smp / SR,
                duration=len_smp / SR,
                channel=0,
                recording=phantom(),
            )
        )
    return CutSet.from_cuts(cuts)


class RandomCutTestCase:
    """
    Base class for tests that need real WAV files and real fbank features.

    Every ``with_*`` helper registers its temp resources on an ExitStack that
    is torn down after each test method.
    """

    device = "cuda"  # where _attach_fbank computes the features

    def setup_method(self, method):
        self._resources = ExitStack()

    def teardown_method(self, method):
        self.cleanup()

    def cleanup(self):
        self._resources.close()
        self._resources = ExitStack()

    def _tmpfile(self, suffix: str):
        return self._resources.enter_context(NamedTemporaryFile("wb", suffix=suffix))

    def _tmpdir(self) -> str:
        return self._resources.enter_context(TemporaryDirectory())

    def with_recording(
        self, sampling_rate: int, num_samples: int, use_zeros: bool = False) -> Recording:
        f = self._tmpfile(".wav")
        shape = (1, num_samples)
        wave = (
            np.zeros(shape, np.float32)
            if use_zeros
            else np.random.rand(*shape).astype(np.float32)
        )
        save_audio(f.name, wave, sampling_rate=sampling_rate)
        f.flush()
        os.fsync(f)
        return Recording(
            id=str(uuid4()), sampling_rate=sampling_rate, num_samples=num_samples,
            duration=num_samples / sampling_rate,
            sources=[AudioSource(type="file", channels=[0], source=f.name)])

    def with_cut(
        self, sampling_rate: int, num_samples: int, features: bool = True,
        supervision: bool = False, alignment: bool = False, custom_field: bool = False,
        frame_shift: Seconds = 0.01, use_zeroes: bool = False) -> MonoCut:
        rec = self.with_recording(
            sampling_rate=sampling_rate, num_samples=num_samples, use_zeros=use_zeroes)
        cut = MonoCut(
            id=str(uuid4()), start=0, duration=num_samples / sampling_rate, channel=0,
            recording=rec)
        if features:
            cut = self._attach_fbank(cut, frame_shift, sampling_rate)
        if supervision:
            ali = self._spread_alignment(cut, "irrelevant") if alignment else None
            sup = SupervisionSegment(
                id=f"sup-{cut.id}", recording_id=cut.recording_id, start=0, duration=cut.duration,
                text="irrelevant", alignment=ali)
            cut.supervisions.append(sup)
        if custom_field:
            self._attach_codebook_indices(cut, frame_shift)
        return cut

    def _attach_fbank(self, cut: MonoCut, frame_shift: Seconds, sampling_rate: int) -> MonoCut:
        fbank = Fbank(config=FbankConfig(
            sampling_rate=sampling_rate, frame_shift=frame_shift, device=self.device))
        store_cls = default_features_storage_backend()
        with store_cls(self._tmpdir()) as storage:
            return cut.compute_and_store_features(fbank, storage=storage)

    def _spread_alignment(self, cut: MonoCut, text: str) -> Dict[str, List[AlignmentItem]]:
        pieces = [text[i : i + 3] for i in range(0, len(text), 3)]
        step = cut.duration / len(pieces)
        return {
            "subword": [
                AlignmentItem(symbol=p, start=k * step, duration=step)
                for k, p in enumerate(pieces)
            ]
        }

    def _attach_codebook_indices(self, cut: MonoCut, frame_shift: Seconds) -> None:
        n = seconds_to_frames(cut.duration, frame_shift=frame_shift)
        with NumpyFilesWriter(self._tmpdir()) as storage:
            cut.codebook_indices = storage.store_array(
                key="ali1", value=np.random.randint(256, size=(n,)), frame_shift=frame_shift,
                temporal_dim=0)

    # The reference helper names: some tests call these private helpers
    # directly.
    _with_features = _attach_fbank
    _with_alignment = _spread_alignment
