"""
Unsupervised datasets: features or waveforms without labels, and
recording chunking (copied from ``lhotse_tpu/dataset/unsupervised.py``):
``UnsupervisedDataset``, ``UnsupervisedWaveformDataset``,
``DynamicUnsupervisedDataset``, ``RecordingChunkIterableDataset``,
``audio_chunk_collate`` and ``audio_chunk_worker_init_fn``.

``RecordingChunkIterableDataset`` is a ``torch.utils.data.IterableDataset``,
so a torch ``DataLoader`` iterates it in its workers, and
``audio_chunk_worker_init_fn`` reads the worker's copy of the dataset from
torch's worker info. The JAX function reads the package's own
``WorkerInfo``, which carries no dataset, and raises ``AttributeError`` in
a worker.
"""
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch.utils.data

from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.audio.utils import suppress_audio_loading_errors
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.collation import (collate_audio, collate_features, collate_matrices)
from lhotse_tpu_torch.features import FeatureExtractor
from lhotse_tpu_torch.qa import validate
from lhotse_tpu_torch.utils import Seconds, compute_num_samples


class UnsupervisedDataset:
    """
    Features-only dataset (no supervisions)::

        {'cuts': CutSet, 'features': (B, T, F), 'features_lens': (B,)}
    """

    def __getitem__(self, cuts: CutSet) -> Dict[str, Any]:
        self._validate(cuts)
        features, features_lens = collate_features(cuts)
        return {"cuts": cuts, "features": features, "features_lens": features_lens}

    def _validate(self, cuts: CutSet) -> None:
        validate(cuts)
        assert all(cut.has_features for cut in cuts)


class UnsupervisedWaveformDataset(UnsupervisedDataset):
    """
    Waveform variant::

        {'cuts': CutSet, 'audio': (B, T), 'audio_lens': (B,)}

    With ``collate=False``, 'audio' is a list of per-cut arrays instead.
    """

    def __init__(self, collate: bool = True) -> None:
        self.collate = collate

    def __getitem__(self, cuts: CutSet) -> Dict[str, Any]:
        self._validate(cuts)

        if self.collate:
            audio, audio_lens = collate_audio(cuts)
            return {"cuts": cuts, "audio": audio, "audio_lens": audio_lens}
        else:
            remain_cuts = []
            remain_audios = []
            for c in cuts:
                with suppress_audio_loading_errors():
                    remain_audios.append(c.load_audio())
                    remain_cuts.append(c)
            return {"cuts": CutSet.from_cuts(remain_cuts), "audio": remain_audios}

    def _validate(self, cuts: CutSet) -> None:
        validate(cuts)
        assert all(cut.has_recording for cut in cuts)


class DynamicUnsupervisedDataset(UnsupervisedDataset):
    """
    On-the-fly feature extraction variant (MixedCuts are mixed in the time
    domain before extraction, unlike UnsupervisedDataset's feature-domain
    mixing).
    """

    def __init__(self, feature_extractor: FeatureExtractor, augment_fn: Optional[Any] = None):
        self.feature_extractor = feature_extractor
        self.augment_fn = augment_fn

    def __getitem__(self, cuts: CutSet) -> np.ndarray:
        self._validate(cuts)

        def generate_cut(cuts: CutSet):
            for cut in cuts:
                with suppress_audio_loading_errors():
                    yield cut.compute_features(
                        extractor=self.feature_extractor, augment_fn=self.augment_fn)

        return collate_matrices(generate_cut(cuts))

    def _validate(self, cuts: CutSet) -> None:
        validate(cuts)
        assert all(cut.has_recording for cut in cuts)


class RecordingChunkIterableDataset(torch.utils.data.IterableDataset):
    """
    Iterates over (possibly overlapping) chunks of each recording — set
    ``chunk_shift < chunk_size`` for overlapped inference. Yields
    **individual** items::

        {"recording_id": str, "begin_time": float32 scalar,
         "end_time": float32 scalar, "audio": float32 (chunk_samples,)}

    Use :func:`audio_chunk_collate` to batch and
    :func:`audio_chunk_worker_init_fn` to shard across workers.
    """

    def __init__(self, recordings: RecordingSet, chunk_size: Seconds, chunk_shift: Seconds) -> None:
        self.recordings = list(recordings)
        self.chunk_size = chunk_size
        self.chunk_shift = chunk_shift
        self.start = 0
        self.end = len(self.recordings)

        self.validate()

    def validate(self) -> None:
        for r in self.recordings:
            assert len(r.sources) == 1, (
                f"We currently don't support multi-source audio in this dataset "
                f"(got {len(r.sources)} sources in recording {r.id})."
            )
            assert r.sources[0].type == "file", (
                f"We currently only support 'file' AudioSource type in this "
                f"dataset (got: {r.sources[0].type} in recording {r.id})."
            )
            assert r.num_channels == 1, (
                f"We currently only support single-channel audio in this "
                f"dataset (got {r.num_channels} channels in recording {r.id})."
            )

    def __iter__(self):
        for r in self.recordings[self.start : self.end]:
            chunk_samples = compute_num_samples(self.chunk_size, r.sampling_rate)
            shift_samples = compute_num_samples(self.chunk_shift, r.sampling_rate)

            begin_time = 0.0
            end_time = self.chunk_size
            offset = 0
            total = r.num_samples
            while offset < total:
                n = min(chunk_samples, total - offset)
                chunk = r.load_audio(
                    offset=offset / r.sampling_rate, duration=n / r.sampling_rate)[0]
                yield {
                    "recording_id": r.id, "begin_time": np.float32(begin_time),
                    "end_time": np.float32(end_time), "audio": chunk.astype(np.float32)}
                offset += shift_samples
                begin_time += self.chunk_shift
                end_time = begin_time + self.chunk_size


def audio_chunk_collate(batch: List[Dict]) -> Dict[str, Any]:
    """Batch chunk items, zero-padding 'audio' to the longest chunk."""
    audios = [np.asarray(d.pop("audio")) for d in batch]
    out = {
        "recording_id": [d["recording_id"] for d in batch],
        "begin_time": np.array([d["begin_time"] for d in batch], dtype=np.float32),
        "end_time": np.array([d["end_time"] for d in batch], dtype=np.float32)}
    maxlen = max(a.shape[0] for a in audios)
    audio = np.zeros((len(audios), maxlen), dtype=np.float32)
    for i, a in enumerate(audios):
        audio[i, : a.shape[0]] = a
    out["audio"] = audio
    return out


def audio_chunk_worker_init_fn(worker_id: int) -> None:
    """Shard the dataset's [start, end) recording range across workers."""
    worker_info = torch.utils.data.get_worker_info()
    if worker_info is None or worker_info.dataset is None:
        return
    dataset = worker_info.dataset
    overall_start = dataset.start
    overall_end = dataset.end
    per_worker = int(math.ceil((overall_end - overall_start) / float(worker_info.num_workers)))
    dataset.start = overall_start + worker_info.id * per_worker
    dataset.end = min(dataset.start + per_worker, overall_end)
