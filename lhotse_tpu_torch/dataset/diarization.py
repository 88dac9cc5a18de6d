"""
Speaker diarization dataset (copied from
``lhotse_tpu/dataset/diarization.py``): TS-VAD-style per-speaker activity
targets, (B, S, T) with the ignore index (-100) on padded frames; with a
UEM, each supervision is intersected with the scored regions first. The
JAX package's intersection raises ``TypeError`` as soon as a region
overlaps a supervision (it puts the trimmed segments in a set); the port
keeps each trimmed segment once.
"""
from typing import Dict, Optional

import numpy as np

from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.collation import PAD_TOKEN_ID, collate_features, collate_matrices
from lhotse_tpu_torch.qa import validate
from lhotse_tpu_torch.supervision import SupervisionSet


class DiarizationDataset:
    """
    Assumes single-channel input and a per-speaker speech-activity matrix as
    supervision (rows = speakers, columns = feature frames; inspired by
    TS-VAD, arXiv:2005.07272). Each item::

        {
            'features': (B, T, F) array,
            'features_lens': (B,) array,
            'speaker_activity': (B, num_speakers, T) array,
        }

    Padded frames in the activity matrix hold the ignore index (-100).

    :param cuts: the CutSet used to build the dataset.
    :param uem: optional SupervisionSet restricting scored regions.
    :param min_speaker_dim: enforce at least this many speaker rows.
    :param global_speaker_ids: keep a fixed speaker→row mapping across cuts.
    """

    def __init__(
        self, cuts: CutSet, uem: Optional[SupervisionSet] = None,
        min_speaker_dim: Optional[int] = None, global_speaker_ids: bool = False) -> None:
        validate(cuts)
        if not uem:
            self.cuts = cuts
        else:
            # Intersect supervisions with the UEM scoring regions.
            recordings = RecordingSet.from_recordings(c.recording for c in cuts if c.has_recording)
            uem_intervals = CutSet.from_manifests(
                recordings=recordings, supervisions=uem).index_supervisions()
            supervisions = []
            for cut_id, index in cuts.index_supervisions().items():
                if cut_id not in uem_intervals:
                    supervisions += list(index)
                    continue
                # Each trimmed segment once, in the order found. The JAX package
                # collects them in a set, which raises: a SupervisionSegment is
                # not hashable.
                kept = {}
                for u in uem_intervals[cut_id]:
                    for s in index.overlap(begin=u.start, end=u.end):
                        t = s.trim(u.end, start=u.start)
                        kept.setdefault((t.id, t.start, t.duration), t)
                supervisions += list(kept.values())
            self.cuts = CutSet.from_manifests(
                recordings=recordings, supervisions=SupervisionSet.from_segments(supervisions))
        self.speakers = (
            {spk: idx for idx, spk in enumerate(sorted(self.cuts.speakers))}
            if global_speaker_ids
            else None
        )
        self.min_speaker_dim = min_speaker_dim

    def __getitem__(self, cuts: CutSet) -> Dict[str, np.ndarray]:
        features, features_lens = collate_features(cuts)
        return {
            "features": features,
            "features_lens": features_lens,
            "speaker_activity": collate_matrices(
                (
                    cut.speakers_feature_mask(
                        min_speaker_dim=self.min_speaker_dim,
                        speaker_to_idx_map=self.speakers,
                    )
                    for cut in cuts
                ),
                # Missing speaker rows are filled with the loss ignore index.
                padding_value=PAD_TOKEN_ID,
            ),
        }
