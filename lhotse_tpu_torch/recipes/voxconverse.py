"""
VoxConverse (copied from ``lhotse_tpu/recipes/voxconverse.py``): speaker
diarization on YouTube "in the wild" audio, the dev and test WAV releases
with the RTTM annotations of the companion GitHub repository (``dev/`` and
``test/`` beside the audio), and the optional re-split of the larger test
part into dev and test halves. ``download_voxconverse`` is not ported: it
needs the network.
"""
from pathlib import Path
from typing import Dict, Optional

from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.recipes.utils import finalize_manifests
from lhotse_tpu_torch.supervision import SupervisionSegment
from lhotse_tpu_torch.utils import Pathlike


def _speaker_turns(rttm: Path):
    for line in rttm.read_text().splitlines():
        if line.strip().startswith("SPEAKER"):
            fields = line.split()
            yield float(fields[3]), float(fields[4]), fields[7]


def prepare_voxconverse(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None, split_test: bool = False,
) -> Dict[str, Dict[str, object]]:
    """
    VoxConverse manifests.  With ``split_test`` the (larger) test release is
    halved into dev/test and the original dev release becomes train.
    """
    corpus_dir = Path(corpus_dir).absolute()
    if split_test:
        test_wavs = sorted((corpus_dir / "test").glob("*.wav"))
        half = len(test_wavs) // 2
        splits = {
            "train": sorted((corpus_dir / "dev").glob("*.wav")), "dev": test_wavs[:half],
            "test": test_wavs[half:]}
        rttm_dir_of = {"train": "dev", "dev": "test", "test": "test"}
    else:
        splits = {
            "dev": sorted((corpus_dir / "dev").glob("*.wav")),
            "test": sorted((corpus_dir / "test").glob("*.wav"))}
        rttm_dir_of = {"dev": "dev", "test": "test"}

    manifests = {}
    for subset, wavs in splits.items():
        recordings, supervisions = [], []
        for wav in wavs:
            rec = Recording.from_file(wav)
            recordings.append(rec)
            rttm = corpus_dir / rttm_dir_of[subset] / f"{wav.stem}.rttm"
            for k, (start, duration, speaker) in enumerate(_speaker_turns(rttm)):
                supervisions.append(
                    SupervisionSegment(
                        id=f"{rec.id}-{k}",
                        recording_id=rec.id,
                        start=start,
                        duration=duration,
                        channel=0,
                        language="en",
                        speaker=speaker,
                    )
                )
        manifests[subset] = finalize_manifests(
            recordings, supervisions, output_dir=output_dir, prefix="voxconverse", part=subset)
    return manifests
