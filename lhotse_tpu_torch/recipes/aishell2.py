"""
AISHELL-2 recipe (copied from ``lhotse_tpu/recipes/aishell2.py``): about
1,000 h of Mandarin read speech in the iOS recording condition, 16 kHz WAV,
under a research license (no public download).

Layout::

    AISHELL-2/iOS/data/{wav/<spk>/*.wav, trans.txt}     # train
    AISHELL-2/iOS/{dev,test}/{wav/..., trans.txt}
"""
import logging
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.recipes.utils import finalize_manifests
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

_FULLWIDTH = str.maketrans({"Ａ": "A", "Ｔ": "T", "Ｍ": "M", "𫖯": "頫", "，": "", "?": ""})


def text_normalize(line: str) -> str:
    """
    AISHELL-2 transcript normalization (WeNet-style): fix fullwidth letters,
    drop punctuation, uppercase, and strip apostrophes that follow CJK
    characters (keeping English contractions like "it's" intact).
    """
    line = line.translate(_FULLWIDTH).replace("-", " ")
    kept = []
    for i, ch in enumerate(line):
        if ch == "'" and i > 0 and "一" <= line[i - 1] <= "鿿":
            continue
        kept.append(ch)
    return "".join(kept).upper()


def prepare_aishell2(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None, num_jobs: int = 1,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """Per-split AISHELL-2 manifests (train/dev/test, iOS condition)."""
    corpus_dir = Path(corpus_dir)
    if not corpus_dir.is_dir():
        raise AssertionError(f"No such directory: {corpus_dir}")
    ios_root = corpus_dir / "AISHELL-2" / "iOS"

    manifests = {}
    for part in ("train", "dev", "test"):
        logging.info(f"Processing aishell2 subset: {part}")
        split_root = ios_root / ("data" if part == "train" else part)
        wav_root = split_root / "wav"

        transcripts = {}
        for line in (split_root / "trans.txt").read_text(encoding="utf-8").splitlines():
            fields = line.split()
            if fields:
                transcripts[fields[0]] = text_normalize(" ".join(fields[1:]))

        recordings = RecordingSet.from_dir(path=wav_root, pattern="*.wav", num_jobs=num_jobs)
        supervisions = []
        for wav in wav_root.rglob("**/*.wav"):
            utt = wav.stem
            if utt not in transcripts:
                logging.warning(f"{wav} has no transcript.")
                continue
            supervisions.append(
                SupervisionSegment(
                    id=utt,
                    recording_id=utt,
                    start=0.0,
                    duration=recordings.duration(utt),
                    channel=0,
                    language="Chinese",
                    speaker=wav.parts[-2],
                    text=transcripts[utt].strip(),
                )
            )
        manifests[part] = finalize_manifests(
            recordings, supervisions, output_dir=output_dir, prefix="aishell2", part=part)
    return manifests
