"""
CSLU Kids recipe (copied from ``lhotse_tpu/recipes/cslu_kids.py``): scripted
and spontaneous speech from about 1,100 children (LDC2007S18), with
verification labels (1 = good .. 4 = puff) on the scripted items. The audio
lies at ``speech/{scripted,spontaneous}/<prompt>/<cat>/<spk>/<utt>.wav``;
scripted text comes from ``docs/all.map``, spontaneous text from the
``trans/`` mirror of that tree, with its noise tags stripped unless
``normalize_text=False``. The recordings are written as
``cslu-kids_recordings_all`` and the supervisions as
``cslu_kids_supervisions_all``, the names the JAX package gives them. The
corpus is LDC-licensed, so there is no download.
"""
import logging
import re
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.recipes.utils import finalize_manifests
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike, check_and_rglob

NOISE_TAGS_REGEX = re.compile("<.*?>")


def read_text(file: Path, normalize: Optional[bool] = True) -> str:
    text = Path(file).read_text().replace("\n", " ")
    return NOISE_TAGS_REGEX.sub("", text) if normalize else text


def prepare_cslu_kids(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
    absolute_paths: Optional[bool] = True, normalize_text: Optional[bool] = True,
) -> Dict[str, Union[RecordingSet, SupervisionSet]]:
    """Manifests with prompted or transcribed text + verification labels."""
    corpus_dir = Path(corpus_dir)
    audio_paths = check_and_rglob(corpus_dir, "*.wav")

    verification = {}
    for file in check_and_rglob(corpus_dir, "*-verified.txt"):
        for line in Path(file).read_text().splitlines():
            if line.strip():
                path, label = line.strip().split()
                verification[Path(path).stem] = int(label)

    prompts = {}
    for line in (corpus_dir / "docs" / "all.map").read_text().splitlines():
        if line.strip():
            prompt, text = line.strip().split(maxsplit=1)
            prompts[prompt] = text[1:-1]  # strip the surrounding quotes

    recordings, supervisions = [], []
    for p in audio_paths:
        uttid = p.stem                                 # e.g. ks001000
        spk = p.parent.stem                            # ks001
        cat = p.parent.parent.stem                     # 0
        prompt = p.parent.parent.parent.stem           # 00
        utt_type = p.parent.parent.parent.parent.stem  # scripted / spontaneous
        recording = Recording.from_file(
            p, relative_path_depth=None if absolute_paths else 3)
        recordings.append(recording)
        if utt_type == "scripted":
            text = prompts[prompt]
            custom = {"type": utt_type, "verification_label": verification.get(uttid)}
        else:
            text = read_text(
                corpus_dir / "trans" / utt_type / prompt / cat / spk / f"{uttid}.txt",
                normalize=normalize_text)
            custom = {"type": utt_type}
        supervisions.append(
            SupervisionSegment(
                id=uttid, recording_id=uttid, start=0, duration=recording.duration,
                speaker=spk, language="English", text=text, custom=custom))

    manifests = finalize_manifests(recordings, supervisions)
    if output_dir is not None:
        logging.info("Writing manifests to JSONL files")
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        manifests["recordings"].to_file(output_dir / "cslu-kids_recordings_all.jsonl.gz")
        manifests["supervisions"].to_file(output_dir / "cslu_kids_supervisions_all.jsonl.gz")
    return manifests
