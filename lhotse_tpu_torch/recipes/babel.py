"""
IARPA BABEL recipe (copied from ``lhotse_tpu/recipes/babel.py``):
conversational telephone speech in 25 low-resource languages, one LDC
package per language. Each package holds
``conversational/{training,dev,eval}/{audio,transcription}``; transcripts
alternate ``[timestamp]`` lines with text lines, and the file name encodes
the language code, speaker, date, hour and channel. The audio is read by
content (SPHERE or WAV). LDC-licensed, so there is no download.
"""
import logging
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.manipulation import combine
from lhotse_tpu_torch.qa import (
    remove_missing_recordings_and_supervisions, trim_supervisions_to_recordings,
    validate_recordings_and_supervisions)
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

BABELCODE2LANG = {
    "101": "Cantonese", "102": "Assamese", "103": "Bengali", "104": "Pashto", "105": "Turkish",
    "106": "Tagalog", "107": "Vietnamese", "201": "Haitian", "202": "Swahili", "203": "Lao",
    "204": "Tamil", "205": "Kurmanji", "206": "Zulu", "207": "Tok-Pisin", "301": "Cebuano",
    "302": "Kazakh", "303": "Telugu", "304": "Lithuanian", "305": "Guarani", "306": "Igbo",
    "307": "Amharic", "401": "Mongolian", "402": "Javanese", "403": "Dholuo", "404": "Georgian"}

_OOV = re.compile(r"(\(\(\)\)|<foreign>|<prompt>|<overlap>|<hes>)")
_SPK_NOISE = re.compile(r"<(limspack|lipsmack|breath|cough)>")
_NOISE = re.compile(r"<(click|ring|dtmf|int|sta)>")
_SIL = re.compile(r"<no-speech>")
_DROP = re.compile(r"<(male-to-female|female-to-male)> ")
# The names the reference lhotse recipe gives these patterns.
OOV_PATTERN = _OOV
SPK_NOISE_PATTERN = _SPK_NOISE
NOISE_PATTERN = _NOISE
SIL_PATTERN = _SIL
REMOVE_PATTERN = _DROP


def normalize_text(text: str) -> str:
    text = _OOV.sub("<unk>", text)
    text = _SPK_NOISE.sub("<v-noise>", text)
    text = _NOISE.sub("<noise>", text)
    text = _SIL.sub("<silence>", text)
    return _DROP.sub("", text)


def _transcript_segments(path: Path):
    """Yield (start, end, text) triples from one BABEL transcript file."""
    lines = path.read_text().splitlines()
    # Drop timestamp lines immediately followed by another timestamp line
    # (annotation glitches with no transcript in between).
    cleaned = []
    for cur, nxt in zip(lines, lines[1:] + [""]):
        if cur.startswith("[") and nxt.startswith("["):
            continue
        cleaned.append(cur)
    stamps = cleaned[0::2]
    texts = cleaned[1::2]
    for k, text in enumerate(texts):
        if k + 1 >= len(stamps):
            break
        yield float(stamps[k][1:-1]), float(stamps[k + 1][1:-1]), text


def deduplicate_supervisions(
    supervisions: Iterable[SupervisionSegment],
) -> List[SupervisionSegment]:
    by_id = {}
    for s in sorted(supervisions, key=lambda s: s.id):
        if s.id in by_id:
            logging.warning(
                f"Found supervisions with conflicting IDs ({s.id}) - keeping "
                f"only the first one."
            )
            continue
        by_id[s.id] = s
    return list(by_id.values())


def prepare_single_babel_language(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None, no_eval_ok: bool = False,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """
    Manifests for one BABEL language package: finds the ``conversational``
    directory, then prepares dev/eval/training (saved as dev/eval/train).
    ``no_eval_ok`` is accepted and not used. The language of the file names
    comes from the transcripts, or from the audio files' names where no
    transcript was read yet (the JAX package raises ``KeyError: None`` for
    a split with audio and no transcript that comes before any with one).
    """
    root = Path(corpus_dir)
    candidates = [d for d in root.rglob("conversational") if d.is_dir()]
    if not candidates:
        raise ValueError(
            f"Could not find 'conversational' directory anywhere inside "
            f"'{corpus_dir}' - please check your path."
        )
    if len(candidates) > 1:
        logging.warning(
            f"Multiple 'conversational' directories inside '{corpus_dir}' - "
            f"using the first one ({candidates[0]}). Pass a single language's "
            f"package directory to avoid ambiguity."
        )
    package = candidates[0].parent

    manifests = defaultdict(dict)
    lang_code = None
    for split in ("dev", "eval", "training"):
        audio_dir = package / "conversational" / split / "audio"
        recordings = combine(
            RecordingSet.from_recordings(Recording.from_file(p) for p in audio_dir.glob("*.sph")),
            RecordingSet.from_recordings(Recording.from_file(p) for p in audio_dir.glob("*.wav")))
        if len(recordings) == 0:
            if split != "training":
                continue
            logging.warning(f"No SPHERE or WAV files found in {audio_dir}")

        supervisions = []
        text_dir = package / "conversational" / split / "transcription"
        for p in text_dir.glob("*"):
            # BABEL_BP_101_10033_20111024_205740_inLine ->
            #   [2]=lang code, [3]=speaker, [4]=date, [5]=hour, [6]=channel tag
            _, _, lang_code, speaker, date, hour, channel_tag, *_ = p.stem.split("_")
            channel = {"inLine": "A", "outLine": "B"}.get(channel_tag, "A")
            for start, end, text in _transcript_segments(p):
                supervisions.append(
                    SupervisionSegment(
                        id=f"{lang_code}_{speaker}_{channel}_{date}_{hour}_"
                        f"{int(100 * start):06}",
                        recording_id=p.stem,
                        start=start,
                        duration=round(end - start, ndigits=8),
                        channel=0,
                        text=normalize_text(text),
                        language=BABELCODE2LANG[lang_code],
                        speaker=f"{lang_code}_{speaker}_{channel}",
                    )
                )
        supervisions = deduplicate_supervisions(supervisions)
        if not supervisions:
            logging.warning(f"No supervisions found in {text_dir}")
        supervisions = SupervisionSet.from_segments(supervisions)

        if not (split == "eval" and len(supervisions) == 0):
            # (eval transcripts are often withheld; keep those recordings.)
            recordings, supervisions = remove_missing_recordings_and_supervisions(
                recordings, supervisions)
            supervisions = trim_supervisions_to_recordings(recordings, supervisions)
        validate_recordings_and_supervisions(recordings, supervisions)
        manifests[split] = {"recordings": recordings, "supervisions": supervisions}

        if output_dir is not None:
            output_dir = Path(output_dir)
            output_dir.mkdir(parents=True, exist_ok=True)
            if lang_code is None and len(recordings):
                lang_code = sorted(recordings.ids)[0].split("_")[2]
            language = BABELCODE2LANG[lang_code]
            tag = "train" if split == "training" else split
            recordings.to_file(output_dir / f"babel-{language}_recordings_{tag}.jsonl.gz")
            supervisions.to_file(output_dir / f"babel-{language}_supervisions_{tag}.jsonl.gz")
    return dict(manifests)
