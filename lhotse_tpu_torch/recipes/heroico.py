"""
Heroico + USMA recipe (copied from ``lhotse_tpu/recipes/heroico.py``):
Latin-American Spanish read and answered speech (LDC2006S37, OpenSLR 39),
three sub-corpora with a fixed fold assignment:

- *answers* (spontaneous answers, ``Answers_Spanish/<spk>/<prompt>.wav``),
  transcripts in ``heroico-answers.txt`` (``spk/prompt\\ttext``) -> train;
- *heroico-recitations* (read speech, ``Recordings_Spanish/<spk>/<id>.wav``),
  transcripts in ``heroico-recordings.txt``; prompt ids <= 354 or >= 562 ->
  train, the 355..561 range ("repeats") -> devtest;
- *usma* (``usma/native-.../<sNNN>.wav``), prompts in ``usma-prompts.txt`` ->
  test.

Transcript files are ISO-8859-1 encoded. Each wav is sorted by the
directories below ``speech_dir``, not by its whole path (the JAX package
tests substrings of the whole path, so a corpus under a directory whose
name holds ``usma`` loses its recitations). The download is not ported.
"""
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.recipes.utils import finalize_manifests
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

FOLDS = ("train", "devtest", "test")

_ANSWERS_FILE = "heroico-answers.txt"
_RECITATIONS_FILE = "heroico-recordings.txt"
_USMA_FILE = "usma-prompts.txt"

# The names the reference lhotse recipe gives these constants.
folds = FOLDS
heroico_dataset_answers = _ANSWERS_FILE
heroico_dataset_recordings = _RECITATIONS_FILE
usma_dataset = _USMA_FILE


def _read_prompt_table(path: Path, line_re: re.Pattern) -> Dict[str, str]:
    table = {}
    for line in path.read_text(encoding="iso-8859-1").splitlines():
        line = line.rstrip()
        if not line_re.match(line):
            continue
        key, text = line.split(maxsplit=1)
        table[key] = text
    return table


def _classify(wav: Path, answers, recitations, usma_prompts):
    """-> (fold, subcorpus, speaker, utt_id, transcript) or None to skip.
    ``wav`` is the path below the speech directory."""
    spk = wav.parts[-2]
    pid = wav.stem
    full = str(wav)
    if "Answers_Spanish" in full:
        text = answers.get(f"{spk}/{pid}")
        if text is None:
            return None  # some answers were never transcribed
        return "train", "answers", spk, f"answers-{spk}-{pid}", text
    if "usma" in full:
        native = re.match(r"native-[fm]-\w+", spk) is not None
        nonnative = re.match(r"nonnative-[fm]-", spk) is not None
        if not (native or nonnative) or not re.fullmatch(r"s\d+", pid):
            return None
        text = usma_prompts.get(pid)
        if text is None:
            return None
        return "test", "usma", spk, f"usma-{spk}-{pid}", text
    if "Recordings_Spanish" in full:
        text = recitations.get(pid)
        if text is None:
            return None
        n = int(pid)
        if 354 < n < 562:
            return (
                "devtest", "heroico-recitations-repeats", spk,
                f"heroico-recitations-repeats-{spk}-{pid}", text)
        return "train", "heroico-recitations", spk, f"heroico-recitations-{spk}-{pid}", text
    return None


def prepare_heroico(
    speech_dir: Pathlike, transcript_dir: Pathlike, output_dir: Optional[Pathlike] = None,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """
    Build per-fold (train/devtest/test) Heroico+USMA manifests.

    :param speech_dir: root of the wav tree.
    :param transcript_dir: directory holding the three prompt/transcript files.
    """
    speech_dir, transcript_dir = Path(speech_dir), Path(transcript_dir)
    for d in (speech_dir, transcript_dir):
        if not d.is_dir():
            raise AssertionError(f"No such directory: {d}")

    answers = _read_prompt_table(transcript_dir / _ANSWERS_FILE, re.compile(r"\d+/\d+\t.+"))
    recitations = _read_prompt_table(transcript_dir / _RECITATIONS_FILE, re.compile(r"\d+\t.+"))
    usma_prompts = _read_prompt_table(transcript_dir / _USMA_FILE, re.compile(r"s\d+\t.+"))

    by_fold = defaultdict(lambda: ([], []))  # fold -> (recordings, supervisions)
    for wav in sorted(speech_dir.rglob("*.wav")):
        below = wav.relative_to(speech_dir)
        entry = None if len(below.parts) < 2 else _classify(
            below, answers, recitations, usma_prompts)
        if entry is None:
            continue
        fold, subcorpus, spk, utt_id, text = entry
        rec = Recording.from_file(wav, recording_id=utt_id)
        recs, sups = by_fold[fold]
        recs.append(rec)
        sups.append(
            SupervisionSegment(
                id=utt_id,
                recording_id=utt_id,
                start=0.0,
                duration=rec.duration,
                channel=0,
                text=text,
                language="Spanish",
                speaker=spk,
                custom={"subcorpus": subcorpus},
            )
        )

    manifests = {}
    for fold in FOLDS:
        if fold not in by_fold:
            continue
        recs, sups = by_fold[fold]
        manifests[fold] = finalize_manifests(
            recs, sups, output_dir=output_dir, prefix="heroico", part=fold)
    return manifests
