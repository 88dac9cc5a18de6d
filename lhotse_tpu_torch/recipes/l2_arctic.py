"""
L2-ARCTIC recipe (copied from ``lhotse_tpu/recipes/l2_arctic.py``):
non-native English read speech (24 speakers, 6 L1 backgrounds) plus the
spontaneous "suitcase corpus" (https://psi.engr.tamu.edu/l2-arctic-corpus/)::

    <SPK>/wav/arctic_*.wav + <SPK>/transcript/arctic_*.txt
    suitcase_corpus/{wav,transcript}/<spk>.{wav,txt}

Returned splits: "read" (the ARCTIC prompts) and "suitcase" (spontaneous).
Every ``*.txt`` under the corpus is read as a transcript, as in the JAX
package. The corpus is registration-gated, so there is no download.
"""
from os import makedirs
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

# speaker -> (gender, native language); from the corpus description table.
SPEAKERS = {
    "aba": ("M", "Arabic"), "ska": ("F", "Arabic"), "ybaa": ("M", "Arabic"),
    "zhaa": ("F", "Arabic"), "bwc": ("M", "Chinese"), "lxc": ("F", "Chinese"),
    "ncc": ("F", "Chinese"), "txhc": ("M", "Chinese"), "asi": ("M", "Hindi"),
    "rrbi": ("M", "Hindi"), "svbi": ("F", "Hindi"), "tni": ("F", "Hindi"), "hjk": ("F", "Korean"),
    "hkk": ("M", "Korean"), "ydck": ("F", "Korean"), "ykwk": ("M", "Korean"),
    "ebvs": ("M", "Spanish"), "erms": ("M", "Spanish"), "mbmps": ("F", "Spanish"),
    "njs": ("F", "Spanish"), "hqtv": ("M", "Vietnamese"), "pnv": ("F", "Vietnamese"),
    "thv": ("F", "Vietnamese"), "tlv": ("M", "Vietnamese")}

# Per-speaker (wav files, annotated files) counts from the corpus description.
_SPEAKER_COUNTS = {
    "aba": (1129, 150), "ska": (974, 150), "ybaa": (1130, 149), "zhaa": (1132, 150),
    "bwc": (1130, 150), "lxc": (1131, 150), "ncc": (1131, 150), "txhc": (1132, 150),
    "asi": (1131, 150), "rrbi": (1130, 150), "svbi": (1132, 150), "tni": (1131, 150),
    "hjk": (1131, 150), "hkk": (1131, 150), "ydck": (1131, 150), "ykwk": (1131, 150),
    "ebvs": (1007, 150), "erms": (1132, 150), "mbmps": (1132, 150), "njs": (1131, 150),
    "hqtv": (1132, 150), "pnv": (1132, 150), "thv": (1132, 150), "tlv": (1132, 150)}

# The ARPAbet phone vocabulary used by the corpus annotations:
# symbol -> (example word, example annotation, phone class).
PHONE_SET = {
    "AA": ("odd", "AA D", "vowel"), "AE": ("at", "AE T", "vowel"),
    "AH": ("hut", "HH AH T", "vowel"), "AO": ("ought", "AO T", "vowel"),
    "AW": ("cow", "K AW", "vowel"), "AX": ("discus", "D IH S K AX S", "vowel"),
    "AY": ("hide", "HH AY D", "vowel"), "B": ("be", "B IY", "stop"),
    "CH": ("cheese", "CH IY Z", "affricate"), "D": ("dee", "D IY", "stop"),
    "DH": ("thee", "DH IY", "fricative"), "EH": ("Ed", "EH D", "vowel"),
    "ER": ("hurt", "HH ER T", "vowel"), "EY": ("ate", "EY T", "vowel"),
    "F": ("fee", "F IY", "fricative"), "G": ("green", "G R IY N", "stop"),
    "HH": ("he", "HH IY", "aspirate"), "IH": ("it", "IH T", "vowel"),
    "IY": ("eat", "IY T", "vowel"), "JH": ("gee", "JH IY", "affricate"),
    "K": ("key", "K IY", "stop"), "L": ("lee", "L IY", "liquid"),
    "M": ("me", "M IY", "nasal"), "N": ("knee", "N IY", "nasal"),
    "NG": ("ping", "P IH NG", "nasal"), "OW": ("oat", "OW T", "vowel"),
    "OY": ("toy", "T OY", "vowel"), "P": ("pee", "P IY", "stop"),
    "R": ("read", "R IY D", "liquid"), "S": ("sea", "S IY", "fricative"),
    "SH": ("she", "SH IY", "fricative"), "T": ("tea", "T IY", "stop"),
    "TH": ("theta", "TH EY T AH", "fricative"), "UH": ("hood", "HH UH D", "vowel"),
    "UW": ("two", "T UW", "vowel"), "V": ("vee", "V IY", "fricative"),
    "W": ("we", "W IY", "semivowel"), "Y": ("yield", "Y IY L D", "semivowel"),
    "Z": ("zee", "Z IY", "fricative"), "ZH": ("seizure", "S IY ZH ER", "fricative")}


def _render_speaker_description() -> str:
    rows = ["", "|Speaker|Gender|Native Language|# Wav Files|# Annotations|",
            "|---|---|---|---|---|"]
    total_wav = total_ann = 0
    for spk, (gender, lang) in SPEAKERS.items():
        wav, ann = _SPEAKER_COUNTS[spk]
        total_wav += wav
        total_ann += ann
        rows.append(f"|{spk.upper()}|{gender}|{lang}|{wav}|{ann}|")
    rows.append(f"|**Total**|||**{total_wav}**|**{total_ann}**|")
    return "\n".join(rows)


def _render_phone_set_description() -> str:
    rows = ["", "|Index|ARPAbet|Example|Annotation|Type|", "|---|---|---|---|---|"]
    for i, (sym, (example, annot, cls)) in enumerate(PHONE_SET.items(), start=1):
        rows.append(f"|{i}|{sym}|{example}|{annot}|{cls}|")
    return "\n".join(rows)


# The corpus description's markdown tables, rendered from the structured
# facts above.
SPEAKER_DESCRIPTION = _render_speaker_description()
PHONE_SET_DESCRIPTION = _render_phone_set_description()


def _identify(path: Path):
    """A transcript/wav path -> (segment id, speaker)."""
    if "suitcase_corpus" in path.parts:
        spk = path.stem.lower()
        return f"suitcase_corpus-{spk}", spk
    spk = path.parent.parent.name.lower()
    return f"{spk}-{path.stem}", spk


def prepare_l2_arctic(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """L2-ARCTIC manifests split into "read" and "suitcase" parts."""
    corpus_dir = Path(corpus_dir)
    if not corpus_dir.is_dir():
        raise AssertionError(f"No such directory: {corpus_dir}")

    recordings = RecordingSet.from_recordings(
        Recording.from_file(wav, recording_id=_identify(wav)[0])
        for wav in corpus_dir.rglob("*.wav")
    )
    supervisions = []
    for txt in corpus_dir.rglob("*.txt"):
        seg_id, spk = _identify(txt)
        gender, native_lang = SPEAKERS[spk]
        supervisions.append(
            SupervisionSegment(
                id=seg_id,
                recording_id=seg_id,
                start=0,
                duration=recordings[seg_id].duration,
                text=txt.read_text().strip(),
                language="English",
                speaker=spk,
                gender=gender,
                custom={"accent": native_lang},
            )
        )
    supervisions = SupervisionSet.from_segments(supervisions)
    recordings, supervisions = fix_manifests(recordings, supervisions)
    validate_recordings_and_supervisions(recordings, supervisions)

    def subset(keep_suitcase: bool):
        pick = (lambda s: "suitcase_corpus" in s) if keep_suitcase else (
            lambda s: "suitcase_corpus" not in s
        )
        return {
            "recordings": recordings.filter(lambda r: pick(r.id)),
            "supervisions": supervisions.filter(lambda s: pick(s.recording_id))}

    splits = {"read": subset(False), "suitcase": subset(True)}
    if output_dir is not None:
        output_dir = Path(output_dir)
        makedirs(output_dir, exist_ok=True)
        for key, m in splits.items():
            m["recordings"].to_file(output_dir / f"l2-arctic_recordings_{key}.jsonl.gz")
            m["supervisions"].to_file(output_dir / f"l2-arctic_supervisions_{key}.jsonl.gz")
    return splits
