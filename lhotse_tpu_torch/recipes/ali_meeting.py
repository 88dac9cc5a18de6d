"""
AliMeeting (the M2MeT challenge; copied from
``lhotse_tpu/recipes/ali_meeting.py``): Mandarin meetings recorded with an
8-microphone circular array ("far") and per-speaker headsets ("near").

Layout::

    {Train,Eval,Test}_Ali_{far,near}/
      audio_dir/R####_M####*.wav
      textgrid_dir/R####_M####*.TextGrid
    (Eval/Test may nest under Eval_Ali/ / Test_Ali/)

Near-field file names carry gender and speaker (R0003_M0046_F_SPK0093);
far-field speaker identities live in the TextGrid tier names. With
``save_mono`` (sdm), channel 0 is written as mono WAV by the ``sox``
binary, as in the JAX package; where ``sox`` is missing that call fails.
``download_ali_meeting`` is not ported: it needs the network.
"""
import logging
import re
import subprocess
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.recipes.textgrid import read_textgrid
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

_FULLWIDTH = str.maketrans(
    {"Ａ": "A", "ａ": "A", "ｂ": "B", "ｃ": "C", "ｋ": "K", "ｔ": "T",
     "，": "", "丶": "", "。": "", "、": "", "？": ""}
)
_TAGS = ("<sil>", "<%>", "<->", "<$>", "<#>", "<_>", "<space>", "`", "&", ",")


def normalize_text_alimeeting(text: str, normalize: str = "m2met") -> str:
    """M2MeT-baseline text normalization."""
    if normalize == "none":
        return text
    if normalize != "m2met":
        raise ValueError(f"Unknown AliMeeting normalization mode: {normalize}")
    for tag in _TAGS:
        text = text.replace(tag, "")
    text = text.translate(_FULLWIDTH)
    if re.search("[a-zA-Z]", text):
        text = text.upper()
    return text


def _far_tier_identity(tier_name: str):
    pieces = tier_name.split("_")
    if len(pieces) == 4:
        _, _, gender, spk = pieces
    elif len(pieces) == 2:
        gender, spk = pieces
    else:
        raise ValueError(f"Unrecognized AliMeeting tier name: {tier_name}")
    return gender, spk[3:]  # SPK1953 -> 1953


def prepare_ali_meeting(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None, mic: Optional[str] = "far",
    normalize_text: str = "none", save_mono: bool = False,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """
    AliMeeting manifests per split (train/eval/test).

    :param mic: "near"/"ihm" (headsets), "far"/"mdm" (8ch array), or "sdm"
        (array audio, channel 0 supervisions).
    :param normalize_text: "none" or "m2met".
    :param save_mono: with sdm, extract channel 0 into mono wav files under
        ``output_dir`` (sox) so later feature jobs skip the 8ch read.
    """
    mic_orig = mic
    field = "near" if mic in ("ihm", "near") else "far"
    if save_mono and mic_orig != "sdm":
        logging.warning("save_mono only applies to mic='sdm'; ignoring.")
        save_mono = False
    if save_mono and not output_dir:
        raise ValueError("save_mono=True requires output_dir.")
    corpus_dir = Path(corpus_dir)
    if not corpus_dir.is_dir():
        raise AssertionError(f"No such directory: {corpus_dir}")
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)

    manifests = defaultdict(dict)
    for part in ("Train", "Eval", "Test"):
        split_root = corpus_dir
        if part in ("Eval", "Test") and (corpus_dir / f"{part}_Ali").is_dir():
            split_root = corpus_dir / f"{part}_Ali"
        wav_dir = split_root / f"{part}_Ali_{field}" / "audio_dir"
        tg_dir = split_root / f"{part}_Ali_{field}" / "textgrid_dir"

        recordings, supervisions = [], []
        for tg_path in sorted(tg_dir.rglob("*.TextGrid")):
            session = tg_path.stem
            try:
                tiers = read_textgrid(tg_path)
            except ValueError:
                logging.warning(f"{session} has annotation issues; skipping.")
                continue
            wav_path = sorted(wav_dir.rglob(f"{session}*.wav"))[0]
            if save_mono:
                mono_dir = output_dir / "alimeeting_sdm" / part
                mono_dir.mkdir(parents=True, exist_ok=True)
                mono_path = mono_dir / wav_path.name
                if not mono_path.is_file():
                    subprocess.run(f"sox {wav_path} -c 1 {mono_path}", shell=True, check=True)
                wav_path = mono_path
            rec = Recording.from_file(wav_path, recording_id=session)
            recordings.append(rec)

            if field == "near":
                _, _, gender, spk_tag = session.split("_")
                near_identity = (gender, spk_tag[3:])
            for tier in tiers:
                gender, spk = (near_identity if field == "near" else _far_tier_identity(tier.name))
                for k, iv in enumerate(tier.intervals):
                    if not iv.mark:
                        continue
                    supervisions.append(
                        SupervisionSegment(
                            id=f"{session}-{spk}-{k}",
                            recording_id=rec.id,
                            start=iv.minTime,
                            duration=round(iv.maxTime - iv.minTime, 4),
                            channel=(
                                0 if mic_orig in ("near", "ihm", "sdm") else list(range(8))
                            ),
                            language="Chinese",
                            speaker=spk,
                            gender=gender,
                            text=normalize_text_alimeeting(
                                iv.mark.strip(), normalize=normalize_text
                            ),
                        )
                    )

        if not recordings:
            logging.warning(f"AliMeeting {part} split has no sessions; skipping.")
            continue
        rec_set, sup_set = fix_manifests(
            RecordingSet.from_recordings(recordings), SupervisionSet.from_segments(supervisions))
        validate_recordings_and_supervisions(rec_set, sup_set)
        if output_dir is not None:
            sup_set.to_file(
                output_dir / f"alimeeting-{mic_orig}_supervisions_{part.lower()}.jsonl.gz"
            )
            rec_set.to_file(
                output_dir / f"alimeeting-{mic_orig}_recordings_{part.lower()}.jsonl.gz"
            )
        manifests[part.lower()] = {"recordings": rec_set, "supervisions": sup_set}
    return dict(manifests)
