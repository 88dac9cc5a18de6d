"""
TIMIT recipe (LDC93S1; copied from ``lhotse_tpu/recipes/timit.py``):
phonetically transcribed read speech, 16 kHz, with word and phone
alignments.

TRAIN is ``data/TRAIN``; DEV and TEST are Kaldi's core splits of
``data/TEST`` by speaker. Each ``.WAV`` has a ``.TXT`` transcript and
``.WRD``/``.PHN`` alignments in samples, attached as "word" and "phone"
``AlignmentItem``s; the phones can be folded 60 → 48 or 60 → 39 as Kaldi's
TIMIT recipe does. The fold tables store only the mappings that are not
identities. ``download_timit`` is not ported: it needs the network.
"""
import logging
from collections import defaultdict
from concurrent.futures.thread import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.supervision import AlignmentItem, SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

# The 48-phone set's identity symbols + fold exceptions (Kaldi TIMIT s5).
_PHONES_48_IDENTITY = (
    "sil aa ae ah ao aw ax ay b ch d dh dx eh el en epi er ey f g hh ih ix "
    "iy jh k l m n ng ow oy p r s sh t th uh uw v w y z zh"
).split()
_FOLD_48 = {
    "ax-h": "ax", "axr": "er", "bcl": "vcl", "dcl": "vcl", "em": "m", "eng": "ng", "gcl": "vcl",
    "h#": "sil", "hv": "hh", "kcl": "cl", "nx": "n", "pau": "sil", "pcl": "cl", "q": "",
    "tcl": "cl", "ux": "uw"}
_PHONES_39_IDENTITY = (
    "sil aa ae ah aw ay b ch d dh dx eh er ey f g hh ih iy jh k l m n ng "
    "ow oy p r s sh t th uh uw v w y z"
).split()
_FOLD_39 = {
    "ao": "aa", "ax": "ah", "ax-h": "ah", "axr": "er", "bcl": "sil", "dcl": "sil", "el": "l",
    "em": "m", "en": "n", "eng": "ng", "epi": "sil", "gcl": "sil", "h#": "sil", "hv": "hh",
    "ix": "ih", "kcl": "sil", "nx": "n", "pau": "sil", "pcl": "sil", "q": "", "tcl": "sil",
    "ux": "uw", "zh": "sh"}


def get_phonemes(num_phones: int) -> Dict[str, str]:
    """60→{60,48,39} phone folding (identity for 60)."""
    if num_phones == 60:
        return {}
    if num_phones == 48:
        identity, fold = _PHONES_48_IDENTITY, _FOLD_48
    elif num_phones == 39:
        identity, fold = _PHONES_39_IDENTITY, _FOLD_39
    else:
        raise ValueError("The value of num_phones must be in [60, 48, 39].")
    phonemes = {p: p for p in identity}
    phonemes.update(fold)
    return phonemes


def get_speakers() -> Tuple[list, list]:
    """The Kaldi TIMIT dev/test core speaker lists."""
    test_spk = (
        "fdhc0 felc0 fjlm0 fmgd0 fmld0 fnlp0 fpas0 fpkt0 mbpm0 mcmj0 mdab0 "
        "mgrt0 mjdh0 mjln0 mjmp0 mklt0 mlll0 mlnt0 mnjm0 mpam0 mtas1 mtls0 "
        "mwbt0 mwew0"
    ).split()
    dev_spk = (
        "fadg0 faks0 fcal1 fcmh0 fdac1 fdms0 fdrw0 fedw0 fgjd0 fjem0 fjmg0 "
        "fjsj0 fkms0 fmah0 fmml0 fnmr0 frew0 fsem0 majc0 mbdg0 mbns0 mbwm0 "
        "mcsh0 mdlf0 mdls0 mdvc0 mers0 mgjf0 mglb0 mgwt0 mjar0 mjfc0 mjsw0 "
        "mmdb1 mmdm2 mmjr0 mmwh0 mpdf0 mrcs0 mreb0 mrjm4 mrjr0 mroa0 mrtk0 "
        "mrws1 mtaa0 mtdt0 mteb0 mthc0 mwjg0"
    ).split()
    return dev_spk, test_spk


def prepare_recording(
    wav_file: Pathlike, num_phones: int, phones_dict: Dict[str, str],
) -> Tuple[Recording, SupervisionSegment]:
    """One utterance: recording + supervision with word & phone alignments."""
    wav_file = Path(wav_file)
    speaker = wav_file.parent.name
    idx = f"{speaker}-{wav_file.stem}"
    recording = Recording.from_file(path=wav_file, recording_id=idx)
    sr = recording.sampling_rate

    # .TXT: "<start> <end> the transcript ..."
    text = " ".join(wav_file.with_suffix(".TXT").read_text().rstrip("\n").split(" ")[2:])

    word_alignments = []
    for line in wav_file.with_suffix(".WRD").read_text().splitlines():
        st, et, word = line.strip().split(" ")
        start, end = float(st) / sr, float(et) / sr
        word_alignments.append(AlignmentItem(word, start, end - start))

    phone_alignments = []
    for line in wav_file.with_suffix(".PHN").read_text().splitlines():
        st, et, phone = line.strip().split(" ")
        start, end = float(st) / sr, float(et) / sr
        if num_phones != 60:
            phone = phones_dict[phone]
        phone_alignments.append(AlignmentItem(phone, start, end - start))

    segment = SupervisionSegment(
        id=idx, recording_id=idx, start=0.0, duration=recording.duration, channel=0,
        language="English", speaker=speaker,
        gender="male" if speaker.lower().startswith("m") else "female", text=text.strip())
    segment = segment.with_alignment("word", word_alignments).with_alignment(
        "phone", phone_alignments)
    return recording, segment


def prepare_timit(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None, num_phones: int = 48,
    num_jobs: int = 1) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """
    Prepare TRAIN/DEV/TEST manifests (DEV/TEST = Kaldi core splits of the
    distribution's TEST portion by speaker).
    """
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
    phones_dict = get_phonemes(num_phones)
    dev_spks, test_spks = get_speakers()

    manifests = defaultdict(dict)
    for part in ("TRAIN", "DEV", "TEST"):
        if part == "TRAIN":
            wav_files = sorted(corpus_dir.glob("data/TRAIN/*/*/*.WAV"))
        else:
            spks = dev_spks if part == "DEV" else test_spks
            wav_files = sorted(
                p
                for p in corpus_dir.glob("data/TEST/*/*/*.WAV")
                if p.parent.name.lower() in spks
            )
        recordings, supervisions = [], []
        with ThreadPoolExecutor(max(num_jobs, 1)) as ex:
            futures = [ex.submit(prepare_recording, p, num_phones, phones_dict) for p in wav_files]
            for f in futures:
                try:
                    recording, supervision = f.result()
                    recordings.append(recording)
                    supervisions.append(supervision)
                except FileNotFoundError as e:
                    logging.warning(e.strerror)
        recording_set, supervision_set = fix_manifests(
            RecordingSet.from_recordings(recordings), SupervisionSet.from_segments(supervisions))
        validate_recordings_and_supervisions(recording_set, supervision_set)
        if output_dir is not None:
            recording_set.to_file(output_dir / f"timit_recordings_{part}.jsonl.gz")
            supervision_set.to_file(output_dir / f"timit_supervisions_{part}.jsonl.gz")
        manifests[part] = {"recordings": recording_set, "supervisions": supervision_set}
    return dict(manifests)
