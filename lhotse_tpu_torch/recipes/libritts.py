"""
LibriTTS and LibriTTS-R recipe (openslr/60 and /141; copied from
``lhotse_tpu/recipes/libritts.py``): the 24 kHz TTS corpus derived from
LibriSpeech, with original and normalized texts and per-utterance SNR.

Each chapter holds ``*.trans.tsv`` (id, original text, normalized text) and
``*.book.tsv`` (its last column the SNR); ``SPEAKERS.txt`` maps speakers to
genders; supervisions can link each utterance to the previous one of its
chapter. LibriTTS-R has the same layout, so ``prepare_librittsr`` is
``prepare_libritts``. ``download_libritts`` and ``download_librittsr`` are
not ported: they need the network.
"""
import logging
import re
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.recipes.utils import manifests_exist, read_manifests_if_cached
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

LIBRITTS = (
    "dev-clean", "dev-other", "test-clean", "test-other", "train-clean-100", "train-clean-360",
    "train-other-500")


def _read_speakers(corpus_dir: Path) -> Dict[str, str]:
    """SPEAKERS.txt: ';'-commented, '|'-separated (id | gender | subset...)."""
    path = corpus_dir / "SPEAKERS.txt"
    if not path.is_file():
        return {}
    out = {}
    for line in path.read_text().splitlines():
        if line.startswith(";"):
            continue
        fields = line.split("|")
        if len(fields) >= 2:
            out[fields[0].strip()] = fields[1].strip()
    return out


def prepare_libritts(
    corpus_dir: Pathlike, dataset_parts: Union[str, Sequence[str]] = "all",
    output_dir: Optional[Pathlike] = None, num_jobs: int = 1, link_previous_utt: bool = False,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """
    Prepare per-split manifests; supervisions carry the normalized text as
    ``text`` and the original text + SNR (and, optionally, the previous
    utterance id for chain reconstruction) in ``custom``.
    """
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    if dataset_parts == "all" or dataset_parts[0] == "all":
        dataset_parts = LIBRITTS
    elif isinstance(dataset_parts, str):
        assert dataset_parts in LIBRITTS
        dataset_parts = [dataset_parts]

    manifests = {}
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        manifests = read_manifests_if_cached(
            dataset_parts=dataset_parts, output_dir=output_dir, prefix="libritts")

    spk2gender = _read_speakers(corpus_dir)

    for part in dataset_parts:
        if manifests_exist(part=part, output_dir=output_dir, prefix="libritts"):
            logging.info(f"LibriTTS subset: {part} already prepared - skipping.")
            continue
        part_path = corpus_dir / part
        # Skip macOS resource forks and the known-corrupted file.
        recordings = RecordingSet.from_dir(
            part_path, "*.wav", num_jobs=num_jobs,
            exclude_pattern=r"^(\._.+|1092_134562_000013_000004\.wav)$")
        supervisions = []
        for trans_path in sorted(part_path.rglob("*.trans.tsv")):
            if re.match(r"^\._.+$", trans_path.name):
                continue
            book_path = trans_path.parent / trans_path.name.replace(".trans.tsv", ".book.tsv")
            utt2snr = {}
            uttids = []
            if book_path.is_file():
                for fields in map(str.split, book_path.read_text().splitlines()):
                    if len(fields) >= 2:
                        uttids.append(fields[0])
                        utt2snr[fields[0]] = float(fields[-1])
            utt2prevutt = (dict(zip(uttids + [None], [None] + uttids)) if link_previous_utt else {})

            prev_rec_id = None
            for line in trans_path.read_text().splitlines():
                rec_id, orig_text, norm_text = line.split("\t")
                if rec_id not in recordings:
                    logging.warning(
                        f"No recording exists for utterance id {rec_id}, "
                        f"skipping (in {trans_path})"
                    )
                    continue
                spk_id = rec_id.split("_")[0]
                customd = {"orig_text": orig_text, "snr": utt2snr.get(rec_id)}
                if link_previous_utt:
                    prev_utt = utt2prevutt.get(rec_id)
                    customd["prev_utt"] = (prev_utt if prev_utt == prev_rec_id else None)
                    prev_rec_id = rec_id
                supervisions.append(
                    SupervisionSegment(
                        id=rec_id,
                        recording_id=rec_id,
                        start=0.0,
                        duration=recordings[rec_id].duration,
                        channel=0,
                        language="English",
                        text=norm_text,
                        speaker=spk_id,
                        gender=spk2gender.get(spk_id),
                        custom=customd,
                    )
                )

        recordings, supervisions = fix_manifests(
            recordings, SupervisionSet.from_segments(supervisions))
        validate_recordings_and_supervisions(recordings, supervisions)
        if output_dir is not None:
            for kind, manifest in (("recordings", recordings), ("supervisions", supervisions)):
                manifest.to_file(output_dir / f"libritts_{kind}_{part}.jsonl.gz")
        manifests[part] = {"recordings": recordings, "supervisions": supervisions}
    return manifests


prepare_librittsr = prepare_libritts
