"""
SPGISpeech recipe (copied from ``lhotse_tpu/recipes/spgispeech.py``): 5,000
hours of transcribed financial calls, 16 kHz WAV, behind a request form.

Each split has a ``|``-separated CSV (``wav_filename|wav_filesize|
transcript``) and its audio under ``<split>/<doc-hash>/<n>.wav``. The
manifests are written as they are made, so that the corpus is never held
in memory; the optional normalization is ESPnet's (punctuation stripped,
lowercase). ``download_spgispeech`` is not ported: it only points at the
form.
"""
import logging
import string
from pathlib import Path
from typing import Dict, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.parallel import parallel_map
from lhotse_tpu_torch.recipes.utils import manifests_exist, read_manifests_if_cached
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike


def normalize(text: str) -> str:
    """ESPNet-style: strip punctuation, lowercase."""
    return text.translate(str.maketrans("", "", string.punctuation)).lower()


def _audio_read_worker(p: Path) -> Recording:
    return Recording.from_file(p, recording_id=f"{p.parent.stem}_{p.stem}")


def prepare_spgispeech(
    corpus_dir: Pathlike, output_dir: Pathlike, normalize_text: bool = True, num_jobs: int = 1,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """
    Prepare train/val manifests, written lazily (output_dir is required:
    the corpus is too large to hold eagerly).
    """
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    audio_dir = (corpus_dir if (corpus_dir / "train").is_dir() else corpus_dir / "spgispeech")
    dataset_parts = ["train", "val"]
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    manifests = read_manifests_if_cached(
        dataset_parts=dataset_parts, output_dir=output_dir, prefix="spgispeech", suffix="jsonl.gz",
        lazy=True)

    for part in dataset_parts:
        logging.info(f"Processing SPGISpeech subset: {part}")
        if manifests_exist(
            part=part, output_dir=output_dir, prefix="spgispeech", suffix="jsonl.gz"):
            logging.info(f"SPGISpeech subset: {part} already prepared - skipping.")
            continue
        durations = {}
        with RecordingSet.open_writer(
            output_dir / f"spgispeech_recordings_{part}.jsonl.gz"
        ) as rec_writer:
            for recording in parallel_map(
                _audio_read_worker, sorted((audio_dir / part).rglob("*.wav")), num_jobs=num_jobs):
                durations[recording.id] = recording.duration
                rec_writer.write(recording)

        with SupervisionSet.open_writer(
            output_dir / f"spgispeech_supervisions_{part}.jsonl.gz"
        ) as sup_writer, open(corpus_dir / f"{part}.csv") as f:
            next(f)  # header
            for line in f:
                fields = line.strip().split("|")
                # 07a785e9.../1.wav -> 07a785e9..._1
                recording_id = fields[0].replace("/", "_").replace(".wav", "")
                if recording_id not in durations:
                    logging.warning(f"No audio for utterance: {recording_id}")
                    continue
                text = fields[2]
                if normalize_text:
                    text = normalize(text)
                sup_writer.write(
                    SupervisionSegment(
                        id=recording_id,
                        recording_id=recording_id,
                        text=text,
                        speaker=recording_id.split("_")[0],
                        start=0,
                        duration=durations[recording_id],
                        language="English",
                    )
                )
        manifests[part] = {
            "recordings": RecordingSet.from_jsonl_lazy(rec_writer.path),
            "supervisions": SupervisionSet.from_jsonl_lazy(sup_writer.path)}
    return manifests
