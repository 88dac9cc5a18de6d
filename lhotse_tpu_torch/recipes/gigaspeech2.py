"""
GigaSpeech 2 recipe (copied from ``lhotse_tpu/recipes/gigaspeech2.py``): a
large ASR corpus of low-resource Southeast Asian languages (th, id, vi)
crawled and refined automatically (https://arxiv.org/abs/2406.11546). Each
``data/{lang}`` directory holds ``{part}.tsv`` tables of segment id and
text; a segment id names its audio's path (``0-1023-42`` lies at
``0/1023/0-1023-42.wav``), and train_raw and train_refined share the train
audio tree. The manifests are streamed into writers, so ``output_dir`` is
required, and returned lazily. It has no download.
"""
import logging
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.serialization import load_manifest
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

GIGASPEECH2_URL = "https://huggingface.co/datasets/speechcolab/gigaspeech2"
GIGASPEECH2_LANGS = ("th", "id", "vi")
GIGASPEECH2_SPLITS = ("train_raw", "train_refined", "dev", "test")


def _read_manifests_if_cached(
    output_dir: Optional[Path], language: str,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    if output_dir is None:
        return {}
    manifests = {}
    for part in GIGASPEECH2_SPLITS:
        found = {}
        for kind in ("recordings", "supervisions"):
            path = output_dir / f"gigaspeech2-{language}_{kind}_{part}.jsonl.gz"
            if path.is_file():
                found[kind] = load_manifest(path)
        if found:
            manifests[part] = found
    return manifests


def _parse_utterance(
    lang: str, part_dir: Path, audio_info: str,
) -> Optional[Tuple[Recording, SupervisionSegment]]:
    segment_id, text = audio_info.split("\t")
    # e.g. "0-1023-42" lives at part_dir/0/1023/0-1023-42.wav
    audio_path = (
        part_dir.joinpath(*segment_id.split("-")[:-1]) / f"{segment_id}.wav").resolve()
    if not audio_path.is_file():
        logging.warning(f"No such file: {audio_path}")
        return None
    recording = Recording.from_file(path=audio_path, recording_id=segment_id)
    segment = SupervisionSegment(
        id=segment_id, recording_id=segment_id, start=0.0,
        duration=recording.duration, channel=0, language=lang, text=text.strip())
    return recording, segment


def prepare_gigaspeech2(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
    languages: Union[str, Sequence[str]] = "auto", num_jobs: int = 1,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """Per-language, per-part lazy manifests off the tsv tables + wav trees."""
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    corpus_dir = corpus_dir / "data"
    if languages == "auto":
        languages = sorted(
            set(GIGASPEECH2_LANGS).intersection(p.name for p in corpus_dir.glob("*")))
        if not languages:
            raise ValueError(
                f"Could not find any of GigaSpeech 2 languages in: {corpus_dir}")
    elif isinstance(languages, str):
        languages = [languages]
    if output_dir is None:
        raise ValueError("prepare_gigaspeech2 requires output_dir (manifests are streamed).")
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    manifests = {}
    for lang in languages:
        logging.info(f"Language: {lang}")
        lang_dir = corpus_dir / lang
        lang_manifests = _read_manifests_if_cached(output_dir=output_dir, language=lang)
        for part in GIGASPEECH2_SPLITS:
            if part in lang_manifests:
                logging.info(f"GigaSpeech 2 {lang} {part} already prepared - skipping.")
                continue
            tsv_path = lang_dir / f"{part}.tsv"
            if not tsv_path.is_file():
                continue
            logging.info(f"Processing GigaSpeech 2 subset: {part}")
            part_dir = lang_dir / part.replace("_raw", "").replace("_refined", "")
            with RecordingSet.open_writer(
                    output_dir / f"gigaspeech2-{lang}_recordings_{part}.jsonl.gz"
                    ) as rec_writer, \
                    SupervisionSet.open_writer(
                        output_dir / f"gigaspeech2-{lang}_supervisions_{part}.jsonl.gz"
                    ) as sup_writer:
                for audio_info in tsv_path.read_text().splitlines():
                    if not audio_info.strip():
                        continue
                    result = _parse_utterance(lang, part_dir, audio_info)
                    if result is None:
                        continue
                    recording, segment = result
                    rec_writer.write(recording)
                    sup_writer.write(segment)
            lang_manifests[part] = {
                "recordings": RecordingSet.from_jsonl_lazy(rec_writer.path),
                "supervisions": SupervisionSet.from_jsonl_lazy(sup_writer.path)}
        manifests[lang] = lang_manifests
    return manifests
