"""
GigaSpeech recipe (copied from ``lhotse_tpu/recipes/gigaspeech.py``): the
10,000-hour English ASR corpus of audiobooks, podcasts and YouTube,
distributed through the ``speechcolab`` SDK, which needs the corpus's
password. The SDK serves one JSON entry per audio file (``aid``, ``path``,
``sample_rate``, ``channels``, ``duration`` and ``segments[].{sid,
begin_time, end_time, speaker, text_tn}``); each part's recordings,
supervisions and cuts are written lazily, since the XL part is too large to
hold eagerly. ``parse_utterance`` needs no SDK. Without ``speechcolab``,
``prepare_gigaspeech`` raises ``ImportError``. The release's audio is Opus.
The download, which goes through the SDK, is not ported.
"""
import logging
from itertools import repeat
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from lhotse_tpu_torch.audio import AudioSource, Recording, RecordingSet
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.parallel import parallel_map
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.recipes.utils import manifests_exist, read_manifests_if_cached
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike, Seconds, compute_num_samples, is_module_available

GIGASPEECH_PARTS = ("XL", "L", "M", "S", "XS", "DEV", "TEST")


def _require_speechcolab():
    if not is_module_available("speechcolab"):
        raise ImportError(
            "To process the GigaSpeech corpus, please install the optional "
            "dependency: pip install speechcolab"
        )
    from speechcolab.datasets.gigaspeech import GigaSpeech

    return GigaSpeech


def parse_utterance(
        audio: Any, root_path: Path) -> Optional[Tuple[Recording, List[SupervisionSegment]]]:
    """One SDK JSON audio entry → (Recording, [SupervisionSegment])."""
    sampling_rate = int(audio["sample_rate"])
    recording = Recording(
        id=audio["aid"],
        sources=[AudioSource(type="file", channels=list(range(int(audio["channels"]))),
                             source=str(Path(root_path) / audio["path"]))],
        num_samples=compute_num_samples(duration=Seconds(audio["duration"]),
                                        sampling_rate=sampling_rate),
        sampling_rate=sampling_rate, duration=Seconds(audio["duration"]))
    segments = [
        SupervisionSegment(
            id=seg["sid"], recording_id=audio["aid"], start=Seconds(seg["begin_time"]),
            duration=round(Seconds(seg["end_time"] - seg["begin_time"]), ndigits=8),
            channel=0, language="English", speaker=seg["speaker"], text=seg["text_tn"])
        for seg in audio["segments"]
    ]
    return recording, segments


def prepare_gigaspeech(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike],
    dataset_parts: Union[str, Sequence[str]] = "auto", num_jobs: int = 1,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet, CutSet]]]:
    """Lazily written recordings, supervisions and cuts of each part
    (``"auto"``: XL, DEV and TEST). A part whose manifests exist is read
    back, cuts included, and not prepared again."""
    GigaSpeech = _require_speechcolab()
    subsets = ("XL", "DEV", "TEST") if dataset_parts == "auto" else dataset_parts
    if isinstance(subsets, str):
        subsets = [subsets]
    corpus_dir = Path(corpus_dir)
    gigaspeech = GigaSpeech(corpus_dir)

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    manifests = read_manifests_if_cached(
        dataset_parts=subsets, output_dir=output_dir, prefix="gigaspeech", suffix="jsonl.gz",
        types=("recordings", "supervisions", "cuts"), lazy=True)

    for part in subsets:
        logging.info(f"Processing GigaSpeech subset: {part}")
        if manifests_exist(part=part, output_dir=output_dir, prefix="gigaspeech",
                           suffix="jsonl.gz"):
            logging.info(f"GigaSpeech subset: {part} already prepared - skipping.")
            continue
        out_of = lambda kind: output_dir / f"gigaspeech_{kind}_{part}.jsonl.gz"  # noqa: E731
        with RecordingSet.open_writer(out_of("recordings")) as rec_writer, \
                SupervisionSet.open_writer(out_of("supervisions")) as sup_writer, \
                CutSet.open_writer(out_of("cuts")) as cut_writer:
            for recording, segments in parallel_map(
                    parse_utterance, gigaspeech.audios("{" + part + "}"),
                    repeat(gigaspeech.gigaspeech_dataset_dir), num_jobs=num_jobs):
                one_rec = RecordingSet.from_recordings([recording])
                one_rec, segments = fix_manifests(
                    recordings=one_rec, supervisions=SupervisionSet.from_segments(segments))
                validate_recordings_and_supervisions(recordings=one_rec, supervisions=segments)
                rec_writer.write(one_rec[0])
                for seg in segments:
                    sup_writer.write(seg)
                cuts = CutSet.from_manifests(recordings=one_rec, supervisions=segments)
                cut_writer.write(cuts[0])
        manifests[part] = {
            "recordings": RecordingSet.from_jsonl_lazy(rec_writer.path),
            "supervisions": SupervisionSet.from_jsonl_lazy(sup_writer.path),
            "cuts": CutSet.from_jsonl_lazy(cut_writer.path)}
    return dict(manifests)
