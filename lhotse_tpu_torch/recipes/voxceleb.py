"""
VoxCeleb 1 and 2 recipe (copied from ``lhotse_tpu/recipes/voxceleb.py``):
speaker-verification corpora of interview clips (about 7,000 speakers).
The Kaldi-style train split is VoxCeleb2 and VoxCeleb1's dev part; the test
split is VoxCeleb1's test part, with positive and negative trial pairs from
the openslr-49 trials list.

VoxCeleb1 is 16 kHz WAV under ``wav/<speaker>/<session>/<utt>.wav`` with
``vox1_meta.csv``; ids are ``speaker-session-utt``, and the splits follow
the metadata's per-speaker ``Set`` column. VoxCeleb2 is AAC in ``.m4a``,
which only ``ffmpeg`` decodes. The trial pairs are two ``CutSet``s of equal
ids, for ``CutPairsSampler``. The downloads are not ported: they need the
network.
"""
import logging
from collections import defaultdict, namedtuple
from concurrent.futures.thread import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.cut import CutSet, MonoCut
from lhotse_tpu_torch.manipulation import combine
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

VOXCELEB1_TRIALS_URL = "http://www.openslr.org/resources/49/voxceleb1_test_v2.txt"

SpeakerMetadata = namedtuple("SpeakerMetadata", ["id", "name", "gender", "nationality", "split"])


def _process_file(
    file_path: Path, speaker_metadata: Dict[str, SpeakerMetadata],
) -> Tuple[Recording, SupervisionSegment]:
    speaker_id = file_path.parent.parent.stem
    session_id = file_path.parent.stem
    uttid = file_path.stem
    recording_id = f"{speaker_id}-{session_id}-{uttid}"
    recording = Recording.from_file(file_path, recording_id=recording_id)
    meta = speaker_metadata[speaker_id]
    supervision = SupervisionSegment(
        id=recording_id, recording_id=recording_id, speaker=speaker_id, gender=meta.gender,
        start=0.0, duration=recording.duration,
        custom={ "speaker_name": meta.name, "nationality": meta.nationality, "split": meta.split, })
    return recording, supervision


def _scan(corpus_path: Path, pattern: str, speaker_metadata, num_jobs: int):
    recordings, supervisions = [], []
    paths = sorted(corpus_path.rglob(pattern))
    with ThreadPoolExecutor(num_jobs) as ex:
        for rec, sup in ex.map(lambda p: _process_file(p, speaker_metadata), paths):
            recordings.append(rec)
            supervisions.append(sup)
    return (RecordingSet.from_recordings(recordings), SupervisionSet.from_segments(supervisions))


def _prepare_voxceleb_v1(corpus_path: Path, num_jobs: int):
    speaker_metadata = {}
    with open(corpus_path / "vox1_meta.csv") as f:
        next(f)
        for line in f:
            spkid, name, gender, nationality, split = line.strip().split("\t")
            speaker_metadata[spkid] = SpeakerMetadata(spkid, name, gender, nationality, split)
    recording_set, supervision_set = _scan(corpus_path / "wav", "*.wav", speaker_metadata, num_jobs)
    manifests = defaultdict(dict)
    for split in ("dev", "test"):
        sups = supervision_set.filter(lambda s: s.custom["split"] == split)
        split_ids = frozenset(s.recording_id for s in sups)
        manifests[split] = {
            "supervisions": sups, "recordings": recording_set.filter(lambda r: r.id in split_ids)}
    manifests["train"] = manifests.pop("dev")
    return manifests


def _prepare_voxceleb_v2(corpus_path: Path, num_jobs: int):
    speaker_metadata = {}
    with open(corpus_path / "vox2_meta.csv") as f:
        next(f)
        for line in f:
            spkid, _, gender, split = map(str.strip, line.split(","))
            speaker_metadata[spkid] = SpeakerMetadata(spkid, "", gender, "", split)
    recordings, supervisions = _scan(corpus_path, "*.m4a", speaker_metadata, num_jobs)
    return {"recordings": recordings, "supervisions": supervisions}


def _prepare_voxceleb_trials(
    manifests: Dict[str, Union[RecordingSet, SupervisionSet]],
    trials_path: Optional[Pathlike] = None) -> Dict[str, Tuple[CutSet, CutSet]]:
    """Build (utt1, utt2) CutSet pairs for positive and negative trials
    (sample them together with CutPairsSampler)."""
    recordings = manifests["recordings"]
    supervisions = manifests["supervisions"]
    if trials_path is None:
        # No implicit network fetch inside prepare (and no writes into the
        # caller's CWD): trials require an explicit local file.
        logging.info(
            "No trials_path provided - skipping VoxCeleb1 trial pairs. "
            f"Download {VOXCELEB1_TRIALS_URL} and pass trials_path to enable them."
        )
        return {}
    pairs = {"1": ([], []), "0": ([], [])}
    with open(trials_path) as f:
        for idx, line in enumerate(f):
            target, utt1, utt2 = line.strip().split(" ")
            # id10270/x6uYqmx31kE/00001.wav -> id10270-x6uYqmx31kE-00001
            utt1 = "-".join(utt1.split(".")[0].split("/"))
            utt2 = "-".join(utt2.split(".")[0].split("/"))
            if utt1 not in recordings or utt2 not in recordings:
                logging.warning(f"Trial {idx} contains unknown recording: {utt1} or {utt2}")
                continue
            for side, utt in zip(pairs[target], (utt1, utt2)):
                side.append(
                    MonoCut(
                        id=f"trial-{idx}",
                        recording=recordings[utt],
                        start=0,
                        duration=recordings[utt].duration,
                        supervisions=list(
                            supervisions.find(recording_id=utt)
                        ),
                        channel=0,
                    )
                )
    return {
        "pos_trials": tuple(CutSet.from_cuts(side) for side in pairs["1"]),
        "neg_trials": tuple(CutSet.from_cuts(side) for side in pairs["0"])}


def prepare_voxceleb(
    voxceleb1_root: Optional[Pathlike] = None, voxceleb2_root: Optional[Pathlike] = None,
    output_dir: Optional[Pathlike] = None, num_jobs: int = 1,
    trials_path: Optional[Pathlike] = None,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """
    Kaldi-style split: train = VoxCeleb2 (all) + VoxCeleb1 dev;
    test = VoxCeleb1 test. Pos/neg trial CutSet pairs are prepared only when
    ``trials_path`` points at a local copy of the VoxCeleb1 trials list
    (no implicit download).
    """
    voxceleb1_root = Path(voxceleb1_root) if voxceleb1_root else None
    voxceleb2_root = Path(voxceleb2_root) if voxceleb2_root else None
    if not (voxceleb1_root or voxceleb2_root):
        raise ValueError("Either VoxCeleb1 or VoxCeleb2 path must be provided.")
    output_dir = Path(output_dir) if output_dir is not None else None

    manifests = defaultdict(dict)
    if voxceleb1_root:
        logging.info("Preparing VoxCeleb1...")
        manifests.update(_prepare_voxceleb_v1(voxceleb1_root, num_jobs))
        manifests.update(_prepare_voxceleb_trials(manifests["test"], trials_path=trials_path))
    else:
        logging.info("VoxCeleb1 not provided; no test split or trials will be created.")
    if voxceleb2_root:
        logging.info("Preparing VoxCeleb2...")
        v2 = _prepare_voxceleb_v2(voxceleb2_root, num_jobs)
        if "train" in manifests:
            manifests["train"] = {
                "recordings": combine( manifests["train"]["recordings"], v2["recordings"] ),
                "supervisions": combine( manifests["train"]["supervisions"], v2["supervisions"] )}
        else:
            manifests["train"] = v2

    for split in ("train", "test"):
        if split not in manifests:
            continue
        recordings, supervisions = fix_manifests(
            manifests[split]["recordings"], manifests[split]["supervisions"])
        validate_recordings_and_supervisions(recordings, supervisions)
        manifests[split] = {"recordings": recordings, "supervisions": supervisions}
        if output_dir is not None:
            output_dir.mkdir(parents=True, exist_ok=True)
            recordings.to_file(output_dir / f"voxceleb_recordings_{split}.jsonl.gz")
            supervisions.to_file(output_dir / f"voxceleb_supervisions_{split}.jsonl.gz")
    if output_dir is not None:
        for kind in ("pos_trials", "neg_trials"):
            for i, cuts in enumerate(manifests.get(kind, ())):
                cuts.to_file(output_dir / f"voxceleb_{kind.replace('_', '-')}_utt{i + 1}.jsonl.gz")
    return dict(manifests)
