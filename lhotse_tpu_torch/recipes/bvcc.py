"""
BVCC recipe (copied from ``lhotse_tpu/recipes/bvcc.py``): the VoiceMOS
Challenge rating corpus, its main track (phase1-main) and out-of-domain
track (phase1-ood) with per-listener ratings
(https://arxiv.org/abs/2105.02373). The DEVSET and TRAINSET rating tables
are folded into one supervision per utterance carrying its ``MOS`` and
``listeners`` in ``custom``; the test and unlabeled parts are recordings
only. The corpus is downloaded by hand, so ``download_bvcc`` (which only
prints instructions) is not ported.
"""
import logging
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike


def parse_main_line(line: str):
    """Main-track rating rows: sysID,uttID,rating,ignore,listenerinfo."""
    sysid, uttid, rating, _ignore, listenerinfo = line.split(",")
    _, agerange, listenerid, listener_mf, _, _, haveimpairment = listenerinfo.split("_")
    assert listener_mf in ("Male", "Female", "Others"), listener_mf
    gender = {"Male": "M", "Female": "F", "Others": "O"}[listener_mf]
    assert haveimpairment in ("Yes", "No"), haveimpairment
    return (
        uttid, sysid, rating,
        {"id": listenerid, "M_F": gender, "impairment": haveimpairment == "Yes",
         "age": agerange})


def parse_ood_line(line: str):
    """OOD-track rating rows; listener type is EE/EP/ER."""
    sysid, uttid, rating, _ignore, listenerinfo = line.split(",")
    _, _, listenerid, _, _, _, listenertype = listenerinfo.split("_")
    assert listenertype in ("EE", "EP", "ER")
    return (uttid, sysid, rating, {"id": listenerid, "type": listenertype})


def segment_from_run(infos, recordings):
    """Collapse one utterance's rating rows into a single supervision."""
    mos, listeners = {}, {}
    uttid_ref, sysid_ref = None, None
    for uttid, sysid, rating, listenerd in infos:
        listenerid = listenerd.pop("id")
        mos[listenerid] = int(rating)
        listeners[listenerid] = listenerd
        if uttid_ref is None:
            uttid_ref, sysid_ref = uttid, sysid
        else:
            assert uttid == uttid_ref, f"{uttid} vs {uttid_ref}"
            assert sysid == sysid_ref, f"{sysid} vs {sysid_ref}"
    if uttid_ref is None:
        return
    assert mos and listeners
    if uttid_ref.endswith(".wav"):
        uttid_ref = uttid_ref[:-4]
    yield SupervisionSegment(
        id=uttid_ref, recording_id=uttid_ref, start=0,
        duration=recordings[uttid_ref].duration, text=None, language=None,
        speaker=None, custom={"MOS": mos, "listeners": listeners})


def gen_supervision_per_utt(lines, recordings, parse_line):
    prev_uttid, run = None, []
    for line in lines:
        info = parse_line(line.strip())
        if info[0] != prev_uttid:
            yield from segment_from_run(run, recordings)
            prev_uttid, run = info[0], [info]
        else:
            run.append(info)
    if run:
        yield from segment_from_run(run, recordings)


def _labeled_part(recordings: RecordingSet, ratings_path: Path, parse_line):
    sups = SupervisionSet.from_segments(
        gen_supervision_per_utt(
            sorted(ratings_path.read_text().splitlines()), recordings, parse_line))
    recs = recordings.filter(lambda rec: rec.id in sups)
    recs, sups = fix_manifests(recs, sups)
    validate_recordings_and_supervisions(recs, sups)
    return {"recordings": recs, "supervisions": sups}


def _listed_recordings(wav_dir: Path, list_path: Path):
    return {
        "recordings": RecordingSet.from_recordings(
            Recording.from_file(wav_dir / name.strip())
            for name in list_path.read_text().splitlines() if name.strip())}


def prepare_bvcc(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None, num_jobs: int = 1,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """main1/ood1 dev/train/test(/unlabeled) manifests."""
    corpus_dir = Path(corpus_dir)
    tracks = {}
    for track, parser in (("main", parse_main_line), ("ood", parse_ood_line)):
        root = (corpus_dir / f"phase1-{track}").resolve()
        assert root.exists(), f"{track} track dir is missing {root}"
        sets_dir = root / "DATA" / "sets"
        wav_dir = root / "DATA" / "wav"
        assert sets_dir.exists() and wav_dir.exists(), (
            f"Have you run data preparation in {root}?")
        tracks[track] = (sets_dir, wav_dir, parser)

    manifests = {}
    for track, (sets_dir, wav_dir, parser) in tracks.items():
        tag = f"{track}1"
        pool = RecordingSet.from_dir(wav_dir, pattern="*.wav", num_jobs=num_jobs)
        for split in ("dev", "train"):
            logging.info(f"Preparing {tag}_{split}")
            manifests[f"{tag}_{split}"] = _labeled_part(
                pool, sets_dir / f"{split.upper()}SET", parser)
        manifests[f"{tag}_test"] = _listed_recordings(wav_dir, sets_dir / "test.scp")
        if track == "ood":
            manifests["ood1_unlabeled"] = _listed_recordings(
                wav_dir, sets_dir / "unlabeled_mos_list.txt")

    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        for part, d in manifests.items():
            d["recordings"].to_file(output_dir / f"bvcc_recordings_{part}.jsonl.gz")
            if "supervisions" in d:
                d["supervisions"].to_file(output_dir / f"bvcc_supervisions_{part}.jsonl.gz")
    return manifests
