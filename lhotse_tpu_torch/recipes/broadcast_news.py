"""
1997 English Broadcast News (Hub-4) recipe (copied from
``lhotse_tpu/recipes/broadcast_news.py``): TV and radio news audio in
16 kHz SPHERE (LDC98S71) with SGML transcripts (LDC98T28). It makes
recordings and two supervision layers: topic ``sections`` and speaker-turn
``segments``, whose text is split at the ``<time sec=...>`` markers with
the turn's end time closing the last window. The SGML is parsed with a
small ``html.parser`` state machine, with a latin-1 fallback.
"""
import logging
from html.parser import HTMLParser
from itertools import chain
from pathlib import Path
from typing import Dict, List, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.recipes.utils import finalize_manifests
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike, check_and_rglob

# Transcript-line prefixes the reference drops when splitting turn text
# (reference: broadcast_news.py:29). Our SGML state machine never surfaces
# these markup lines as text, so the list exists for compatibility with code
# that imported it to post-filter transcripts.
EXCLUDE_BEGINNINGS = ["</time", "<overlap", "</overlap"]


class _Hub4Sgml(HTMLParser):
    """Collects (episode, sections[turns[time-marked text]]) off HUB4 SGML."""

    def __init__(self):
        super().__init__(convert_charrefs=True)
        self.episode = {}
        self.sections = []
        self._turn = None

    def handle_starttag(self, tag, attrs):
        attrs = dict(attrs)
        if tag == "episode":
            self.episode = attrs
        elif tag == "section":
            self.sections.append({"attrs": attrs, "turns": []})
        elif tag == "turn" and self.sections:
            self._turn = {"attrs": attrs, "times": [], "texts": []}
            self.sections[-1]["turns"].append(self._turn)
        elif tag == "time" and self._turn is not None:
            self._turn["times"].append(float(attrs["sec"]))
            self._turn["texts"].append([])

    def handle_endtag(self, tag):
        if tag == "turn":
            self._turn = None

    def handle_data(self, data):
        if self._turn is not None and self._turn["texts"]:
            self._turn["texts"][-1].append(data)


def _parse_sgml(sgml_path: Path) -> _Hub4Sgml:
    try:
        text = sgml_path.read_text()
    except UnicodeDecodeError:
        text = sgml_path.read_text(encoding="latin-1")
    parser = _Hub4Sgml()
    parser.feed(text)
    return parser


def make_supervisions(
    sgml_path: Pathlike, recording: Recording) -> Dict[str, List[SupervisionSegment]]:
    """Section + segment supervisions for one HUB4 recording."""
    doc = _parse_sgml(Path(sgml_path))
    language = doc.episode.get("language")
    section_sups, segment_sups = [], []
    text_idx = 0
    for sec_idx, section in enumerate(doc.sections):
        sec_attrs = section["attrs"]
        sec_start = float(sec_attrs["starttime"])
        section_sups.append(
            SupervisionSegment(
                id=f"{recording.id}_section{sec_idx:03d}", recording_id=recording.id,
                start=sec_start,
                duration=round(float(sec_attrs["endtime"]) - sec_start, ndigits=3),
                channel=0, language=language,
                custom={
                    "section": sec_attrs.get("type"),
                    "program": doc.episode.get("program")}))
        for turn in section["turns"]:
            if not turn["times"]:
                continue
            bounds = turn["times"] + [float(turn["attrs"]["endtime"])]
            for (start, end), pieces in zip(zip(bounds, bounds[1:]), turn["texts"]):
                text = " ".join(" ".join(pieces).split())
                if not text:
                    continue
                segment_sups.append(
                    SupervisionSegment(
                        id=f"{recording.id}_segment{text_idx:04d}",
                        recording_id=recording.id, start=start,
                        duration=round(end - start, ndigits=8), channel=0,
                        language=language, text=text,
                        speaker=turn["attrs"].get("speaker"),
                        gender=turn["attrs"].get("spkrtype")))
                text_idx += 1
    return {"sections": section_sups, "segments": segment_sups}


def prepare_broadcast_news(
    audio_dir: Pathlike, transcripts_dir: Pathlike, output_dir: Optional[Pathlike] = None,
    absolute_paths: bool = False) -> Dict[str, Union[RecordingSet, SupervisionSet]]:
    """Manifests keyed ``{'recordings', 'sections', 'segments'}``."""
    audio_paths = check_and_rglob(audio_dir, "*.sph")
    sgml_paths = check_and_rglob(transcripts_dir, "*.sgml")
    recordings = RecordingSet.from_recordings(
        Recording.from_file(p, relative_path_depth=None if absolute_paths else 3)
        for p in audio_paths)
    logging.info(f"Parsing {len(sgml_paths)} HUB4 SGML transcripts")
    sups = [make_supervisions(p, r) for p, r in zip(sgml_paths, recordings)]
    sections = SupervisionSet.from_segments(
        chain.from_iterable(s["sections"] for s in sups))
    segments = SupervisionSet.from_segments(
        chain.from_iterable(s["segments"] for s in sups))
    fixed = finalize_manifests(recordings, segments)
    recordings, segments = fixed["recordings"], fixed["supervisions"]
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        recordings.to_file(output_dir / "broadcast-news_recordings_all.jsonl.gz")
        sections.to_file(output_dir / "broadcast-news_sections_all.jsonl.gz")
        segments.to_file(output_dir / "broadcast-news_segments_all.jsonl.gz")
    return {"recordings": recordings, "sections": sections, "segments": segments}
