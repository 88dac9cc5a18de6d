"""
SBCSAE recipe (copied from ``lhotse_tpu/recipes/sbcsae.py``): the Santa
Barbara Corpus of Spoken American English (openslr 155), naturally
occurring conversation from across the United States, in the layout of the
unpacked release::

    WAV/SBC<nnn>.wav                       # mono or stereo
    TRN/SBC<nnn>.trn                       # latin-1, DT-style transcripts
    docs/Part_{1,2,3,4}/{segment,speaker}.tbl

Transcripts lose their discourse markup (laughter becomes ``<LAUGH>``,
unintelligible words ``<UNK>``, code-switching is tagged through the
language of each supervision) and get the per-recording errata fixes of the
reference recipe, which are kept as a data table. Speakers are mapped to
the corpus's global ids through the doc tables; a speaker the tables lack
gets a fresh id (0214 onward) that depends only on the corpus, not on
earlier calls. This port prepares the local path only: the published STM
realignments and the speakers' geolocation need the network and raise
``NotImplementedError`` naming the URL. The download is not ported.
"""
import logging
import re
from copy import deepcopy
from dataclasses import dataclass
from math import inf
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.qa import fix_manifests
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike, fastcopy, is_module_available

# What the JAX package fetches: the published realignments, and the
# geocoder it asks for the speakers' home towns.
STM_URLS = {
    kind: "https://raw.githubusercontent.com/domklement/SBCSAE_alignments/main/alignments/stm/"
          f"aligned_for_{kind}.stm" for kind in ("asr", "diar")}
NOMINATIM_URL = "https://nominatim.openstreetmap.org"

# Languages of consecutive <L2 ...> spans, per recording (corpus annotation).
LANG_SEQUENCES = {
    "SBC004": ["Spanish"] * 17,
    "SBC006": ["French"] * 2,
    "SBC010": ["Spanish"],
    "SBC012": ["Greek"] * 2,
    "SBC015": ["Spanish"] * 10,
    "SBC025": ["German"] * 2 + ["Latin"],
    "SBC027": ["Spanish"] * 6 + ["French"] * 2,
    "SBC031": ["French"] * 2,
    "SBC033": ["French"],
    "SBC034": ["French"] * 3,
    "SBC036": ["Spanish"] * 36,
    "SBC037": ["Spanish"] * 60,
    "SBC047": ["Spanish"],
    "SBC057": ["Japanese"] * 62,
    "SBC058": ["Spanish"] + ["Italian"] * 2}

# These recordings have unusable second channels.
bad_stereo = ["SBC020", "SBC021", "SBC027", "SBC028"]

# Generic speaker labels that stay unmapped.
_UNMAPPED_SPEAKERS = [
    "SBC006_ALL", "SBC008_ALL", "SBC012_MANY", "SBC020_AUD", "SBC021_MANY",
    "SBC023_MANY", "SBC025_AUD", "SBC026_AUD", "SBC027_MANY", "SBC027_AUD",
    "SBC028_BOTH", "SBC030_AUD", "SBC038_AUD", "SBC053_RADIO", "SBC054_AUD",
    "SBC054_MANY", "SBC055_AUD"]


class _DummySpkIterator:
    """Allocates fresh global speaker ids for unmapped transcript speakers:
    0214, 0215, ... in the order they are met. ``prepare_sbcsae`` makes one
    per call, so the ids do not depend on earlier calls in the process."""

    def __init__(self):
        self.ind = 213

    def next(self, spk: str = "SBCXXX_X") -> str:
        self.ind += 1
        name = "_".join(spk.split("_")[1:])
        if name.startswith("X") or name.startswith("AUD"):
            name = "UNK"
        return f"{self.ind:04d}_{name}"


def prepare_sbcsae(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
    geolocation: Optional[bool] = False, omit_realignments: Optional[bool] = False,
) -> Dict[str, Union[RecordingSet, SupervisionSet]]:
    """Recordings and normalized supervisions, written as
    ``sbcsae_{recordings,supervisions}.jsonl.gz``. A supervision under 20
    ms is made to start 10 ms earlier and last 20 ms, within the recording. A mono
    recording, or one of ``bad_stereo``, gives channel 0; a stereo one
    ``[0, 1]``. The published STM realignments (``omit_realignments=False``,
    the default) and the speakers' home towns (``geolocation=True``) are
    fetched from the network in the JAX package; here they raise
    ``NotImplementedError`` naming the URL, the realignments after the
    manifests are written."""
    corpus_dir = Path(corpus_dir)
    output_dir = Path(output_dir) if output_dir is not None else None

    audio_dir = corpus_dir / "WAV"
    recordings = RecordingSet.from_recordings(
        Recording.from_file(p) for p in sorted(audio_dir.glob("*.wav")))
    if len(recordings) == 0:
        logging.warning(f"No .wav files found in {audio_dir}")

    spk2gen_dict, spk2glob_dict = generate_speaker_map_dicts(corpus_dir / "docs")
    if geolocation:
        generate_geolocations(corpus_dir, spk2glob_dict)

    supervisions = []
    trn_dir = corpus_dir / "TRN"
    spk_iterator = _DummySpkIterator()
    for p in sorted(trn_dir.glob("*.trn")):
        supervisions.extend(
            _filename_to_supervisions(p, spk2gen_dict, spk2glob_dict, spk_iterator))
    if not supervisions:
        logging.warning(f"No supervisions found in {trn_dir}")

    adjusted = []
    for s in supervisions:
        if s.duration < 0.02:
            # Pad ultra-short segments to 20 ms (clipped to the recording).
            # The JAX package passes the end time, min(new_start + 0.02,
            # recording duration), as the duration.
            s_reco = recordings[s.recording_id]
            new_start = max(0, s.start - 0.01)
            s = fastcopy(s, start=new_start, duration=min(0.02, s_reco.duration - new_start))
        reco_channels = recordings[s.recording_id].channel_ids
        if (not isinstance(reco_channels, list) or len(reco_channels) < 2
                or s.recording_id in bad_stereo):
            s.channel = reco_channels[0]
        adjusted.append(s)
    supervisions = SupervisionSet.from_segments(adjusted)
    recordings, supervisions = fix_manifests(recordings, supervisions)

    if output_dir is not None:
        output_dir.mkdir(parents=True, exist_ok=True)
        recordings.to_file(output_dir / "sbcsae_recordings.jsonl.gz")
        supervisions.to_file(output_dir / "sbcsae_supervisions.jsonl.gz")
    manifests = {"recordings": recordings, "supervisions": supervisions}

    if not omit_realignments:
        asr_sup, diar_sup = apply_aligned_stms(list(recordings.ids), supervisions)
        _, asr_sup = fix_manifests(recordings, asr_sup)
        _, diar_sup = fix_manifests(recordings, diar_sup)
        if output_dir is not None:
            asr_sup.to_file(output_dir / "sbcsae_supervisions_asr_aligned.jsonl.gz")
            diar_sup.to_file(output_dir / "sbcsae_supervisions_diar_aligned.jsonl.gz")
        manifests = {
            "asr_supervisions": asr_sup, "diar_supervisions": diar_sup, **manifests}
    return manifests


def generate_geolocations(corpus: Path, spk2glob_dict: dict) -> Dict:
    """Hometown coordinates per speaker, which the JAX package looks up in
    OpenStreetMap's Nominatim geocoder."""
    raise NotImplementedError(
        f"SBCSAE geolocation looks the speakers' home towns up at {NOMINATIM_URL}; "
        "lhotse_tpu_torch does not fetch it.")


def generate_speaker_map_dicts(doc_dir: Path) -> Tuple[dict, dict]:
    """(speaker -> gender, speaker -> global id) off the doc tables."""
    spk2gen_dict, spk2glob_dict = {}, {}

    # Parts 1/2/4: link per-recording speaker labels to global ids via tables.
    spk_num_to_reco_ids = {}
    for part in ("Part_1", "Part_2", "Part_4"):
        for line in (doc_dir / part / "segment.tbl").read_text().split("\n"):
            if "speaker:" not in line:
                continue
            line = line.replace(" 0", "\t0")
            reco_id = re.sub(r"sbc0?([0-9]{3})\s.*", r"SBC\1", line)
            spk_num = line.split("\t")[-1][:4]
            spk_num_to_reco_ids.setdefault(spk_num, [])
            if reco_id not in spk_num_to_reco_ids[spk_num]:
                spk_num_to_reco_ids[spk_num].append(reco_id)
    for part in ("Part_1", "Part_2", "Part_4"):
        for line in (doc_dir / part / "speaker.tbl").read_text().split("\n"):
            if "," not in line:
                continue
            line = line.replace("0163,Dan,m", "0166,Dan,M")
            spk_num, name, gen = line.split(",")[:3]
            name = name.replace(" (extra-corpus)", "").upper().split(" ")[-1].split("/")[0]
            gen = gen.upper() or None
            if spk_num in ("0069", "0091", "0092", "0097"):
                continue
            for reco in spk_num_to_reco_ids[spk_num]:
                spk2gen_dict[f"{reco}_{name}"] = gen
                spk2glob_dict[f"{reco}_{name}"] = f"{spk_num}_{name}"

    # Part 3 pairs the two tables row-by-row.
    seg_list, spk_list = [], []
    for line in (doc_dir / "Part_3" / "segment.tbl").read_text().split("\n"):
        if "speaker:" in line:
            reco_id = re.sub(r"sbc0?([0-9]{3})\s.*", r"SBC\1", line)
            name = line.split(" ")[-1].upper().split("/")[0]
            seg_list.append([name, reco_id])
    for line in (doc_dir / "Part_3" / "speaker.tbl").read_text().split("\n"):
        if "," not in line:
            continue
        spk_num, name, gen = line.split(",")[:3]
        spk_list.append([name.upper().split("/")[0], spk_num, gen])
    for seg_info, spk_info in zip(seg_list, spk_list):
        assert seg_info[0] == spk_info[0], f"{seg_info[0]} != {spk_info[0]}"
        spk2gen_dict[f"{seg_info[1]}_{seg_info[0]}"] = spk_info[2]
        spk2glob_dict[f"{seg_info[1]}_{seg_info[0]}"] = f"{spk_info[1]}_{spk_info[0]}"

    for spk_key in _UNMAPPED_SPEAKERS:
        spk2gen_dict[spk_key] = None
        spk2glob_dict[spk_key] = spk_key
    return spk2gen_dict, spk2glob_dict


def _parse_time_speaker(line: str) -> Optional[Tuple[float, float, str, str]]:
    """Decode one .trn row in its several tab/space layouts."""
    line = re.sub(r"\t+", "\t", re.sub(r" +", " ", line.strip()))
    fields = line.strip().split("\t")
    if len(fields) == 4:
        spk_field, raw_trans = fields[2:]
        start, end = (float(t.rstrip()) for t in fields[:2])
    elif len(fields) == 3:
        if len(fields[0].rstrip().split(" ")) > 1:
            start, end = (float(t) for t in fields[0].split(" ")[:2])
            spk_field, raw_trans = fields[1], fields[-1]
        else:
            start, end = (float(t.rstrip()) for t in fields[:2])
            candidate = fields[2].split(" ")[0]
            if re.fullmatch(r"[A-Z]+:", candidate):
                spk_field = candidate
                raw_trans = " ".join(fields[2].split(" ")[1:])
            else:
                spk_field, raw_trans = "", fields[2]
    elif len(fields) == 2:
        timesish = fields[0].rstrip().split(" ")
        if len(timesish) == 1:
            return None
        start, end = (float(t) for t in timesish[:2])
        if len(timesish) > 2:
            spk_field, raw_trans = timesish[2], fields[1]
        else:
            candidate = fields[1].split(" ")[0]
            if re.fullmatch(r"[A-Z]+:", candidate):
                spk_field = candidate
                raw_trans = " ".join(fields[1].split(" ")[1:])
            else:
                spk_field, raw_trans = "", fields[1]
    else:
        split = line.split(" ")
        if (len(split) > 2 and re.fullmatch(r"[0-9]+\.[0-9]+", split[0])
                and re.fullmatch(r"[0-9]+\.[0-9]+", split[1])):
            start, end = (float(t.rstrip()) for t in split[:2])
            if re.fullmatch(r"[A-Z]+:", split[2]):
                spk_field = split[2]
                raw_trans = " ".join(split[3:])
            else:
                spk_field, raw_trans = "", " ".join(split[2:])
        else:
            return None
    return start, end, spk_field, raw_trans


def _filename_to_supervisions(filename: Path, spk2gen_dict: dict, spk2glob_dict: dict,
                              spk_iterator: _DummySpkIterator):
    """One ``.trn`` file's supervisions; unmapped speakers get their ids
    from ``spk_iterator``."""
    reco_id = filename.stem.split(".")[0]
    lines = filename.read_text(encoding="latin1")
    lines = lines.replace("\x92", "'").replace("\u007f", "").replace("\u0000", "c")
    lines = _apply_transcript_fixes(reco_id, lines)

    supervisions = []
    spk_buffer = ""
    lang_buffer = "English"
    lang_iter = iter(LANG_SEQUENCES.get(reco_id, []))
    for line in lines.split("\n"):
        if line == "77.200\t77.540 :\t(H)":
            continue
        if line.startswith("000000000 000000000 ") or line.startswith("0.00 0.00"):
            continue
        if "and in his pamphlet the Liber Arbetrio" in line:
            continue
        parsed = _parse_time_speaker(line)
        if parsed is None:
            continue
        start, end, spk_field, raw_trans = parsed
        if raw_trans == "[2<L2 Zocalo.":
            raw_trans = "[2<L2 Zocalo L2>2]."
        elif raw_trans == "[You're <L2 outre mer L2].":
            raw_trans = "[You're <L2 outre mer L2>]."
        if " $ " in raw_trans:
            continue
        spk_field = spk_field.strip().rstrip(":").rstrip().upper()
        if spk_field in (">ENV", "ENV", ">MAC", ">DOG", ">HORSE", ">CAT", ">BABY"):
            continue
        if spk_field == "#READ":
            spk_field = "WALT"
        if spk_field:
            spk_buffer = re.sub(r"^[^A-Z]", "", spk_field)

        utt_id = f"{reco_id}_{int(start * 1000):07}_{int(end * 1000):07}_{spk_buffer}"
        text, lang_tag = _parse_raw_transcript(raw_trans)
        if "l" in lang_tag:
            for _ in range(lang_tag.count("l")):
                new_lang = next(lang_iter)
            lang_buffer = f"English-{new_lang}" if "c" in lang_tag else new_lang
        elif "c" in lang_tag:
            lang_buffer = f"English-{lang_buffer.split('-')[-1]}"

        spk_key = f"{reco_id}_{spk_buffer}"
        if spk_key not in spk2glob_dict and reco_id != "SBC021":
            spk2gen_dict[spk_key] = None
            spk2glob_dict[spk_key] = spk_iterator.next(spk_key)
        if spk_key in spk2glob_dict:
            speaker = spk2glob_dict[spk_key]
            gender = spk2gen_dict[spk_key]
        else:
            speaker = spk_iterator.next(spk_key)
            gender = None
        if re.search(r"[A-Za-z]", text):
            supervisions.append(
                SupervisionSegment(
                    id=utt_id, recording_id=reco_id, start=start, duration=end - start,
                    channel=[0, 1], text=text, language=lang_buffer, speaker=speaker,
                    gender=gender))
        if lang_tag:
            if lang_tag[-1] == "r":
                lang_buffer = "English"
            if lang_tag[-1] == "l":
                lang_buffer = lang_buffer.split("-")[-1]
    return supervisions


def _parse_raw_transcript(transcript: str) -> Tuple[str, str]:
    """Strip DT markup, emit <LAUGH>/<UNK>/<YELL> tokens + an L2 tag string."""
    for src, dst in (
            ("0h", "oh"), ("s@so", "s- so"), ("la@ter", "later"), ("you@.", "you @."),
            ("[N=]", "N"), ("[2C2]=", "C"), ("[MM=]", "MM"), ("[I=]", "I"),
            ("(YELL)", "<yell>"), ("_", "-"), ("=", ""), ("%", "")):
        transcript = transcript.replace(src, dst)
    transcript = re.sub(r"\[([2-9]?)([A-Z])+\1\]", r"\2", transcript)
    for paren_match in re.findall(r"\([^a-z@ ]*\)", transcript):
        transcript = transcript.replace(
            paren_match, re.sub(r"[^\[\]]", "", paren_match))
    for brack_match in re.findall(r"\[[^a-z@ ]+\]", transcript):
        transcript = transcript.replace(
            brack_match, re.sub(r"[^\(\)]", "", brack_match))
    transcript = re.sub(r"<<[^a-z@ ]+>>", "", transcript)
    transcript = re.sub(r"<<[^a-z@ ]+", "", transcript)
    transcript = re.sub(r"[^a-z@ ]+>>", "", transcript)
    transcript = re.sub(r"<[^a-z@ ]+>", "", transcript)
    transcript = re.sub(r"<[^a-z2 ]*[^2 ]([ <])", r"\1", transcript)
    transcript = re.sub(r"([ >])[^a-z2 ]*[^a-z 2]>", r"\1", transcript)
    transcript = re.sub(r"\[[2-9]?", "", transcript)
    transcript = re.sub(r"[2-9]?\]", "", transcript)
    for src, dst in (
            (("(Hx)"), " "), (("(hx)"), " "), (("(@Hx)"), "@"),
            (("(COUGH COUGH)"), " "), (("(SNIFF"), ""), (("("), ""), ((")"), ""),
            (("< "), " "), ((" >"), " ")):
        transcript = transcript.replace(src, dst)
    transcript = re.sub(r"[^A-Za-z-]-+", "", transcript)
    transcript = re.sub(r"\.\.+", "", transcript)
    for ch in "+&#*":
        transcript = transcript.replace(ch, "")
    transcript = re.sub(r"!([A-Za-z])", r"\1", transcript)
    transcript = re.sub(r" +", " ", transcript)
    transcript = re.sub(r"X+", "X", transcript)
    transcript = transcript.replace("on@,", "on @,")
    transcript = re.sub(r"([a-z-])@([a-z])", r"\1\2", transcript)
    transcript = re.sub(r"@+", "@", transcript)
    transcript = re.sub(r"(^| )@([^ ])", r" @ \2", transcript)
    transcript = re.sub(r"([^ ])@( |$)", r"\1 @ ", transcript)
    transcript = transcript.replace("@ @", "@").replace("@ @", "@")
    transcript = re.sub(r"(^| )X([ ,.?']|$)", r"\1<UNK>\2", transcript)
    transcript = re.sub(r"(^| )X([ ,.?']|$)", r"\1<UNK>\2", transcript)
    transcript = re.sub(r"X-($| )", r"<UNK>\1", transcript)
    transcript = transcript.strip()
    transcript = transcript.replace(" .", ".").replace(" ,", ",").replace(" ?", "?")
    transcript = re.sub(r"^\. ", "", transcript)
    transcript = re.sub(r"^\.$", "", transcript)

    # A code-switch tag is emitted when English text surrounds the L2 spans.
    has_english_prefix = (
        len(transcript.split("<L2")) > 1
        and re.search(r"[A-Za-z]", transcript.split("<L2")[0]))
    has_english_suffix = (
        len(transcript.split("L2>")) > 1
        and re.search(r"[A-Za-z]", transcript.split("L2>")[-1]))
    lang_tag = "c" if (has_english_prefix or has_english_suffix) else ""
    transcript = transcript.replace("@", "<LAUGH>").replace("<yell>", "<YELL>")
    if "L2" in transcript:
        span_tags = re.sub(
            r"(<L2|L2>)(?!.*(<L2|L2>)).*$", r"\1",
            re.sub(r".*?(<L2|L2>)", r"\1", transcript))
        lang_tag += span_tags.replace("<L2", "l").replace("L2>", "r")
    return transcript, lang_tag


# ---------------------------------------------------------------------------
# STM realignment (published alignments; CER-gated replacement)
# ---------------------------------------------------------------------------
@dataclass
class StmSegment:
    recording_id: str
    speaker: str
    start: float
    end: float
    text: str
    channel: str = "1"


def parse_stm_file(data: str) -> List[StmSegment]:
    segments = []
    for line in data.split("\n"):
        if not line:
            continue
        fields = line.strip().split()
        reco_id, channel, speaker = fields[:3]
        start, end = (float(t) for t in fields[3:5])
        segments.append(
            StmSegment(
                recording_id=reco_id, speaker=speaker, start=start, end=end,
                text=" ".join(fields[5:]), channel=channel))
    return segments


def retrieve_stm_file(url: str) -> List[StmSegment]:
    """The published STM file at ``url``, which the JAX package fetches."""
    raise NotImplementedError(
        f"The SBCSAE realignments are read from {url}; lhotse_tpu_torch does not fetch it. "
        "Pass omit_realignments=True (--omit-realignments) for the corpus's own segmentation.")


def norm_txt(text: str) -> str:
    return text.strip().lower()


def compute_iou(seg1: SupervisionSegment, seg2: StmSegment) -> float:
    start = max(seg1.start, seg2.start)
    end = min(seg1.end, seg2.end)
    intersection = max(0.0, end - start)
    union = (seg1.end - seg1.start) + (seg2.end - seg2.start) - intersection
    return intersection / union


def apply_stm(
    recording_ids: List[str], supervisions: SupervisionSet,
    aligned_stm_segs: List[StmSegment]) -> SupervisionSet:
    if not is_module_available("intervaltree"):
        raise ImportError(
            "intervaltree package not found. Please install (pip install intervaltree)")
    if not is_module_available("jiwer"):
        raise ImportError(
            "jiwer package not found. Please install (pip install jiwer==3.0.4)")
    from intervaltree import IntervalTree
    from jiwer import cer

    sset = deepcopy(supervisions)
    per_rec_its = {rid: IntervalTree() for rid in recording_ids}
    for stm_seg in aligned_stm_segs:
        per_rec_its[stm_seg.recording_id][stm_seg.start:stm_seg.end] = stm_seg

    for s in sset:
        collar = 2.0
        window = per_rec_its[s.recording_id][s.start - collar:s.end + collar]
        matching = [m for m in window if m.data.speaker == s.speaker] or list(window)
        best_cer, best_cer_res, best_match, best_iou = inf, None, None, 0.0
        for candidate in matching:
            cer_res = cer(norm_txt(s.text), norm_txt(candidate.data.text), return_dict=True)
            cer_val = cer_res["cer"]
            if cer_val < best_cer:
                best_cer, best_cer_res = cer_val, cer_res
                best_match, best_iou = candidate, compute_iou(s, candidate.data)
            if (cer_val == best_cer
                    and candidate.data.speaker.split("_")[1] == s.speaker.split("_")[1]):
                current_iou = compute_iou(s, candidate.data)
                if current_iou >= best_iou:
                    best_match, best_cer_res, best_iou = candidate, cer_res, current_iou
        if (s.speaker.split("_")[1] == best_match.data.speaker.split("_")[1]
                and best_cer_res["substitutions"] == best_cer_res["deletions"] == 0
                and (best_cer < 0.5 or len(s.text) < 3)):
            s.start = best_match.data.start
            s.duration = best_match.data.end - best_match.data.start
            s.text = best_match.data.text
            per_rec_its[s.recording_id].remove(best_match)
    return sset


def apply_aligned_stms(
    recording_ids: List[str], processed_supervisions: SupervisionSet,
) -> Tuple[SupervisionSet, SupervisionSet]:
    asr_sup = apply_stm(
        recording_ids, processed_supervisions, retrieve_stm_file(STM_URLS["asr"]))
    diar_sup = apply_stm(
        recording_ids, processed_supervisions, retrieve_stm_file(STM_URLS["diar"]))
    return asr_sup, diar_sup


# ---------------------------------------------------------------------------
# Per-recording transcript errata (verbatim from the reference)
# ---------------------------------------------------------------------------
def _apply_transcript_fixes(reco_id: str, lines: str) -> str:
    for src, dst in _TRANSCRIPT_FIXES.get(reco_id, ()):  # plain replacements
        lines = lines.replace(src, dst)
    for pattern, repl in _TRANSCRIPT_REGEX_FIXES.get(reco_id, ()):
        lines = re.sub(pattern, repl, lines)
    return lines


_TRANSCRIPT_FIXES: Dict[str, Tuple[Tuple[str, str], ...]] = {
    "SBC002": (("(TSK ", "(TSK) "),),
    "SBC004": (("KATE", "KATHY"), ("sen~orita", "se\xf1orita")),
    "SBC005": (
        ("good_/god/", "good"), ("(H)@>", "(H) @>"),
        ("[@@ <@Mm@>]", "[@@ <@ Mm @>]")),
    "SBC006": (
        ("/pub/", "pub"), ("<WH@@@@ (H) @@WH>", "<WH @@@@ (H) @@ WH>"),
        ("[2(H)2]1", "[2(H)2]")),
    "SBC007": (
        ("\\000000000 000000000 MARY: 1182.90 1186.92\t        ",
         "\n1182.90 1186.92\tMARY:   "),
        ("(YAWN0", "(YAWN)")),
    "SBC008": (("[<X Go]=dX>", "[<X Go]=d X>"),),
    "SBC010": (("366.87 366.87", "366.16 366.87"),),
    "SBC012": (
        ("\n".join(["807.02 807.92\tFRANK:  \t.. Mhm."] * 2),
         "807.02 807.92\tFRANK:  \t.. Mhm."),
        ("MONTOYA", "MONTOYO")),
    "SBC013": (
        ("[8<@She8]", "[8<@ She8]"), ("[2(H) cou_ couch@>2]", "[2(H) cou_ couch @>2]"),
        ("[4<@No=4]", "[4<@ No=4]"), ("VOX2]", "VOX>2]")),
    "SBC014": (
        ("\\000000000 000000000 ", "\n"), ("<@he thought", "<@ he thought")),
    "SBC015": (
        ("243.055\t244.080\tKEN:\t(H)] the little,",
         "243.465\t244.670\tKEN:\t(H)] the little,"),
        ("\u0000urch things.", "church things."), ("2(H]=2", "2(H)=2"),
        (" 0.000000e+00", "e"), ("0m=,", "um=,"), ("0eople", "people"),
        ("0id", "did"), ("X 0ne %tho", "X uh line %tho"),
        ("and 0t [was]", "and it [was]"), ("0t was like", "it was like")),
    "SBC016": (("/sed ai/", "sed ai"),),
    "SBC017": (
        ("a\tand names the] na=me,", "and names the] na=me,"),
        (" 0.000000e+00", "e"), ("[2I mean2", "[2I mean2]"), ("no2.", "no."),
        ("0rganisms", "organisms"), ("0ttle", "little")),
    "SBC018": (
        ("0f", "if"),
        ("129.916\t130.324\tLINDSEY:\tYeah.\n129.915\t130.325\t\t[Mhm.]\n",
         "129.915\t130.325\tLINDSEY:\t[Mhm.] Yeah.\n")),
    "SBC019": (
        ("cello_(/cheller/)", "cheller"), ("(sigh)", "(SIGH)"),
        ("<F<VOX> Mo=m", "<F<VOX Mo=m"), ("@@[3@=3", "@@[3@=3]"),
        ("[#5Jason", "[5#Jason"), ("[20nh2]", "[2Unh2]"), ("Draw 0n", "Draw on"),
        ("0oes", "Does"), ("0=kay", "O=kay")),
    "SBC020": (
        ("(COUGh)", "(COUGH)"), ("(throat)", "(THROAT)"), ("S-  0emon", "S- demon"),
        (" 0.000000E+00", "E"), ("now 0m", "now um"), ("uh  0s", "uh is"),
        ("but  0n", "but uh in"), ("i- % 0t's", "i- uh it's"), ("0retty", "pretty"),
        ("AUD:\tY", "X:\tY")),
    "SBC022": (
        (("(h)"), "(H)"), ("0.000000e+00", "e-"), ("0ttle", "little"),
        ("0ne thing", "uh one thing")),
    "SBC023": (
        ("JANICD", "JANICE"), ("NORA?", "NORA"), ("SUE?", "SUE"),
        ("(throat)", "(THROAT)"), ("2(SNIFF2", "2(SNIFF)2"),
        ("[<Xbu=tX>]", "[<X bu=t X>]"), ("<or did it", "<Q or did it"),
        ("x>5]", "X>5]"), ("0nly", "uh only"), ("[50r5]", "[5Or5]")),
    "SBC024": (
        ((" >ENV: "), ">ENV:\t"), (" 0.000000irst", "First"), ("2[cause", "[2cause"),
        (" 0oes", "does"), ("0id]", "did]")),
    "SBC025": (
        ("<ot,", "<% not,"), (" 0.000000e+00", "e"), ("0mself", "himself")),
    "SBC026": (
        ("does_(/uz/)", "does"), (" 0.000000e+00", "e"), ("0ngoing", "ongoing"),
        ("AUD:\t<X", "X_2:\t<X")),
    "SBC027": (
        ("142.870\t144.790 :", "142.870\t144.790"),
        ("451.510\t452.130 :", "451.510\t452.130"),
        (" 0oing", "doing"), ("AUD:\t.. [We", "X:\t.. [We"),
        ("AUD:\t... Liquid", "X_1:\t... Liquid"), ("AUD:\tAdd", "X_2:\tAdd"),
        ("AUD:\t     [", "X_3:\t     ["), ("AUD1:\t... One", "X_4:\t... One"),
        ("AUD2:\t[One", "X_5:\t[One"), ("AUD:\t...X [X", "X_6:\tX [X"),
        ("AUD1:\tEight", "X_7:\tEight"), ("AUD2:\t... [@", "AUD:\t... [@"),
        ("AUD3:\t    [Four", "X_8:\t    [Four"), ("AUD:\t... Seven", "X_9:\t... Seven"),
        ("AUD1:\t.. <L2", "X_10:\t.. <L2"), ("AUD2:\t        [", "X_11:\t       ["),
        ("AUD:\t... <L2", "X_12:\t... <L2"), ("AUD1:\t... [E", "X_13:\t... [E"),
        ("AUD2:\t    [<L2", "X_14:\t    [<L2"), ("AUD1:\t     ", "X_15:\t     "),
        ("AUD2:\t... There", "X_16:\t... There"), ("AUD1:\t[Pull", "X_17:\t[Pull"),
        ("AUD2:\tYou", "X_18:\tYou"), ("AUD:\t[<X", "X_19:\t[<X"),
        ("AUD:\t... Solid", "X_20:\t... Solid"),
        ("AUD:\t.. Hydrogen", "X_21:\t.. Hydrogen"),
        ("AUD:\t.. Oxygen", "X_22:\t.. Oxygen"), ("AUD:\t.. [<", "X_23:\t.. [<"),
        ("AUD:\t       ", "X_24:\t       "), ("AUD:\tThey're", "X_25:\tThey're"),
        ("AUD:\t XXX", "X_26:\t XXX"), ("AUD:\t... No", "X_27:\t... No"),
        ("AUD:\t<X", "X_28:\t<X"), ("AUD:\tThrow", "X_29:\tThrow"),
        ("AUD:\tHotter", "X_30:\tHotter"), ("AUD:\t.. Liquid", "X_31:\t.. Liquid"),
        ("AUD:\t Did", "X_32:\t Did"), ("AUD:\tX", "X_33:\tX")),
    "SBC028": (
        ("482.610\t484.010\tJILL_S: ", "482.610\t484.010\tJILL_S:\t"),
        ("<@Oh[2=@>", "<@ Oh[2= @>"), (" 0.000000", " "), ("i 0f", "i- if"),
        ("0f we", "if we"), ("th- 0t's", "th- that's"), ("0t's", "it's"),
        ("0f", "if")),
    "SBC029": (
        ("96.230\t98.240\t>ENV: ", "96.230\t98.240\t>ENV:\t"), ("(H )", "(H)"),
        ("<0h=,", "<% Oh=,"), ("knowX>]", "know X>]"),
        ("0verheating", "overheating")),
    "SBC030": (("DANNY", "BRADLEY"), ("AUD:\tYes", "X:\tYes")),
    "SBC034": (("13548.02 ", "1354.802"),),
    "SBC036": (
        ("1558.463\t1558.906\t\t[thought he was,",
         "1558.906\t1558.923\t\t[thought he was,"),),
    "SBC038": (
        ("AUD:\t... What's", "X_2:\t... What's"), ("AUD:\t... U", "X_3:\t... U"),
        ("AUD:\t... How far", "X_2:\t... How far"),
        ("AUD:\t<X Quite", "X_4:\t<X Quite"), ("AUD:\tYeah", "X_5:\tYeah"),
        ("AUD:\tAbout", "X_6:\tAbout"), ("AUD:\t... That", "X_7:\t... That"),
        ("AUD:\t.. <X Oh", "X_8:\t.. <X Oh"),
        ("AUD:\t... How long", "X_3:\t... How long"), ("AUD:\t<X @", "X_3:\t<X @"),
        ("AUD:\tEach", "X_2:\tEach"), ("AUD:\tThe water", "X_2:\tThe water"),
        ("AUD:\t[Right", "X_9:\t[Right"), ("AUD:\t... It's", "X_9:\t... It's"),
        ("AUD:\t[Perp", "X_9:\t[Perp"), ("AUD:\t[2perp", "X_9:\t[2perp"),
        ("AUD:\t[3The", "X_9:\t[3The"), ("AUD:\t[4Right", "X_9:\t[4Right"),
        ("AUD:\tOh yeah", "X_9:\tOh yeah"), ("AUD:\t[6Now", "X_9:\t[6Now"),
        ("AUD:\twith the", "X_9:\twith the"), ("AUD:\t[That-", "X_9:\t[That-"),
        ("AUD:\t[Spinning", "X_9:\t[Spinning"), ("AUD:\t[2Yeah", "X_9:\t[2Yeah"),
        ("AUD:\t[3X", "X_9:\t[3X"), ("AUD:\t[4<X", "X_9:\t[4<X"),
        ("AUD:\tAnd that's", "X_9:\tAnd that's"), ("AUD:\t[So", "X_9:\t[So"),
        ("AUD:\t[2that's", "X_9:\t[2that's"), ("AUD:\tthat's3", "X_9:\tthat's3"),
        ("AUD:\tWe", "X_9:\tWe"), ("AUD:\t.. All", "X_9:\t.. All"),
        ("AUD:\t.. What's", "X_10:\t.. What's"), ("AUD:\t... Are", "X_3:\t... Are"),
        ("AUD:\tThe rest", "X_11:\tThe rest"),
        ("AUD:\t... Y'all", "X_12:\t... Y'all"), ("AUD:\t... Is", "X_13:\t... Is"),
        ("AUD:\t[<X", "X_13:\t[<X"), ("AUD:\t[Yeah", "X_13:\t[Yeah"),
        ("AUD:\t... What are", "X_13:\t... What are"), ("AUD_2", "AUD"),
        ("AUD:\t[What are", "X_13:\t[What are"), ("AUD:\t... Say", "X_14:\t... Say"),
        ("AUD:\t[what's", "X_14:\t[what's"), ("AUD:\t.. Hmm", "X_14:\t.. Hmm"),
        ("AUD:\t[3When", "X_14:\t[3When"), ("AUD:\t[It's", "X_15:\t[It's"),
        ("AUD:\t... Have", "X_16:\t... Have"), ("AUD:\tThanks", "X_17:\tThanks"),
        ("AUD:\t... Wow", "X_13:\t... Wow")),
    "SBC040": (
        ("AUD:\t... What's", "X:\t... What's"), ("AUD:\t... He", "X_2:\t... He"),
        ("AUD:\t[What", "X_3:\t[What"), ("AUD:\t.. Isn't", "X_4:\t.. Isn't"),
        ("AUD:\tClaiborne", "X_4:\tClaiborne"), ("AUD:\t... How", "X_4:\t... How"),
        ("AUD:\t.. How", "X_4:\t.. How"), ("AUD:\t.. The", "X_5:\t.. The"),
        ("AUD:\t... Yes", "X_6:\t... Yes")),
    "SBC043": (
        ("< HI any nights HI>", "<HI any nights HI>"), ("ANNETTE", "ANETTE")),
    "SBC048": (("<@in San[2ta", "<@ in San[2ta"),),
    "SBC052": (("~Janine\t said", "~Janine said"),),
    "SBC054": (
        ("<VOX Ugh VOX >", "<VOX Ugh VOX>"), ("AUD:\tX", "X:\tX"),
        ("AUD:\t<X", "X_2:\t<X"), ("AUD_2:\t[Tha-]", "X_3:\t[Tha-]"),
        ("AUD_3:\t[Tha-]", "X_4:\t[Tha-]"), ("AUD:\t[@rhino", "X_5:\t[@rhino"),
        ("AUD_2", "AUD")),
    "SBC055": (
        ("in spite ..\tof having", "in spite .. of having"),
        ("AUD:\t... Beatrice", "X:\t... Beatrice"),
        ("AUD:\tHow was", "X_2:\tHow was"), ("AUD:\tCan", "X_3:\tCan"),
        ("AUD_2:", "X_4:")),
    "SBC056": (
        ("@@@2]\t[3@@@@3]", "@@@2] [3@@@@3]"), ("(sniff)", "(SNIFF)")),
    "SBC057": (
        ("Hane-makikomi", "<L2 Hane-makikomi L2>"), ("sensei", "<L2 sensei L2>"),
        ("ippon", "Ippon"), ("Ippon", "<L2 Ippon L2>"),
        ("Hane-goshi", "<L2 Hane-goshi L2>"),
        ("Sode-makikomi", "<L2 Sode-makikomi L2>"), ("shiai", "<L2 shiai L2>"),
        ("randori", "<L2 randori L2>"), ("Ukemi", "<L2 Ukemi L2>"),
        ("Ha-jime", "<L2 Ha-jime L2>"), ("Ude-garami", "<L2 Ude-garami L2>"),
        ("Hane-uchi-mata", "<L2 Hane-uchi-mata L2>"),
        ("Uchi-<X mother X>", "Uchi-mata"), ("Uchi-mata", "<L2 Uchi-mata L2>"),
        ("Hande-maki- <L2 ", "<L2 Hande-maki- "),
        ("%Sode-maki[komi]", "<L2 %Sode-maki[komi] L2>"),
        ("Tsuri-komi", "<L2 Tsuri-komi L2>"), ("Uchi-komi", "<L2 Uchi-komi L2>"),
        ("O-uchi", "<L2 O-uchi L2>"), ("Goshi", "<L2 Goshi L2>"),
        ("Uchi]-mata", "<L2 Uchi]-mata L2>"), ("Komi", "<L2 Komi L2>"),
        ("Tani-otoshi", "<L2 Tani-otoshi L2>"),
        ("Hane-maki][2komi=", "<L2 Hane-maki][2komi= L2>"),
        ("Makikomi-waza", "<L2 Makikomi-waza L2>"), ("Seoi", "<L2 Seoi L2>"),
        ("uke", "<L2 uke L2>")),
    "SBC059": (
        ("[<F 3And you", "<F [3And you"), ("hour[6=6 F>]", "hour[6=6] F>")),
}

_TRANSCRIPT_REGEX_FIXES: Dict[str, Tuple[Tuple[str, str], ...]] = {
    # ordered regex fixes interleaved with the plain SBC057 replacements above
    "SBC057": (
        (r"gi([^a-z])", r"<L2 gi L2>\1"),
        (r"Makikomi([^-])", r"<L2 Makikomi L2>\1"),
        (r"Sode([^-])", r"<L2 Sode L2>\1"),
        (r"Hane([^-])", r"<L2 Hane L2>\1")),
}
