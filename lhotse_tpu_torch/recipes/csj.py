"""
CSJ recipe (copied from ``lhotse_tpu/recipes/csj.py``): the Corpus of
Spontaneous Japanese (https://clrd.ninjal.ac.jp/csj/en/). It parses the
Shift-JIS MORPH/SDB tables into ``{surface}+{morph}+{pron}`` transcripts and
builds Kaldi's eval1, eval2, eval3 and excluded splits and a validation
set. With a ``transcript_dir`` it first copies each speaker's SDB there,
splits the dialogue (``D…``) sessions into L and R channel SDBs with their
own wav lists, and moves the pinned eval, valid and excluded sessions; each
processed SDB gets a ``{spk}-trans.txt`` beside it. Disfluency tags
``(TAG left;right)`` are resolved by the ``DECISIONS`` table, spanning
R/M/O tags are unlinked across segments, and ``concat_csj_supervisions``
merges consecutive supervisions of a speaker. ``SupervisionSegment.text``
is the disfluent rendering, and ``custom`` holds ``raw``, ``disfluent`` and
``disfluent_tag`` (a tag per character). The corpus has no download.
"""
import copy
import logging
import re
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.recipes.utils import manifests_exist, read_manifests_if_cached
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

_FULL_DATA_PARTS = ["eval1", "eval2", "eval3", "excluded", "valid", "core", "noncore"]

# Sessions excluded alongside A01M0056 (kaldi convention).
_A01M0056 = ["S05M0613", "R00M0187", "D01M0019", "D04M0056", "D02M0028", "D03M0017"]

_VALID = [
    "A01M0264", "A01M0377", "A01M0776", "A01M0891", "A03F0109", "A04M0899",
    "A05M0420", "A07M0318", "A07M0912", "A11M0795", "A12M0983", "D03F0058",
    "R00M0415", "R01F0101", "R01F0125", "R02M0073", "R03F0108", "R03F0157",
    "S00F0014", "S00M0793", "S01F0507", "S02F0122", "S02F0362", "S02M1351",
    "S02M1372", "S03F1199", "S04F1020", "S05F0443", "S07F0853", "S07F1333",
    "S07M0827", "S08F0717", "S08F1340", "S09M0619", "S10M1090", "S10M1275",
    "S11F0578", "S11M0864", "S11M1174"]

_EVAL = [
    ["A01M0110", "A01M0137", "A01M0097", "A04M0123", "A04M0121", "A04M0051",
     "A03M0156", "A03M0112", "A03M0106", "A05M0011"],
    ["A01M0056", "A03F0072", "A02M0012", "A03M0016", "A06M0064", "A06F0135",
     "A01F0034", "A01F0063", "A01F0001", "A01M0141"],
    ["S00M0112", "S00F0066", "S00M0213", "S00F0019", "S00M0079", "S01F0105",
     "S00F0152", "S00M0070", "S00M0008", "S00F0148"]]

INTERNAL_SEP = " "

# SDB tab-column indices of the fields we consume.
_FIELDS = {
    "time": 3, "surface": 5, "notag": 9, "pos1": 11, "cForm": 12, "cType1": 13,
    "pos2": 14, "cType2": 15, "other": 16, "pron": 10, "spkid": 2}
_MORPH = ["pos1", "cForm", "cType2", "pos2"]

_REPLACEMENTS = [
    "<FV>", "<VN>", "<H>", "<Q>", "<笑>", "<咳>", "<息>", "<泣>", "<フロア発話>",
    "<フロア笑>", "<拍手>", "<デモ>", "<ベル>", "<朗読間違い>", "<雑音>"]

# Which alternative a disfluency tag resolves to (0 = left, 1 = right).
DECISIONS = {
    "F": 0, "D": 0, "D2": 0, "?": 0, "?,": 0, "M": 0, "O": 0, "R": 0, "X": 0,
    "A": 1, "A_num": 0, "K": 1, "W": 1, "B": 0, "笑": 0, "泣": 0, "咳": 0, "L": 0}


# ---------------------------------------------------------------------------
# Stage 0: optional transcript-directory materialization
# ---------------------------------------------------------------------------
def _move_sessions(trans_dir: Path, session_ids: Sequence[str], dest: str) -> None:
    for session in session_ids:
        files = list(trans_dir.glob(f"*/{session}/{session}*"))
        for f in files:
            *root, _vol, spk_id, filename = f.as_posix().split("/")
            new_dir = Path("/".join(root + [dest, spk_id]))
            new_dir.mkdir(parents=True, exist_ok=True)
            f.rename(new_dir / filename)
        if files:
            files[0].parent.rmdir()


def _create_trans_dir(corpus_dir: Path, trans_dir: Path) -> None:
    marker = trans_dir / ".done_mv"
    if marker.exists():
        logging.info(f"{trans_dir} already created. Delete {marker} to create again.")
        return
    for sdb in (corpus_dir / "MORPH/SDB").glob("*/*.sdb"):
        vol = sdb.parts[-2]
        spk_id = sdb.name[:-4]
        new_dir = trans_dir / vol / spk_id
        new_dir.mkdir(parents=True, exist_ok=True)
        wav_dir = corpus_dir / "WAV" / vol
        if spk_id[0] == "D":
            # dialogs are split into L/R channel SDBs + wav lists
            for side in ("L", "R"):
                wav = wav_dir / f"{spk_id}-{side}.wav"
                assert wav.is_file(), f"{spk_id}-{side}.wav cannot be found"
                (new_dir / f"{spk_id}-{side}-wav.list").write_text(
                    wav.as_posix(), encoding="utf8")
            sides = {"L": [], "R": []}
            for line in sdb.read_text(encoding="shift_jis").split("\n"):
                if not line:
                    sides["L"].append(line)
                    sides["R"].append(line)
                elif "L:" in line.split("\t")[3]:
                    sides["L"].append(line)
                else:
                    assert "R:" in line, line
                    sides["R"].append(line)
            for side, rows in sides.items():
                (new_dir / f"{spk_id}-{side}.sdb").write_text(
                    "\n".join(rows), encoding="shift_jis")
        else:
            (new_dir / f"{spk_id}.sdb").write_bytes(sdb.read_bytes())
            wav = wav_dir / f"{spk_id}.wav"
            assert wav.is_file(), f"{spk_id}.wav cannot be found"
            (new_dir / f"{spk_id}-wav.list").write_text(wav.as_posix(), encoding="utf8")
    _move_sessions(trans_dir, _A01M0056, "excluded")
    for i, eval_list in enumerate(_EVAL, start=1):
        _move_sessions(trans_dir, eval_list, f"eval{i}")
    _move_sessions(trans_dir, _VALID, "valid")
    marker.touch()
    logging.info("Transcripts have been moved.")


# ---------------------------------------------------------------------------
# SDB row / segment model
# ---------------------------------------------------------------------------
class _CSJSDBWord:
    time = ""
    surface = ""
    notag = ""
    pos1 = ""
    cForm = ""
    cType1 = ""
    pos2 = ""
    cType2 = ""
    other = ""
    pron = ""
    spkid = ""
    sgid = 0
    start = -1.0
    end = -1.0
    morph = ""

    @staticmethod
    def from_line(line: str = "") -> "_CSJSDBWord":
        word = _CSJSDBWord()
        cols = line.strip().split("\t")
        for name, idx in _FIELDS.items():
            setattr(word, name, cols[idx] if idx < len(cols) else "")
        # collapse elongated ん and drop event markers
        for _ in range(2):
            for long_form, short_form in (("んー", "ん"), ("ンー", "ン")):
                word.pron = word.pron.replace(long_form, short_form)
                word.surface = word.surface.replace(long_form, short_form)
        for marker in _REPLACEMENTS:
            word.pron = word.pron.replace(marker, "")
            word.surface = word.surface.replace(marker, "")
        word.pron = word.pron.replace(INTERNAL_SEP, "_")
        word.surface = word.surface.replace(INTERNAL_SEP, "_")
        word.pron = re.sub(r"<PL.+>", "", word.pron)
        word.surface = word.surface.rstrip("・")
        word.morph = "/".join(m for m in (getattr(word, s) for s in _MORPH) if m)
        for c in ("Ａ", "１", "２", "３", "４"):
            word.morph = word.morph.replace(c, "")
        word.morph = word.morph.replace("　", "＿")
        word.sgid, start_end, channel = word.time.split(" ")
        word.start, word.end = (float(s) for s in start_end.split("-"))
        if word.spkid[0] == "D":
            word.spkid = word.spkid + "-" + channel.split(":")[0]
        return word

    def __repr__(self):
        return f"{self.surface}+{self.morph}+{self.pron}"

    def __bool__(self):
        return bool(self.surface or self.pron)


class _CSJSDBSegment:
    text: str
    start: float
    end: float
    sgid: str

    @staticmethod
    def from_words(words: List[_CSJSDBWord]) -> "_CSJSDBSegment":
        seg = _CSJSDBSegment()
        seg.text = INTERNAL_SEP.join(str(w) for w in words)
        seg.start = words[0].start
        seg.end = words[-1].end
        seg.sgid = f"{words[0].spkid}_{words[0].sgid}"
        return seg

    def __repr__(self):
        return self.text

    def to_line(self) -> str:
        return f"{self.sgid}\t{self.start:09.3f}\t{self.end:09.3f}\t{self.text}"

    def verify_line(self) -> bool:
        return self.text.count("(") == self.text.count(")")

    @staticmethod
    def from_line(line: str) -> "_CSJSDBSegment":
        seg = _CSJSDBSegment()
        seg.sgid, start, end, seg.text = line.strip().split("\t")
        seg.start = float(start)
        seg.end = float(end)
        return seg


class _Transcript:
    """Flattened text of several segments with per-character coordinates."""

    def __init__(self, segments, text_type: str):
        self.text = ""
        self.shape0, self.shape1, self.shape2 = [], [], []
        self.tag_end = {}
        self.right_offset = defaultdict(list)
        for i, seg in enumerate(segments):
            for j, word in enumerate(seg):
                rendered = getattr(word, text_type)
                self.text += rendered
                for k in range(len(rendered)):
                    self.shape0.append(i)
                    self.shape1.append(j)
                    self.shape2.append(k)
        open_brackets = []
        for i, c in enumerate(self.text):
            if c == "(":
                open_brackets.append(i)
            elif c == ")":
                self.tag_end[open_brackets.pop()] = i

    def use_index(self, pos: int, right: bool = False) -> Tuple[int, ...]:
        coords = (self.shape0[pos], self.shape1[pos], self.shape2[pos])
        if not right:
            return coords
        # account for characters already deleted from the same word
        key = coords[:2]
        adjust = sum(1 for prior in self.right_offset[key] if prior < coords[2])
        self.right_offset[key].append(coords[2])
        return (coords[0], coords[1], coords[2] - adjust)


class _CSJSDBTagSegment:
    """Accumulates words across SDB segments while brackets remain open."""

    def __init__(self):
        self.segments: List[List[_CSJSDBWord]] = []
        self.surface_open_brackets: Dict[int, str] = {}
        self.pron_open_brackets: Dict[int, str] = {}

    def append(self, word: _CSJSDBWord) -> None:
        if self.segments:
            self.segments[-1].append(word)
        else:
            self.segments = [[word]]

    def flatten(self) -> _CSJSDBSegment:
        return _CSJSDBSegment.from_words([w for s in self.segments for w in s])

    def split(self) -> List[_CSJSDBSegment]:
        return [_CSJSDBSegment.from_words(s) for s in self.segments if s]

    def __getitem__(self, pos):
        return self.segments[pos]

    def __bool__(self):
        return bool(self.segments and self.segments[0])

    @staticmethod
    def _open_brackets(text: str) -> List[int]:
        stack = []
        for i, c in enumerate(text):
            if c == "(":
                stack.append(i)
            elif c == ")":
                stack.pop()
        return stack

    @property
    def is_complete(self) -> bool:
        surface = "".join(w.surface for s in self.segments for w in s)
        pron = "".join(w.pron for s in self.segments for w in s)
        surface_open = self._open_brackets(surface)
        pron_open = self._open_brackets(pron)
        if not surface_open and not pron_open:
            return True
        self.surface_open_brackets.update(
            {i: surface[i + 1] for i in surface_open[::-1]})
        self.pron_open_brackets.update({i: pron[i + 1] for i in pron_open[::-1]})
        return False


# ---------------------------------------------------------------------------
# Disfluency-tag parser
# ---------------------------------------------------------------------------
class CSJSDBParser:
    """Resolves '(TAG left;right)' constructs per the DECISIONS table and
    produces (character, tag) pairs for the chosen rendering."""

    tag_regex = re.compile(r"( )|([\x00-\x7F])")
    JPN_NUM = [
        "ゼロ", "０", "零", "一", "二", "三", "四", "五", "六", "七", "八", "九",
        "十", "百", "千", "．"]

    def __init__(self, decisions: Dict = DECISIONS, preprocess: Callable = None):
        self.decisions = decisions
        self.preprocess = preprocess if preprocess else self._keep_surface

    @staticmethod
    def _keep_surface(text: str) -> str:
        """Default preprocessing: keep only the surface of each word triple."""
        words = (w.split("+")[0] for w in text.split(INTERNAL_SEP))
        return INTERNAL_SEP.join(w for w in words if w)

    def parse(self, text: str, sep: str = "", with_tags: bool = False):
        result = self._parse(self.preprocess(text), -1)
        assert len(result["string"]) == len(result["tag"]), text
        if not with_tags:
            return result["string"].replace(INTERNAL_SEP, sep)
        pairs = zip(result["string"], result["tag"])
        if not sep:
            return [(w, t) for w, t in pairs if w != INTERNAL_SEP]
        return [(w, t) if w != INTERNAL_SEP else (sep, t) for w, t in pairs]

    def _parse(self, text: str, open_bracket: int):
        i = open_bracket + 1
        tag = ""
        choices = [""]
        choices_tag = [[]]
        while i < len(text):
            c = text[i]
            char_tags = [tag]
            if c == "(":
                inner = self._parse(text, i)
                c = inner["string"]
                i = inner["end"]
                char_tags = (
                    inner["tag"] if not tag
                    else [tag + f"/{t}" for t in inner["tag"]])
            matches = self.tag_regex.search(c)
            if c == ")" and not tag:
                logging.warning(
                    f"Untagged bracket at {open_bracket}..{i} in {text!r}")
                return {"string": choices[-1], "end": i, "tag": choices_tag[-1]}
            elif c == ")":
                if tag == "A" and choices[0] and choices[0][0] in self.JPN_NUM:
                    tag = "A_num"
                result, result_tag = self._decide(tag, choices + [""], choices_tag + [[]])
                return {"string": result, "end": i, "tag": result_tag}
            elif c == ";":
                choices.append("")
                choices_tag.append([])
            elif c == ",":
                choices.append("")
                choices_tag.append([])
                if "," not in tag:
                    tag += ","
            elif c == "_":
                pass
            elif matches and matches.group(2):
                tag += c
            elif not tag and open_bracket > -1 and c in ("笑", "泣", "咳"):
                tag = c
            else:
                choices[-1] += c
                choices_tag[-1].extend(char_tags)
            i += 1
        return {
            "string": choices[-1], "end": i,
            "tag": choices_tag[-1] if choices[-1] else []}

    def _decide(self, tag, choices, choices_tag) -> Tuple[str, List[str]]:
        assert len(choices) > 1
        if tag not in self.decisions:
            raise NotImplementedError(f"Unknown tag {tag} encountered.")
        decision = self.decisions[tag]
        if isinstance(decision, int):
            return choices[decision], choices_tag[decision]
        raise Exception(f"Decision for {tag} cannot be resolved. Got {decision}")


# ---------------------------------------------------------------------------
# One SDB -> segments -> manifests
# ---------------------------------------------------------------------------
def _unlink_spanning_tags(words: _CSJSDBTagSegment) -> bool:
    """Strip R/M/O tags spanning segments; returns True if splitting is safe."""
    pron = _Transcript(words, "pron")
    for pos, linking_tag in words.pron_open_brackets.items():
        if linking_tag in ("R", "M", "O"):
            l0, l1, l2 = pron.use_index(pos)
            r0, r1, r2 = pron.use_index(pron.tag_end[pos], True)
            left = words[l0][l1].pron
            right = words[r0][r1].pron
            words[l0][l1].pron = left[:l2] + left[l2 + 3:]
            words[r0][r1].pron = right[:r2] + right[r2 + 1:]
    surface = _Transcript(words, "surface")
    split = True
    for pos, linking_tag in words.surface_open_brackets.items():
        if linking_tag in ("R", "M", "O"):
            l0, l1, l2 = surface.use_index(pos)
            r0, r1, r2 = surface.use_index(surface.tag_end[pos], True)
            left = words[l0][l1].surface
            right = words[r0][r1].surface
            words[l0][l1].surface = left[:l2] + left[l2 + 3:]
            words[r0][r1].surface = right[:r2] + right[r2 + 1:]
        else:
            split = False
    return split


def _read_one_sdb(sdb: Path) -> List[_CSJSDBSegment]:
    lines = sdb.read_text(encoding="shift_jis").split("\n")
    sgid = lines[0].split("\t")[3].split(" ")[0]
    pending = _CSJSDBTagSegment()
    segments: List[_CSJSDBSegment] = []
    for line in lines:
        word = _CSJSDBWord.from_line(line) if line else _CSJSDBWord()
        if not word and line:
            continue
        if word.sgid == sgid:
            pending.append(word)
            continue
        sgid = word.sgid
        if not pending.is_complete:
            pending.segments.append([])  # keep accumulating across segments
        elif not pending:
            pass
        elif len(pending.segments) > 1:
            if _unlink_spanning_tags(pending):
                segments.extend(pending.split())
            else:
                segments.append(pending.flatten())
            pending = _CSJSDBTagSegment()
        else:
            segments.append(pending.flatten())
            pending = _CSJSDBTagSegment()
        pending.append(word)
    return segments


def _process_one_recording(
    segments: List[_CSJSDBSegment], wav: Path, recording_id: str, parser: CSJSDBParser,
) -> Tuple[Recording, List[SupervisionSegment]]:
    recording = Recording.from_file(wav, recording_id=recording_id)
    supervision_segments = []
    for segment in segments:
        parsed = parser.parse(segment.text, sep="", with_tags=True)
        if not parsed:
            continue
        chars, tags = zip(*parsed)
        text = "".join(chars)
        supervision_segments.append(
            SupervisionSegment(
                id=segment.sgid, recording_id=recording_id, start=segment.start,
                duration=segment.end - segment.start, channel=0, language="Japanese",
                speaker=recording_id,
                gender="Male" if recording_id[3] == "M" else "Female", text=text,
                custom={
                    "raw": segment.text, "disfluent": text,
                    "disfluent_tag": ",".join(tags)}))
    return recording, supervision_segments


def _process_one(sdb: Path, parser: CSJSDBParser):
    segments = _read_one_sdb(sdb)
    spk = sdb.stem
    try:
        wavfile = Path((sdb.parent / (spk + "-wav.list")).read_text())
        (sdb.parent / f"{spk}-trans.txt").write_text(
            "\n".join(s.to_line() for s in segments))
    except FileNotFoundError:
        part = sdb.parent.name
        wavfile = sdb.parents[3] / f"WAV/{part}/{spk}.wav"
        assert wavfile.exists()
    return _process_one_recording(segments, wavfile, spk, parser)


def prepare_manifests(
    transcript_dir: Path, dataset_parts: Union[str, Sequence[str]] = None,
    manifest_dir: Pathlike = None, num_jobs: int = 1,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """Parse every requested part's SDBs and build the per-part manifests."""
    assert transcript_dir.is_dir(), (
        f"No such directory for transcript_dir: {transcript_dir}")
    if not dataset_parts:
        dataset_parts = _FULL_DATA_PARTS
    elif isinstance(dataset_parts, str):
        dataset_parts = [dataset_parts]
    glob_pattern = "*.sdb" if transcript_dir.name == "SDB" else "*/*.sdb"
    manifests = {}
    if manifest_dir:
        manifest_dir = Path(manifest_dir)
        manifest_dir.mkdir(parents=True, exist_ok=True)
        manifests = read_manifests_if_cached(
            dataset_parts=dataset_parts, output_dir=manifest_dir, prefix="csj") or {}

    parser = CSJSDBParser(DECISIONS)
    for part in dataset_parts:
        if manifests_exist(part=part, output_dir=manifest_dir, prefix="csj"):
            logging.info(f"CSJ subset: {part} already prepared - skipping.")
            continue
        logging.info(f"Processing CSJ subset: {part}")
        recordings, supervisions = [], []
        for sdb in sorted(transcript_dir.glob(f"{part}/{glob_pattern}")):
            recording, segments = _process_one(sdb, parser)
            recordings.append(recording)
            supervisions.extend(segments)
        recording_set = RecordingSet.from_recordings(recordings)
        supervision_set = SupervisionSet.from_segments(supervisions)
        recording_set, supervision_set = fix_manifests(recording_set, supervision_set)
        validate_recordings_and_supervisions(recording_set, supervision_set)
        if manifest_dir:
            supervision_set.to_file(manifest_dir / f"csj_supervisions_{part}.jsonl.gz")
            recording_set.to_file(manifest_dir / f"csj_recordings_{part}.jsonl.gz")
        manifests[part] = {
            "recordings": recording_set, "supervisions": supervision_set}
    return manifests


def prepare_csj(
    corpus_dir: Pathlike, transcript_dir: Pathlike = None, manifest_dir: Pathlike = None,
    dataset_parts: Union[str, Sequence[str]] = None, nj: int = 16):
    """Optionally materialize the transcript tree, then build manifests."""
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir()
    if transcript_dir:
        transcript_dir = Path(transcript_dir)
        transcript_dir.mkdir(parents=True, exist_ok=True)
        logging.info("Creating transcript directories now.")
        _create_trans_dir(corpus_dir, transcript_dir)
    else:
        transcript_dir = corpus_dir / "MORPH" / "SDB"
        logging.info(
            "Preparing manifests without saving transcripts. Only core and "
            "noncore can be created. ")
        if not dataset_parts:
            dataset_parts = ["core", "noncore"]
    return prepare_manifests(
        transcript_dir=transcript_dir, dataset_parts=dataset_parts,
        manifest_dir=manifest_dir, num_jobs=nj)


def concat_csj_supervisions(
    supervisions: SupervisionSet, gap: float, maxlen: float,
    max_extend_right: float = 0.0) -> SupervisionSet:
    """Utility: merge consecutive same-speaker supervisions under a gap/length
    budget (segments containing '×' act as hard boundaries and are dropped)."""
    grouped: List[List[SupervisionSegment]] = []
    run: List[SupervisionSegment] = []
    for sup in copy.deepcopy(supervisions):
        if "×" in sup.custom["raw"]:
            if run:
                grouped.append(run)
                run = []
        elif not run:
            run.append(sup)
        elif (sup.speaker != run[0].speaker) or (sup.end - run[0].start) >= maxlen:
            grouped.append(run)
            run = [sup]
        elif (sup.start - run[-1].end) >= gap:
            run[-1].duration += min(max_extend_right, sup.start - run[-1].end)
            grouped.append(run)
            run = [sup]
        else:
            run.append(sup)
    if run:
        grouped.append(run)

    merged = []
    for run in grouped:
        head = run[0]
        head.duration = run[-1].end - head.start
        for key in head.custom:
            if key == "raw":
                head.custom[key] = " ".join(sp.custom[key] for sp in run)
            elif "_tag" in key:
                head.custom[key] = ",".join(sp.custom[key] for sp in run)
            else:
                head.custom[key] = "".join(sp.custom[key] for sp in run)
        head.text = "".join(sp.text for sp in run)
        merged.append(head)
    return SupervisionSet.from_segments(merged)
