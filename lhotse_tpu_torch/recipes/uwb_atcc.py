"""
UWB-ATCC recipe (copied from ``lhotse_tpu/recipes/uwb_atcc.py``): 20 h of
Czech air-traffic-control radio communication in English (8 kHz mono),
transcribed by hand with the speaker's role (pilot or controller), in the
layout of the unpacked ``ZCU_CZ_ATC`` archive::

    <name>.wav    # 8 kHz
    <name>.trs    # Transcriber XML, cp1250; audio_filename="e2_<name>.wav"

The ``Sync`` marks of each ``Turn`` delimit the segments; ``[air]``,
``[ground]`` and ``[air_|]``/``[ground_|]`` give the speaker role, and a
segment without one is dropped. Five transcripts of the release are cut
off; the closing tags are appended before they are parsed. The text goes
through the corpus's own spelling pipeline (markup, phonetic alphabet,
numbers in words, typo fixes); numbers are verbalised by a local converter
instead of the ``num2words`` package. The download, which unpacks a RAR
archive, is not ported.
"""
import logging
import re
import unicodedata
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.recipes.utils import finalize_manifests
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

_NUM_TRS_FILES = 2657
# These transcripts ship with truncated XML; appending the closing tags fixes them.
_TRUNCATED_TRS = ("ACCU-80UXVV", "ACCU-7NqzYv", "ACCU-PhR5Oj", "ACCU-JaeNLH", "TWR-XgqNSk")

SPEAKER_TO_ID_SUFFIX = {"air_ground": "PIAT", "ground": "AT", "air": "PI"}

ABBREVIATIONS = {
    ".": "DECIMAL", "..": "DECIMAL DECIMAL", "FL": "FLIGHT LEVEL", "Fl": "FLIGHT LEVEL",
    "LLZ": "LOCALIZER", "PR": "PAPA ROMEO", "RWY": "RUNWAY"}

UNKNOWN_ABBREVIATIONS = ("HDO", "VOZ", "VLM")

PHONETIC_ALPHABET = {
    "A": "ALFA", "B": "BRAVO", "C": "CHARLIE", "D": "DELTA", "E": "ECHO", "F": "FOXTROT",
    "G": "GOLF", "H": "HOTEL", "I": "INDIA", "J": "JULIETT", "K": "KILO", "L": "LIMA",
    "M": "MIKE", "N": "NOVEMBER", "O": "OSCAR", "P": "PAPA", "Q": "QUEBEC", "R": "ROMEO",
    "S": "SIERRA", "T": "TANGO", "U": "UNIFORM", "V": "VICTOR", "W": "WHISKEY",
    "X": "XRAY", "Y": "YANKEE", "Z": "ZULU"}

INDIVIDUALLY_PRONOUNCED = (
    "ATR", "CRJ", "CSA", "CTO", "DEM", "DME", "EFC", "IFR", "ILS", "KLM", "QNH", "TMA",
    "UPS", "VFR", "VMC", "VOR")

FIX_TYPOS = {
    "ACCELARATING": "ACCELERATING", "ACCPET": "ACCEPT", "ACTUALY": "ACTUALLY",
    "AFETRNOON": "AFTERNOON", "AFFRIM": "AFFIRM", "AFTENOON": "AFTERNOON",
    "AFTERNON": "AFTERNOON", "AIRBORN": "AIRBORNE", "ALLRIGHT": "ALL RIGHT",
    "ALTITUED": "ALTITUDE", "APPORACH": "APPROACH", "APPORACHING": "APPROACHING",
    "APPRAOCH": "APPROACH", "APPROCHING": "APPROACHING", "APPRON": "APRON",
    "APROVED": "APPROVED", "APROXIMATELY": "APPROXIMATELY", "APROXIMETLY": "APPROXIMATELY",
    "AUSRTIAN": "AUSTRIAN", "AUSTRAIN": "AUSTRIAN", "AVAILBALE": "AVAILABLE",
    "AVALIABLE": "AVAILABLE", "AVIALABLE": "AVAILABLE", "BOARDLINE": "BROAD LINE",
    "BRUSSELES": "BRUSSELS", "BRUSSELS": "BRUSSELS", "CANCELED": "CANCELLED",
    "CANCELING": "CANCELLING", "CHALENGER": "CHALLENGER", "CHECH": "CZECH",
    "CIMB": "CLIMB", "CIMBING": "CLIMBING", "CLEARD": "CLEARED", "CLEARENCE": "CLEARANCE",
    "CLIBM": "CLIMB", "CLIMBIN": "CLIMBING", "CLMBING": "CLIMBING", "COMMING": "COMING",
    "CONACT": "CONTACT", "CONATACT": "CONTACT", "CONNTINUE": "CONTINUE",
    "CONTAC": "CONTACT", "CONTACE": "CONTACT", "CONTATC": "CONTACT",
    "CONTROLE": "CONTROL", "CONTROLO": "CONTROL", "COORECTION": "CORRECTION",
    "COPPIED": "COPIED", "CORECTION": "CORRECTION", "COTACT": "CONTACT",
    "COTINUE": "CONTINUE", "COTNACT": "CONTACT", "CURCUIT": "CIRCUIT",
    "DEAPARTURE": "DEPARTURE", "DEAPRTURE": "DEPARTURE", "DECEND": "DESCEND",
    "DEGEES": "DEGREES", "DEGRES": "DEGREES", "DENCENDING": "DESCENDING",
    "DEPARURE": "DEPARTURE", "DESCEDING": "DESCENDING", "DESCEN": "DESCEND",
    "DESCENG": "DESCEND", "DESCENIDNG": "DESCENDING", "DESCNED": "DESCEND",
    "DESECEND": "DESCEND", "DESEND": "DESCEND", "DESSCEND": "DESCEND", "DIREC": "DIRECT",
    "DISCRTION": "DISCRETION", "EADING": "HEADING", "ESTABLSIH": "ESTABLISH",
    "ESTALBISHED": "ESTABLISHED", "ETABLISHED": "ESTABLISHED", "ETIOPIAN": "ETHIOPIAN",
    "EVNING": "EVENING", "EXEPECT": "EXPECT", "EXPERIANCING": "EXPERIENCING",
    "EXTANSION": "EXTENSION", "FAVOUR": "FAVOR", "FINNARI": "FINNAIR",
    "FLIGTH": "FLIGHT", "FOLOW": "FOLLOW", "FOURTY": "FORTY",
    "GERMANWING": "GERMANWINGS", "GOAHEAD": "GO AHEAD", "GODD": "GOOD",
    "GOODBYE": "GOOD BYE", "GROSJET": "GROSSJET", "GROUDN": "GROUND", "HALLO": "HELLO",
    "HEADINT": "HEADING", "HEADNIG": "HEADING", "HEDING": "HEADING",
    "HODLING": "HOLDING", "HUDRED": "HUNDRED", "IFORMATION": "INFORMATION",
    "INBOUD": "INBOUND", "INBOUDN": "INBOUND", "INFOMRATION": "INFORMATION",
    "INITIALY": "INITIALLY", "INTERESCTION": "INTERSECTION", "KDNOTS": "KNOTS",
    "KNTOS": "KNOTS", "LANDA": "LAND", "LCIMB": "CLIMB", "LENGHT": "LENGTH",
    "LENGT": "LENGTH", "LEVELED": "LEVEL", "LEVLE": "LEVEL", "LIGHER": "LIGHTER",
    "LOUND": "LOUD", "LUFHANSA": "LUFTHANSA", "LUFHTANSA": "LUFTHANSA",
    "LUFTAHNSA": "LUFTHANSA", "LUFTHASNA": "LUFTHANSA", "MAINATINANING": "MAINTAINING",
    "MAINTAING": "MAINTAINING", "MAINTANING": "MAINTAINING", "MAITAIN": "MAINTAIN",
    "MINTUES": "MINUTES", "MOLDAVA": "MOLDOVA", "MOORNING": "MORNING",
    "NEAGATIVE": "NEGATIVE", "NINTEEN": "NINETEEN", "NINTY": "NINETY", "NOICE": "NOISE",
    "NORTHSHUTTLE": "NORSHUTTLE", "NORTHSTHUTTEL": "NORSHUTTLE",
    "NORTHSTHUTTLE": "NORSHUTTLE", "NOSIG": "NOSING", "NOSRHUTLE": "NORSHUTTLE",
    "OPOSITE": "OPPOSITE", "OT": "TO", "PASSINF": "PASSING", "PASSIN": "PASSING",
    "PLESE": "PLEASE", "POSSBILE": "POSSIBLE", "PREFERED": "PREFERRED",
    "PROCCEDING": "PROCEEDING", "PROCEEDTO": "PROCEED TO", "PSSING": "PASSING",
    "QHN": "QNH", "QUANTAS": "QANTAS", "QUATARI": "QATARI", "RADR": "RADAR",
    "READBACK": "READ BACK", "RECOMEND": "RECOMMEND", "REQEUSTED": "REQUESTED",
    "REQEUST": "REQUEST", "REQUESTE": "REQUEST", "REQUSTED": "REQUESTED",
    "REQUSTING": "REQUESTING", "RESETING": "RESETTING", "RESRTICTION": "RESTRICTION",
    "RESTRCTIONS": "RESTRICTIONS", "RESTRISCTION": "RESTRICTION", "RIGH": "RIGHT",
    "ROGGER": "ROGER", "ROGRE": "ROGER", "SESION": "DECISION", "SHOTRCUT": "SHORTCUT",
    "SINAGAPORE": "SINGAPORE", "SINGAPOOR": "SINGAPORE", "SKYRAVEL": "SKYTRAVEL",
    "SKYTAVEL": "SKYTRAVEL", "SMARTWING": "SMARTWINGS", "SPEEDBIRG": "SPEEDBIRD",
    "SQUAKING": "SQUAWKING", "SQUAK": "SQUAWK", "SQUWAK": "SQUAWK",
    "STANDAR": "STANDARD", "STANDART": "STANDARD", "STARTUP": "START UP",
    "SUFFICIAN": "SUFFICIENT", "SWTICHING": "SWITCHING", "TAHNK": "THANK",
    "TECHNICAN": "TECHNICIAN", "TELAVIV": "TEL AVIV", "THAT'T": "THAT'S",
    "THIRDY": "THIRTY", "THOSUAND": "THOUSAND", "THOUASAND": "THOUSAND",
    "TIMECHECK": "TIME CHECK", "TRAFIC": "TRAFFIC", "TRESHOLD": "THRESHOLD",
    "TUBULENCE": "TURBULENCE", "TURBOLENCE": "TURBULENCE", "TURUBLENCE": "TURBULENCE",
    "UNREADEBLE": "UNREADABLE", "UNTILL": "UNTIL", "UTNIL": "UNTIL", "VACAT": "VACATE",
    "VECTORIN": "VECTOR IN", "WCHICH": "WHICH", "WIHT": "WITH", "WINE": "WIEN",
    "WIZZIAR": "WIZZAIR", "WONDREFUL": "WONDERFUL"}

COLLAPSE_WORDS = (
    ("AIR SPACE", "AIRSPACE"), ("CLEAR FOR", "CLEARED FOR"), ("DESCENT TO", "DESCEND TO"),
    ("DESCENT FLIGHT", "DESCEND FLIGHT"), ("DESCEND RATE", "DESCENT RATE"),
    ("STAND BYE", "STANDBY"))


def strip_accents(s: str) -> str:
    return "".join(
        c for c in unicodedata.normalize("NFD", s) if unicodedata.category(c) != "Mn")


_ONES = ("ZERO ONE TWO THREE FOUR FIVE SIX SEVEN EIGHT NINE TEN ELEVEN TWELVE "
         "THIRTEEN FOURTEEN FIFTEEN SIXTEEN SEVENTEEN EIGHTEEN NINETEEN").split()
_TENS = ("", "", "TWENTY", "THIRTY", "FORTY", "FIFTY", "SIXTY", "SEVENTY", "EIGHTY",
         "NINETY")


def int_to_words(n: int) -> str:
    """English words for a non-negative integer (num2words-compatible shape)."""
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, ones = divmod(n, 10)
        return _TENS[tens] + (f" {_ONES[ones]}" if ones else "")
    for scale, name in ((10**9, "BILLION"), (10**6, "MILLION"), (1000, "THOUSAND"),
                        (100, "HUNDRED")):
        if n >= scale:
            head, rest = divmod(n, scale)
            out = f"{int_to_words(head)} {name}"
            return f"{out} {int_to_words(rest)}" if rest else out
    return _ONES[n]


# transcription-markup patterns (module-level so text_normalize stays cheap)
_PAD_OPEN = re.compile(r"([\w.+])([\[(])")
_PAD_CLOSE = re.compile(r"([\])])([\w+])")
_COMMENT = re.compile(r"\[comment_\|].*?\[\|_comment]")
_BG_SPEECH = re.compile(r"\[background_speech_\|](.*?)\[\|_background_speech]")
_NOISE_SPAN = re.compile(r"\[noise_\|](.*?)\[\|_noise]")
_SPEAKER_SPAN = re.compile(r"\[speaker_\|](.*?)\[\|_speaker]")
_DOT_NUM = re.compile(r"\.([0-9])")
_NUM_DOT = re.compile(r"([0-9])\.")
_PHONETIC_CUT1 = re.compile(r"([A-Z]+\+)")
_PHONETIC_CUT2 = re.compile(r"(\+[A-Z]+)")
_CUT1 = re.compile(r"(\w+\+)")
_CUT2 = re.compile(r"(\+\w+)")
_ABBREV_EXPANSION = re.compile(r"\(((\w*|\s*|\+)*)\(((\w*|\s*)*)\)\)")
_NUM_ALPHA = re.compile(r"([0-9])([A-Za-z])")
_ALPHA_NUM = re.compile(r"([A-Za-z])([0-9])")
_NO_ENG = re.compile(r"\[NO_ENG_\|](.*?)\[\|_NO_ENG]")
_CZECH = re.compile(r"\[CZECH_\|](.*?)\[\|_CZECH]")
_UNINTELLIGIBLE = re.compile(r"\[UNINTELLIGIBLE_\|](.*?)\[\|_UNINTELLIGIBLE]")
_MULTISPACE = re.compile(r"  +")


def text_normalize(
    text: str, silence_sym: str, breath_sym: str, noise_sym: str,
    foreign_sym: Optional[str], unintelligble_sym: Optional[str],
    partial_sym: Optional[str], unknown_sym: str) -> str:
    """The UWB-ATCC spelling pipeline: markup stripping, phonetic-alphabet
    expansion, number verbalization, typo fixes."""
    text = _PAD_OPEN.sub(r"\1 \2", text)
    text = _PAD_CLOSE.sub(r"\1 \2", text)
    text = text.replace("](", "] (")
    for ch in ("°", "?", "¨"):
        text = text.replace(ch, "")
    text = text.replace("´", "'")
    text = _COMMENT.sub("", text)
    text = _BG_SPEECH.sub(r"\1", text)
    text = _NOISE_SPAN.sub(r"\1", text)
    text = _SPEAKER_SPAN.sub(r"\1", text)
    text = _DOT_NUM.sub(r". \1", text)
    text = _NUM_DOT.sub(r"\1 .", text)
    text = _PHONETIC_CUT1.sub(lambda m: m.group(1).lower(), text)
    text = _PHONETIC_CUT2.sub(lambda m: m.group(1).lower(), text)
    text = _ABBREV_EXPANSION.sub(r"\1", text)
    text = text.replace("6raha", "praha")
    text = _NUM_ALPHA.sub(r"\1 \2", text)
    text = _ALPHA_NUM.sub(r"\1 \2", text)
    text = strip_accents(text)

    token_replacements = {
        "[ehm_]": breath_sym, "[noise]": noise_sym, "[unintelligible]": unknown_sym,
        "[background_speech]": noise_sym, "[speaker]": breath_sym}

    def verbalize(w: str) -> str:
        if w in token_replacements:
            return token_replacements[w]
        if w in UNKNOWN_ABBREVIATIONS:
            return unknown_sym
        if w in ABBREVIATIONS:
            return ABBREVIATIONS[w]
        if w in INDIVIDUALLY_PRONOUNCED:
            return " ".join(w).upper()
        if w in PHONETIC_ALPHABET:
            return PHONETIC_ALPHABET[w]
        if w.isdigit():
            return int_to_words(int(w))
        return w.upper()

    text = " ".join(verbalize(w) for w in text.split())
    foreign_repl = r"\1" if foreign_sym is None else foreign_sym
    text = text.replace("[NO_ENG]", unknown_sym if foreign_sym is None else foreign_sym)
    text = _NO_ENG.sub(foreign_repl, text)
    text = _CZECH.sub(foreign_repl, text)
    text = _UNINTELLIGIBLE.sub(
        r"\1" if unintelligble_sym is None else unintelligble_sym, text)
    if partial_sym is not None:
        text = _CUT1.sub(partial_sym, text)
        text = _CUT2.sub(partial_sym, text)
    text = text.replace("+", "")
    text = _MULTISPACE.sub(" ", text).strip()
    text = " ".join(FIX_TYPOS.get(w, w) for w in text.split())
    for src, dst in COLLAPSE_WORDS:
        text = text.replace(src, dst)
    return text


def _finish_segment(supervisions: list, segment: SupervisionSegment, end_time: float):
    segment.duration = end_time - segment.start
    segment.id += "_%06d_%s" % (end_time * 100, SPEAKER_TO_ID_SUFFIX[segment.speaker])
    supervisions.append(segment)


def _speaker_role(text: str) -> Optional[str]:
    if "[air_|]" in text or "[ground_|]" in text:
        return "air_ground"
    if "[air]" in text:
        return "air"
    if "[ground]" in text:
        return "ground"
    return None


def _load_trs(path: Path) -> ET.Element:
    if path.stem in _TRUNCATED_TRS:
        with open(path, encoding="cp1250") as f:
            return ET.fromstring(f.read() + "</Turn></Section></Episode></Trans>")
    return ET.parse(path).getroot()


def prepare_uwb_atcc(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
    silence_sym: Optional[str] = "", breath_sym: Optional[str] = "",
    noise_sym: Optional[str] = "", foreign_sym: Optional[str] = "<unk>",
    partial_sym: Optional[str] = "<unk>", unintelligble_sym: Optional[str] = "<unk>",
    unknown_sym: Optional[str] = "<unk>",
) -> Dict[str, Union[RecordingSet, SupervisionSet]]:
    """Single-part manifests off the extracted ZCU_CZ_ATC directory."""
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    trs_files = sorted(corpus_dir.glob("*.trs"), key=lambda p: p.name)
    if len(trs_files) != _NUM_TRS_FILES:
        logging.warning(
            f"Expected {_NUM_TRS_FILES} .trs transcripts, found {len(trs_files)}")

    normalize = lambda t: text_normalize(  # noqa: E731
        t, silence_sym=silence_sym, breath_sym=breath_sym, noise_sym=noise_sym,
        foreign_sym=foreign_sym, partial_sym=partial_sym,
        unintelligble_sym=unintelligble_sym, unknown_sym=unknown_sym)

    recordings, supervisions = [], []
    for t in trs_files:
        root = _load_trs(t)
        audio_path = corpus_dir / root.attrib["audio_filename"][len("e2_"):]
        if not audio_path.is_file():
            logging.warning(f"No such file: {audio_path}")
            continue
        recording = Recording.from_file(audio_path)
        recordings.append(recording)
        open_segment = None
        for section in root.findall(".//Section"):
            for turn in section:
                if turn.tag != "Turn":
                    logging.warning(f"Unexpected tag: {turn.tag}")
                    continue
                end_time = float(turn.attrib["endTime"])
                for sync in turn:
                    if sync.tag != "Sync":
                        logging.warning(f"Unexpected tag: {sync.tag}")
                        continue
                    time = float(sync.attrib["time"])
                    if open_segment:
                        _finish_segment(supervisions, open_segment, time)
                        open_segment = None
                    raw = (sync.tail or "").strip()
                    if not raw:
                        continue
                    speaker = _speaker_role(raw)
                    if speaker is None:
                        continue
                    text = raw.replace("][", "] [")
                    for label in ("[air_|]", "[|_air]", "[ground_|]", "[|_ground]",
                                  "[air]", "[ground]"):
                        text = text.replace(label, "")
                    text = normalize(text)
                    if not text:
                        continue
                    open_segment = SupervisionSegment(
                        id="uwb-atcc_%s_%06d" % (audio_path.stem, time * 100),
                        recording_id=recording.id, start=time,
                        duration=0,  # filled when the closing Sync/Turn arrives
                        channel=0, language="English", text=text, speaker=speaker,
                        custom={
                            "type": section.attrib["type"],
                            "orig_text": _MULTISPACE.sub(" ", raw)})
                if open_segment:
                    _finish_segment(supervisions, open_segment, end_time)
                    open_segment = None

    manifests = finalize_manifests(recordings, supervisions)
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        manifests["supervisions"].to_file(output_dir / "uwb_atcc_supervisions_all.jsonl.gz")
        manifests["recordings"].to_file(output_dir / "uwb_atcc_recordings_all.jsonl.gz")
    return manifests
