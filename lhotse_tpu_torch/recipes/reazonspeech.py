"""
ReazonSpeech recipe (copied from ``lhotse_tpu/recipes/reazonspeech.py``):
35,000+ h of natural Japanese speech from terrestrial TV
(https://huggingface.co/datasets/reazon-research/reazonspeech). The
preparation reads a local ``dataset.json`` (id, audio path, normalised text
and duration per row) and splits it into fixed parts: dev is the first 1,000
rows, test the next 100, train the rest; each part is streamed into lazy
recording, supervision and cut writers. ``normalize`` turns fullwidth
characters halfwidth, strips punctuation and reads digits out in Japanese
(through ``num2words`` where it is installed, else a local converter). The
download, which goes through the ``datasets`` package, is not ported.
"""
import json
import logging
import re
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.parallel import parallel_map
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.recipes.utils import manifests_exist, read_manifests_if_cached
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike, is_module_available

REAZONSPEECH = (
    "tiny", "small", "medium", "large", "all", "small-v1", "medium-v1", "all-v1")

PUNCTUATIONS = {ord(x): "" for x in "、。「」『』，,？！!!?!?"}
ZENKAKU = "ａｂｃｄｅｆｇｈｉｊｋｌｍｎｏｐｑｒｓｔｕｖｗｘｙｚＡＢＣＤＥＦＧＨＩＪＫＬＭＮＯＰＱＲＳＴＵＶＷＸＹＺ０１２３４５６７８９"
HANKAKU = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
ZEN2HAN = str.maketrans(ZENKAKU, HANKAKU)

_JA_DIGITS = "〇一二三四五六七八九"
_JA_SMALL = ((1000, "千"), (100, "百"), (10, "十"))
_JA_BIG = ((10**12, "兆"), (10**8, "億"), (10**4, "万"))


def _ja_under_10000(n: int) -> str:
    if n == 0:
        return ""
    out = []
    for base, name in _JA_SMALL:
        d, n = divmod(n, base)
        if d:
            out.append(("" if d == 1 else _JA_DIGITS[d]) + name)
    if n:
        out.append(_JA_DIGITS[n])
    return "".join(out)


def _ja_number(text: str) -> str:
    """Japanese reading of an integer/decimal string (num2words-style)."""
    if "." in text:
        whole, frac = text.split(".", 1)
        return _ja_number(whole) + "点" + "".join(_JA_DIGITS[int(c)] for c in frac)
    n = int(text)
    if n == 0:
        return "ゼロ"
    out = []
    for base, name in _JA_BIG:
        d, n = divmod(n, base)
        if d:
            out.append(_ja_under_10000(d) + name)
    out.append(_ja_under_10000(n))
    return "".join(out)


def normalize(s: str) -> str:
    """Fullwidth -> halfwidth, strip punctuation, verbalize digits."""
    s = s.translate(PUNCTUATIONS).translate(ZEN2HAN)
    if is_module_available("num2words"):
        import num2words

        conv = lambda m: num2words.num2words(m.group(0), lang="ja")  # noqa: E731
    else:
        conv = lambda m: _ja_number(m.group(0))  # noqa: E731
    return re.sub(r"\d+\.?\d*", conv, s)


def write_to_json(data, filename) -> None:
    with open(filename, "w", encoding="utf-8") as f:
        json.dump(data, f, ensure_ascii=False, indent=4)


def parse_utterance(item: Any) -> Optional[Tuple[Recording, SupervisionSegment]]:
    recording = Recording.from_file(item["audio_filepath"], recording_id=item["id"])
    segment = SupervisionSegment(
        id=item["id"], recording_id=item["id"], start=0.0, duration=item["duration"],
        channel=0, language="Japanese", text=item["text"])
    return recording, segment


def prepare_reazonspeech(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike], num_jobs: int = 1,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """Split dataset.json 1000/100/rest into dev/test/train lazy manifests."""
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    full = json.loads((corpus_dir / "dataset.json").read_text(encoding="utf-8"))
    splits = {"dev": full[:1000], "test": full[1000:1100], "train": full[1100:]}
    for part, items in splits.items():
        write_to_json(items, corpus_dir / f"{part}.json")

    parts = ("train", "dev", "test")
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    # types includes "cuts" so a cached re-run returns the cuts manifest too.
    manifests = read_manifests_if_cached(
        dataset_parts=parts, output_dir=output_dir, prefix="reazonspeech",
        suffix="jsonl.gz", types=("recordings", "supervisions", "cuts"),
        lazy=True) or {}

    for part in parts:
        if manifests_exist(
                part=part, output_dir=output_dir, prefix="reazonspeech", suffix="jsonl.gz"):
            logging.info(f"ReazonSpeech subset: {part} already prepared - skipping.")
            continue
        logging.info(f"Processing ReazonSpeech subset: {part}")
        items = json.loads((corpus_dir / f"{part}.json").read_text(encoding="utf-8"))
        with RecordingSet.open_writer(
                output_dir / f"reazonspeech_recordings_{part}.jsonl.gz") as rec_writer, \
                SupervisionSet.open_writer(
                    output_dir / f"reazonspeech_supervisions_{part}.jsonl.gz") as sup_writer, \
                CutSet.open_writer(
                    output_dir / f"reazonspeech_cuts_{part}.jsonl.gz") as cut_writer:
            for recording, segment in parallel_map(
                    parse_utterance, items, num_jobs=num_jobs):
                recordings, segments = fix_manifests(
                    recordings=RecordingSet.from_recordings([recording]),
                    supervisions=SupervisionSet.from_segments([segment]))
                validate_recordings_and_supervisions(
                    recordings=recordings, supervisions=segments)
                cuts = CutSet.from_manifests(recordings=recordings, supervisions=segments)
                rec_writer.write(recordings[0])
                sup_writer.write(segments[0])
                cut_writer.write(cuts[0])
        manifests[part] = {
            "recordings": RecordingSet.from_jsonl_lazy(rec_writer.path),
            "supervisions": SupervisionSet.from_jsonl_lazy(sup_writer.path),
            "cuts": CutSet.from_jsonl_lazy(cut_writer.path)}
    return manifests
