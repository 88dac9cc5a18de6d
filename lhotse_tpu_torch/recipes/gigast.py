"""
GigaST recipe (copied from ``lhotse_tpu/recipes/gigast.py``): speech
translation labels over GigaSpeech audio, machine-translated train text and
human-translated test text (https://arxiv.org/abs/2204.03939). It needs
GigaSpeech's manifests prepared beforehand: it walks their supervisions in
order, attaches the translated text where the segment ids line up, and
writes only supervisions (the recordings stay GigaSpeech's). A cached
re-run reads its manifests back, so that it returns what the first run did.
``download_gigast`` is not ported: it needs the network.
"""
import json
import logging
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.recipes.utils import manifests_exist, read_manifests_if_cached
from lhotse_tpu_torch.supervision import SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

GIGASPEECH_PARTS = ("XL", "L", "M", "S", "XS", "DEV", "TEST")
GIGAST_LANGS = ("de", "zh")


class GigaST:
    """Streams segment rows across the per-audio structure of GigaST.json."""

    def __init__(self, corpus_dir: Pathlike, lang: str):
        with open(Path(corpus_dir) / f"GigaST.{lang}.json") as f:
            self.audio_generator = iter(json.load(f)["audios"])
        self.segment_generator = iter(next(self.audio_generator)["segments"])

    def get_next_line(self):
        try:
            return next(self.segment_generator)
        except StopIteration:
            self.segment_generator = iter(next(self.audio_generator)["segments"])
            return next(self.segment_generator)


def prepare_gigast(
    corpus_dir: Pathlike, manifests_dir: Pathlike, output_dir: Optional[Pathlike],
    languages: Union[str, Sequence[str]] = "auto",
    dataset_parts: Union[str, Sequence[str]] = "auto",
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """Translated supervision manifests aligned to GigaSpeech segment ids."""
    corpus_dir = Path(corpus_dir)
    manifests_dir = Path(manifests_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    logging.info("Preparing GigaST...")
    languages = GIGAST_LANGS if languages == "auto" else languages
    if isinstance(languages, str):
        languages = [languages]
    dataset_parts = ("XL", "TEST") if dataset_parts == "auto" else dataset_parts
    if isinstance(dataset_parts, str):
        dataset_parts = [dataset_parts]
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)

    gigaspeech = read_manifests_if_cached(
        dataset_parts=dataset_parts, output_dir=manifests_dir, prefix="gigaspeech",
        suffix="jsonl.gz")
    assert gigaspeech is not None
    assert len(gigaspeech) == len(dataset_parts), (
        len(gigaspeech), len(dataset_parts), list(gigaspeech.keys()), dataset_parts)

    out = {}
    for lang in languages:
        assert lang in GIGAST_LANGS, (lang, GIGAST_LANGS)
        logging.info(f"Loading GigaST.{lang}.json")
        gigast = GigaST(corpus_dir, lang)
        for partition, m in gigaspeech.items():
            if manifests_exist(
                    part=partition, output_dir=output_dir, prefix=f"gigast-{lang}",
                    suffix="jsonl.gz"):
                logging.info(
                    f"GigaST {lang} subset: {partition} already prepared - skipping.")
                # Unlike upstream lhotse (which also checks a
                # hardcoded 'gigast-de' prefix for every language and returns
                # None), read the cached manifest back so re-runs are
                # equivalent to first runs.
                cached = read_manifests_if_cached(
                    dataset_parts=[partition], output_dir=output_dir,
                    prefix=f"gigast-{lang}", suffix="jsonl.gz",
                    types=("supervisions",))
                if cached and partition in cached:
                    out[f"{lang}-{partition}"] = cached[partition]
                continue
            logging.info(f"Processing {partition}")
            supervisions = []
            cur_line = gigast.get_next_line()
            for sup in m["supervisions"]:
                if cur_line["sid"] != sup.id:
                    continue
                if partition != "TEST":
                    sup.custom = {
                        "text_raw": cur_line["text_raw"], "extra": cur_line["extra"]}
                else:
                    sup.custom = {"text_raw": cur_line["text_raw"]}
                supervisions.append(sup)
                try:
                    cur_line = gigast.get_next_line()
                except StopIteration:
                    break
            logging.info(f"Saving GigaST {lang} subset: {partition}")
            supervisionset = SupervisionSet.from_segments(supervisions)
            if output_dir is not None:
                supervisionset.to_file(
                    output_dir / f"gigast-{lang}_supervisions_{partition}.jsonl.gz")
            out[f"{lang}-{partition}"] = {"supervisions": supervisionset}
    return out
