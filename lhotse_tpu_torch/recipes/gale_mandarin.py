"""
GALE Mandarin broadcast speech recipe (copied from
``lhotse_tpu/recipes/gale_mandarin.py``): broadcast news and conversation
across the LDC GALE Mandarin releases, passed in matched speech and
transcript pairs as for GALE Arabic. The dev split is the list of
recording ids that the Kaldi repository publishes per LDC speech corpus:
``_fetch_dev_ids`` reads it from the network in every call, as the
original does. The ``segment_words`` option splits the transcripts into
words with ``jieba``.
"""
import logging
from itertools import chain
from typing import Dict, List, Optional, Union
from urllib.request import urlopen

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.recipes._tdf import tdf_supervisions
from lhotse_tpu_torch.recipes.gale_arabic import scan_gale_audio, split_gale_manifests
from lhotse_tpu_torch.recipes.utils import finalize_manifests
from lhotse_tpu_torch.supervision import SupervisionSet
from lhotse_tpu_torch.utils import Pathlike, check_and_rglob, is_module_available

# Dev recording ids are published in the Kaldi repo per LDC speech corpus.
KALDI_BASE_URL = (
    "https://github.com/kaldi-asr/kaldi/blob/master/egs/gale_mandarin/s5/local/test.")
TEST_FILE_URLS = [
    KALDI_BASE_URL + name
    for name in (
        "LDC2013S04", "LDC2013S08", "LDC2014S09", "LDC2015S06", "LDC2015S13",
        "LDC2016S03")]


def _fetch_dev_ids() -> List[str]:
    return [
        line.decode("utf-8").strip() for url in TEST_FILE_URLS for line in urlopen(url)]


def prepare_gale_mandarin(
    audio_dirs: List[Pathlike], transcript_dirs: List[Pathlike],
    output_dir: Optional[Pathlike] = None, absolute_paths: Optional[bool] = True,
    segment_words: Optional[bool] = False,
) -> Dict[str, Union[RecordingSet, SupervisionSet]]:
    """train/dev manifests off matched GALE Mandarin speech + transcript corpora."""
    if len(audio_dirs) != len(transcript_dirs):
        raise AssertionError(
            "Paths to the same speech and transcript corpora must be provided")
    transform_text = None
    if segment_words:
        if not is_module_available("jieba"):
            raise ImportError(
                "The 'segment_words' option requires the 'jieba' package to be "
                "installed. Please install it with 'pip install jieba' and try again."
            )
        import jieba

        transform_text = lambda t: " ".join(jieba.cut(t))  # noqa: E731

    logging.info("Reading audio and transcript paths from provided dirs")
    audio_paths = scan_gale_audio(audio_dirs)
    transcript_paths = list(
        chain.from_iterable(check_and_rglob(d, "*.tdf") for d in transcript_dirs))

    logging.info("Preparing recordings and supervisions manifests")
    recordings = RecordingSet.from_recordings(
        Recording.from_file(p, relative_path_depth=None if absolute_paths else 3)
        for p in audio_paths.values())
    supervisions = SupervisionSet.from_segments(
        tdf_supervisions(transcript_paths, language="Mandarin", transform_text=transform_text)
    ).filter(lambda s: s.recording_id in audio_paths)
    fixed = finalize_manifests(recordings, supervisions)

    return split_gale_manifests(
        fixed["recordings"], fixed["supervisions"], _fetch_dev_ids(), ("train", "dev"),
        output_dir, "gale-mandarin")
