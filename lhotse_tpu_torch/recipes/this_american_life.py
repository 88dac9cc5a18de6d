"""
This American Life recipe (copied from
``lhotse_tpu/recipes/this_american_life.py``): 663 episodes (637 h) of the
radio programme with aligned transcripts (arXiv:2005.08072), in the layout
its download leaves::

    {train,valid,test}-transcripts-aligned.json
        # {episode: [{utterance, n_words, utterance_start, utterance_end,
        #             speaker, alignments: [[start, end, word index], ...]}]}
    audio/<episode>.mp3

The ``dev`` part reads the ``valid`` file. Each supervision carries its
word alignment, indexing into the tokenized utterance: tokens come from
``nltk.word_tokenize`` where nltk is installed and its tokenizer data is
present, and from a regex otherwise. An episode without its MP3 is skipped.
The download, which scrapes the programme's web site, is not ported.
"""
import json
import logging
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.recipes.utils import finalize_manifests
from lhotse_tpu_torch.supervision import AlignmentItem, SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike, is_module_available

_FALLBACK_TOKEN = re.compile(r"\w+(?:['']\w+)?|[^\w\s]")


def _tokenize(text: str) -> List[str]:
    if is_module_available("nltk"):
        try:
            from nltk import word_tokenize

            return word_tokenize(text)
        except LookupError:
            # nltk is installed but its tokenizer data (punkt) is not
            # downloaded; the regex keeps the recipe usable offline.
            pass
    return _FALLBACK_TOKEN.findall(text)


def included_episodes(target_dir: Pathlike) -> Iterable[str]:
    """The episode ids of the train, valid and test transcripts."""
    for subset in ("train", "valid", "test"):
        with open(Path(target_dir) / f"{subset}-transcripts-aligned.json") as f:
            yield from json.load(f).keys()


def prepare_this_american_life_subset(
    corpus_dir: Pathlike, subset: str, output_dir: Optional[Pathlike] = None,
) -> Dict[str, Union[RecordingSet, SupervisionSet]]:
    """One part's manifests, written as
    ``this-american-life_{recordings,supervisions}_<subset>.jsonl.gz``."""
    corpus_dir = Path(corpus_dir).absolute()
    file_subset = "valid" if subset == "dev" else subset
    transcripts = json.loads(
        (corpus_dir / f"{file_subset}-transcripts-aligned.json").read_text())

    recordings, supervisions = [], []
    for ep_id, transcript in transcripts.items():
        audio_path = corpus_dir / "audio" / f"{ep_id}.mp3"
        if not audio_path.is_file():
            logging.warning(f"File {audio_path} not found - skipping.")
            continue
        recordings.append(Recording.from_file(audio_path))
        for utt_ix, utt in enumerate(transcript):
            text = utt["utterance"]
            words = _tokenize(text)
            if len(words) != utt["n_words"]:
                logging.warning(
                    f"Transcript mismatch for {ep_id}-{utt_ix}: {utt['n_words']} words "
                    f"in the transcript, {len(words)} tokens in the text.")
            alignment = [
                AlignmentItem(words[int(ix)], start, end - start)
                for start, end, ix in utt["alignments"]
                if ix < len(words)]
            supervisions.append(
                SupervisionSegment(
                    id=f"{ep_id}-{utt_ix}", recording_id=ep_id,
                    start=utt["utterance_start"],
                    duration=utt["utterance_end"] - utt["utterance_start"], channel=0,
                    text=text, language="en", speaker=utt["speaker"],
                ).with_alignment("word", alignment))
    return finalize_manifests(
        recordings, supervisions, output_dir=output_dir,
        prefix="this-american-life", part=subset)


def prepare_this_american_life(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """train/dev/test manifests from the aligned transcripts and the MP3s."""
    return {
        subset: prepare_this_american_life_subset(corpus_dir, subset, output_dir)
        for subset in ("train", "dev", "test")}
