"""
Export/Import CutSet ↔ HuggingFace Dataset (copied from
``lhotse_tpu/hf.py``): ``export_cuts_to_hf`` turns mono cuts with one audio
source into a ``datasets.Dataset``, and ``LazyHFDatasetIterator`` streams a
dataset (an object, or the arguments of ``datasets.load_dataset``) back as
cuts, image columns as :class:`~lhotse_tpu_torch.image.Image` manifests.
All operations are gated on the optional ``datasets`` package. The
``segments`` of a cut with several supervisions and the alignment items are
declared as lists of structs (``[Features(...)]``); the JAX package's
``Sequence(Features(...))`` is a struct of lists to ``datasets``, which
refuses the lists of dicts it is given (ROADMAP C2).
"""
from hashlib import md5
from typing import Any, Dict, List, Optional, Set, Tuple, Union

from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.cut import CutSet, MonoCut
from lhotse_tpu_torch.image import Image
from lhotse_tpu_torch.lazy import IteratorNode
from lhotse_tpu_torch.supervision import SupervisionSegment
from lhotse_tpu_torch.utils import is_module_available


def contains_only_mono_cuts(cutset: CutSet) -> bool:
    return all(isinstance(cut, MonoCut) for cut in cutset)


def has_one_supervision_per_cut(cutset: CutSet) -> bool:
    return all(len(cut.supervisions) == 1 for cut in cutset)


def has_one_audio_source(cutset: CutSet) -> bool:
    return all(len(cut.recording.sources) == 1 for cut in cutset)


def convert_cuts_info_to_hf(cutset: CutSet) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Cut attributes + the matching HF feature-type description."""
    from datasets import Audio, Value

    cut_info = {
        "id": [cut.id for cut in cutset],
        "audio": [cut.recording.sources[0].source for cut in cutset],
        "duration": [cut.duration for cut in cutset],
        "num_channels": [len(cut.recording.channel_ids) for cut in cutset]}
    # The audio column is declared as a plain string path at creation time
    # and cast to the Audio feature afterwards: HF datasets >= 5.0 requires
    # torchcodec inside Audio.encode_example even for path inputs, while the
    # arrow-level string->Audio cast is codec-free.
    cut_info_description = {
        "id": Value("string"), "audio": Value("string"), "duration": Value("float"),
        "num_channels": Value("uint16")}
    return cut_info, cut_info_description


def convert_supervisions_info_to_hf(
    cutset: CutSet, exclude_attributes: Optional[Union[List[str], Set[str]]] = None,
) -> Tuple[List[List[Dict[str, Any]]], Dict[str, Any]]:
    """Per-cut supervision dicts + the matching HF feature description."""
    from datasets import Features, Value

    def keep(attr: str) -> bool:
        return exclude_attributes is None or attr not in exclude_attributes

    def first_sup_has(attr: str) -> bool:
        return any(getattr(cut.supervisions[0], attr, None) is not None for cut in cutset)

    has_speaker, has_language = first_sup_has("speaker"), first_sup_has("language")
    alignment_types = {
        kind
        for c in cutset
        for s in c.supervisions
        if s.alignment is not None
        for kind in s.alignment
    }

    # (field, emit?, value-of-supervision, HF type)
    field_specs = [
        ("start", keep("start"), lambda s: s.start, Value("float")),
        ("end", keep("end"), lambda s: s.end, Value("float")),
        ( "channel", keep("channel"), lambda s: ",".join(map(str, s.channel)) if isinstance(s.channel, list) else str(s.channel), Value("string"), ),
        ("speaker", has_speaker and keep("speaker"), lambda s: str(s.speaker), Value("string")),
        ("language", has_language and keep("language"), lambda s: str(s.language), Value("string"))]
    emit_alignments = bool(alignment_types) and keep("alignments")

    def one_sup(s) -> Dict[str, Any]:
        row = {"text": s.text}
        for field, emit, value_of, _ in field_specs:
            if emit:
                row[field] = value_of(s)
        if emit_alignments:
            for kind in alignment_types:
                row[kind + "_alignment"] = [
                    {"symbol": item.symbol, "start": item.start, "end": item.end}
                    for item in s.alignment[kind]
                ]
        return row

    sup_dicts = [[one_sup(s) for s in c.supervisions] for c in cutset]

    sup_dicts_info = {"text": Value("string")}
    for field, emit, _, hf_type in field_specs:
        if emit:
            sup_dicts_info[field] = hf_type
    if emit_alignments:
        item_features = Features(symbol=Value("string"), start=Value("float"), end=Value("float"))
        for kind in alignment_types:
            sup_dicts_info[kind + "_alignment"] = [item_features]

    return sup_dicts, sup_dicts_info


def lod_to_dol(lod: List[Dict[str, Any]]) -> Dict[str, List]:
    """List of dicts → dict of lists."""
    return {k: [d[k] for d in lod] for k in lod[0].keys()}


def export_cuts_to_hf(cutset: CutSet):
    """
    Convert a CutSet into a HuggingFace Dataset (MonoCuts with one audio
    source): single-supervision cuts flatten the supervision fields into the
    row; multi-supervision cuts store them under a 'segments' sequence.
    """
    assert has_one_audio_source(cutset), (
        "Only CutSets with one audio source per cut are supported. "
        "MultiSource cuts coming soon."
    )

    if not is_module_available("datasets"):
        raise ImportError("Please install the 'datasets' package (pip install datasets).")
    from datasets import Dataset, Features

    # start/end/channel are redundant with one supervision per cut.
    cut_info, cut_info_description = convert_cuts_info_to_hf(cutset)
    sup_dicts, sup_dicts_info = convert_supervisions_info_to_hf(
        cutset,
        exclude_attributes={"start", "end", "channel"} if has_one_supervision_per_cut(cutset) else None,
    )

    if has_one_supervision_per_cut(cutset):
        dataset_dict = {**cut_info, **lod_to_dol([x[0] for x in sup_dicts])}
        dataset_info = Features(**cut_info_description, **sup_dicts_info)
    else:
        dataset_dict = {**cut_info, "segments": sup_dicts}
        dataset_info = Features(
            segments=[Features(**sup_dicts_info)], **cut_info_description)

    from datasets import Audio

    dataset = Dataset.from_dict(dataset_dict, features=dataset_info)
    return dataset.cast_column("audio", Audio(num_channels=None))


class LazyHFDatasetIterator(IteratorNode):
    """
    Stream a HuggingFace dataset as Cuts: pass an existing HF dataset object
    or args/kwargs for ``datasets.load_dataset()``. ``audio_key``,
    ``text_key``, ``lang_key``, ``gender_key`` name the example fields; the
    remaining keys land in ``cut.custom``.

    Example::

        >>> cuts_it = LazyHFDatasetIterator(
        ...     "mozilla-foundation/common_voice_11_0", "hi", split="test")
        >>> for cut in cuts_it: ...
    """

    def __init__(
        self, *dataset_args, audio_key: str = "audio", text_key: str = "sentence",
        lang_key: str = "language", gender_key: str = "gender", **dataset_kwargs):
        assert is_module_available("datasets"), (
            "LazyHFDatasetIterator requires the 'datasets' package "
            "(pip install datasets)."
        )
        self.audio_key, self.text_key = audio_key, text_key
        self.lang_key, self.gender_key = lang_key, gender_key
        self.dataset_args, self.dataset_kwargs = dataset_args, dataset_kwargs

    def __iter__(self):
        from datasets import (
            Audio, Dataset, DatasetDict, IterableDataset, IterableDatasetDict, load_dataset)

        if len(self.dataset_args) == 1 and isinstance(
            self.dataset_args[0], (Dataset, IterableDataset, DatasetDict, IterableDatasetDict)):
            dataset = self.dataset_args[0]
        else:
            dataset = load_dataset(*self.dataset_args, **self.dataset_kwargs)
        dataset = dataset.cast_column(self.audio_key, Audio(decode=False))
        for item in dataset:
            yield self._example_to_cut(item)

    def _example_to_cut(self, item: dict):
        audio_data = item.pop(self.audio_key)
        blob = audio_data.get("bytes")
        if blob is not None:
            recording = Recording.from_bytes(blob, recording_id=md5(blob).hexdigest())
        else:
            # Audio stored by reference: the example carries only a path.
            recording = Recording.from_file(audio_data["path"])
        cut = recording.to_cut()
        cut.supervisions = [
            SupervisionSegment(
                id=recording.id,
                recording_id=recording.id,
                start=0.0,
                duration=recording.duration,
                text=item.pop(self.text_key, None),
                language=item.pop(self.lang_key, None),
                gender=item.pop(self.gender_key, None),
            )
        ]
        maybe_resolve_images(item)
        cut.custom = item
        return cut


def maybe_resolve_images(item: dict) -> None:
    if not is_module_available("PIL"):
        return
    import PIL.Image

    for k, v in item.items():
        if isinstance(v, PIL.Image.Image):
            item[k] = Image.from_pillow(v)
