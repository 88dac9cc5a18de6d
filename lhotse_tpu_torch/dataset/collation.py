"""
Collation of CutSet mini-batches into dense numpy host arrays (copied from
``lhotse_tpu/dataset/collation.py``): ``TokenCollater``,
``collate_features`` (padding with ``LOG_EPSILON`` on either side),
``collate_audio`` (the mono fast path, and the padded-cut route for
multi-channel batches, ``mono_downmix``, custom recording fields and
fault-tolerant reads), ``collate_custom_field``,
``collate_multi_channel_features``, ``read_audio_from_cuts``,
``read_features_from_cuts``, ``collate_vectors``, ``collate_matrices``
and ``collate_images`` (Pillow-gated, as the images are).

Left out: video collation.
"""
import warnings
from concurrent.futures import Executor
from functools import partial
from itertools import repeat
from typing import Iterable, List, Optional, Tuple, Union

import numpy as np

from lhotse_tpu_torch.audio import Recording, suppress_audio_loading_errors
from lhotse_tpu_torch.cut import Cut, CutSet, MixedCut
from lhotse_tpu_torch.utils import DEFAULT_PADDING_VALUE, LOG_EPSILON, compute_num_samples

# Padding label for token targets, conventionally ignored by the loss.
PAD_TOKEN_ID = -100

# collate_audio's direct zero-pad route for all-mono batches.
_USE_MONO_FAST_PATH = True


def _round_up(value: int, multiple: Optional[int]) -> int:
    if multiple is None or multiple <= 1:
        return value
    return ((value + multiple - 1) // multiple) * multiple


class TokenCollater:
    """
    Map sentences to integer token sequences padded to equal length, with
    optional <bos>/<eos>. ``inverse()`` reconstructs the strings.

    Example::

        >>> token_collater = TokenCollater(cuts)
        >>> tokens_batch, tokens_lens = token_collater(cuts.subset(first=32))
        >>> original_sentences = token_collater.inverse(tokens_batch, tokens_lens)

    Returns ``(tokens_batch int64 (B, L), tokens_lens int32 (B,))`` where the
    lens include <bos>/<eos> but not padding.
    """

    def __init__(
        self, cuts: CutSet, add_eos: bool = True, add_bos: bool = True, pad_symbol: str = "<pad>",
        bos_symbol: str = "<bos>", eos_symbol: str = "<eos>", unk_symbol: str = "<unk>"):
        self.pad_symbol, self.unk_symbol = pad_symbol, unk_symbol
        self.bos_symbol, self.eos_symbol = bos_symbol, eos_symbol
        self.add_bos, self.add_eos = add_bos, add_eos

        specials = [pad_symbol, unk_symbol]
        if add_bos:
            specials.append(bos_symbol)
        if add_eos:
            specials.append(eos_symbol)
        alphabet = sorted({ch for cut in cuts for ch in cut.supervisions[0].text})
        vocabulary = specials + alphabet
        self.token2idx = {token: idx for idx, token in enumerate(vocabulary)}
        self.idx2token = vocabulary

    def __call__(self, cuts: CutSet) -> Tuple[np.ndarray, np.ndarray]:
        token_sequences = [
            " ".join(supervision.text for supervision in cut.supervisions)
            for cut in cuts
        ]
        max_len = len(max(token_sequences, key=len))

        unk = self.token2idx[self.unk_symbol]
        seqs = [
            ([self.bos_symbol] if self.add_bos else [])
            + list(seq)
            + ([self.eos_symbol] if self.add_eos else [])
            + [self.pad_symbol] * (max_len - len(seq))
            for seq in token_sequences
        ]

        tokens_batch = np.array(
            [[self.token2idx.get(token, unk) for token in seq] for seq in seqs], dtype=np.int64)
        tokens_lens = np.array(
            [ len(seq) + int(self.add_eos) + int(self.add_bos) for seq in token_sequences ],
            dtype=np.int32)
        return tokens_batch, tokens_lens

    def inverse(self, tokens_batch: np.ndarray, tokens_lens: np.ndarray) -> List[str]:
        start = 1 if self.add_bos else 0
        sentences = [
            "".join( self.idx2token[idx] for idx in np.asarray(tokens_list)[start : int(end) - int(self.add_eos)] ) for tokens_list,
            end in zip(tokens_batch, tokens_lens)]
        return sentences


def collate_features(
    cuts: CutSet, pad_direction: str = "right", executor: Optional[Executor] = None,
    features_dtype: Optional[np.dtype] = None, pad_to_multiple: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """
    Load features for all cuts into a ``(batch, time, features)`` array,
    padding with feature-domain silence where needed.

    :param pad_to_multiple: round the padded frame count up to this multiple
        so batches land on a bounded set of shapes.
    :return: ``(features, features_lens)``.
    """
    assert all(cut.has_features for cut in cuts)
    features_lens = np.array([cut.num_frames for cut in cuts], dtype=np.int32)
    target_frames = _round_up(int(features_lens.max()), pad_to_multiple)
    if pad_direction == "right":
        # Right-padding a batch is one LOG_EPSILON fill per padded row tail
        # plus a row-block copy per cut, bit-identical to pad()+load_features().
        first_cut = next(iter(cuts))
        features = np.empty(
            (len(cuts), target_frames, first_cut.num_features),
            dtype=features_dtype if features_dtype is not None else np.float32)
        loaded = (
            (cut.load_features() for cut in cuts)
            if executor is None
            else executor.map(_read_features, cuts)
        )
        for idx, feats in enumerate(loaded):
            n = min(feats.shape[0], target_frames)
            features[idx, :n] = feats[:n]
            if n < target_frames:
                features[idx, n:] = LOG_EPSILON
        return features, features_lens
    cuts = cuts.pad(num_frames=target_frames, direction=pad_direction)
    first_cut = next(iter(cuts))
    features = np.empty(
        (len(cuts), first_cut.num_frames, first_cut.num_features),
        dtype=features_dtype if features_dtype is not None else np.float32)
    if executor is None:
        for idx, cut in enumerate(cuts):
            features[idx] = cut.load_features()
    else:
        for idx, example_features in enumerate(executor.map(_read_features, cuts)):
            features[idx] = example_features
    return features, features_lens


def collate_audio(
    cuts: CutSet, pad_direction: str = "right", executor: Optional[Executor] = None,
    fault_tolerant: bool = False, recording_field: Optional[str] = None,
    mono_downmix: Optional[bool] = None, pad_to_multiple: Optional[int] = None,
) -> Union[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray, CutSet]]:
    """
    Load audio for all cuts into ``(batch, time)`` (or ``(batch, channels,
    time)``) float32, padding with silence.

    :param fault_tolerant: skip cuts whose audio fails to load and return the
        surviving CutSet as a third element.
    :param recording_field: load from ``cut.load_<recording_field>()`` instead
        of ``cut.load_audio()``.
    :param mono_downmix: None = auto (multichannel collation only when every
        cut is multichannel); True = average channels to mono; False = put
        mono in channel 0 and zero-pad remaining channels.
    :param pad_to_multiple: round the padded sample count up to this multiple.
    :return: ``(audio, audio_lens)`` or ``(audio, audio_lens, cuts)``.
    """
    for cut in cuts:
        if recording_field is None:
            assert cut.has_recording, f"Missing recording in cut {cut.id}"
        else:
            assert cut.has_custom(recording_field), (
                f"Missing custom recording field {recording_field} in cut {cut.id}"
            )

    # Remember per-cut sample counts before any fault-tolerant filtering.
    sample_counts = []
    for cut in cuts:
        if recording_field is None:
            num_samples = cut.num_samples
        else:
            num_samples = compute_num_samples(
                cut.duration, sampling_rate=getattr(cut, recording_field).sampling_rate)
        sample_counts.append(num_samples)

    max_duration = max(cut.duration for cut in cuts)
    if pad_to_multiple is not None and pad_to_multiple > 1:
        sr = next(iter(cuts)).sampling_rate
        target_samples = _round_up(compute_num_samples(max_duration, sr), pad_to_multiple)
        max_duration = target_samples / sr

    if (
        _USE_MONO_FAST_PATH
        and recording_field is None
        and mono_downmix is None
        and pad_direction in ("right", "left")
        and all(getattr(c, "num_channels", None) == 1 for c in cuts)
    ):
        # Mono fast path: read each cut ONCE and zero-pad it directly into
        # the batch buffer. Functionally identical to the pad()-then-collate
        # route below (silence padding), but skips materializing a per-cut
        # padded MixedCut waveform AND the second (B, L) fill+copy in
        # collate_vectors — on the training hot loop that pad+mix detour
        # was ~60% of batch-assembly time.
        sr = next(iter(cuts)).sampling_rate
        target_len = compute_num_samples(max_duration, sr)
        audios, ok_cuts, sample_counts = read_audio_from_cuts(
            cuts, executor, suppress_errors=fault_tolerant,
            recording_field=None, filter_aux_iter=sample_counts)
        if not audios:
            empty = np.zeros((0, 0), dtype=np.float32)
            lens = np.zeros((0,), dtype=np.int32)
            return (empty, lens, ok_cuts) if fault_tolerant else (empty, lens)
        # np.empty + explicit pad-region fill: only the silence tail is
        # written twice, halving the allocation's memory traffic vs zeros().
        batch = np.empty((len(audios), target_len), dtype=np.float32)
        for i, audio in enumerate(audios):
            row = audio[0] if audio.ndim == 2 else audio
            n = min(row.shape[0], target_len)
            if pad_direction == "right":
                batch[i, :n] = row[:n]
                if n < target_len:
                    batch[i, n:] = 0.0
            else:
                batch[i, target_len - n :] = row[:n]
                if n < target_len:
                    batch[i, : target_len - n] = 0.0
        audio_lens = np.array(sample_counts, dtype=np.int32)
        if fault_tolerant:
            # Contract: the surviving cuts come back padded (as the slow
            # path returns them) — a manifest-level op, no audio I/O.
            ok_cuts = ok_cuts.pad(
                duration=max_duration, direction=pad_direction, preserve_id=True
            )
            return batch, audio_lens, ok_cuts
        return batch, audio_lens

    cuts = cuts.pad(duration=max_duration, direction=pad_direction, preserve_id=True)

    audios, cuts, sample_counts = read_audio_from_cuts(
        cuts, executor, suppress_errors=fault_tolerant, recording_field=recording_field,
        filter_aux_iter=sample_counts)

    if not audios:
        # Every cut failed to load (fault_tolerant; otherwise read raised):
        # hand back an empty, well-shaped batch instead of crashing.
        empty = np.zeros((0, 0), dtype=np.float32)
        lens = np.zeros((0,), dtype=np.int32)
        return (empty, lens, cuts) if fault_tolerant else (empty, lens)

    if mono_downmix is None:
        # Auto-detect: multichannel collation only when every audio is 2-D.
        mono_downmix = not all(a.ndim == 2 for a in audios)

    if mono_downmix:
        processed = []
        for audio in audios:
            if audio.ndim == 2:
                audio = audio.mean(axis=0)
            processed.append(audio)
        audios = collate_vectors(processed, padding_value=0.0)
    else:
        max_channels = max(a.shape[0] if a.ndim == 2 else 1 for a in audios)
        processed = []
        for audio in audios:
            if audio.ndim == 1:
                expanded = np.zeros((max_channels, audio.shape[0]), dtype=audio.dtype)
                expanded[0] = audio
                audio = expanded
            elif audio.shape[0] < max_channels:
                expanded = np.zeros((max_channels, audio.shape[1]), dtype=audio.dtype)
                expanded[: audio.shape[0]] = audio
                audio = expanded
            processed.append(audio)
        audios = collate_matrices([a.T for a in processed], padding_value=0.0).transpose(0, 2, 1)
    audio_lens = np.array(sample_counts, dtype=np.int32)

    if fault_tolerant:
        return audios, audio_lens, cuts
    else:
        return audios, audio_lens


collate_multi_channel_audio = collate_audio  # the JAX package's alias


def collate_custom_field(
    cuts: CutSet, field: str, pad_value: Union[None, int, float] = None,
    pad_direction: str = "right") -> Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]:
    """
    Collate a custom field across cuts:

    - :class:`~lhotse_tpu_torch.array.Array` → stacked ``(batch, d0, d1, ...)``
      (all shapes must match — fixed-size embeddings).
    - :class:`~lhotse_tpu_torch.array.TemporalArray` → padded along the temporal
      dim and stacked; returns ``(collated, lens)``. Integer dtypes below
      int64 are promoted to int64 (token/label targets).
    - :class:`~lhotse_tpu_torch.image.Image` → stacked images.
    - :class:`~lhotse_tpu_torch.audio.Recording` → delegates to
      :func:`collate_audio` with ``recording_field``.
    - anything else (int/float/...) → 1-D array of the raw values.
    """
    from lhotse_tpu_torch.array import Array, TemporalArray
    from lhotse_tpu_torch.image import Image

    cuts_list = list(cuts)
    first_manifest = getattr(cuts_list[0], field)
    if isinstance(first_manifest, Array):
        assert all(getattr(c, field).shape == first_manifest.shape for c in cuts_list), (
            "Cannot collate manifests of type Array with different shapes, "
            "because we don't know which dimension must be padded. "
            "Use TemporalArray manifests and try again."
        )
        return np.stack([c.load_custom(field) for c in cuts_list])
    elif isinstance(first_manifest, TemporalArray):
        if pad_value is None:
            warnings.warn(
                f"Argument 'pad_value' not passed -- we will pad field '{field}' "
                f"with {DEFAULT_PADDING_VALUE}."
            )
            pad_value = DEFAULT_PADDING_VALUE
        temporal_dim = first_manifest.temporal_dim

        # Load everything and pad to the longest sequence (ignoring
        # frame_shift metadata, which users may define inconsistently).
        arrs = [np.asarray(c.load_custom(field)) for c in cuts_list]
        arr_lens = np.array([a.shape[temporal_dim] for a in arrs], dtype=np.int32)
        largest_arr = max(arrs, key=lambda a: a.size)
        maxlen = largest_arr.shape[temporal_dim]
        collated_shape = (len(arrs), *largest_arr.shape)
        dtype = largest_arr.dtype
        if dtype in (np.uint8, np.int8, np.int16, np.int32) or np.issubdtype(dtype, np.integer):
            dtype = np.int64
        tensors = np.full(collated_shape, pad_value, dtype=dtype)
        for aidx, a in enumerate(arrs):
            alen = a.shape[temporal_dim]
            if pad_direction == "right":
                temporal_slice = slice(0, alen)
            elif pad_direction == "left":
                temporal_slice = slice(maxlen - alen, maxlen)
            elif pad_direction == "both":
                half = (maxlen - alen) // 2
                temporal_slice = slice(half, half + alen)
            else:
                raise ValueError(f"Unexpected pad_direction argument: '{pad_direction}'")
            indices = (aidx,) + tuple(
                temporal_slice if i == temporal_dim else slice(None)
                for i in range(len(a.shape))
            )
            tensors[indices] = a

        return tensors, arr_lens
    elif isinstance(first_manifest, Image):
        return collate_images(cuts_list, field)
    elif isinstance(first_manifest, Recording):
        return collate_audio(
            CutSet.from_cuts(cuts_list), recording_field=field, pad_direction=pad_direction)
    else:
        return np.array([getattr(c, field) for c in cuts_list])


def collate_multi_channel_features(cuts: CutSet) -> np.ndarray:
    """
    Load features of MixedCuts whose tracks are interpreted as channels into
    a ``(batch, channel, time, features)`` array.
    """
    assert all(cut.has_features for cut in cuts)
    assert all(isinstance(cut, MixedCut) for cut in cuts)
    cuts = cuts.pad()
    first_cut = next(iter(cuts))
    features = np.empty(
        (len(cuts), len(first_cut.tracks), first_cut.num_frames, first_cut.num_features),
        dtype=np.float32)
    for idx, cut in enumerate(cuts):
        features[idx] = cut.load_features(mixed=False)
    return features


def collate_vectors(
    tensors: Iterable[np.ndarray], padding_value: Union[int, float] = PAD_TOKEN_ID,
    pad_direction: str = "right", matching_shapes: bool = False) -> np.ndarray:
    """
    Stack 1-D arrays of various lengths into ``(B, L)`` with padding.
    """
    tensors = [np.asarray(t) for t in tensors]
    assert all(t.ndim == 1 for t in tensors), "Expected only 1-D input tensors."
    if pad_direction not in ("left", "right"):
        raise ValueError(f"pad_direction must be 'left' or 'right', got {pad_direction}")
    longest = max(tensors, key=lambda t: t.shape[0])
    if matching_shapes:
        assert all(t.shape == longest.shape for t in tensors), (
            "All tensors must have the same shape when matching_shapes is set to True."
        )
    result = np.full((len(tensors), longest.shape[0]), padding_value, dtype=longest.dtype)
    for i, t in enumerate(tensors):
        if pad_direction == "right":
            result[i, : t.shape[0]] = t
        else:
            result[i, -t.shape[0] :] = t
    return result


def collate_matrices(
    tensors: Iterable[np.ndarray], padding_value: Union[int, float] = 0,
    matching_shapes: bool = False) -> np.ndarray:
    """
    Stack 2-D arrays with consistent second dim into ``(B, L, F)``.
    """
    tensors = [np.asarray(t) for t in tensors]
    assert all(t.ndim == 2 for t in tensors), "Expected only 2-D input tensors."
    longest = max(tensors, key=lambda t: t.shape[0])
    if matching_shapes:
        assert all(t.shape == longest.shape for t in tensors), (
            "All tensors must have the same shape when matching_shapes is set to True."
        )
    # np.empty + per-row tail fill (see collate_features): pad-only writes.
    result = np.empty((len(tensors), *longest.shape), dtype=longest.dtype)
    for i, t in enumerate(tensors):
        n = t.shape[0]
        result[i, :n] = t
        if n < longest.shape[0]:
            result[i, n:] = padding_value
    return result


def read_audio_from_cuts(
    cuts: Iterable[Cut], executor: Optional[Executor] = None, suppress_errors: bool = False,
    recording_field: Optional[str] = None, filter_aux_iter: Optional[Iterable] = None,
) -> Union[Tuple[List[np.ndarray], CutSet], Tuple[List[np.ndarray], CutSet, List]]:
    """
    Load audio for each cut (optionally concurrently / fault-tolerantly).
    Returns ``(audios, ok_cuts)`` — plus the filtered auxiliary iterable when
    ``filter_aux_iter`` is given.
    """
    aux_requested = True
    if filter_aux_iter is None:
        filter_aux_iter = repeat(None)
        aux_requested = False
    from lhotse_tpu_torch.tracing import add_work, trace_span

    map_fn = map if executor is None else executor.map
    audios = []
    ok_cuts = []
    aux_iter_out = []
    with trace_span("collation.read_audio"):
        for cut, maybe_audio, aux_item in zip(
            cuts,
            map_fn( partial( _read_audio, suppress_errors=suppress_errors, recording_field=recording_field, ), cuts, ),
            filter_aux_iter):
            if maybe_audio is None:
                continue
            audios.append(maybe_audio)
            ok_cuts.append(cut)
            aux_iter_out.append(aux_item)
        add_work(sum(c.duration for c in ok_cuts))
    ans = (audios, CutSet.from_cuts(ok_cuts))
    if aux_requested:
        ans = ans + (aux_iter_out,)
    return ans


def read_features_from_cuts(
    cuts: Iterable[Cut], executor: Optional[Executor] = None) -> List[np.ndarray]:
    map_fn = map if executor is None else executor.map
    return list(map_fn(_read_features, cuts))


def _read_features(cut: Cut) -> np.ndarray:
    return np.asarray(cut.load_features())


def _read_audio(
    cut: Cut, suppress_errors: bool = False, recording_field: Optional[str] = None,
) -> Optional[np.ndarray]:
    with suppress_audio_loading_errors(enabled=suppress_errors):
        if recording_field is None:
            audio = cut.load_audio()
        else:
            attr = getattr(cut, recording_field)
            assert isinstance(attr, Recording), (
                f"Expected 'getattr(cut, {recording_field})' to yield Recording, "
                f"got {type(attr)}"
            )
            audio = cut.load_custom(recording_field)
        audio = np.asarray(audio)
        if audio.ndim == 2 and audio.shape[0] == 1:
            audio = audio[0]  # collapse channel dim if mono
        return audio


def collate_images(cuts: CutSet, image_field: str = "image") -> np.ndarray:
    """Load and stack images into ``(batch, height, width, channel)``."""
    images = [np.asarray(cut.load_custom(image_field)) for cut in cuts]
    return np.stack(images)
