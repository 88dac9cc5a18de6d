"""
Input strategies: CutSet -> collated batch of audio or features (copied
from ``lhotse_tpu/dataset/input_strategies.py``): ``BatchIO``,
``PrecomputedFeatures`` (read from feature storage), ``AudioSamples`` (the
strategy of the device augmenter's path) and ``OnTheFlyFeatures``
(extraction per batch with a :class:`FeatureExtractor`).
``AudioSamples(use_batch_loader=True)`` fetches every remote payload of a
batch through :class:`~lhotse_tpu_torch.ais.AISBatchLoader` first (its
fetcher is AIStore where the ``aistore`` package imports, else
:class:`~lhotse_tpu_torch.ais.LocalBatchFetcher`, as in the JAX package).
"""
import logging
from concurrent.futures import Executor, ThreadPoolExecutor
from functools import lru_cache
from typing import Callable, Dict, List, Optional, Tuple, Type, TypeVar, Union

import numpy as np

from lhotse_tpu_torch.cut import CutSet, compute_supervisions_frame_mask
from lhotse_tpu_torch.dataset.collation import (
    collate_audio, collate_features, collate_matrices, collate_vectors, read_audio_from_cuts)
from lhotse_tpu_torch.features import FeatureExtractor
from lhotse_tpu_torch.utils import (
    LOG_EPSILON, ifnone, supervision_to_frames, supervision_to_samples)

ExecutorType = TypeVar("ExecutorType", bound=Executor)


class BatchIO:
    """
    Converts a :class:`CutSet` into a collated batch of audio representations
    (samples or features, single- or multi-channel). All strategies accept
    ``num_workers`` to parallelize storage reads with a thread/process pool.
    """

    def __init__(
        self, num_workers: int = 0, executor_type: Type[ExecutorType] = ThreadPoolExecutor) -> None:
        self.num_workers = num_workers
        self._executor_type = executor_type

    def __call__(self, cuts: CutSet) -> Tuple[np.ndarray, np.ndarray]:
        """Collated input signals + per-example lengths before padding."""
        raise NotImplementedError()

    def supervision_intervals(self, cuts: CutSet) -> Dict[str, np.ndarray]:
        """
        Start/end bounds per supervision as 1-D int arrays, e.g.
        ``{"sequence_idx", "start_frame", "num_frames"}`` (or the
        ``*_sample`` variants). ``sequence_idx`` is the index of the cut in
        the batch; there may be more supervisions than cuts.
        """
        raise NotImplementedError()

    def supervision_masks(self, cuts: CutSet) -> np.ndarray:
        """Collated ``(B, NF)`` / ``(B, NS)`` masks of supervised regions,
        zero-padded to the longest cut."""
        raise NotImplementedError()


class PrecomputedFeatures(BatchIO):
    """
    Reads pre-computed features from storage and pads them to a common frame
    count with feature-domain silence (log(1e-10)).
    """

    def __init__(
        self, num_workers: int = 0, executor_type: Type[ExecutorType] = ThreadPoolExecutor,
        pad_to_multiple: Optional[int] = None) -> None:
        super().__init__(num_workers=num_workers, executor_type=executor_type)
        self.pad_to_multiple = pad_to_multiple

    def __call__(
        self, cuts: CutSet, pad_direction: Optional[str] = "right",
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns ``(features (B, T, F), feature_lens (B,))``."""
        return collate_features(
            cuts, pad_direction=pad_direction,
            executor=_get_executor(self.num_workers, executor_type=self._executor_type),
            pad_to_multiple=self.pad_to_multiple)

    def supervision_intervals(
        self, cuts: CutSet, pad_direction: Optional[str] = "right") -> Dict[str, np.ndarray]:
        """Frame-domain supervision bounds: sequence_idx/start_frame/num_frames."""
        if pad_direction not in ("left", "right"):
            raise ValueError(f"pad_direction must be 'left' or 'right', got {pad_direction}")

        per_sup = [(i, cut, sup) for i, cut in enumerate(cuts) for sup in cut.supervisions]
        max_frames = max(cut.num_frames for cut in cuts)
        bounds = [
            supervision_to_frames( sup, cut.frame_shift, cut.sampling_rate, max_frames=cut.num_frames ) for _,
            cut, sup in per_sup]
        start_frames = [b[0] for b in bounds]
        nums_frames = [b[1] for b in bounds]
        if pad_direction == "left":
            # Left padding shifts every supervision by the pad amount.
            start_frames = [
                s + (max_frames - cut.num_frames) for s, (_, cut, _) in zip(start_frames, per_sup)]
        return {
            "sequence_idx": np.array([i for i, _, _ in per_sup], dtype=np.int32),
            "start_frame": np.array(start_frames, dtype=np.int32),
            "num_frames": np.array(nums_frames, dtype=np.int32)}

    def supervision_masks(
        self, cuts: CutSet, use_alignment_if_exists: Optional[str] = None,
        pad_direction: Optional[str] = "right") -> np.ndarray:
        """Mask of supervised frames (optionally from a named alignment)."""
        if pad_direction not in ("left", "right"):
            raise ValueError(f"pad_direction must be 'left' or 'right', got {pad_direction}")
        masks = [
            cut.supervisions_feature_mask(use_alignment_if_exists=use_alignment_if_exists)
            for cut in cuts
        ]
        return collate_vectors(masks, pad_direction=pad_direction, padding_value=0)


class AudioSamples(BatchIO):
    """
    Reads raw audio from recordings and zero-pads to the longest cut
    (``(B, T)``, or ``(B, C, T)`` for multichannel batches).
    """

    def __init__(
        self, num_workers: int = 0, fault_tolerant: bool = False,
        executor_type: Type[ExecutorType] = ThreadPoolExecutor, mono_downmix: Optional[bool] = None,
        pad_to_multiple: Optional[int] = None, use_batch_loader: bool = False,
        ais_force_individual: bool = False) -> None:
        """
        :param fault_tolerant: skip cuts with failed reads; ``__call__``
            returns the surviving CutSet as an extra item. With
            ``use_batch_loader=True`` it also makes per-object AIS fetch
            failures drop the affected cut instead of raising.
        :param mono_downmix: channel handling (see :func:`collate_audio`).
        :param pad_to_multiple: round the padded sample count up to a multiple
            (bounds the compiled shape count).
        :param use_batch_loader: fetch all remotely-referenced audio in the
            batch through :class:`~lhotse_tpu_torch.ais.AISBatchLoader` before
            collation (reference: input_strategies.py:225).
        :param ais_force_individual: only meaningful with
            ``use_batch_loader=True`` — never attempt a multi-object request.
        """
        super().__init__(num_workers=num_workers, executor_type=executor_type)
        self.fault_tolerant = fault_tolerant
        self.mono_downmix = mono_downmix
        self.pad_to_multiple = pad_to_multiple
        self.use_batch_loader = use_batch_loader
        self.ais_batch_loader = None
        if use_batch_loader:
            from lhotse_tpu_torch.ais import AISBatchLoader

            self.ais_batch_loader = AISBatchLoader(
                force_individual=ais_force_individual,
                skip_failed_fetches=fault_tolerant)

    def __call__(
        self, cuts: CutSet, recording_field: Optional[str] = None,
    ) -> Union[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray, CutSet]]:
        """Returns ``(audio (B, T), audio_lens (B,)[, cuts])``."""
        if self.ais_batch_loader is not None:
            cuts = self.ais_batch_loader(cuts)
        return collate_audio(
            cuts, executor=_get_executor(self.num_workers, executor_type=self._executor_type),
            fault_tolerant=self.fault_tolerant, recording_field=recording_field,
            mono_downmix=self.mono_downmix, pad_to_multiple=self.pad_to_multiple)

    def supervision_intervals(self, cuts: CutSet) -> Dict[str, np.ndarray]:
        """Sample-domain supervision bounds: sequence_idx/start_sample/num_samples."""
        start_samples, nums_samples = zip(
            *(
                supervision_to_samples(sup, cut.sampling_rate)
                for cut in cuts
                for sup in cut.supervisions
            )
        )
        sequence_idx = [i for i, c in enumerate(cuts) for _ in c.supervisions]
        return {
            "sequence_idx": np.array(sequence_idx, dtype=np.int32),
            "start_sample": np.array(start_samples, dtype=np.int32),
            "num_samples": np.array(nums_samples, dtype=np.int32)}

    def supervision_masks(
        self, cuts: CutSet, use_alignment_if_exists: Optional[str] = None) -> np.ndarray:
        """Mask of supervised samples (optionally from a named alignment)."""
        return collate_vectors(
            [ cut.supervisions_audio_mask( use_alignment_if_exists=use_alignment_if_exists ) for cut in cuts ],
            padding_value=0)


class OnTheFlyFeatures(BatchIO):
    """
    Reads audio and computes features on-the-fly with a
    :class:`FeatureExtractor`, padding with feature-domain silence. With the
    Fbank/Mfcc extractors on the card, ``extract_batch`` runs the fbank
    kernel once over the whole batch; the features come back to the host
    and are collated there (numpy out, as in the JAX package).
    """

    def __init__(
        self, extractor: FeatureExtractor,
        wave_transforms: List[Callable[[np.ndarray], np.ndarray]] = None, num_workers: int = 0,
        use_batch_extract: bool = True, fault_tolerant: bool = False, return_audio: bool = False,
        executor_type: Type[ExecutorType] = ThreadPoolExecutor) -> None:
        """
        :param extractor: feature extractor applied on-the-fly.
        :param wave_transforms: optional per-waveform transforms applied
            before extraction.
        :param use_batch_extract: use ``extract_batch`` (all cuts must share a
            sampling rate) instead of per-cut ``extract``.
        :param fault_tolerant: skip cuts with failed reads, returning the
            surviving CutSet as an extra item.
        :param return_audio: also return collated audio + lens.
        """
        super().__init__(num_workers=num_workers, executor_type=executor_type)
        self.extractor = extractor
        self.wave_transforms = ifnone(wave_transforms, [])
        self.use_batch_extract = use_batch_extract
        self.fault_tolerant = fault_tolerant
        self.return_audio = return_audio

    def __call__(
        self, cuts: CutSet, recording_field: Optional[str] = None,
    ) -> Union[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray, CutSet]]:
        """
        Returns ``(feats (B, T, F), feat_lens[, audios, audio_lens][, cuts])``.
        """
        audios, cuts = read_audio_from_cuts(
            cuts, executor=_get_executor(self.num_workers, executor_type=self._executor_type),
            suppress_errors=self.fault_tolerant, recording_field=recording_field)

        for tfnm in self.wave_transforms:
            for idx in range(len(audios)):
                audios[idx] = tfnm(audios[idx])

        cuts_list = list(cuts)
        if self.use_batch_extract:
            assert all(c.sampling_rate == cuts_list[0].sampling_rate for c in cuts_list)
            # An extractor with an in-place host route writes every item's
            # features straight into one padded (B, T, F) buffer; the port's
            # Kaldi extractors return None here and take extract_batch.
            collated = getattr(self.extractor, "extract_batch_collated", None)
            if collated is not None and not self.return_audio:
                got = collated(
                    audios,
                    sampling_rate=cuts_list[0].sampling_rate,
                    pad_value=LOG_EPSILON,
                )
                if got is not None:
                    features_batch, feature_lens = got
                    out = (features_batch, feature_lens)
                    if self.fault_tolerant:
                        out = out + (cuts,)
                    return out
            features_single = self.extractor.extract_batch(
                audios, sampling_rate=cuts_list[0].sampling_rate)
            features_single = [np.asarray(f) for f in features_single]
        else:
            features_single = []
            for idx, cut in enumerate(cuts_list):
                samples = np.asarray(audios[idx])
                try:
                    features = self.extractor.extract(samples, cut.sampling_rate)
                except Exception:
                    logging.error(
                        f"Error while extracting the features for cut with ID "
                        f"{cut.id} -- details:\n{cut}"
                    )
                    raise
                features_single.append(np.asarray(features))

        features_batch = collate_matrices(features_single, padding_value=LOG_EPSILON)
        feature_lens = np.array([f.shape[0] for f in features_single], dtype=np.int64)

        out = (features_batch, feature_lens)

        if self.return_audio:
            flat = [a[0] if a.ndim == 2 else a for a in audios]
            audio_lens = np.array([a.shape[0] for a in flat], dtype=np.int64)
            collated_audio = collate_vectors(flat, padding_value=0)
            out = out + (collated_audio, audio_lens)

        if self.fault_tolerant:
            out = out + (cuts,)

        return out

    def supervision_intervals(self, cuts: CutSet) -> Dict[str, np.ndarray]:
        """Frame-domain supervision bounds using the extractor's frame_shift."""
        start_frames, nums_frames = zip(
            *(
                supervision_to_frames(sup, self.extractor.frame_shift, cut.sampling_rate)
                for cut in cuts
                for sup in cut.supervisions
            )
        )
        sequence_idx = [i for i, c in enumerate(cuts) for _ in c.supervisions]
        return {
            "sequence_idx": np.array(sequence_idx, dtype=np.int32),
            "start_frame": np.array(start_frames, dtype=np.int32),
            "num_frames": np.array(nums_frames, dtype=np.int32)}

    def supervision_masks(
        self, cuts: CutSet, use_alignment_if_exists: Optional[str] = None) -> np.ndarray:
        """Mask of supervised frames using the extractor's frame_shift."""
        return collate_vectors(
            [ compute_supervisions_frame_mask( cut, frame_shift=self.extractor.frame_shift, use_alignment_if_exists=use_alignment_if_exists, ) for cut in cuts ],
            padding_value=0)


@lru_cache(maxsize=1)
def _get_executor(
    max_workers: int = 0, executor_type: Type[ExecutorType] = ThreadPoolExecutor,
) -> Optional[Executor]:
    """Process-global cached thread/process pool for concurrent reads."""
    if max_workers <= 0:
        return None
    return executor_type(max_workers=max_workers)
