"""
Input strategies: CutSet -> collated batch of audio (copied from
``lhotse_tpu/dataset/input_strategies.py``): ``BatchIO`` and
``AudioSamples``, the strategy of the device augmenter's path.
``PrecomputedFeatures`` and ``OnTheFlyFeatures`` (host feature
extraction) and the AIStore batch loader are not ported.
"""
from concurrent.futures import Executor, ThreadPoolExecutor
from functools import lru_cache
from typing import Dict, Optional, Tuple, Type, TypeVar, Union

import numpy as np

from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.collation import collate_audio, collate_vectors
from lhotse_tpu_torch.utils import not_ported, supervision_to_samples

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
            raise not_ported("AISBatchLoader (use_batch_loader=True)")

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


@lru_cache(maxsize=1)
def _get_executor(
    max_workers: int = 0, executor_type: Type[ExecutorType] = ThreadPoolExecutor,
) -> Optional[Executor]:
    """Process-global cached thread/process pool for concurrent reads."""
    if max_workers <= 0:
        return None
    return executor_type(max_workers=max_workers)
