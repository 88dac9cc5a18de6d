"""
FeatureExtractor ABC, the Features manifest, FeatureSet, and the offline
extraction pipeline (copied from ``lhotse_tpu/features/base.py``):
``FeatureExtractor`` (``extract``, ``frame_shift``, ``feature_dim``, the
feature-domain ``mix``/``compute_energy``/``scale``, the generic
``extract_batch``, ``extract_from_samples_and_store``,
``extract_from_recording_and_store``, ``from_dict``/``to_dict``), the
extractor registry, the ``Features`` manifest with partial
``load(start, duration)``, ``FeatureSet`` and ``FeatureSetBuilder``,
``store_feature_array`` and the streaming global statistics.

Multi-channel features (one ``(C, T, F)`` matrix from a ``(C, N)``
signal) are stored time-major, as ``(T, C, F)``, so that a chunked archive
reads a time window of every channel in one range, and ``Features.load``
gives them back as ``(C, t, F)``; their manifest counts ``T`` frames and
``F`` features. The JAX package describes such a matrix by its first two
axes, ``num_frames=C``, and its validation then refuses it.

The port keeps no progress bars, no YAML (de)serialisation and no
``FeatureSet.split_lazy``.
"""
from __future__ import annotations

import multiprocessing
import pickle
import warnings
from abc import ABCMeta, abstractmethod
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, is_dataclass
from functools import partial
from itertools import chain, islice
from math import isclose
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Type, Union

import numpy as np

from lhotse_tpu_torch.audio.recording import Recording
from lhotse_tpu_torch.features.io import FeaturesReader, FeaturesWriter, get_reader, is_in_memory
from lhotse_tpu_torch.lazy import AlgorithmMixin
from lhotse_tpu_torch.serialization import LazyMixin, Serializable, load_yaml, save_to_yaml
from lhotse_tpu_torch.utils import (
    Pathlike, Seconds, asdict_nonull, compute_num_frames, compute_num_frames_from_samples,
    exactly_one_not_null, fastcopy, ifnone, split_manifest_lazy, split_sequence, to_list, uuid4)

AugmentFn = Callable[[np.ndarray, int], np.ndarray]


class FeatureExtractor(metaclass=ABCMeta):
    """
    Base class for all feature extractors. Initialized with a dataclass config
    (``config_type``); must implement ``extract``, ``frame_shift``, and
    ``feature_dim``; extractors supporting feature-domain mixing also define
    static ``compute_energy`` and ``mix``.
    """

    name = None
    config_type = None

    def __init__(self, config: Optional[Any] = None):
        if config is None:
            config = self.config_type()
        assert is_dataclass(config), "The feature configuration object must be a dataclass."
        self.config = config

    @abstractmethod
    def extract(self, samples: np.ndarray, sampling_rate: int) -> np.ndarray:
        """Extract features from audio samples; returns the feature matrix."""
        ...

    @property
    @abstractmethod
    def frame_shift(self) -> Seconds:
        ...

    @abstractmethod
    def feature_dim(self, sampling_rate: int) -> int:
        ...

    @property
    def device(self) -> str:
        return "cpu"

    @staticmethod
    def mix(
        features_a: np.ndarray, features_b: np.ndarray, energy_scaling_factor_b: float,
    ) -> np.ndarray:
        """Feature-domain mix of two signals; the mixed-in signal's energy is
        scaled by ``energy_scaling_factor_b`` to reach a target SNR."""
        _undefined_op("mix", "feature-domain mix")

    @staticmethod
    def compute_energy(features: np.ndarray) -> float:
        """Total energy of a feature matrix (never zero when implemented)."""
        _undefined_op("compute_energy", "feature-domain mix")

    @staticmethod
    def scale(features: np.ndarray, energy_scaling_factor: float) -> np.ndarray:
        """Scale a feature matrix by the provided energy factor."""
        _undefined_op("scale", "feature-domain scaling")

    def extract_batch(
        self, samples: Union[np.ndarray, Sequence[np.ndarray]], sampling_rate: int,
        lengths: Optional[np.ndarray] = None) -> Union[np.ndarray, List[np.ndarray]]:
        """
        Batch extraction over variable-length inputs. The generic fallback
        calls :meth:`extract` sequentially; extractors with true batched
        kernels (the Kaldi JAX/Pallas path) override this. With ``lengths``
        given, the input is assumed to be one padded 2-D batch and per-item
        feature lengths are sliced out afterwards.
        """
        input_is_list = isinstance(samples, list)
        if lengths is not None:
            assert getattr(samples, "ndim", 0) == 2, (
                "If `lengths` is provided, `samples` must be a batched, "
                "padded 2-D array."
            )
            # Padded rows produce garbage frames past each item's true length.
            keep = [
                compute_num_frames_from_samples(n, self.frame_shift, sampling_rate)
                for n in lengths
            ]
            result = [
                self.extract(row, sampling_rate=sampling_rate)[:t] for row,
                t in zip(np.asarray(samples), keep)]
        else:
            if not input_is_list:
                samples = list(samples) if samples.ndim > 1 else [samples.reshape(1, -1)]
            result = [
                self.extract(np.asarray(item), sampling_rate=sampling_rate)
                for item in samples
            ]

        if len(result) == 1:
            return result if input_is_list else result[0]
        if all(item.shape == result[0].shape for item in result[1:]):
            return np.stack(result, axis=0)
        return result

    def extract_from_samples_and_store(
        self, samples: np.ndarray, storage: FeaturesWriter, sampling_rate: int, offset: Seconds = 0,
        channel: Optional[Union[int, List[int]]] = None, augment_fn: Optional[AugmentFn] = None,
    ) -> "Features":
        """
        Full pipeline over raw samples: optional augmentation → extract →
        store → return a ``Features`` manifest (without recording reference).
        """
        if augment_fn is not None:
            samples = augment_fn(samples, sampling_rate)
        feats = self.extract(samples=samples, sampling_rate=sampling_rate)
        return self._store_and_describe(
            feats, storage, sampling_rate=sampling_rate, start=offset,
            duration=round(samples.shape[1] / sampling_rate, ndigits=8), channels=channel)

    def extract_from_recording_and_store(
        self, recording: Recording, storage: FeaturesWriter, offset: Seconds = 0,
        duration: Optional[Seconds] = None, channels: Union[int, List[int]] = None,
        augment_fn: Optional[AugmentFn] = None) -> "Features":
        """
        Full pipeline over a Recording: load audio → optional augmentation →
        extract → store → return a ``Features`` manifest.
        """
        samples = recording.load_audio(offset=offset, duration=duration, channels=channels)
        if augment_fn is not None:
            samples = augment_fn(samples, recording.sampling_rate)
        feats = self.extract(samples=samples, sampling_rate=recording.sampling_rate)
        return self._store_and_describe(
            feats, storage, sampling_rate=recording.sampling_rate, start=offset,
            duration=recording.duration,
            channels=channels if channels is not None else recording.channel_ids,
            recording_id=recording.id)

    def _store_and_describe(
        self, feats: np.ndarray, storage: FeaturesWriter, **manifest_fields) -> "Features":
        """Persist a feature matrix and build + validate its manifest."""
        from lhotse_tpu_torch.qa import validate_features

        stored = np.ascontiguousarray(feats.transpose(1, 0, 2)) if feats.ndim == 3 else feats
        key = store_feature_array(stored, storage=storage)
        manifest = Features(
            type=self.name, num_frames=feats.shape[-2], num_features=feats.shape[-1],
            frame_shift=self.frame_shift, storage_type=storage.name,
            storage_path=str(storage.storage_path), storage_key=key, **manifest_fields)
        validate_features(manifest, feats_data=feats)
        return manifest

    @classmethod
    def from_dict(cls, data: dict) -> "FeatureExtractor":
        data = dict(data)
        feature_type = data.pop("feature_type")
        extractor_type = get_extractor_type(feature_type)
        config = extractor_type.config_type.from_dict(data)
        return extractor_type(config)

    def to_dict(self) -> Dict[str, Any]:
        d = self.config.to_dict()
        d["feature_type"] = self.name
        return d

    @classmethod
    def from_yaml(cls, path: Pathlike) -> "FeatureExtractor":
        return cls.from_dict(load_yaml(path))

    def to_yaml(self, path: Pathlike):
        data = self.to_dict()
        save_to_yaml(data, path=path)


def _undefined_op(name: str, capability: str):
    hint = (
        "compute the features after, rather than before, mixing the cuts."
        if "mix" in capability
        else "scaling is only available for extractors that define it."
    )
    raise ValueError(
        f'The feature extractor\'s "{name}" operation is undefined. '
        f"It does not support {capability}; {hint}"
    )


FEATURE_EXTRACTORS = {}


def get_extractor_type(name: str) -> Type:
    return FEATURE_EXTRACTORS[name]


def create_default_feature_extractor(name: str) -> "Optional[FeatureExtractor]":
    return get_extractor_type(name)()


def register_extractor(cls):
    FEATURE_EXTRACTORS[cls.name] = cls
    return cls


@dataclass(order=True)
class Features:
    """
    Features extracted for a particular time range of a recording/channel,
    plus the storage metadata (storage_type/path/key) needed to load them.
    """

    type: str
    num_frames: int
    num_features: int
    frame_shift: Seconds
    sampling_rate: int
    start: Seconds
    duration: Seconds
    storage_type: str
    storage_path: str
    storage_key: Union[str, bytes]
    recording_id: Optional[str] = None
    channels: Optional[Union[int, List[int]]] = None

    end = property(lambda self: self.start + self.duration)
    is_in_memory = property(lambda self: is_in_memory(self.storage_type))
    is_placeholder = property(lambda self: self.storage_type == "shar")

    def _frame_window(self, start: Optional[Seconds], duration: Optional[Seconds]):
        """(left, right) frame offsets for a partial read."""
        if start is None:
            start = self.start
        if start < self.start - 1e-3:
            raise ValueError(
                f"Cannot load features for recording {self.recording_id} starting from "
                f"{start}s. The available range is ({self.start}, {self.end}) seconds."
            )
        to_frames = lambda secs: compute_num_frames(
            secs, frame_shift=self.frame_shift, sampling_rate=self.sampling_rate)
        left = 0 if isclose(start, self.start) else to_frames(start - self.start)
        right = None if duration is None else left + to_frames(duration)
        return left, right

    def load(
        self, start: Optional[Seconds] = None, duration: Optional[Seconds] = None,
        channel_id: Optional[Union[int, List[int]]] = None) -> np.ndarray:
        """Load the matrix, translating second offsets to frame offsets for a
        partial read (reference: features/base.py:488). A multi-channel
        matrix comes back as ``(C, t, F)``, cut to ``channel_id`` when it is
        given; a single-channel one ignores ``channel_id``."""
        left, right = self._frame_window(start, duration)
        storage = get_reader(self.storage_type)(self.storage_path)
        arr = storage.read(self.storage_key, left_offset_frames=left, right_offset_frames=right)
        if arr.ndim != 3:
            return arr
        arr = arr.transpose(1, 0, 2)
        if channel_id is None:
            return arr
        stored = to_list(self.channels)
        return arr[[stored.index(c) for c in to_list(channel_id)]]

    def move_to_memory(
        self, start: Seconds = 0, duration: Optional[Seconds] = None, lilcom: bool = False,
    ) -> "Features":
        from lhotse_tpu_torch.features.io import get_memory_writer

        if self.storage_type in ("memory_lilcom", "memory_writer"):
            return self
        arr = self.load(start=start, duration=duration)
        if arr.ndim == 3:
            arr = np.ascontiguousarray(arr.transpose(1, 0, 2))
        compress = lilcom and issubclass(arr.dtype.type, np.floating)
        writer = get_memory_writer("memory_lilcom" if compress else "memory_raw")()
        return fastcopy(
            self, start=0.0, duration=ifnone(duration, self.duration), num_frames=arr.shape[0],
            storage_type=writer.name, storage_key=writer.write("", arr), storage_path="")

    def with_path_prefix(self, path: Pathlike) -> "Features":
        return fastcopy(self, storage_path=str(Path(path) / self.storage_path))

    def copy_with(self, **kwargs) -> "Features":
        return fastcopy(self, **kwargs)

    def to_dict(self) -> dict:
        return asdict_nonull(self)

    def copy_feats(self, writer: FeaturesWriter) -> "Features":
        """Re-store the referenced feature array with ``writer`` and return an
        updated manifest."""
        feats = self.load()
        new_key = writer.write(self.storage_key, feats)
        return fastcopy(
            self, storage_type=writer.name, storage_path=writer.storage_path, storage_key=new_key)

    @staticmethod
    def from_dict(data: dict) -> "Features":
        if "frame_shift" not in data and "storage_type" in data:
            warnings.warn(
                'The "frame_shift" field was not found in a feature manifest; '
                "inferring it from duration/num_frames."
            )
            inferred = data["duration"] / data["num_frames"]
            data["frame_shift"] = round(inferred, ndigits=3)
        if "storage_path" not in data and {"storage_key", "storage_type"} <= set(data):
            data["storage_path"] = None
        return Features(**data)

    def __repr__(self):
        return (
            f"Features(type='{self.type}', num_frames={self.num_frames}, "
            f"num_features={self.num_features}, frame_shift={self.frame_shift}, "
            f"sampling_rate={self.sampling_rate}, start={self.start}, "
            f"duration={self.duration}, storage_type='{self.storage_type}', "
            f"storage_path='{self.storage_path}', "
            f"storage_key='{self.storage_key if isinstance(self.storage_key, str) else '<binary-data>'}', "
            f"recording_id='{self.recording_id}', channels={self.channels})"
        )


class FeatureSet(Serializable, AlgorithmMixin):
    """
    A feature manifest: load features for recordings within particular
    channels and time ranges; raises KeyError when unavailable.
    """

    def __init__(self, features: Optional[List[Features]] = None) -> None:
        self.features = ifnone(features, [])
        self._features_by_recording_id: Optional[Dict[str, List[Features]]] = None

    def __eq__(self, other: "FeatureSet") -> bool:
        return self.features == other.features

    @property
    def data(self) -> Union[Dict[str, Features], Iterable[Features]]:
        return self.features

    @staticmethod
    def from_features(features: Union[Iterable[Features], LazyMixin]) -> "FeatureSet":
        return (
            FeatureSet([f for f in features])
            if isinstance(features, LazyMixin)
            else FeatureSet(list(features))
        )

    from_items = from_features

    @staticmethod
    def from_dicts(data: Iterable[dict]) -> "FeatureSet":
        return FeatureSet(features=[Features.from_dict(d) for d in data])

    def to_dicts(self) -> Iterable[dict]:
        return (f.to_dict() for f in self)

    def with_path_prefix(self, path: Pathlike) -> "FeatureSet":
        return FeatureSet.from_features(f.with_path_prefix(path) for f in self)

    def split(
        self, num_splits: int, shuffle: bool = False, drop_last: bool = False,
    ) -> List["FeatureSet"]:
        return [
            FeatureSet.from_features(subset)
            for subset in split_sequence(
                self, num_splits=num_splits, shuffle=shuffle, drop_last=drop_last
            )
        ]

    def split_lazy(
        self, output_dir: Pathlike, chunk_size: int, prefix: str = "") -> List["FeatureSet"]:
        return split_manifest_lazy(
            self, output_dir=output_dir, chunk_size=chunk_size, prefix=prefix)

    def shuffle(self, *args, **kwargs):
        raise NotImplementedError("FeatureSet does not support shuffling.")

    def subset(self, first: Optional[int] = None, last: Optional[int] = None) -> "FeatureSet":
        assert exactly_one_not_null(first, last), "subset() can handle only one non-None arg."
        if first is not None:
            assert first > 0
            return FeatureSet.from_items(islice(self, first))
        if last is not None:
            assert last > 0
            N = len(self)
            if last > N:
                return self
            return FeatureSet.from_items(islice(self, N - last, N))

    def find(
        self, recording_id: str, channel_id: Union[int, List[int]] = 0, start: Seconds = 0.0,
        duration: Optional[Seconds] = None, leeway: Seconds = 0.05) -> Features:
        """
        Find the Features object best matching the criteria (closest time
        markers within ``leeway``); raise KeyError when none match.
        """
        if duration is not None:
            end = start + duration
        candidates = self._index_by_recording_id_and_cache().get(recording_id, [])
        candidates = (
            f
            for f in candidates
            if f.channels == channel_id and f.start - leeway <= start < f.end + leeway
        )
        if duration is not None:
            candidates = (f for f in candidates if f.end >= end - leeway)
        candidates = list(candidates)
        if not candidates:
            raise KeyError(
                f"No features available for recording '{recording_id}', channel "
                f"{channel_id} in time range [{start}s, "
                f"{'end' if duration is None else duration}s]"
            )
        if duration is not None:
            return min(candidates, key=lambda f: (start - f.start) ** 2 + (end - f.end) ** 2)
        return min(candidates, key=lambda f: (start - f.start) ** 2)

    def _index_by_recording_id_and_cache(self):
        if self._features_by_recording_id is None:
            from collections import defaultdict

            index = defaultdict(list)
            for feat in self:
                index[feat.recording_id].append(feat)
            self._features_by_recording_id = dict(index)
        return self._features_by_recording_id

    def load(
        self, recording_id: str, channel_id: Union[int, List[int]] = 0, start: Seconds = 0.0,
        duration: Optional[Seconds] = None) -> np.ndarray:
        feature_info = self.find(
            recording_id=recording_id, channel_id=channel_id, start=start, duration=duration)
        return feature_info.load(start=start, duration=duration)

    def copy_feats(self, writer: FeaturesWriter) -> "FeatureSet":
        return FeatureSet.from_features(f.copy_feats(writer=writer) for f in self)

    def compute_global_stats(self, storage_path: Optional[Pathlike] = None) -> Dict[str, np.ndarray]:
        """Single-pass global per-bin mean/std (Chan–Golub–LeVeque)."""
        return compute_global_stats(feature_manifests=self, storage_path=storage_path)

    def __repr__(self) -> str:
        return f"FeatureSet(len={len(self)})"

    def __iter__(self) -> Iterable[Features]:
        return iter(self.features)

    def __getitem__(self, i: int) -> Features:
        return self.features[i]

    def __len__(self) -> int:
        return len(self.features)


class FeatureSetBuilder:
    """
    Wrapper for the feature extraction script: consumes Recordings, extracts
    features per channel, stores them, and builds a FeatureSet.
    """

    def __init__(
        self, feature_extractor: FeatureExtractor, storage: FeaturesWriter,
        augment_fn: Optional[AugmentFn] = None):
        self.feature_extractor, self.storage = feature_extractor, storage
        self.augment_fn = augment_fn

    def process_and_store_recordings(
        self, recordings: Sequence[Recording], output_manifest: Optional[Pathlike] = None,
        num_jobs: int = 1) -> FeatureSet:
        if num_jobs == 1:
            per_recording = map(self._process_and_store_recording, recordings)
            feature_set = FeatureSet.from_features(chain.from_iterable(per_recording))
        else:
            # Workers only EXTRACT (extractor + augment_fn pickle cleanly);
            # all writes happen here in the parent, because storage writers
            # hold open file handles (unpicklable) and a single sequential
            # writer is what keeps an .lca archive consistent anyway.
            # The reference pickles the open writer into each worker and
            # crashes (features/base.py:890-919 upstream).
            spawn = multiprocessing.get_context("spawn")
            worker = partial(
                _extract_recording_features, self.feature_extractor, self.augment_fn)
            with ProcessPoolExecutor(num_jobs, mp_context=spawn) as pool:

                def extract_then_store_here():
                    for recording, per_channel in zip(
                        recordings, pool.map(worker, recordings)
                    ):
                        for channel, feats in per_channel:
                            yield self.feature_extractor._store_and_describe(
                                feats, self.storage,
                                sampling_rate=recording.sampling_rate, start=0,
                                duration=recording.duration, channels=channel,
                                recording_id=recording.id)

                feature_set = FeatureSet.from_features(extract_then_store_here())
        # Make the returned manifests immediately loadable: buffered writers
        # (e.g. LilcomChunkyWriter) would otherwise hold the tail of the
        # archive in memory until close().
        self.storage.flush()
        if output_manifest is not None:
            feature_set.to_file(output_manifest)
        return feature_set

    def _process_and_store_recording(self, recording: Recording) -> List[Features]:
        return [
            self.feature_extractor.extract_from_recording_and_store(
                recording=recording,
                storage=self.storage,
                channels=channel,
                augment_fn=self.augment_fn,
            )
            for channel in recording.channel_ids
        ]


def _extract_recording_features(
    extractor: FeatureExtractor, augment_fn: Optional[AugmentFn], recording: Recording,
) -> List[Tuple[int, np.ndarray]]:
    """Subprocess half of the parallel builder: per-channel feature matrices
    only, no storage access (see FeatureSetBuilder.process_and_store_recordings)."""
    out = []
    for channel in recording.channel_ids:
        samples = recording.load_audio(channels=channel)
        if augment_fn is not None:
            samples = augment_fn(samples, recording.sampling_rate)
        out.append((channel, extractor.extract(samples, recording.sampling_rate)))
    return out


def store_feature_array(feats: np.ndarray, storage: FeaturesWriter) -> str:
    """Store a feature array under a random unique key."""
    feats_id = str(uuid4())
    return storage.write(feats_id, feats)


def compute_global_stats(
    feature_manifests: Iterable[Features], storage_path: Optional[Pathlike] = None,
) -> Dict[str, np.ndarray]:
    """
    Single-pass global per-bin means and stds using the Chan–Golub–LeVeque
    streaming variance update (reference: features/base.py:957).
    """
    feature_manifests = iter(feature_manifests)
    head = next(feature_manifests)
    stats = StatsAccumulator(feature_dim=head.num_features)
    for features in chain([head], feature_manifests):
        stats.update(features.load().astype(np.float64))
    mvn = stats.get()
    if storage_path is not None:
        Path(storage_path).write_bytes(pickle.dumps(mvn))
    return mvn


class StatsAccumulator:
    """Streaming per-dimension mean/std over feature matrices, merged with
    Chan's parallel-variance formula (numerically stable for long corpora)."""

    def __init__(self, feature_dim: int):
        self.count = 0
        self.mean = np.zeros((feature_dim,), dtype=np.float64)
        self.m2 = np.zeros((feature_dim,), dtype=np.float64)

    def update(self, arr: np.ndarray) -> None:
        """Fold in a (T, F) matrix, or a multi-channel (C, T, F) one, whose
        every channel-frame counts as a frame."""
        arr = arr.astype(np.float64).reshape(-1, arr.shape[-1])
        n = arr.shape[0]
        if n == 0:
            return
        batch_mean = arr.mean(axis=0)
        batch_m2 = arr.var(axis=0) * n
        total = self.count + n
        delta = batch_mean - self.mean
        self.m2 = self.m2 + batch_m2 + delta**2 * (self.count * n / total)
        self.mean = self.mean + delta * (n / total)
        self.count = total

    norm_means = property(lambda self: self.mean.copy())
    norm_stds = property(lambda self: np.sqrt(self.m2 / self.count))

    def get(self) -> Dict[str, np.ndarray]:
        return {"norm_means": self.norm_means, "norm_stds": self.norm_stds}
