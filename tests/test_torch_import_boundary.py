"""
The port's import boundary: lhotse_tpu_torch and chip_smoke.py import
neither jax nor lhotse_tpu, and importing the kernel's module needs no CUDA
toolkit. Checked in subprocesses, because this test process has already
imported jax (tests/conftest.py).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "lhotse_tpu_torch").rglob("*.py")
) + ["chip_smoke.py"]
FORBIDDEN = re.compile(r"^\s*(import|from) (jax|lhotse_tpu)\b", re.MULTILINE)


def _python(code: str, **env) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, **env})


def test_port_imports_neither_jax_nor_lhotse_tpu():
    proc = _python(
        "import lhotse_tpu_torch, lhotse_tpu_torch.dataset.device_augment, "
        "lhotse_tpu_torch.ops.fbank_cuda, lhotse_tpu_torch.convert, "
        "lhotse_tpu_torch.dataset.signal_transforms, lhotse_tpu_torch.ops.wire, "
        "lhotse_tpu_torch.dataset.device_cache, lhotse_tpu_torch.dataset.loader, "
        "lhotse_tpu_torch.features.kaldi.extractors, lhotse_tpu_torch.models, "
        "lhotse_tpu_torch.models.encoder, lhotse_tpu_torch.entry, lhotse_tpu_torch.ops.wpe, "
        "lhotse_tpu_torch.parallel, lhotse_tpu_torch.parallel.mesh, lhotse_tpu_torch.utils, "
        "lhotse_tpu_torch.serialization, lhotse_tpu_torch.lazy, lhotse_tpu_torch.checkpoint, "
        "lhotse_tpu_torch.caching, lhotse_tpu_torch.tracing, lhotse_tpu_torch.native_build, "
        "lhotse_tpu_torch.custom, lhotse_tpu_torch.supervision, lhotse_tpu_torch.qa, "
        "lhotse_tpu_torch.manipulation, lhotse_tpu_torch.audio, lhotse_tpu_torch.audio.utils, "
        "lhotse_tpu_torch.audio.wavio, lhotse_tpu_torch.audio.flacio, "
        "lhotse_tpu_torch.audio.backend, lhotse_tpu_torch.audio.source, "
        "lhotse_tpu_torch.audio.recording, lhotse_tpu_torch.cut, lhotse_tpu_torch.cut.base, "
        "lhotse_tpu_torch.cut.data, lhotse_tpu_torch.cut.mono, lhotse_tpu_torch.cut.set, "
        "lhotse_tpu_torch.dataset.dataloading, lhotse_tpu_torch.dataset.sampling, "
        "lhotse_tpu_torch.dataset.sampling.base, lhotse_tpu_torch.dataset.sampling.dynamic, "
        "lhotse_tpu_torch.dataset.sampling.checkpoint_backends, "
        "lhotse_tpu_torch.dataset.sampling.dynamic_bucketing, lhotse_tpu_torch.dataset.collation, "
        "lhotse_tpu_torch.dataset.input_strategies, lhotse_tpu_torch.dataset.speech_recognition, "
        "lhotse_tpu_torch.ops.host_dsp, lhotse_tpu_torch.codecs, "
        "lhotse_tpu_torch.codecs.lilcom_codec, lhotse_tpu_torch.array, lhotse_tpu_torch.features, "
        "lhotse_tpu_torch.features.base, lhotse_tpu_torch.features.io, "
        "lhotse_tpu_torch.features.compression, lhotse_tpu_torch.augmentation, "
        "lhotse_tpu_torch.augmentation.transform, lhotse_tpu_torch.augmentation.resample, "
        "lhotse_tpu_torch.augmentation.transforms, lhotse_tpu_torch.augmentation.utils, "
        "lhotse_tpu_torch.augmentation.rir, lhotse_tpu_torch.audio.mixer, "
        "lhotse_tpu_torch.features.mixer, lhotse_tpu_torch.cut.padding, "
        "lhotse_tpu_torch.cut.mixed, lhotse_tpu_torch.dataset.cut_transforms, "
        "lhotse_tpu_torch.dataset.cut_transforms.perturb_speed, "
        "lhotse_tpu_torch.dataset.cut_transforms.perturb_tempo, "
        "lhotse_tpu_torch.dataset.cut_transforms.perturb_volume, "
        "lhotse_tpu_torch.dataset.cut_transforms.mix, "
        "lhotse_tpu_torch.dataset.cut_transforms.extra_padding, "
        "lhotse_tpu_torch.dataset.cut_transforms.reverberate, lhotse_tpu_torch.indexing, "
        "lhotse_tpu_torch.shar, lhotse_tpu_torch.shar.lazy_pointer, lhotse_tpu_torch.shar.utils, "
        "lhotse_tpu_torch.shar.readers, lhotse_tpu_torch.shar.readers.tar, "
        "lhotse_tpu_torch.shar.readers.utils, lhotse_tpu_torch.shar.readers.lazy, "
        "lhotse_tpu_torch.shar.readers.indexed, lhotse_tpu_torch.shar.writers, "
        "lhotse_tpu_torch.shar.writers.tar, lhotse_tpu_torch.shar.writers.common, "
        "lhotse_tpu_torch.shar.writers.cut, lhotse_tpu_torch.shar.writers.audio, "
        "lhotse_tpu_torch.shar.writers.array, lhotse_tpu_torch.shar.writers.shar, "
        "lhotse_tpu_torch.dataset.iterable_dataset, lhotse_tpu_torch.testing, "
        "lhotse_tpu_torch.testing.dummies; "
        "import sys; "
        "assert 'jax' not in sys.modules and 'lhotse_tpu' not in sys.modules, "
        "sorted(m for m in sys.modules if m.startswith(('jax', 'lhotse_tpu.')))")
    assert proc.returncode == 0, proc.stderr


def test_cpu_route_needs_no_nvcc():
    """Without a CUDA toolkit the kernel's module imports and a CPU tensor
    takes the plain version: nothing is built."""
    proc = _python(
        "import torch; from lhotse_tpu_torch import _build; "
        "from lhotse_tpu_torch.ops import fbank_cuda; "
        "from lhotse_tpu_torch.features.kaldi.layers import Wav2LogFilterBank; "
        "out = Wav2LogFilterBank(device='cpu')(torch.zeros(2, 16000)); "
        "assert out.shape == (2, 100, 80); "
        "assert _build.load.cache_info().currsize == 0",
        PATH="/nonexistent", CUDA_HOME="/nonexistent", CUDA_PATH="/nonexistent")
    assert proc.returncode == 0, proc.stderr


HOST_PATH = """
import sys
sys.modules["jax"] = None
sys.modules["lhotse_tpu"] = None
import tempfile
from pathlib import Path

import numpy as np

from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.audio.flacio import write_flac
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.device_augment import OnDeviceAugmenter
from lhotse_tpu_torch.dataset.input_strategies import AudioSamples
from lhotse_tpu_torch.dataset.loader import DataLoader
from lhotse_tpu_torch.dataset.sampling.dynamic_bucketing import (
    DynamicBucketingSampler, FixedBucketBatchSizeConstraint)
from lhotse_tpu_torch.dataset.signal_transforms import SpecAugment
from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
from lhotse_tpu_torch.supervision import SupervisionSegment

SR, BUCKETS = 16000, [(1.0, 2), (2.0, 2)]
with tempfile.TemporaryDirectory(dir=sys.argv[1]) as tmp:
    rng = np.random.default_rng(0)
    cuts = []
    for i, sec in enumerate([0.6, 0.9, 1.4, 1.8]):
        path = Path(tmp) / f"u{i}.flac"
        write_flac(str(path), (0.1 * rng.standard_normal(int(SR * sec))).astype(np.float32), SR)
        cut = Recording.from_file(path).to_cut()
        cut.supervisions.append(SupervisionSegment(
            id=f"s{i}", recording_id=cut.recording_id, start=0.0, duration=cut.duration))
        cuts.append(cut)
    CutSet.from_cuts(cuts).to_file(Path(tmp) / "cuts.jsonl.gz")
    sampler = DynamicBucketingSampler(
        CutSet.from_jsonl_lazy(Path(tmp) / "cuts.jsonl.gz"),
        constraint=FixedBucketBatchSizeConstraint([1.0, 2.0], [2, 2]), num_buckets=None,
        duration_bins=[1.0], shuffle=True, seed=0, world_size=1, rank=0)
    aug = OnDeviceAugmenter(BUCKETS, speed_factor=1.1, specaugment=SpecAugment(seed=0), device="cpu")

    def stage(batch):
        return aug.stage(batch["inputs"], batch["supervisions"]["num_samples"], transfer=False)

    loader = DataLoader(sampler, K2SpeechRecognitionDataset(input_strategy=AudioSamples()),
                        main_apply_fn=stage, transfer_lookahead=2, checkpoint_objects=[aug],
                        device="cpu")
    shapes = [tuple(aug.compute(staged)[0].shape) for staged in loader]
assert sorted(shapes) == [(2, 91, 80), (2, 182, 80)], shapes
assert loader.state_dict()["objects"] == [{"seed": 0, "next_counter": 2}]
assert sys.modules["jax"] is None and sys.modules["lhotse_tpu"] is None
assert not any(m.startswith(("jax.", "lhotse_tpu.")) for m in sys.modules)
"""


def test_host_path_runs_without_jax_and_lhotse_tpu(tmp_path):
    """Manifest → sampler → dataset → DataLoader → OnDeviceAugmenter on the
    CPU, in a process where importing either package fails."""
    proc = subprocess.run(
        [sys.executable, "-c", HOST_PATH, str(tmp_path)], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


PRECOMPUTED_PATH = """
import sys
sys.modules["jax"] = None
sys.modules["lhotse_tpu"] = None
import tempfile
from pathlib import Path

import numpy as np

from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.audio.flacio import write_flac
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
from lhotse_tpu_torch.features import Fbank, FbankConfig
from lhotse_tpu_torch.ops import wire
from lhotse_tpu_torch.supervision import SupervisionSegment

SR = 16000
with tempfile.TemporaryDirectory(dir=sys.argv[1]) as tmp:
    rng = np.random.default_rng(0)
    cuts = []
    for i, sec in enumerate([0.6, 0.9, 1.4]):
        path = Path(tmp) / f"u{i}.flac"
        write_flac(str(path), (0.1 * rng.standard_normal(int(SR * sec))).astype(np.float32), SR)
        cut = Recording.from_file(path).to_cut()
        cut.supervisions.append(SupervisionSegment(
            id=f"s{i}", recording_id=cut.recording_id, start=0.0, duration=cut.duration))
        cuts.append(cut)
    extractor = Fbank(FbankConfig(device="cpu"))
    stored = CutSet.from_cuts(cuts).compute_and_store_features_batch(
        extractor, Path(tmp) / "feats", manifest_path=Path(tmp) / "cuts.jsonl")
    batch = K2SpeechRecognitionDataset()[CutSet.from_file(Path(tmp) / "cuts.jsonl").to_eager()]
    fly = K2SpeechRecognitionDataset(input_strategy=OnTheFlyFeatures(extractor))[CutSet.from_cuts(cuts)]
    assert batch["inputs"].shape == fly["inputs"].shape == (3, 140, 80), batch["inputs"].shape
    assert np.abs(batch["inputs"] - fly["inputs"]).max() <= 2.0 ** -6 + 1e-6
    x = (0.1 * rng.standard_normal((2, 640))).astype(np.float32)
    assert np.array_equal(wire.encode_wire(x, "adpcm4"), wire._adpcm4_encode_np(x))
assert sys.modules["jax"] is None and sys.modules["lhotse_tpu"] is None
assert not any(m.startswith(("jax.", "lhotse_tpu.")) for m in sys.modules)
"""


def test_precomputed_path_runs_without_jax_and_lhotse_tpu(tmp_path):
    """FLAC cuts → compute_and_store_features_batch → the chunky archive →
    K2SpeechRecognitionDataset() (PrecomputedFeatures), and OnTheFlyFeatures,
    on the CPU in a process where importing either package fails."""
    proc = subprocess.run(
        [sys.executable, "-c", PRECOMPUTED_PATH, str(tmp_path)], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


AUGMENTED_PATH = """
import random
import sys
sys.modules["jax"] = None
sys.modules["lhotse_tpu"] = None
import tempfile
from pathlib import Path

import numpy as np

from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.audio.flacio import write_flac
from lhotse_tpu_torch.cut import CutSet, MixedCut
from lhotse_tpu_torch.dataset.cut_transforms import CutMix, ExtraPadding, PerturbSpeed
from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
from lhotse_tpu_torch.features import Fbank, FbankConfig
from lhotse_tpu_torch.supervision import SupervisionSegment

SR = 16000
with tempfile.TemporaryDirectory(dir=sys.argv[1]) as tmp:
    rng = np.random.default_rng(0)

    def cut_of(name, sec, text=None):
        path = Path(tmp) / f"{name}.flac"
        write_flac(str(path), (0.1 * rng.standard_normal(int(SR * sec))).astype(np.float32), SR)
        cut = Recording.from_file(path).to_cut()
        if text:
            cut.supervisions.append(SupervisionSegment(
                id=name, recording_id=cut.recording_id, start=0.0, duration=cut.duration, text=text))
        return cut

    CutSet.from_cuts([cut_of(f"u{i}", sec, "x") for i, sec in enumerate([0.6, 0.9, 1.4])]).to_file(
        Path(tmp) / "cuts.jsonl")
    CutSet.from_cuts([cut_of(f"n{i}", 1.0) for i in range(2)]).to_file(Path(tmp) / "noise.jsonl")
    noise = CutSet.from_file(Path(tmp) / "noise.jsonl")
    cuts = CutSet.from_jsonl_lazy(Path(tmp) / "cuts.jsonl").perturb_speed(1.1).mix(
        noise, snr=(10, 20), mix_prob=1.0, seed=7)
    eager = cuts.to_eager()
    assert all(isinstance(c, MixedCut) for c in eager)
    dataset = K2SpeechRecognitionDataset(
        cut_transforms=[PerturbSpeed(0.9, p=1.0, randgen=random.Random(0)),
                        CutMix(noise, p=1.0, seed=1), ExtraPadding(extra_seconds=0.05)],
        input_strategy=OnTheFlyFeatures(Fbank(FbankConfig(device="cpu"))))
    batch = dataset[eager]
    assert batch["inputs"].shape[0] == 3 and np.isfinite(batch["inputs"]).all()
assert sys.modules["jax"] is None and sys.modules["lhotse_tpu"] is None
assert not any(m.startswith(("jax.", "lhotse_tpu.")) for m in sys.modules)
"""


def test_augmented_path_runs_without_jax_and_lhotse_tpu(tmp_path):
    """FLAC cuts → perturb_speed → mix → K2SpeechRecognitionDataset with cut
    transforms → OnTheFlyFeatures on the CPU, in a process where importing
    either package fails."""
    proc = subprocess.run(
        [sys.executable, "-c", AUGMENTED_PATH, str(tmp_path)], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


SHAR_PATH = """
import sys
sys.modules["jax"] = None
sys.modules["lhotse_tpu"] = None
import tempfile
import warnings
from pathlib import Path

import numpy as np

from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset import dataloading
from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
from lhotse_tpu_torch.dataset.iterable_dataset import IdentityDataset, IterableDatasetWrapper
from lhotse_tpu_torch.dataset.sampling import checkpoint_backends
from lhotse_tpu_torch.dataset.sampling.dynamic_bucketing import DynamicBucketingSampler
from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
from lhotse_tpu_torch.features import Fbank, FbankConfig
from lhotse_tpu_torch.testing import DummyManifest

warnings.simplefilter("ignore")
with tempfile.TemporaryDirectory(dir=sys.argv[1]) as tmp:
    cuts = DummyManifest(CutSet, begin_id=0, end_id=6, with_data=True)
    for c in cuts:
        c.custom = {}
    extractor = Fbank(FbankConfig(device="cpu"))
    cuts.to_shar(Path(tmp) / "shar", fields={"recording": "flac", "features": "numpy"},
                 shard_size=2, compress_jsonl=False)
    ids = sorted(c.id for c in cuts)
    streaming = CutSet.from_shar(in_dir=Path(tmp) / "shar", indexed=False, shuffle_shards=True,
                                 split_for_dataloading=True, seed=0)
    wrapper = IterableDatasetWrapper(IdentityDataset(), DynamicBucketingSampler(
        streaming, max_duration=2.0, num_buckets=2, shuffle=True, seed=0))
    assert sorted(c.id for b in wrapper for c in b) == ids
    indexed = CutSet.from_shar(in_dir=Path(tmp) / "shar", shuffle_shards=True, seed=0)
    assert indexed.has_constant_time_access
    sampler = DynamicBucketingSampler(indexed, max_duration=2.0, num_buckets=2, shuffle=True, seed=0)
    dataset = K2SpeechRecognitionDataset(input_strategy=OnTheFlyFeatures(extractor))
    it = iter(sampler)
    first = next(it)
    state = sampler.state_dict()
    rest = []
    while (b := next(it, None)) is not None:
        rest.append([c.id for c in b])
    resumed = DynamicBucketingSampler(CutSet.from_shar(in_dir=Path(tmp) / "shar", shuffle_shards=True,
                                                       seed=0), max_duration=2.0, num_buckets=2,
                                      shuffle=True, seed=0)
    resumed.load_state_dict(state)
    assert checkpoint_backends._sources_are_seekable(resumed)
    assert [[c.id for c in b] for b in resumed] == rest
    batch = dataset[first]
    assert batch["inputs"].shape[2] == 80 and np.isfinite(batch["inputs"]).all()
    feats = [c.load_features() for c in CutSet.from_shar(in_dir=Path(tmp) / "shar", lazy=True)]
    assert len(feats) == 6 and all(f.shape == (100, 23) for f in feats)
assert sys.modules["jax"] is None and sys.modules["lhotse_tpu"] is None
assert not any(m.startswith(("jax.", "lhotse_tpu.")) for m in sys.modules)
"""


def test_shar_path_runs_without_jax_and_lhotse_tpu(tmp_path):
    """Dummy cuts → to_shar → streaming from_shar through
    IterableDatasetWrapper; indexed from_shar through the sampler (its seek
    resume) into OnTheFlyFeatures; pointer reads of stored features; on the
    CPU, in a process where importing either package fails."""
    proc = subprocess.run(
        [sys.executable, "-c", SHAR_PATH, str(tmp_path)], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", PORT_FILES)
def test_source_has_no_jax_import(path):
    assert not FORBIDDEN.search((ROOT / path).read_text()), path
