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
        "lhotse_tpu_torch.testing.dummies, lhotse_tpu_torch.audio.recording_set, "
        "lhotse_tpu_torch.cut.describe, lhotse_tpu_torch.dataset.sampling.data_source, "
        "lhotse_tpu_torch.dataset.sampling.simple, lhotse_tpu_torch.dataset.sampling.bucketing, "
        "lhotse_tpu_torch.dataset.sampling.utils, lhotse_tpu_torch.dataset, "
        "lhotse_tpu_torch.recipes, lhotse_tpu_torch.recipes.utils, "
        "lhotse_tpu_torch.recipes.librispeech, lhotse_tpu_torch.cut.multi, "
        "lhotse_tpu_torch.augmentation.wpe, lhotse_tpu_torch.recipes.ami, "
        "lhotse_tpu_torch.features.compliance, lhotse_tpu_torch.features.kaldifeat, "
        "lhotse_tpu_torch.features.whisper, lhotse_tpu_torch.features.librosa_fbank, "
        "lhotse_tpu_torch.augmentation.clipping, lhotse_tpu_torch.augmentation.loudness, "
        "lhotse_tpu_torch.augmentation.narrowband, "
        "lhotse_tpu_torch.dataset.cut_transforms.clipping, "
        "lhotse_tpu_torch.dataset.cut_transforms.lowpass, "
        "lhotse_tpu_torch.dataset.cut_transforms.concatenate, "
        "lhotse_tpu_torch.dataset.sampling.weighted_simple, "
        "lhotse_tpu_torch.dataset.sampling.zip, lhotse_tpu_torch.dataset.sampling.round_robin, "
        "lhotse_tpu_torch.dataset.sampling.stateless, lhotse_tpu_torch.dataset.vad, "
        "lhotse_tpu_torch.dataset.diarization, lhotse_tpu_torch.dataset.surt, "
        "lhotse_tpu_torch.audio.sphio, lhotse_tpu_torch.audio.aiffio, "
        "lhotse_tpu_torch.dataset.sampling.cut_pairs, lhotse_tpu_torch.dataset.speech_translation, "
        "lhotse_tpu_torch.dataset.source_separation, lhotse_tpu_torch.dataset.speech_synthesis, "
        "lhotse_tpu_torch.dataset.audio_tagging, lhotse_tpu_torch.dataset.unsupervised, "
        "lhotse_tpu_torch.audio.syscodecs, lhotse_tpu_torch.augmentation.compress, "
        "lhotse_tpu_torch.dataset.cut_transforms.compress, lhotse_tpu_torch.recipes.commonvoice, "
        "lhotse_tpu_torch.kaldi, lhotse_tpu_torch.audio.resampling_backend, lhotse_tpu_torch.bin, "
        "lhotse_tpu_torch.bin.modes, lhotse_tpu_torch.bin.lhotse_tpu_torch, "
        "lhotse_tpu_torch.parallel.pool, lhotse_tpu_torch.workflows, "
        "lhotse_tpu_torch.workflows.meeting_simulation, "
        "lhotse_tpu_torch.workflows.meeting_simulation.base, "
        "lhotse_tpu_torch.workflows.meeting_simulation.conversational, "
        "lhotse_tpu_torch.workflows.meeting_simulation.speaker_independent, "
        "lhotse_tpu_torch.index_pack, lhotse_tpu_torch.packed_lazy, "
        "lhotse_tpu_torch.dataset.webdataset, lhotse_tpu_torch.bin.modes.workflows, "
        "lhotse_tpu_torch.recipes.musan, lhotse_tpu_torch.recipes.rir_noise, "
        "lhotse_tpu_torch.recipes.but_reverb_db, lhotse_tpu_torch.recipes.wham, "
        "lhotse_tpu_torch.recipes.textgrid, lhotse_tpu_torch.recipes.aishell4, "
        "lhotse_tpu_torch.recipes.ali_meeting, lhotse_tpu_torch.recipes.icsi, "
        "lhotse_tpu_torch.recipes.notsofar1, lhotse_tpu_torch.recipes.libricss, "
        "lhotse_tpu_torch.recipes.chime6, lhotse_tpu_torch.recipes.dipco, "
        "lhotse_tpu_torch.bin.modes.recipes.musan, lhotse_tpu_torch.bin.modes.recipes.rir_noise, "
        "lhotse_tpu_torch.bin.modes.recipes.wham, lhotse_tpu_torch.bin.modes.recipes.but_reverb_db, "
        "lhotse_tpu_torch.bin.modes.recipes.aishell4, "
        "lhotse_tpu_torch.bin.modes.recipes.ali_meeting, lhotse_tpu_torch.bin.modes.recipes.icsi, "
        "lhotse_tpu_torch.bin.modes.recipes.notsofar1, "
        "lhotse_tpu_torch.bin.modes.recipes.libricss, lhotse_tpu_torch.bin.modes.recipes.chime6, "
        "lhotse_tpu_torch.bin.modes.recipes.dipco, lhotse_tpu_torch.recipes.yesno, "
        "lhotse_tpu_torch.recipes.aishell, lhotse_tpu_torch.recipes.aishell2, "
        "lhotse_tpu_torch.recipes.tedlium, lhotse_tpu_torch.recipes.tedlium2, "
        "lhotse_tpu_torch.recipes.libritts, lhotse_tpu_torch.recipes.librilight, "
        "lhotse_tpu_torch.recipes.mls, lhotse_tpu_torch.recipes.peoples_speech, "
        "lhotse_tpu_torch.recipes.spgispeech, lhotse_tpu_torch.recipes.ljspeech, "
        "lhotse_tpu_torch.recipes.vctk, lhotse_tpu_torch.recipes.timit, "
        "lhotse_tpu_torch.recipes.voxceleb, lhotse_tpu_torch.bin.modes.recipes.yesno, "
        "lhotse_tpu_torch.bin.modes.recipes.aishell, lhotse_tpu_torch.bin.modes.recipes.aishell2, "
        "lhotse_tpu_torch.bin.modes.recipes.tedlium, lhotse_tpu_torch.bin.modes.recipes.tedlium2, "
        "lhotse_tpu_torch.bin.modes.recipes.libritts, "
        "lhotse_tpu_torch.bin.modes.recipes.librilight, lhotse_tpu_torch.bin.modes.recipes.mls, "
        "lhotse_tpu_torch.bin.modes.recipes.peoples_speech, "
        "lhotse_tpu_torch.bin.modes.recipes.spgispeech, "
        "lhotse_tpu_torch.bin.modes.recipes.ljspeech, lhotse_tpu_torch.bin.modes.recipes.vctk, "
        "lhotse_tpu_torch.bin.modes.recipes.timit, lhotse_tpu_torch.bin.modes.recipes.voxceleb, "
        "lhotse_tpu_torch.cut.text, lhotse_tpu_torch.features.kaldi, "
        "lhotse_tpu_torch.recipes._zh_common, lhotse_tpu_torch.recipes.thchs_30, "
        "lhotse_tpu_torch.recipes.stcmds, lhotse_tpu_torch.recipes.primewords, "
        "lhotse_tpu_torch.recipes.magicdata, lhotse_tpu_torch.recipes.aidatatang_200zh, "
        "lhotse_tpu_torch.recipes.tal_asr, lhotse_tpu_torch.recipes.tal_csasr, "
        "lhotse_tpu_torch.recipes.cdsd, lhotse_tpu_torch.recipes.kespeech, "
        "lhotse_tpu_torch.recipes.aishell3, lhotse_tpu_torch.recipes.baker_zh, "
        "lhotse_tpu_torch.recipes.wenetspeech4tts, lhotse_tpu_torch.recipes.speechio, "
        "lhotse_tpu_torch.recipes.xbmu_amdo31, lhotse_tpu_torch.recipes.mdcc, "
        "lhotse_tpu_torch.bin.modes.recipes.zh_corpora, "
        "lhotse_tpu_torch.bin.modes.recipes.zh_corpora_extra, "
        "lhotse_tpu_torch.bin.modes.recipes.aishell3, lhotse_tpu_torch.bin.modes.recipes.mdcc, "
        "lhotse_tpu_torch.recipes._tdf, lhotse_tpu_torch.recipes.switchboard, "
        "lhotse_tpu_torch.recipes.eval2000, lhotse_tpu_torch.recipes.fisher_english, "
        "lhotse_tpu_torch.recipes.fisher_spanish, lhotse_tpu_torch.recipes.callhome_english, "
        "lhotse_tpu_torch.recipes.callhome_egyptian, lhotse_tpu_torch.recipes.gale_arabic, "
        "lhotse_tpu_torch.recipes.gale_mandarin, lhotse_tpu_torch.recipes.mgb2, "
        "lhotse_tpu_torch.recipes.broadcast_news, "
        "lhotse_tpu_torch.bin.modes.recipes.switchboard, "
        "lhotse_tpu_torch.bin.modes.recipes.fisher_english, "
        "lhotse_tpu_torch.bin.modes.recipes.telephone_broadcast, "
        "lhotse_tpu_torch.bin.modes.recipes.broadcast_news, "
        "lhotse_tpu_torch.recipes.librimix, lhotse_tpu_torch.recipes.librimix_mini, "
        "lhotse_tpu_torch.recipes.librispeechmix, lhotse_tpu_torch.recipes.spatial_librispeech, "
        "lhotse_tpu_torch.recipes.dihard3, lhotse_tpu_torch.recipes.voxconverse, "
        "lhotse_tpu_torch.recipes.earnings21, lhotse_tpu_torch.recipes.earnings22, "
        "lhotse_tpu_torch.bin.modes.recipes.libri_variants, "
        "lhotse_tpu_torch.bin.modes.recipes.dihard3, "
        "lhotse_tpu_torch.bin.modes.recipes.voxconverse, "
        "lhotse_tpu_torch.bin.modes.recipes.earnings, "
        "lhotse_tpu_torch.recipes.must_c, lhotse_tpu_torch.recipes.iwslt22_ta, "
        "lhotse_tpu_torch.recipes.mtedx, lhotse_tpu_torch.recipes.gigast, "
        "lhotse_tpu_torch.recipes.voxpopuli, lhotse_tpu_torch.recipes.gigaspeech2, "
        "lhotse_tpu_torch.recipes.emilia, lhotse_tpu_torch.recipes.bvcc, "
        "lhotse_tpu_torch.recipes.csj, lhotse_tpu_torch.bin.modes.recipes.translation_mos, "
        "lhotse_tpu_torch.bin.modes.recipes.voxpopuli, lhotse_tpu_torch.bin.modes.recipes.csj, "
        "lhotse_tpu_torch.recipes.ksponspeech, lhotse_tpu_torch.recipes.nsc, "
        "lhotse_tpu_torch.recipes.babel, lhotse_tpu_torch.recipes.heroico, "
        "lhotse_tpu_torch.recipes.icmcasr, lhotse_tpu_torch.recipes.reazonspeech, "
        "lhotse_tpu_torch.recipes.bengaliai_speech, "
        "lhotse_tpu_torch.bin.modes.recipes.asr_corpora; "
        "from lhotse_tpu_torch.recipes.chime6 import Chime6ArraySynchronizer, verify_md5_checksums; "
        "from lhotse_tpu_torch.lazy import LazyIteratorMultiplexer, LazyTxtIterator; "
        "from lhotse_tpu_torch.checkpoint import DataloaderCheckpoint; "
        "from lhotse_tpu_torch.dataset.signal_transforms import GlobalMVN, RandomizedSmoothing; "
        "import lhotse_tpu_torch.dataset as D; "
        "[getattr(lhotse_tpu_torch, n) for n in lhotse_tpu_torch.__all__]; "
        "[getattr(D, n) for n in D.__all__]; "
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


RECIPE_PATH = """
import io
import sys
import warnings
from contextlib import redirect_stdout

# Neither package, and none of the optional modules the recipe path can use.
for name in ("jax", "lhotse_tpu", "yaml", "tabulate", "tqdm"):
    sys.modules[name] = None
import tempfile
from pathlib import Path

import numpy as np

from lhotse_tpu_torch.audio.flacio import write_flac
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset import BucketingSampler, SimpleCutSampler
from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
from lhotse_tpu_torch.features import Fbank, FbankConfig
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.recipes import prepare_librispeech
from lhotse_tpu_torch.serialization import load_manifest

SR = 16000
with tempfile.TemporaryDirectory(dir=sys.argv[1]) as tmp:
    rng = np.random.default_rng(0)
    chapter = Path(tmp) / "LibriSpeech" / "dev-clean" / "7" / "70"
    chapter.mkdir(parents=True)
    lines = []
    for i in range(4):
        write_flac(str(chapter / f"7-70-{i:04d}.flac"),
                   (0.1 * rng.standard_normal(int(SR * (1 + 0.3 * i)))).astype(np.float32), SR)
        lines.append(f"7-70-{i:04d} TEXT {i}")
    (chapter / "7-70.trans.txt").write_text("\\n".join(lines) + "\\n")
    parts = prepare_librispeech(Path(tmp) / "LibriSpeech", output_dir=Path(tmp) / "m")
    recs, sups = fix_manifests(**parts["dev-clean"])
    validate_recordings_and_supervisions(recs, sups)
    assert len(load_manifest(Path(tmp) / "m" / "librispeech_recordings_dev-clean.jsonl.gz")) == 4
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cuts = CutSet.from_manifests(recs, sups, lazy=True, output_path=Path(tmp) / "c.jsonl.gz")
    windows = cuts.cut_into_windows(0.5).to_eager()
    trimmed = cuts.trim_to_supervisions(keep_overlapping=False).to_eager()
    fbank = Fbank(FbankConfig(device="cpu"))
    dataset = K2SpeechRecognitionDataset(input_strategy=OnTheFlyFeatures(fbank))
    for batch in SimpleCutSampler(cuts, max_duration=3.0):
        assert np.isfinite(dataset[batch]["inputs"]).all()
    # Windows cut through supervisions, which the ASR dataset refuses: their
    # features go straight through the input strategy.
    for batch in BucketingSampler(windows, num_buckets=2, max_duration=1.5):
        feats, lens = OnTheFlyFeatures(fbank)(batch)
        assert np.isfinite(feats).all() and len(lens) == len(batch)
    stored = trimmed.compute_and_store_features(fbank, Path(tmp) / "f", progress_bar=False)
    assert len(K2SpeechRecognitionDataset()[stored]["inputs"]) == 4
    buf = io.StringIO()
    with redirect_stdout(buf):
        stored.describe(full=True)
    assert "Cuts count:" in buf.getvalue()
    try:
        stored.to_file(Path(tmp) / "c.yaml")
    except ImportError:
        pass
    else:
        raise AssertionError("a YAML manifest was written without PyYAML")
for name in ("jax", "lhotse_tpu", "yaml", "tabulate", "tqdm"):
    assert sys.modules[name] is None, name
assert not any(m.startswith(("jax.", "lhotse_tpu.")) for m in sys.modules)
"""


def test_recipe_path_runs_without_jax_and_optional_modules(tmp_path):
    """A LibriSpeech-layout corpus → prepare_librispeech → fix and validate
    → lazy from_manifests → windows and trimmed cuts → the eager samplers →
    OnTheFlyFeatures, stored features and describe, on the CPU, in a process
    where importing jax, lhotse_tpu, PyYAML, tabulate or tqdm fails."""
    proc = subprocess.run(
        [sys.executable, "-c", RECIPE_PATH, str(tmp_path)], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


MEETING_PATH = """
import sys
sys.modules["jax"] = None
sys.modules["lhotse_tpu"] = None
import tempfile
from pathlib import Path

import numpy as np

from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.audio.wavio import write_wav
from lhotse_tpu_torch.cut import CutSet, MonoCut, MultiCut
from lhotse_tpu_torch.features import Fbank, FbankConfig
from lhotse_tpu_torch.features.io import LilcomChunkyWriter
from lhotse_tpu_torch.recipes import prepare_ami

SR = 16000
with tempfile.TemporaryDirectory(dir=sys.argv[1]) as tmp:
    root = Path(tmp)
    rng = np.random.default_rng(0)
    ann = root / "ami_public_manual_1.6.2"
    for sub in ("corpusResources", "segments", "words"):
        (ann / sub).mkdir(parents=True)
    xml = ["<meetings>"]
    for meet in ("ES2002a", "ES2011a", "ES2004a"):
        audio = root / meet / "audio"
        audio.mkdir(parents=True)
        for k in range(1, 4):
            write_wav(str(audio / f"{meet}.Array1-0{k}.wav"),
                      (0.1 * rng.standard_normal(3 * SR)).astype(np.float32), SR)
        xml.append(f'<meeting observation="{meet}">'
                   '<speaker nxt_agent="A" global_name="MEE001" channel="0"/></meeting>')
        (ann / "segments" / f"{meet}.A.segments.xml").write_text(
            '<segments><segment transcriber_start="0.5" transcriber_end="2.0"/></segments>')
        (ann / "words" / f"{meet}.A.words.xml").write_text(
            '<words><w starttime="0.5" endtime="1.0">HELLO</w>'
            '<w starttime="1.1" endtime="1.9">WORLD</w></words>')
    (ann / "corpusResources" / "meetings.xml").write_text("".join(xml) + "</meetings>")
    train = prepare_ami(root, mic="mdm")["train"]
    sessions = CutSet.from_manifests(**train)
    assert [type(c) for c in sessions] == [MultiCut]
    fbank = Fbank(FbankConfig(device="cpu"))
    featured = sessions.compute_and_store_features(
        fbank, root / "feats", storage_type=LilcomChunkyWriter)
    trimmed = featured.trim_to_supervisions(keep_all_channels=True).to_eager()
    (seg,) = list(trimmed)
    assert seg.load_features().shape == (3, seg.num_frames, 80)
    monos = seg.to_mono()
    assert [type(m) for m in monos] == [MonoCut] * 3
    assert seg.dereverb_wpe().load_audio().shape == (3, seg.num_samples)
    rir = root / "rir.wav"
    write_wav(str(rir), (0.05 * rng.standard_normal((4, SR // 4))).astype(np.float32), SR)
    mic = Recording.from_file(root / "ES2002a" / "audio" / "ES2002a.Array1-01.wav").to_cut()
    fanned = mic.reverb_rir(Recording.from_file(rir), rir_channels=[0, 1, 2, 3])
    assert isinstance(fanned, MultiCut) and fanned.load_audio().shape == (4, 3 * SR)
assert not any(m.startswith(("jax.", "lhotse_tpu.")) for m in sys.modules)
"""


def test_meeting_path_runs_without_jax(tmp_path):
    """An AMI-layout corpus → prepare_ami(mic="mdm") → MultiCuts → stored
    (C, T, F) features → trimmed MultiCuts → to_mono, host WPE and a
    multi-channel RIR fan-out, on the CPU, in a process where importing jax
    or lhotse_tpu fails."""
    proc = subprocess.run(
        [sys.executable, "-c", MEETING_PATH, str(tmp_path)], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_task_datasets_load_lazily():
    """``import lhotse_tpu_torch`` and its ``dataset`` package load none of
    the task datasets; naming one through ``lhotse_tpu_torch.dataset``
    loads its module alone."""
    lazy = ["vad", "diarization", "surt", "speech_translation", "source_separation",
            "speech_synthesis", "audio_tagging", "unsupervised"]
    proc = _python(
        "import sys, lhotse_tpu_torch, lhotse_tpu_torch.dataset as D; "
        f"lazy = ['lhotse_tpu_torch.dataset.' + m for m in {lazy!r}]; "
        "assert not [m for m in lazy if m in sys.modules], [m for m in lazy if m in sys.modules]; "
        "D.CutPairsSampler, D.K2Speech2TextTranslationDataset; "
        "assert 'lhotse_tpu_torch.dataset.speech_translation' in sys.modules; "
        "assert 'lhotse_tpu_torch.dataset.unsupervised' not in sys.modules")
    assert proc.returncode == 0, proc.stderr


PAIRED_PATH = """
import sys
sys.modules["jax"] = None
sys.modules["lhotse_tpu"] = None
import tempfile
from pathlib import Path

import numpy as np

from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.audio.aiffio import write_aiff
from lhotse_tpu_torch.audio.sphio import write_sph
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset import (
    CutPairsSampler, K2Speech2TextTranslationDataset, PreMixedSourceSeparationDataset,
    RecordingChunkIterableDataset, SpeechSynthesisDataset, TokenCollater, audio_chunk_collate)
from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
from lhotse_tpu_torch.features import Fbank, FbankConfig
from lhotse_tpu_torch.features.io import LilcomChunkyWriter
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import fastcopy

SR = 16000
with tempfile.TemporaryDirectory(dir=sys.argv[1]) as tmp:
    root = Path(tmp)
    rng = np.random.default_rng(0)
    for i in range(4):
        x = (0.1 * rng.standard_normal(int(SR * (0.6 + 0.2 * i)))).astype(np.float32)
        write_sph(root / f"u{i}.sph", x, SR, coding=("pcm16", "ulaw")[i % 2])
        write_aiff(root / f"u{i}.aiff", x, SR)

    def cuts(pattern):
        recs = RecordingSet.from_dir(root, pattern)
        sups = SupervisionSet.from_segments(
            SupervisionSegment(id=f"{r.id}-s", recording_id=r.id, start=0.0, duration=r.duration,
                               text="HELLO WORLD", custom={"translated_text": "HALLO WELT"})
            for r in recs)
        return CutSet.from_manifests(recs, sups).to_eager()

    src, tgt = cuts("*.sph"), cuts("*.aiff")
    fbank = Fbank(FbankConfig(device="cpu"))
    dataset = K2Speech2TextTranslationDataset(input_strategy=OnTheFlyFeatures(fbank))
    batches = [(dataset[s], dataset[t]) for s, t in CutPairsSampler(src, tgt, max_source_duration=1.5)]
    assert sum(len(b["supervisions"]["tgt_text"]) for b, _ in batches) == 4
    assert all(b["inputs"].shape[2] == 80 for pair in batches for b in pair)
    tts = SpeechSynthesisDataset(feature_input_strategy=OnTheFlyFeatures(fbank))[src]
    collater = TokenCollater(src)
    assert collater.inverse(*collater(src)) == ["HELLO WORLD"] * 4 and tts["audio"].shape[0] == 4
    pair = CutSet.from_cuts(c.truncate(duration=0.6) for c in src.subset(first=2))
    mixed = CutSet.from_cuts([fastcopy(pair[0].mix(pair[1]), id="mix")])
    (mix,) = list(mixed.compute_and_store_features_batch(
        fbank, root / "feats", storage_type=LilcomChunkyWriter))
    featured = pair.compute_and_store_features_batch(
        fbank, root / "src_feats", storage_type=LilcomChunkyWriter)
    sources = CutSet.from_cuts(
        fastcopy(c, id=f"mix-{k}", recording=None, features=fastcopy(c.features, recording_id="mix"))
        for k, c in enumerate(featured))
    item = PreMixedSourceSeparationDataset(sources, CutSet.from_cuts([mix]))[0]
    assert item["sources"].shape[0] == 2 and item["mixture"].ndim == 2
    chunks = list(RecordingChunkIterableDataset(RecordingSet.from_dir(root, "*.sph"), 0.5, 0.5))
    assert audio_chunk_collate(chunks)["audio"].shape[1] == SR // 2
assert not any(m.startswith(("jax.", "lhotse_tpu.")) for m in sys.modules)
"""


def test_paired_path_runs_without_jax(tmp_path):
    """SPHERE and AIFF corpora → ``CutPairsSampler`` →
    ``K2Speech2TextTranslationDataset`` with ``OnTheFlyFeatures``, TTS with
    ``TokenCollater``, a batch-extracted mixture into
    ``PreMixedSourceSeparationDataset`` and chunked recordings, on the CPU,
    in a process where importing jax or lhotse_tpu fails."""
    proc = subprocess.run(
        [sys.executable, "-c", PAIRED_PATH, str(tmp_path)], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", PORT_FILES)
def test_source_has_no_jax_import(path):
    assert not FORBIDDEN.search((ROOT / path).read_text()), path


LOSSY_PATH = """
import sys
sys.modules["jax"] = None
sys.modules["lhotse_tpu"] = None
import tempfile
from pathlib import Path

import numpy as np

from lhotse_tpu_torch.audio import syscodecs as sc
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset import SimpleCutSampler
from lhotse_tpu_torch.dataset.cut_transforms import Compress
from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
from lhotse_tpu_torch.features import Fbank, FbankConfig
from lhotse_tpu_torch.recipes import prepare_commonvoice
from lhotse_tpu_torch.shar.readers import LazySharIterator

with tempfile.TemporaryDirectory(dir=sys.argv[1]) as tmp:
    lang = Path(tmp) / "cv" / "en"
    (lang / "clips").mkdir(parents=True)
    rng = np.random.default_rng(0)
    rows = ["client_id\\tpath\\tsentence\\tage\\tgender\\taccents"]
    for i in range(4):
        x = (0.1 * rng.standard_normal(int(48000 * (0.5 + 0.2 * i)))).astype(np.float32)
        (lang / "clips" / f"c{i}.mp3").write_bytes(sc.mp3_encode(x, 48000))
        rows.append(f"spk{i}\\tc{i}.mp3\\tsay \\"{i}\\tthirties\\tfemale\\tus")
    for split in ("train", "dev", "test"):
        (lang / f"{split}.tsv").write_text("\\n".join(rows) + "\\n")
    train = prepare_commonvoice(lang.parent, Path(tmp) / "manifests", num_jobs=2)["en"]["train"]
    cuts = CutSet.from_manifests(**train).resample(16000)
    dataset = K2SpeechRecognitionDataset(
        cut_transforms=[Compress(codecs=["opus", "mp3", "vorbis"], p=1.0, seed=1)],
        input_strategy=OnTheFlyFeatures(Fbank(FbankConfig(device="cpu"))))
    batches = [dataset[b] for b in SimpleCutSampler(cuts, max_duration=2.0)]
    assert sum(len(b["supervisions"]["text"]) for b in batches) == 4
    assert all(b["inputs"].shape[2] == 80 and np.isfinite(b["inputs"]).all() for b in batches)
    cuts.to_shar(Path(tmp) / "shar", fields={"recording": "opus"}, shard_size=2)
    restored = list(LazySharIterator(in_dir=Path(tmp) / "shar"))
    assert [c.load_audio().shape[1] for c in restored] == [c.num_samples for c in cuts]
assert not any(m.startswith(("jax.", "lhotse_tpu.")) for m in sys.modules)
"""


def test_lossy_codec_path_runs_without_jax(tmp_path):
    """A CommonVoice MP3 layout → ``prepare_commonvoice`` → 16 kHz cuts →
    the ``Compress`` cut transform → ``OnTheFlyFeatures``, and the cuts as
    Opus Shar shards read back, on the CPU, in a process where importing
    jax or lhotse_tpu fails."""
    proc = subprocess.run(
        [sys.executable, "-c", LOSSY_PATH, str(tmp_path)], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


KALDI_WITHOUT_CLICK = """
import sys
sys.modules["jax"] = None
sys.modules["lhotse_tpu"] = None
sys.modules["click"] = None
from pathlib import Path

import numpy as np

import lhotse_tpu_torch.audio.source
from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.audio.flacio import write_flac
from lhotse_tpu_torch.kaldi import export_to_kaldi, load_kaldi_data_dir

root = Path(sys.argv[1])
write_flac(str(root / "a.flac"), (0.1 * np.random.default_rng(0).standard_normal(8000)).astype(np.float32), 16000)
kdir = root / "kdir"
kdir.mkdir()
(kdir / "wav.scp").write_text(f"a cat {root / 'a.flac'} |\\n")
(kdir / "reco2dur").write_text("a 0.5\\n")
(kdir / "utt2spk").write_text("a spk\\n")
recs, sups, _ = load_kaldi_data_dir(kdir, sampling_rate=16000)
assert np.array_equal(recs["a"].load_audio(), Recording.from_file(root / "a.flac").load_audio())
export_to_kaldi(recs, sups, root / "out")
assert (root / "out" / "wav.scp").read_text().endswith(" |\\n")
try:
    import lhotse_tpu_torch.bin.modes
except ImportError:
    pass
else:
    raise AssertionError("the CLI imported without click")
assert not any(m.startswith(("jax.", "lhotse_tpu.", "click.")) for m in sys.modules)
"""


def test_kaldi_path_runs_without_click(tmp_path):
    """``lhotse_tpu_torch.kaldi`` and ``audio.source`` import, and a piped
    Kaldi data dir is read and written, in a process where importing click,
    jax or lhotse_tpu fails; only the CLI needs click."""
    proc = subprocess.run(
        [sys.executable, "-c", KALDI_WITHOUT_CLICK, str(tmp_path)], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


KALDI_CLI_PATH = """
import sys
sys.modules["jax"] = None
sys.modules["lhotse_tpu"] = None
from pathlib import Path

import numpy as np

from lhotse_tpu_torch.audio.wavio import write_wav
from lhotse_tpu_torch.bin.modes import cli
from lhotse_tpu_torch.cut import CutSet

root = Path(sys.argv[1])
rng = np.random.default_rng(0)
kdir = root / "kdir"
kdir.mkdir()
scp, dur = [], []
for i in range(3):
    write_wav(str(root / f"u{i}.wav"), (0.1 * rng.standard_normal(16000)).astype(np.float32), 16000)
    scp.append(f"u{i} cat {root / f'u{i}.wav'} |")
    dur.append(f"u{i} 1.0")
(kdir / "wav.scp").write_text("\\n".join(scp) + "\\n")
(kdir / "reco2dur").write_text("\\n".join(dur) + "\\n")
(kdir / "segments").write_text("u0-a u0 0.1 0.6\\nu1-a u1 0.0 -1\\nu2-a u2 0.2 0.9\\n")
(kdir / "utt2spk").write_text("u0-a s0\\nu1-a s1\\nu2-a s0\\n")
(kdir / "text").write_text("u0-a one\\nu1-a two\\nu2-a three\\n")
(root / "cpu.yaml").write_text("feature_type: kaldi-fbank\\ndevice: cpu\\n")
m, out = str(root / "m"), str(root / "o")
(root / "o").mkdir()
for argv in (["kaldi", "import", str(kdir), "16000", m],
             ["fix", m + "/recordings.jsonl.gz", m + "/supervisions.jsonl.gz", m + "/fixed"],
             ["cut", "simple", "-r", m + "/fixed/recordings.jsonl.gz",
              "-s", m + "/fixed/supervisions.jsonl.gz", out + "/cuts.jsonl.gz"],
             ["cut", "trim-to-supervisions", out + "/cuts.jsonl.gz", out + "/trimmed.jsonl.gz"],
             ["feat", "extract-cuts-batch", "-f", str(root / "cpu.yaml"), "-j", "1",
              out + "/trimmed.jsonl.gz", out + "/feats.jsonl.gz", out + "/storage"],
             ["shar", "export", "-a", "flac", out + "/trimmed.jsonl.gz", out + "/shar"],
             ["shar", "compute-features", "-f", str(root / "cpu.yaml"), out + "/shar"],
             ["kaldi", "export", m + "/fixed/recordings.jsonl.gz",
              m + "/fixed/supervisions.jsonl.gz", out + "/kaldi"]):
    cli.main(argv, standalone_mode=False)
cuts = sorted(CutSet.from_file(out + "/feats.jsonl.gz"), key=lambda c: c.supervisions[0].id)
feats = [c.load_features() for c in cuts]
assert [f.shape for f in feats] == [(50, 80), (100, 80), (70, 80)]
assert all(np.isfinite(f).all() for f in feats)
assert len(list((root / "o" / "shar").glob("features.*.tar"))) == 1
assert (root / "o" / "kaldi" / "wav.scp").read_text().count("|") == 3
assert not any(m.startswith(("jax.", "lhotse_tpu.")) for m in sys.modules)
"""


def test_kaldi_cli_path_runs_without_jax(tmp_path):
    """A piped Kaldi data dir through the port's CLI in one process: import,
    fix, cut simple, trim, ``feat extract-cuts-batch`` on the CPU, Shar
    export with ``compute-features``, and Kaldi export, where importing jax
    or lhotse_tpu fails."""
    proc = subprocess.run(
        [sys.executable, "-c", KALDI_CLI_PATH, str(tmp_path)], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


SIM_SHARDED_PATH = """
import sys
sys.modules["jax"] = None
sys.modules["lhotse_tpu"] = None
import tempfile
from pathlib import Path

import numpy as np

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.audio.flacio import write_flac
from lhotse_tpu_torch.bin.modes import cli
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset import K2SurtDataset, SimpleCutSampler
from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
from lhotse_tpu_torch.features import Fbank, FbankConfig
from lhotse_tpu_torch.index_pack import (
    IndexPackCollectionSpec, index_pack_collection_key, write_index_pack)
from lhotse_tpu_torch.indexing import create_jsonl_index
from lhotse_tpu_torch.packed_lazy import LazyPackedManifestIterator
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import fix_random_seed
from lhotse_tpu_torch.workflows import ConversationalMeetingSimulator

with tempfile.TemporaryDirectory(dir=sys.argv[1]) as tmp:
    tmp = Path(tmp)
    rng = np.random.default_rng(0)
    cuts = []
    for i in range(8):
        write_flac(str(tmp / f"u{i}.flac"), (0.1 * rng.standard_normal(16000 + 2000 * i)).astype(
            np.float32), 16000)
        c = Recording.from_file(tmp / f"u{i}.flac").to_cut()
        c.supervisions = [SupervisionSegment(id=f"s{i}", recording_id=c.recording_id, start=0,
                                             duration=c.duration, text=f"w{i}",
                                             speaker=f"spk{i % 4}")]
        cuts.append(c)
    cuts = CutSet.from_cuts(cuts)
    fbank = Fbank(FbankConfig(device="cpu"))
    fix_random_seed(0)
    sim = ConversationalMeetingSimulator()
    sim.fit(SupervisionSet.from_segments([SupervisionSegment(
        id=f"m{k}", recording_id="m", start=1.1 * k - 0.3 * (k % 3 == 0), duration=1.0,
        speaker=f"x{k % 2}") for k in range(1, 12)]))
    meetings = sim.reverberate(sim.simulate(cuts, num_repeats=1, num_speakers_per_meeting=[2, 3]))
    windows = meetings.cut_into_windows(4.0, keep_excessive_supervisions=False).filter(
        lambda c: len(c.supervisions) > 0).to_eager()
    surt = K2SurtDataset(input_strategy=OnTheFlyFeatures(fbank))
    batches = [surt[b] for b in SimpleCutSampler(windows, max_duration=8.0)]
    assert batches and all(np.isfinite(b["inputs"]).all() for b in batches)
    shards = []
    for k in range(2):
        shards.append(tmp / f"cuts-{k}.jsonl")
        CutSet.from_cuts(list(cuts)[k::2]).to_file(shards[-1])
        create_jsonl_index(shards[-1])
    key = index_pack_collection_key("records", "json-lines", "cuts-{0..1}.jsonl")
    write_index_pack(tmp / "cuts.idxpack", [IndexPackCollectionSpec(
        role="records", kind="json-lines", source_spec="cuts-{0..1}.jsonl", paths=shards)])
    cli.main(["index", "verify-pack", str(tmp / "cuts.idxpack")], standalone_mode=False)
    cli.main(["cut", "export-to-webdataset", "-s", "4", str(shards[0]),
              str(tmp / "wds-%03d.tar")], standalone_mode=False)
    asr = K2SpeechRecognitionDataset(input_strategy=OnTheFlyFeatures(fbank))
    for leg in (CutSet.from_files(shards, seed=0),
                CutSet(LazyPackedManifestIterator(tmp / "cuts.idxpack", key, shuffle_shards=True)),
                CutSet.from_webdataset([f"pipe:cat {tmp}/wds-000.tar"])):
        batches = [asr[b] for b in SimpleCutSampler(leg, max_duration=6.0)]
        assert sum(len(b["supervisions"]["text"]) for b in batches) in (4, 8)
assert not any(m.startswith(("jax.", "lhotse_tpu.")) for m in sys.modules)
"""


def test_simulated_and_sharded_paths_run_without_jax(tmp_path):
    """Simulated, reverberated meetings in windows through ``K2SurtDataset``
    with ``OnTheFlyFeatures``, and sharded manifests (``from_files``, an
    index pack checked by ``index verify-pack``, WebDataset shards written by
    ``cut export-to-webdataset`` and read through ``pipe:cat``) through
    ``K2SpeechRecognitionDataset``, on the CPU, in a process where importing
    jax or lhotse_tpu fails."""
    proc = subprocess.run(
        [sys.executable, "-c", SIM_SHARDED_PATH, str(tmp_path)], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


NOISE_MEETING_PATH = """
import sys
sys.modules["jax"] = None
sys.modules["lhotse_tpu"] = None
import json
from pathlib import Path

import numpy as np

from lhotse_tpu_torch.audio.flacio import write_flac
from lhotse_tpu_torch.audio.wavio import write_wav
from lhotse_tpu_torch.bin.modes import cli
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset import SimpleCutSampler
from lhotse_tpu_torch.dataset.device_augment import OnDeviceAugmenter
from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
from lhotse_tpu_torch.features import Fbank, FbankConfig
from lhotse_tpu_torch.recipes import prepare_aishell4, prepare_chime6, prepare_musan, prepare_rir_noise
from lhotse_tpu_torch.serialization import load_manifest

root = Path(sys.argv[1])
rng = np.random.default_rng(0)
def wav(path, seconds, channels=1):
    path.parent.mkdir(parents=True, exist_ok=True)
    write_wav(path, (0.1 * rng.standard_normal((channels, int(seconds * 16000)))).astype(np.float32), 16000)
for i in range(4):
    wav(root / "musan" / "noise" / "free-sound" / f"noise-free-sound-{i:04d}.wav", 0.5 + i)
rir_dir = root / "RIRS_NOISES" / "real_rirs_isotropic_noises"
for i in range(2):
    rir_dir.mkdir(parents=True, exist_ok=True)
    rir = rng.standard_normal(4000) * np.exp(-np.arange(4000) / 600.0)
    rir[10] = 1.0
    write_wav(rir_dir / f"RWCP_type{i}_rir_circle.wav", rir[None].astype(np.float32), 16000)
for argv in (["prepare", "musan", "-p", "noise", str(root / "musan"), str(root / "m")],
             ["prepare", "rir-noise", "-p", "real_rir", str(root / "RIRS_NOISES"), str(root / "m")]):
    cli.main(argv, standalone_mode=False)
noise = load_manifest(root / "m" / "musan_recordings_noise.jsonl.gz")
rirs = load_manifest(root / "m" / "real-rir_recordings_all.jsonl.gz")
assert len(noise) == 4 and len(rirs) == 2
assert [r.id for r in noise] == [r.id for r in prepare_musan(root / "musan", parts="noise")["noise"]["recordings"]]
assert len(prepare_rir_noise(root / "RIRS_NOISES", parts="real_rir")["real_rir"]["recordings"]) == 2
pool = np.stack([np.resize(r.load_audio()[0], 48000) for r in noise])
aug = OnDeviceAugmenter([(2.0, 4)], speed_factor=1.1, noise_pool=pool,
                        rir=list(rirs)[0].load_audio()[0], wire_format="int16", device="cpu")
feats, lens = aug((0.1 * rng.standard_normal((4, 32000))).astype(np.float32), [32000] * 4)
assert tuple(feats.shape) == (4, 182, 80) and np.isfinite(feats.numpy()).all()
session = root / "aishell4" / "train_L"
(session / "TextGrid").mkdir(parents=True)
(session / "wav").mkdir()
write_flac(str(session / "wav" / "L_R003S01C02.flac"),
           (0.1 * rng.standard_normal((8, 48000))).astype(np.float32), 16000)
tg = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "xmin = 0", "xmax = 3",
      "tiers? <exists>", "size = 1", "item []:", "    item [1]:", '        class = "IntervalTier"',
      '        name = "1"', "        xmin = 0", "        xmax = 3", "        intervals: size = 2",
      "        intervals [1]:", "            xmin = 0.5", "            xmax = 1.5",
      '            text = "你好"', "        intervals [2]:", "            xmin = 1.5",
      "            xmax = 2.5", '            text = "再见"']
(session / "TextGrid" / "L_R003S01C02.TextGrid").write_text("\\n".join(tg) + "\\n")
sessions = CutSet.from_manifests(**prepare_aishell4(root / "aishell4")["train_L"])
monos = CutSet.from_cuts(m for c in sessions.trim_to_supervisions(keep_all_channels=True)
                         for m in c.to_mono())
assert len(monos) == 16
dataset = K2SpeechRecognitionDataset(input_strategy=OnTheFlyFeatures(Fbank(FbankConfig(device="cpu"))))
batches = [dataset[b] for b in SimpleCutSampler(monos, max_duration=8.0)]
assert sum(len(b["supervisions"]["text"]) for b in batches) == 16
chime = root / "CHiME6"
for name in ("S02_U01.CH1", "S02_U01.CH2", "S09_U01.CH1"):
    wav(chime / "audio" / "dev" / f"{name}.wav", 2.0)
(chime / "transcriptions" / "dev").mkdir(parents=True)
for session in ("S02", "S09"):
    (chime / "transcriptions" / "dev" / f"{session}.json").write_text(json.dumps([
        {"start_time": "0:00:00.50", "end_time": "0:00:01.50", "words": "ok", "speaker": "P05"}]))
dev = prepare_chime6(chime, dataset_parts="dev")["dev"]
assert [s.channel for s in dev["supervisions"]] == [[0, 1], [0]]
assert not any(m.startswith(("jax.", "lhotse_tpu.")) for m in sys.modules)
"""


def test_noise_and_meeting_recipes_run_without_jax(tmp_path):
    """MUSAN and RIRS_NOISES prepared through the CLI into the augmenter's
    noise pool and RIR, an 8-channel AISHELL-4 session through
    ``trim_to_supervisions`` and ``to_mono`` into ``OnTheFlyFeatures``, and a
    synchronised CHiME-6 layout, on the CPU, in a process where importing jax
    or lhotse_tpu fails."""
    proc = subprocess.run(
        [sys.executable, "-c", NOISE_MEETING_PATH, str(tmp_path)], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
