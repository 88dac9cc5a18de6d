"""
The port's noise and room-impulse-response recipes (lhotse_tpu_torch.recipes
``musan``, ``rir_noise``, ``but_reverb_db`` and ``wham``) against the JAX
package's, on the fixture layouts of tests/test_recipes.py,
tests/test_recipes_tranche6.py, tests/test_recipes_tranche2.py and
tests/test_recipes_tranche3.py (made from a numpy seed), and the slice as a
whole at a small size:

- a MUSAN layout (4 noise files) and a RIRS_NOISES layout (2 RIRs) through
  each package's ``prepare_*``, the noise recordings into the noise pool of
  each package's ``OnDeviceAugmenter`` and a seeded choice of the real RIRs
  into its ``rir``, at a 2 s x 4 bucket with an int16 wire, speed 1.1, SNR
  (10, 20) and SpecAugment: within 1e-4, the bound of
  tests/test_torch_device_augment.py, of the JAX augmenter with the JAX
  fbank layer's kernel route;
- ``CutMix`` over the MUSAN noise cuts and ``ReverbWithImpulseResponse``
  over the ``real_rir`` and BUT Reverb DB ``rir`` recordings, into
  ``K2SpeechRecognitionDataset`` with ``OnTheFlyFeatures``: the same cuts,
  and features within ``EXTRACTOR_TOL`` (tests/test_torch_recipes.py) of
  the JAX chain with its extractor's device route.

Written ``.jsonl.gz`` manifests are compared after decompression, since a
gzip header carries its write time.
"""
import gzip
import json
import random
from types import SimpleNamespace

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.audio.wavio import write_wav
from lhotse_tpu.dataset import cut_transforms as JT
from lhotse_tpu.dataset.device_augment import OnDeviceAugmenter as JAugmenter
from lhotse_tpu.dataset.input_strategies import OnTheFlyFeatures as JOnTheFly
from lhotse_tpu.dataset.signal_transforms import SpecAugment as JSpecAugment
from lhotse_tpu.dataset.speech_recognition import K2SpeechRecognitionDataset as JDataset
from lhotse_tpu.features.kaldi.extractors import Fbank as JFbank
from lhotse_tpu.features.kaldi.extractors import FbankConfig as JFbankConfig
from lhotse_tpu.recipes import but_reverb_db as jbut
from lhotse_tpu.recipes import musan as jmusan
from lhotse_tpu.recipes import rir_noise as jrir
from lhotse_tpu.recipes import wham as jwham
from lhotse_tpu.utils import fix_random_seed as jfix
from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset import cut_transforms as PT
from lhotse_tpu_torch.dataset.device_augment import OnDeviceAugmenter
from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
from lhotse_tpu_torch.dataset.signal_transforms import SpecAugment
from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
from lhotse_tpu_torch.features import Fbank, FbankConfig
from lhotse_tpu_torch.recipes import but_reverb_db as pbut
from lhotse_tpu_torch.recipes import musan as pmusan
from lhotse_tpu_torch.recipes import rir_noise as prir
from lhotse_tpu_torch.recipes import wham as pwham
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import fix_random_seed
from test_torch_device_augment import _JaxKernelRoute

SR = 16000
AUG_TOL = 1e-4  # tests/test_torch_device_augment.py:103
EXTRACTOR_TOL = 3e-4  # tests/test_torch_recipes.py:41
POOL_SECONDS = 3.0  # each noise recording tiled or cut to this length in the pool
RIR_SEED = 11  # the seeded choice of a real RIR


def _wav(path, seconds=1.0, seed=0, channels=1, sr=SR):
    """tests/test_recipes*.py::_wav: 0.1 white noise from RandomState(seed)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    write_wav(path, (rng.randn(channels, int(seconds * sr)) * 0.1).astype(np.float32), sr)


def _rir(path, seconds, seed):
    """An exponentially decaying noise response with its direct path at 1."""
    path.parent.mkdir(parents=True, exist_ok=True)
    n = int(seconds * SR)
    rng = np.random.RandomState(seed)
    rir = rng.randn(n) * np.exp(-np.arange(n) / (n / 6.0)) * 0.3
    rir[int(0.002 * SR)] = 1.0
    write_wav(path, rir[None].astype(np.float32), SR)


# -- the JAX tests' layouts ---------------------------------------------------------------


def musan_tree(root, layout="recipes"):
    """``recipes``: tests/test_recipes.py:31 (one file per part, a vocal
    track); ``tranche6``: tests/test_recipes_tranche6.py:140 (two music
    tracks, one instrumental, an ANNOTATIONS line with an extra field);
    ``pool``: the slice's layout, with 4 noise files of 0.5-2.5 s."""
    if layout == "recipes":
        _wav(root / "music" / "fma" / "music-fma-0000.wav", seed=1)
        _wav(root / "noise" / "free-sound" / "noise-free-sound-0000.wav", seed=2)
        _wav(root / "speech" / "us-gov" / "speech-us-gov-0000.wav", seed=3)
        (root / "music" / "fma" / "ANNOTATIONS").write_text("music-fma-0000 rock,pop Y artist1\n")
    elif layout == "tranche6":
        for part, names in (("music", ["music-fma-0000", "music-fma-0001"]),
                            ("speech", ["speech-librivox-0000"]),
                            ("noise", ["noise-free-sound-0000"])):
            for n in names:
                _wav(root / part / "sub" / f"{n}.wav", seconds=0.8)
        (root / "music" / "sub" / "ANNOTATIONS").write_text(
            "music-fma-0000 jazz,blues Y artist1 extra-ignored\n"
            "music-fma-0001 rock N artist2\n")
    else:
        for i, (sub, seconds) in enumerate(
                [("free-sound", 0.5), ("free-sound", 2.5), ("sound-bible", 1.2),
                 ("sound-bible", 3.4)]):
            _wav(root / "noise" / sub / f"noise-{sub}-{i:04d}.wav", seconds=seconds, seed=20 + i)
        _wav(root / "music" / "hd-classical" / "music-hd-0000.wav", seconds=1.0, seed=30)
        (root / "music" / "hd-classical" / "ANNOTATIONS").write_text(
            "music-hd-0000 classical N bach\n")
        _wav(root / "speech" / "librivox" / "speech-librivox-0000.wav", seconds=1.0, seed=31)
    return root


def rir_noise_tree(root, n_rirs=1):
    """tests/test_recipes_tranche2.py:251, with ``n_rirs`` real responses."""
    _wav(root / "pointsource_noises" / "noise-1.wav", seed=42)
    names = ["RWCP_type4_rir_cirline", "RVB2014_type1_rir_largeroom1_near_angla"]
    for i in range(n_rirs):
        _rir(root / "real_rirs_isotropic_noises" / f"{names[i % 2]}_{i:02d}.wav", 0.3 + 0.1 * i,
             seed=43 + i)
    _wav(root / "real_rirs_isotropic_noises" / "RVB2014_type1_noise_largeroom1_1.wav", seed=44)
    _wav(root / "simulated_rirs" / "smallroom" / "Room001" / "Room001-00001.wav", seed=45)
    return root


def wham_tree(root):
    """tests/test_recipes_tranche2.py:419."""
    for split, seed in (("tr", 84), ("cv", 85), ("tt", 86)):
        _wav(root / split / f"noise_{split}.wav", seed=seed)
    return root


def but_reverb_tree(root):
    """tests/test_recipes_tranche3.py:573, and a second room's RIR."""
    base = root / "Q301" / "MicID01" / "SpkID1" / "01"
    _rir(base / "RIR" / "IR_sweep.v00.wav", 0.25, seed=53)
    _wav(base / "silence" / "sil.v00.wav", seconds=2.0, seed=54)
    _rir(root / "L207" / "MicID02" / "SpkID3" / "02" / "RIR" / "IR_sweep.v01.wav", 0.4, seed=55)
    return root


# -- comparisons ------------------------------------------------------------------------


def _dicts(manifests):
    """Nested manifest dicts as plain dicts, manifest items as ``to_dict()``."""
    if isinstance(manifests, dict):
        return {k: _dicts(v) for k, v in manifests.items()}
    return [item.to_dict() for item in manifests]


def _decompressed(directory) -> dict:
    return {p.name: gzip.decompress(p.read_bytes()) for p in sorted(directory.glob("*.jsonl.gz"))}


def _same(ours, theirs, tmp_path):
    assert _dicts(ours) == _dicts(theirs)
    written = _decompressed(tmp_path / "ours")
    assert written and written == _decompressed(tmp_path / "jax")
    return written


# -- the recipes against JAX ----------------------------------------------------------------


@pytest.mark.parametrize("layout", ["recipes", "tranche6", "pool"])
@pytest.mark.parametrize("kwargs", [
    dict(), dict(parts=("music",)), dict(use_vocals=False), dict(parts="noise"),
    dict(parts=("speech", "noise"))], ids=["all", "music", "no-vocals", "noise", "speech+noise"])
def test_prepare_musan_equals_jax(tmp_path, layout, kwargs):
    root = musan_tree(tmp_path / "musan", layout)
    ours = pmusan.prepare_musan(root, output_dir=tmp_path / "ours", **kwargs)
    theirs = jmusan.prepare_musan(root, output_dir=tmp_path / "jax", **kwargs)
    written = _same(ours, theirs, tmp_path)
    assert len(written) == sum(len(p) for p in ours.values())
    for part, pair in ours.items():
        assert type(pair["recordings"]) is RecordingSet
        assert ("supervisions" in pair) == (part == "music")
    if "music" in ours:
        sups = list(ours["music"]["supervisions"])
        assert all(isinstance(s.custom["genres"], list) for s in sups)
        if not kwargs.get("use_vocals", True):
            assert all(s.custom["vocals"] is False for s in sups)


def test_prepare_musan_refuses_as_jax(tmp_path):
    root = musan_tree(tmp_path / "musan")
    for prepare in (pmusan.prepare_musan, jmusan.prepare_musan):
        with pytest.raises(ValueError):
            prepare(root, parts=())
        with pytest.raises(AssertionError):
            prepare(tmp_path / "no-such-dir")
    assert _dicts(pmusan.prepare_music(root)) == _dicts(jmusan.prepare_music(root))


@pytest.mark.parametrize("parts", [
    ("point_noise", "iso_noise", "real_rir", "sim_rir"), ("real_rir",), "point_noise",
    ("iso_noise", "sim_rir")], ids=["all", "real_rir", "point_noise", "iso+sim"])
def test_prepare_rir_noise_equals_jax(tmp_path, parts):
    root = rir_noise_tree(tmp_path / "RIRS_NOISES", n_rirs=2)
    ours = prir.prepare_rir_noise(root, output_dir=tmp_path / "ours", parts=parts)
    theirs = jrir.prepare_rir_noise(root, output_dir=tmp_path / "jax", parts=parts)
    written = _same(ours, theirs, tmp_path)
    assert set(written) == {f"{p.replace('_', '-')}_recordings_all.jsonl.gz"
                            for p in ([parts] if isinstance(parts, str) else parts)}
    if "real_rir" in ours:
        assert len(ours["real_rir"]["recordings"]) == 2
    if "sim_rir" in ours:
        assert [r.id for r in ours["sim_rir"]["recordings"]] == ["small-Room001-00001"]
    assert prir.PARTS == jrir.PARTS


def test_prepare_rir_noise_refuses_as_jax(tmp_path):
    root = rir_noise_tree(tmp_path / "RIRS_NOISES")
    (tmp_path / "empty").mkdir()
    for prepare in (prir.prepare_rir_noise, jrir.prepare_rir_noise):
        with pytest.raises(ValueError):
            prepare(root, parts=("real_rir", "no_such_part"))
        with pytest.raises(ValueError):
            prepare(root, parts=())
        with pytest.raises(AssertionError):
            prepare(tmp_path / "empty", parts="real_rir")
        with pytest.raises(AssertionError):
            prepare(tmp_path / "no-such-dir")


def test_prepare_wham_equals_jax(tmp_path):
    root = wham_tree(tmp_path / "wham_noise")
    ours = pwham.prepare_wham(root, output_dir=tmp_path / "ours")
    written = _same(ours, jwham.prepare_wham(root, output_dir=tmp_path / "jax"), tmp_path)
    assert set(ours) == {"tr", "cv", "tt"} and len(written) == 3
    for prepare in (pwham.prepare_wham, jwham.prepare_wham):
        with pytest.raises(AssertionError):
            prepare(tmp_path / "no-such-dir")


@pytest.mark.parametrize("parts", [("silence", "rir"), ("rir",), "silence"],
                         ids=["all", "rir", "silence"])
def test_prepare_but_reverb_db_equals_jax(tmp_path, parts):
    root = but_reverb_tree(tmp_path / "BUT_ReverbDB")
    ours = pbut.prepare_but_reverb_db(root, output_dir=tmp_path / "ours", parts=parts)
    theirs = jbut.prepare_but_reverb_db(root, output_dir=tmp_path / "jax", parts=parts)
    _same(ours, theirs, tmp_path)
    if "rir" in ours:
        assert [r.id for r in ours["rir"]["recordings"]] == [
            "L207-MicID02-SpkID3-02-vv01", "Q301-MicID01-SpkID1-01-vv00"]
    for prepare in (pbut.prepare_but_reverb_db, jbut.prepare_but_reverb_db):
        with pytest.raises(ValueError):
            prepare(root, parts=())


# -- the slice: MUSAN and RIRS_NOISES into the on-device chain ---------------------------------


def noise_pool(recordings, seconds=POOL_SECONDS) -> np.ndarray:
    """The augmenter's (N, T) pool: each noise recording's first channel,
    tiled or cut to ``seconds``."""
    n = int(seconds * SR)
    return np.stack([np.resize(r.load_audio()[0], n) for r in recordings]).astype(np.float32)


def seeded_rir(recordings, seed=RIR_SEED) -> np.ndarray:
    """A seeded choice among the recordings (by sorted id), as (L,) taps."""
    rec = random.Random(seed).choice(sorted(recordings, key=lambda r: r.id))
    return rec.load_audio()[0].astype(np.float32)


@pytest.fixture(scope="module")
def noise_corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("noise_corpora")
    _write_utterances(root)
    return (musan_tree(root / "musan", "pool"), rir_noise_tree(root / "RIRS_NOISES", n_rirs=2),
            but_reverb_tree(root / "BUT_ReverbDB"), root)


def test_musan_rir_fed_augmenter_equals_jax(noise_corpora, tmp_path):
    musan, rirs, _, _ = noise_corpora
    ours = (pmusan.prepare_musan(musan, parts="noise")["noise"]["recordings"],
            prir.prepare_rir_noise(rirs, parts="real_rir")["real_rir"]["recordings"])
    theirs = (jmusan.prepare_musan(musan, parts="noise")["noise"]["recordings"],
              jrir.prepare_rir_noise(rirs, parts="real_rir")["real_rir"]["recordings"])
    pool, rir = noise_pool(ours[0]), seeded_rir(ours[1])
    assert pool.shape == (4, int(POOL_SECONDS * SR)) and len(ours[1]) == 2
    assert np.array_equal(pool, noise_pool(theirs[0]))
    assert np.array_equal(rir, seeded_rir(theirs[1]))
    common = dict(speed_factor=1.1, noise_pool=pool, rir=rir, snr=(10, 20), mix_prob=0.5, seed=3)
    port = OnDeviceAugmenter([(2.0, 4)], wire_format="int16", specaugment=SpecAugment(seed=7),
                             device="cpu", **common)
    jax_aug = JAugmenter([(2.0, 4)], wire_format="int16", specaugment=JSpecAugment(seed=7),
                         fbank=_JaxKernelRoute(), **common)
    rng = np.random.default_rng(5)
    mixed = 0
    for lens in ([32000, 24000, 30000, 17000], [32000, 32000, 9000], [20000, 31000]):
        audio = (0.1 * rng.standard_normal((len(lens), max(lens)))).astype(np.float32)
        s_ours, s_theirs = port.stage(audio, lens), jax_aug.stage(audio, lens)
        mixed += int(np.asarray(s_ours.kwargs["mix_mask"]).sum())
        feats, feat_lens = port.compute(s_ours)
        jfeats, jlens = jax_aug.compute(s_theirs)
        assert tuple(feats.shape) == np.asarray(jfeats).shape == (4, 182, 80)
        assert np.array_equal(feat_lens.numpy(), np.asarray(jlens))
        np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), rtol=0, atol=AUG_TOL)
    assert mixed > 0  # the MUSAN pool went into some rows


def _write_utterances(root):
    """Six 0.8-1.6 s WAV tone bursts over a 0.01 noise floor."""
    rng = np.random.RandomState(1234)
    for i in range(6):
        n = int(SR * (0.8 + 0.16 * i))
        x = 0.2 * np.sin(2 * np.pi * (120 + 25 * i) * np.arange(n) / SR) + 0.01 * rng.randn(n)
        write_wav(root / f"utt{i}.wav", x[None].astype(np.float32), SR)


def _utterances(root, pkg):
    """The utterances as cuts of one package, one supervision each."""
    m = J if pkg == "jax" else SimpleNamespace(
        Recording=Recording, RecordingSet=RecordingSet, SupervisionSegment=SupervisionSegment,
        SupervisionSet=SupervisionSet, CutSet=CutSet)
    recs = m.RecordingSet.from_recordings(
        m.Recording.from_file(p) for p in sorted(root.glob("utt*.wav")))
    sups = m.SupervisionSet.from_segments(
        m.SupervisionSegment(id=f"s-{r.id}", recording_id=r.id, start=0.0, duration=r.duration,
                             text=r.id) for r in recs)
    return m.CutSet.from_manifests(recordings=recs, supervisions=sups)


def _on_the_fly(pkg, corpora):
    """MUSAN noise cuts into CutMix and the real and BUT RIRs into
    ReverbWithImpulseResponse, in one package, batch by batch."""
    musan, rirs, but, root = corpora
    if pkg == "port":
        prepare = (pmusan.prepare_musan, prir.prepare_rir_noise, pbut.prepare_but_reverb_db)
        T, CS, seed_fn = PT, CutSet, fix_random_seed
        dataset_cls = K2SpeechRecognitionDataset
        strategy = OnTheFlyFeatures(Fbank(FbankConfig(device="cpu")))
    else:
        prepare = (jmusan.prepare_musan, jrir.prepare_rir_noise, jbut.prepare_but_reverb_db)
        T, CS, seed_fn = JT, J.CutSet, jfix
        dataset_cls = JDataset
        # The JAX extractors' device route, in XLA on the CPU.
        strategy = JOnTheFly(JFbank(JFbankConfig(device="tpu")))
    noise = CS.from_manifests(recordings=prepare[0](musan, parts="noise")["noise"]["recordings"])
    rir_recs = (list(prepare[1](rirs, parts="real_rir")["real_rir"]["recordings"])
                + list(prepare[2](but, parts="rir")["rir"]["recordings"]))
    dataset = dataset_cls(return_cuts=True, input_strategy=strategy, cut_transforms=[
        T.CutMix(noise, snr=(10, 20), p=0.5, seed=1),
        T.ReverbWithImpulseResponse(rir_recs, p=0.5, randgen=random.Random(3))])
    cuts = list(_utterances(root, pkg))
    out = []
    for i in range(0, len(cuts), 2):
        seed_fn(100 + i)
        out.append(dataset[CS.from_cuts(cuts[i:i + 2])])
    return out


def test_cutmix_and_reverb_on_the_fly_equal_jax(noise_corpora):
    ours = _on_the_fly("port", noise_corpora)
    theirs = _on_the_fly("jax", noise_corpora)
    assert len(ours) == len(theirs) == 3
    text = ""
    for a, b in zip(ours, theirs):
        assert a["inputs"].shape == b["inputs"].shape and np.isfinite(a["inputs"]).all()
        np.testing.assert_allclose(a["inputs"], b["inputs"], rtol=0, atol=EXTRACTOR_TOL)
        for key in ("sequence_idx", "start_frame", "num_frames"):
            np.testing.assert_array_equal(a["supervisions"][key], b["supervisions"][key])
        dicts = [c.to_dict() for c in a["supervisions"]["cut"]]
        assert dicts == [c.to_dict() for c in b["supervisions"]["cut"]]
        text += json.dumps(dicts)
    # Both transforms drew: some cuts carry MUSAN noise, some a room response.
    assert '"MixedCut"' in text and "noise-" in text
    assert "ReverbWithImpulseResponse" in text
