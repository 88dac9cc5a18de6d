"""
The small names of the port's A7 slice against their JAX counterparts: the
``utils`` helpers, ``serialization.grouper`` and ``InvalidPathExtension``,
the audio error and switch names, ``flacio.is_available`` and
``native_build.native_disabled``, ``read_features_from_cuts``,
``pick_at_random``, ``augmentation.resample.resample``,
``FeatureSet.split_lazy``, the base ``Cut.unmix``, the extractors'
``.to(device)``, ``testing/random.py`` and ``testing/fixtures.py``,
``tools/env.py``, ``parallel/mesh.py::data_parallel_mesh`` and
``augmentation/wpe.py::dereverb_wpe_torch``. Each case feeds the same
seeded inputs to both packages; every comparison is exact.
"""
import random
import warnings

import numpy as np
import pytest
import torch

import lhotse_tpu as J
import lhotse_tpu.audio.backend as jbackend
import lhotse_tpu.audio.flacio as jflacio
import lhotse_tpu.audio.utils as jaudio_utils
import lhotse_tpu.augmentation.resample as jresample
import lhotse_tpu.augmentation.wpe as jwpe
import lhotse_tpu.dataset.collation as jcollation
import lhotse_tpu.dataset.sampling.dynamic_bucketing as jdb
import lhotse_tpu.native_build as jnative
import lhotse_tpu.serialization as jser
import lhotse_tpu.tools.env as jenv
import lhotse_tpu.utils.core as ju
import lhotse_tpu_torch as P
import lhotse_tpu_torch.audio.backend as pbackend
import lhotse_tpu_torch.audio.flacio as pflacio
import lhotse_tpu_torch.audio.utils as paudio_utils
import lhotse_tpu_torch.augmentation.resample as presample
import lhotse_tpu_torch.augmentation.wpe as pwpe
import lhotse_tpu_torch.dataset.collation as pcollation
import lhotse_tpu_torch.dataset.sampling.dynamic_bucketing as pdb
import lhotse_tpu_torch.native_build as pnative
import lhotse_tpu_torch.serialization as pser
import lhotse_tpu_torch.tools.env as penv
import lhotse_tpu_torch.utils as pu
from lhotse_tpu.testing import dummies as JD
from lhotse_tpu.testing import fixtures as jfixtures
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.features import FeatureSet
from lhotse_tpu_torch.features.kaldi import extractors as pext
from lhotse_tpu_torch.testing import dummies as PD
from lhotse_tpu_torch.testing import fixtures as pfixtures
from lhotse_tpu_torch.testing.random import deterministic_rng  # noqa: F401 - a fixture

# -- utils --------------------------------------------------------------------------------------


def test_utils_constants_and_pure_helpers_equal_jax():
    assert pu.INT16MAX == ju.INT16MAX == 32768
    for args in ((1.0, 16000, 16000), (1.0, 15999, 16000), (0.123, 1968, 16000)):
        assert pu.duration_to_num_samples_check(*args) == ju.duration_to_num_samples_check(*args)
    rng = np.random.default_rng(0)
    lens = rng.integers(1, 9, size=5)
    assert np.array_equal(pu.lens_to_mask(lens), ju.lens_to_mask(lens))
    assert pu.lens_to_mask(lens).dtype == np.float32
    assert list(pu.pairwise("abcd")) == list(ju.pairwise("abcd")) == [
        ("a", "b"), ("b", "c"), ("c", "d")]
    for args in ((0.0, 0.025, 0.01), (1.0, 0.025, 0.01), (0.3333, 0.05, 0.02)):
        assert pu.time_diff_to_num_frames(*args) == ju.time_diff_to_num_frames(*args)
    for url in ("s3://bucket/a/b.tar", "gs://x/y", "msc://old/z?k=1"):
        assert (pu.replace_bucket_with_profile_name(url, "prof")
                == ju.replace_bucket_with_profile_name(url, "prof"))
    assert pu.is_torchaudio_available() == ju.is_torchaudio_available()
    assert pu.is_torchcodec_available() == ju.is_torchcodec_available()
    with pu.nullcontext(7) as value:
        assert value == 7
    with ju.nullcontext(7) as value:
        assert value == 7


def test_overlap_fraction_and_index_check_equal_jax():
    spans = [pu.TimeSpan(0.0, 1.0), pu.TimeSpan(0.5, 2.0), pu.TimeSpan(1.0, 3.0),
             pu.TimeSpan(2.0, 2.0), pu.TimeSpan(-1.0, 0.25)]
    for a in spans:
        for b in spans:
            assert pu.measure_overlap_frac(a, b) == ju.measure_overlap_frac(
                ju.TimeSpan(a.start, a.end), ju.TimeSpan(b.start, b.end))
    items = [PD.dummy_supervision(i) for i in range(3)]
    assert list(pu.index_by_id_and_check(items)) == list(
        ju.index_by_id_and_check([JD.dummy_supervision(i) for i in range(3)]))
    with pytest.raises(AssertionError, match="Duplicated manifest ID"):
        pu.index_by_id_and_check(items + items[:1])


def test_docs_build_switch_equals_jax(monkeypatch):
    monkeypatch.delenv("READTHEDOCS", raising=False)
    assert pu.during_docs_build() is ju.during_docs_build() is False
    monkeypatch.setenv("READTHEDOCS", "1")
    assert pu.during_docs_build() is ju.during_docs_build() is True


def test_build_rng_and_deprecated_equal_jax():
    assert ([pu.build_rng(5).random() for _ in range(3)]
            == [ju.build_rng(5).random() for _ in range(3)])
    assert type(pu.build_rng("trng")).__name__ == type(ju.build_rng("trng")).__name__
    assert issubclass(pu.DeprecatedWarning, UserWarning)

    def f(x):
        """Doubles."""
        return 2 * x

    ours, theirs = pu.deprecated("use g")(f), ju.deprecated("use g")(f)
    assert ours.__doc__ == theirs.__doc__ and ours.__name__ == "f"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert ours(3) == 6
    assert [(w.category.__name__, str(w.message)) for w in caught] == [
        ("DeprecatedWarning", "use g")]


class _Rar:
    def __init__(self, names):
        self.names, self.extracted = names, None

    def namelist(self):
        return self.names

    def extractall(self, path, members):
        self.extracted = (path, members)


@pytest.mark.parametrize("names", [["a/b.wav", "c.txt"], ["../evil"], ["/abs/evil"]])
def test_safe_extract_rar_equals_jax(tmp_path, names):
    ours, theirs = _Rar(names), _Rar(names)
    results = []
    for fn, rar in ((pu.safe_extract_rar, ours), (ju.safe_extract_rar, theirs)):
        try:
            fn(rar, tmp_path)
            results.append(("ok", rar.extracted))
        except Exception as e:  # noqa: BLE001 - the test compares what each raises
            results.append((type(e).__name__, str(e)))
    assert results[0] == results[1]


def test_serialization_grouper_and_path_extension_error_equal_jax():
    for n, items in ((2, range(5)), (3, range(6)), (4, [])):
        assert list(pser.grouper(n, items)) == list(jser.grouper(n, items))
    assert issubclass(pser.InvalidPathExtension, ValueError)
    assert pser.InvalidPathExtension.__mro__[1:] == (ValueError, Exception, BaseException, object)


# -- audio names --------------------------------------------------------------------------------


def test_audio_errors_switches_and_availability_equal_jax(monkeypatch):
    assert issubclass(paudio_utils.AudioSavingError, Exception)
    for value in (None, "0", "1"):
        if value is None:
            monkeypatch.delenv("LHOTSE_AUDIO_LOADING_EXCEPTION_VERBOSE", raising=False)
        else:
            monkeypatch.setenv("LHOTSE_AUDIO_LOADING_EXCEPTION_VERBOSE", value)
        assert (paudio_utils.verbose_audio_loading_exceptions()
                == jaudio_utils.verbose_audio_loading_exceptions())
    monkeypatch.setattr(pbackend, "_FFMPEG_TORCHAUDIO_INFO_ENABLED", False)
    monkeypatch.setattr(jbackend, "_FFMPEG_TORCHAUDIO_INFO_ENABLED", False)
    for flag in (True, False, True):
        P.set_ffmpeg_torchaudio_info_enabled(flag)
        J.set_ffmpeg_torchaudio_info_enabled(flag)
        assert P.get_ffmpeg_torchaudio_info_enabled() is J.get_ffmpeg_torchaudio_info_enabled()
        assert P.audio.get_ffmpeg_torchaudio_info_enabled() is flag
    assert pflacio.is_available() is jflacio.is_available() is True
    monkeypatch.setattr(pflacio, "_get_lib", lambda: (_ for _ in ()).throw(OSError("no cc")))
    assert pflacio.is_available() is False
    for value in (None, "1", "0"):
        if value is None:
            monkeypatch.delenv("LHOTSE_TPU_NO_NATIVE", raising=False)
        else:
            monkeypatch.setenv("LHOTSE_TPU_NO_NATIVE", value)
        assert pnative.native_disabled() is jnative.native_disabled()


@pytest.mark.parametrize("rates", [(16000, 8000), (8000, 22050), (44100, 16000)])
def test_functional_resample_equals_jax(rates):
    x = np.random.default_rng(rates[0] + rates[1]).standard_normal((2, 4000)).astype(np.float32)
    ours, theirs = presample.resample(x, *rates), jresample.resample(x, *rates)
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    assert np.array_equal(presample.resample(x, *rates, lowpass_filter_width=4, rolloff=0.9),
                          jresample.resample(x, *rates, lowpass_filter_width=4, rolloff=0.9))
    with pytest.raises(ValueError, match="sinc_interp_hann"):
        presample.resample(x, *rates, resampling_method="sinc_interp_kaiser")


# -- data names ---------------------------------------------------------------------------------


def test_read_features_from_cuts_equals_jax():
    np.random.seed(4)
    ours = [PD.dummy_cut(i, with_data=True) for i in range(3)]
    np.random.seed(4)
    theirs = [JD.dummy_cut(i, with_data=True) for i in range(3)]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        for executor in (None, pool):
            got = pcollation.read_features_from_cuts(ours, executor=executor)
            want = jcollation.read_features_from_cuts(theirs, executor=executor)
            assert len(got) == 3 and all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("as_queue", [False, True])
def test_pick_at_random_equals_jax(as_queue):
    import queue

    def bucket():
        if not as_queue:
            return list("abcdefg")
        q = queue.Queue()
        for item in "abcdefg":
            q.put(item)
        return q

    ours_used, theirs_used = [], []
    ours = list(pdb.pick_at_random(bucket(), random.Random(3), ours_used))
    theirs = list(jdb.pick_at_random(bucket(), random.Random(3), theirs_used))
    assert ours == theirs and ours_used == theirs_used and sorted(ours) == list("abcdefg")


def test_feature_set_split_lazy_equals_jax(tmp_path):
    feats = [JD.dummy_features(i) for i in range(7)]
    theirs = J.FeatureSet.from_features(feats)
    ours = FeatureSet.from_dicts([f.to_dict() for f in feats])
    osplit = ours.split_lazy(tmp_path / "port", chunk_size=3, prefix="f")
    jsplit = theirs.split_lazy(tmp_path / "jax", chunk_size=3, prefix="f")
    assert [len(s) for s in osplit] == [len(s) for s in jsplit] == [3, 3, 1]
    assert ([[f.to_dict() for f in s] for s in osplit]
            == [[f.to_dict() for f in s] for s in jsplit])
    assert (sorted(p.name for p in (tmp_path / "port").iterdir())
            == sorted(p.name for p in (tmp_path / "jax").iterdir()))


def test_cut_unmix_equals_jax():
    ours, theirs = PD.dummy_cut(0), JD.dummy_cut(0)
    assert ours.unmix() == [ours] and ours.unmix(tag="x") == [ours]
    assert [c.to_dict() for c in ours.unmix()] == [c.to_dict() for c in theirs.unmix()]


@pytest.mark.parametrize("name", ["Fbank", "Mfcc", "Spectrogram", "LogSpectrogram"])
def test_extractor_to_sets_config_device(name):
    """``.to(device)`` sets ``config.device`` as in JAX; the port's
    extraction then runs there (the card by default)."""
    extractor = getattr(pext, name)()
    assert extractor.config.device == "cuda" and extractor.device == torch.device("cuda")
    assert extractor.to("cpu") is None
    assert extractor.config.device == "cpu" and extractor.device == torch.device("cpu")
    x = np.random.default_rng(1).standard_normal(1600).astype(np.float32) * 0.1
    feats = extractor.extract(x, 16000)
    assert feats.shape[1] == extractor.feature_dim(16000) and np.isfinite(feats).all()


# -- testing helpers ----------------------------------------------------------------------------


@pytest.mark.seed(1337)
def test_deterministic_rng_seeds_as_jax(deterministic_rng):
    assert deterministic_rng == 1337
    ours = (np.random.rand(), random.random())
    np.random.seed(1337)
    random.seed(1337)
    assert ours == (np.random.rand(), random.random())


def test_random_cut_set_equals_jax():
    pu.fix_random_seed(2)
    ours = pfixtures.random_cut_set(n_cuts=5)
    ju.fix_random_seed(2)
    theirs = jfixtures.random_cut_set(n_cuts=5)
    assert [c.to_dict() for c in ours] == [c.to_dict() for c in theirs]
    assert isinstance(ours, CutSet)


def test_with_dill_enabled_fixture_sets_the_switch(monkeypatch):
    monkeypatch.delenv("LHOTSE_DILL_ENABLED", raising=False)
    for fixture in (pfixtures.with_dill_enabled, jfixtures.with_dill_enabled):
        fixture.__wrapped__()
    assert __import__("os").environ["LHOTSE_DILL_ENABLED"] == "1"
    assert P.is_dill_enabled()


class _PortCase(pfixtures.RandomCutTestCase):
    device = "cpu"


def test_random_cut_test_case_equals_jax():
    """``with_cut`` with features, a supervision with an alignment and a
    custom array, in both packages after one seed: the same manifests (but
    the temporary paths) and audio; the features within the CPU routes'
    float32 distance (5e-4, on uniform noise)."""
    ours, theirs = _PortCase(), jfixtures.RandomCutTestCase()
    ours.setup_method(None)
    theirs.setup_method(None)
    try:
        pu.fix_random_seed(9)
        np.random.seed(9)
        ocut = ours.with_cut(16000, 8000, supervision=True, alignment=True, custom_field=True)
        ju.fix_random_seed(9)
        np.random.seed(9)
        jcut = theirs.with_cut(16000, 8000, supervision=True, alignment=True, custom_field=True)
        assert np.array_equal(ocut.load_audio(), jcut.load_audio())
        assert np.array_equal(ocut.load_codebook_indices(), jcut.load_codebook_indices())
        assert ocut.supervisions[0].alignment.keys() == jcut.supervisions[0].alignment.keys()
        assert ([a.to_dict() if hasattr(a, "to_dict") else tuple(a)
                 for a in ocut.supervisions[0].alignment["subword"]]
                == [tuple(a) for a in jcut.supervisions[0].alignment["subword"]])
        assert ocut.features.storage_type == jcut.features.storage_type
        assert np.abs(ocut.load_features() - jcut.load_features()).max() <= 5e-4
        assert ocut.id == jcut.id and ocut.recording.id == jcut.recording.id
    finally:
        ours.teardown_method(None)
        theirs.teardown_method(None)


# -- tools, mesh and WPE --------------------------------------------------------------------------


def test_tools_env_under_a_patched_home(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("PATH", "/usr/bin")
    assert penv.default_tools_cachedir() == tmp_path / ".lhotse_tpu_torch" / "tools"
    assert jenv.default_tools_cachedir() == tmp_path / ".lhotse_tpu" / "tools"
    assert (tmp_path / ".lhotse_tpu_torch" / "tools").is_dir()
    assert P.default_tools_cachedir() == penv.default_tools_cachedir()
    import sys

    monkeypatch.setattr(sys, "path", list(sys.path))
    penv.add_tools_to_path()
    ours_path = __import__("os").environ["PATH"]
    monkeypatch.setenv("PATH", "/usr/bin")
    jenv.add_tools_to_path()
    theirs_path = __import__("os").environ["PATH"]
    assert ours_path == f"/usr/bin:{tmp_path}/.lhotse_tpu_torch/tools/sph2pipe-2.5"
    assert theirs_path == f"/usr/bin:{tmp_path}/.lhotse_tpu/tools/sph2pipe-2.5"
    assert sys.path[-2:] == [f"{tmp_path}/.lhotse_tpu_torch/tools/sph2pipe-2.5",
                             f"{tmp_path}/.lhotse_tpu/tools/sph2pipe-2.5"]
    # A directory that cannot be made is a warning, or an error when forced.
    (tmp_path / "file").write_text("")
    monkeypatch.setenv("HOME", str(tmp_path / "file"))
    assert penv.default_tools_cachedir() == tmp_path / "file" / ".lhotse_tpu_torch" / "tools"
    with pytest.raises(OSError):
        penv.default_tools_cachedir(force_mkdir=True)


def test_data_parallel_mesh_on_the_cpu_feeds_local_rows():
    from lhotse_tpu_torch.parallel import data_parallel_mesh, local_rows

    assert not torch.distributed.is_initialized()
    try:
        mesh = data_parallel_mesh(1, device="cpu")
        assert mesh.mesh_dim_names == ("data",) and mesh.device_type == "cpu"
        assert mesh.size() == 1 and torch.distributed.get_world_size() == 1
        batch = torch.arange(12.0).reshape(4, 3)
        rows = local_rows(batch, mesh)
        assert torch.equal(rows.to_local(), batch) and torch.equal(rows.full_tensor(), batch)
        assert data_parallel_mesh(device="cpu").mesh_dim_names == ("data",)
        with pytest.raises(ValueError, match="does not fit"):
            data_parallel_mesh(2, device="cpu")
    finally:
        torch.distributed.destroy_process_group()
    with pytest.raises(ValueError, match="needs 2 processes"):
        data_parallel_mesh(2, device="cpu")
    if not torch.cuda.is_available():  # the card by default: no silent fallback
        with pytest.raises(RuntimeError, match="needs CUDA"):
            data_parallel_mesh(1)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dereverb_wpe_torch_on_the_cpu_equals_jax(dtype):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 4000)) * 0.1
    x[:, 100:] += 0.5 * x[:, :-100]
    audio = torch.from_numpy(x).to(dtype)
    ours = pwpe.dereverb_wpe_torch(audio, taps=4, iterations=2)
    theirs = jwpe.dereverb_wpe_torch(audio, taps=4, iterations=2)
    assert ours.device == audio.device and ours.dtype == dtype and ours.shape == audio.shape
    assert torch.equal(ours, theirs.to(dtype))
    assert torch.equal(ours, torch.from_numpy(pwpe.dereverb_wpe_numpy(
        audio.numpy(), taps=4, iterations=2)))
