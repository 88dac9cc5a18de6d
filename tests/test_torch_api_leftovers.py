"""
The smaller public names the port gained with the multiplexers, against the
JAX package: ``Cut.has_overlapping_supervisions`` and ``Cut.split``,
``CutSet.load_audio`` and ``CutSet.sample``, ``with_custom``/``drop_custom``,
``utils.streaming_shuffle``, the tracing hooks (``traced``, the metrics
hooks, ``format_tracing_report``), the resampling backend switch,
``maybe_sample_int``/``maybe_sample_float`` and the checkpoint backends'
builders. Everything here is exact: manifests as dicts, audio with
``np.array_equal``, orders under the same seed.
"""
import importlib
import random

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu import tracing as jtracing
from lhotse_tpu.dataset.cut_transforms import extra_padding as jpad
from lhotse_tpu.dataset.sampling import checkpoint_backends as jcb
from lhotse_tpu.dataset.sampling.dynamic import DynamicCutSampler as JDynamicCutSampler
from lhotse_tpu.utils import fix_random_seed as jfix
from lhotse_tpu.utils import streaming_shuffle as jstreaming_shuffle
from lhotse_tpu_torch import CutSet, Recording, SupervisionSegment, streaming_shuffle
from lhotse_tpu_torch import tracing
from lhotse_tpu_torch.audio.flacio import write_flac
from lhotse_tpu_torch.augmentation import Resample
from lhotse_tpu_torch.dataset import DynamicCutSampler
from lhotse_tpu_torch.dataset.cut_transforms import extra_padding as ppad
from lhotse_tpu_torch.dataset.sampling import checkpoint_backends as pcb
from lhotse_tpu_torch.indexing import create_jsonl_index
from lhotse_tpu_torch.utils import fix_random_seed

# The packages export a function named ``resampling_backend`` from ``audio``,
# which hides the submodule of that name as an attribute.
jrb = importlib.import_module("lhotse_tpu.audio.resampling_backend")
prb = importlib.import_module("lhotse_tpu_torch.audio.resampling_backend")

SR = 16000


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four seeded FLAC recordings of 1-2 s, each cut with two
    supervisions; in the odd ones they overlap."""
    root = tmp_path_factory.mktemp("leftovers")
    rng = np.random.RandomState(44)
    cuts = []
    for i in range(4):
        n = int(SR * rng.uniform(1.0, 2.0))
        path = root / f"r{i}.flac"
        write_flac(str(path), (rng.randn(n) * 0.1).astype(np.float32), SR)
        cut = Recording.from_file(path).to_cut()
        second = 0.3 if i % 2 else 0.6
        cut.supervisions = [
            SupervisionSegment(id=f"s{i}a", recording_id=cut.recording_id, start=0.0,
                               duration=0.5, speaker="A"),
            SupervisionSegment(id=f"s{i}b", recording_id=cut.recording_id, start=second,
                               duration=0.3, speaker="B")]
        cuts.append(cut)
    CutSet.from_cuts(cuts).to_file(root / "cuts.jsonl")
    create_jsonl_index(root / "cuts.jsonl")
    return root / "cuts.jsonl"


def _both(corpus):
    return CutSet.from_file(corpus).to_eager(), J.CutSet.from_file(corpus).to_eager()


def test_has_overlapping_supervisions_equals_jax(corpus):
    ours, theirs = _both(corpus)
    got = [c.has_overlapping_supervisions for c in ours]
    assert got == [c.has_overlapping_supervisions for c in theirs] == [False, True, False, True]
    lone = ours[0].truncate(duration=0.4)
    assert not lone.has_overlapping_supervisions


@pytest.mark.parametrize("at", [0.25, 0.55, 0.9])
def test_cut_split_equals_jax(corpus, at):
    ours, theirs = _both(corpus)
    for k, (c, jc) in enumerate(zip(ours, theirs)):
        # Truncated cuts with supervisions take uuid4 ids: seed each package.
        fix_random_seed(k)
        left, right = c.split(at)
        jfix(k)
        jleft, jright = jc.split(at)
        assert left.to_dict() == jleft.to_dict() and right.to_dict() == jright.to_dict()
        assert np.array_equal(right.load_audio(), jright.load_audio())
        assert left.duration + right.duration == pytest.approx(c.duration)
    with pytest.raises(AssertionError):
        ours[0].split(0.0)


def test_cutset_load_audio_equals_jax(corpus):
    ours, theirs = _both(corpus)
    for a, b in zip(ours.load_audio(), theirs.load_audio()):
        assert np.array_equal(a, b)
    audio, lens = ours.load_audio(collate=True)
    jaudio, jlens = theirs.load_audio(collate=True)
    assert np.array_equal(audio, jaudio) and np.array_equal(lens, jlens)
    with pytest.raises(AssertionError):
        CutSet.from_jsonl_lazy(corpus).load_audio()
    with pytest.raises(AssertionError):
        ours.load_audio(limit=4)


@pytest.mark.parametrize("n_cuts", [1, 2, 4, 9])
def test_cutset_sample_equals_jax(corpus, n_cuts):
    ours, theirs = _both(corpus)
    random.seed(n_cuts)
    got = ours.sample(n_cuts)
    random.seed(n_cuts)
    want = theirs.sample(n_cuts)
    if n_cuts == 1:
        assert got.id == want.id
    else:
        assert isinstance(got, CutSet) and [c.id for c in got] == [c.id for c in want]


def test_with_custom_and_drop_custom_equal_jax(corpus):
    ours, theirs = _both(corpus)
    c, jc = ours[0], theirs[0]
    tagged, jtagged = c.with_custom("lang", "en"), jc.with_custom("lang", "en")
    assert tagged.to_dict() == jtagged.to_dict() and tagged.lang == "en"
    assert c.custom is None  # a copy: the source is untouched
    sup, jsup = c.supervisions[0].with_custom("x", 1), jc.supervisions[0].with_custom("x", 1)
    assert sup.to_dict() == jsup.to_dict()
    assert tagged.drop_custom("lang") is tagged and not tagged.has_custom("lang")
    assert jtagged.drop_custom("lang") is jtagged
    assert tagged.to_dict() == jtagged.to_dict()
    assert tagged.drop_custom("lang") is None and jtagged.drop_custom("lang") is None


@pytest.mark.parametrize("bufsize", [1, 3, 10, 100])
@pytest.mark.parametrize("n", [0, 7, 50])
def test_streaming_shuffle_equals_jax(bufsize, n):
    got = list(streaming_shuffle(range(n), bufsize=bufsize, rng=random.Random(bufsize)))
    want = list(jstreaming_shuffle(range(n), bufsize=bufsize, rng=random.Random(bufsize)))
    assert got == want and sorted(got) == list(range(n))


def test_tracing_hooks_equal_jax(monkeypatch):
    reports = {}
    for name, mod in (("port", tracing), ("jax", jtracing)):
        monkeypatch.setattr(mod, "_ENABLED", True)
        monkeypatch.setattr(mod, "_METRICS_HOOKS", [])
        mod.reset_tracing()

        @mod.traced("leftovers.span")
        def work(x):
            return 2 * x

        @mod.traced()
        def unnamed():
            return None

        assert work(3) == 6 and work.__name__ == "work"
        unnamed()
        got = []

        def broken(payload):
            raise RuntimeError("an exporter must not take the pipeline down")

        mod.register_metrics_hook(got.append)
        mod.register_metrics_hook(broken)
        mod.emit_metrics({"step": 1})
        mod.unregister_metrics_hook(broken)
        mod.unregister_metrics_hook(broken)  # twice: a no-op
        mod.emit_metrics(reset=True)
        mod.emit_metrics()
        reports[name] = (
            [{k: (v["calls"], v["work"]) if isinstance(v, dict) and "calls" in v else v
              for k, v in p.items()} for p in got],
            mod.format_tracing_report({}).splitlines(),
            mod.format_tracing_report({"a": {"calls": 2, "total_s": 0.5, "mean_s": 0.25,
                                             "work": 3.0, "throughput": 6.0}}))
        mod.reset_tracing()
    # Span times aside, the payloads and the formatted reports are JAX's.
    assert reports["port"] == reports["jax"]
    payloads = reports["port"][0]
    assert len(payloads) == 3 and payloads[0]["leftovers.span"] == (1, 0.0)
    assert payloads[0]["extra"] == {"step": 1} and payloads[2] == {}


def test_resampling_backend_switch(monkeypatch):
    monkeypatch.setattr(prb, "CURRENT_RESAMPLING_BACKEND", None)
    monkeypatch.setattr(jrb, "CURRENT_RESAMPLING_BACKEND", None)
    monkeypatch.delenv("LHOTSE_TPU_RESAMPLING_BACKEND", raising=False)
    monkeypatch.delenv("LHOTSE_RESAMPLING_BACKEND", raising=False)
    assert prb.available_resampling_backends() == ["default"]
    assert prb.get_current_resampling_backend() == jrb.get_current_resampling_backend() == "default"
    with prb.resampling_backend("default"):
        assert prb.get_current_resampling_backend() == "default"
    assert prb.CURRENT_RESAMPLING_BACKEND is None  # the explicit choice it found: none
    prb.set_current_resampling_backend("default")
    assert prb.get_current_resampling_backend() == "default"
    for bad in ("nope", ""):
        with pytest.raises(ValueError, match="Invalid resampling backend"):
            jrb.set_current_resampling_backend(bad)
        with pytest.raises(ValueError, match="Invalid resampling backend"):
            prb.set_current_resampling_backend(bad)
    # The JAX package lists "sox" only where libsox loads (not here), so it
    # refuses the name; the port names it as not ported.
    if "sox" not in jrb.available_resampling_backends():
        with pytest.raises(ValueError):
            jrb.set_current_resampling_backend("sox")
    with pytest.raises(NotImplementedError, match="sox"):
        prb.set_current_resampling_backend("sox")
    with pytest.raises(NotImplementedError, match="sox"):
        with prb.resampling_backend("sox"):
            pass
    assert prb.get_current_resampling_backend() == "default"


def test_resampling_backend_from_the_environment(monkeypatch):
    monkeypatch.setattr(prb, "CURRENT_RESAMPLING_BACKEND", None)
    monkeypatch.setenv("LHOTSE_RESAMPLING_BACKEND", "default")
    assert prb.get_current_resampling_backend() == "default"
    x = np.random.default_rng(0).standard_normal(1600).astype(np.float32)
    assert Resample(16000, 8000)(x).shape == (800,)
    monkeypatch.setenv("LHOTSE_TPU_RESAMPLING_BACKEND", "sox")
    with pytest.raises(NotImplementedError, match="sox"):
        Resample(16000, 8000)(x)
    with prb.resampling_backend("default"):  # an explicit choice wins over the variable
        assert Resample(16000, 8000)(x).shape == (800,)


@pytest.mark.parametrize("value", [0, 1, 7])
def test_maybe_sample_equals_jax(value):
    got, want = [], []
    for out, mod in ((got, ppad), (want, jpad)):
        random.seed(value)
        out += [mod.maybe_sample_int(value, s) for s in (True, False, True)]
        out += [mod.maybe_sample_float(value * 0.5, s) for s in (True, False, True)]
    assert got == want
    assert got[1] == value and got[4] == value * 0.5


@pytest.mark.parametrize("indexed", [True, False])
def test_checkpoint_backend_builders_plan_as_jax(corpus, indexed):
    plans = []
    for cutset_cls, sampler_cls, mod in ((CutSet, DynamicCutSampler, pcb),
                                         (J.CutSet, JDynamicCutSampler, jcb)):
        cuts = cutset_cls.from_file(corpus) if indexed else cutset_cls.from_jsonl_lazy(corpus)
        sampler = sampler_cls(cuts, max_cuts=2)
        plan = mod.build_dynamic_cut_checkpoint_backend(
            sampler, current_epoch=0, num_batches_to_iter=1)
        bucketing = mod.build_dynamic_bucketing_checkpoint_backend(
            sampler, current_epoch=0, num_batches_to_iter=1)
        kinds = (type(plan).__name__, type(bucketing).__name__)
        assert isinstance(plan, (mod.IndexedCheckpointBackend, mod.ReplayCheckpointBackend))
        plans.append(kinds)
    assert plans[0] == plans[1]
    assert plans[0][0] == ("SeekResume" if indexed else "ReplayResume")
