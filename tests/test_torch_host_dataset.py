"""
The port's K2SpeechRecognitionDataset with AudioSamples
(lhotse_tpu_torch.dataset) against the JAX package's on the same batches
of FLAC and WAV cuts: ``np.array_equal`` inputs, equal supervisions, the
same cuts with ``return_cuts=True``, and the same ``batch_cut_info``.
"""
import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.audio.flacio import write_flac
from lhotse_tpu.audio.wavio import write_wav
from lhotse_tpu.dataset.device_cache import batch_cut_info as jbatch_cut_info
from lhotse_tpu.dataset.input_strategies import AudioSamples as JAudioSamples
from lhotse_tpu.dataset.speech_recognition import K2SpeechRecognitionDataset as JDataset
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.device_cache import batch_cut_info
from lhotse_tpu_torch.dataset.input_strategies import AudioSamples
from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset

SR = 16000


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """10 cuts, FLAC and WAV alternating; cuts 2 and 6 carry two
    supervisions each."""
    root = tmp_path_factory.mktemp("dataset")
    rng = np.random.default_rng(21)
    cuts = []
    for i in range(10):
        n = int(SR * rng.uniform(0.3, 1.6))
        x = (0.2 * rng.standard_normal(n)).astype(np.float32)
        path = root / f"u{i}.{'flac' if i % 2 else 'wav'}"
        (write_flac if i % 2 else write_wav)(str(path), x, SR)
        cut = J.Recording.from_file(path).to_cut()
        if i in (2, 6):
            half = round(cut.duration / 2, 3)
            spans = [(0.0, half), (half, round(cut.duration - half, 3))]
        else:
            spans = [(0.0, cut.duration)]
        for k, (start, dur) in enumerate(spans):
            cut.supervisions.append(J.SupervisionSegment(
                id=f"s{i}_{k}", recording_id=cut.recording_id, start=start, duration=dur,
                text=f"text {i} {k}"))
        cuts.append(cut)
    path = root / "cuts.jsonl"
    J.CutSet.from_cuts(cuts).to_file(path)
    return path


SPLITS = [slice(0, 3), slice(3, 7), slice(7, 10), slice(0, 10)]


def _batches(manifest):
    ours = CutSet.from_file(manifest).to_eager()
    theirs = J.CutSet.from_file(manifest).to_eager()
    for s in SPLITS:
        yield CutSet.from_cuts(list(ours)[s]), J.CutSet.from_cuts(list(theirs)[s])


@pytest.mark.parametrize("return_cuts", [False, True])
def test_batches_equal_jax(manifest, return_cuts):
    ours_ds = K2SpeechRecognitionDataset(return_cuts=return_cuts, input_strategy=AudioSamples())
    jax_ds = JDataset(return_cuts=return_cuts, input_strategy=JAudioSamples())
    for ours_cuts, jax_cuts in _batches(manifest):
        ours, theirs = ours_ds[ours_cuts], jax_ds[jax_cuts]
        assert ours["inputs"].dtype == theirs["inputs"].dtype == np.float32
        assert np.array_equal(ours["inputs"], theirs["inputs"])
        a, b = ours["supervisions"], theirs["supervisions"]
        assert set(a) == set(b)
        for key in a:
            if key == "cut":
                assert [c.to_dict() for c in a[key]] == [c.to_dict() for c in b[key]]
            elif key == "text":
                assert a[key] == b[key]
            else:
                assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key
        if return_cuts:
            ids, lens = batch_cut_info(ours)
            jids, jlens = jbatch_cut_info(theirs)
            assert ids == jids and np.array_equal(lens, jlens) and lens.dtype == jlens.dtype
            assert len(ids) == ours["inputs"].shape[0]


def test_inputs_are_sorted_padded_audio(manifest):
    cuts = CutSet.from_file(manifest).to_eager()
    batch = K2SpeechRecognitionDataset(return_cuts=True, input_strategy=AudioSamples())[cuts]
    ids, lens = batch_cut_info(batch)
    by_id = {c.id: c for c in cuts}
    assert list(lens) == sorted(lens, reverse=True)
    for row, (cut_id, n) in enumerate(zip(ids, lens)):
        assert np.array_equal(batch["inputs"][row, :n], by_id[cut_id].load_audio()[0])
        assert not batch["inputs"][row, n:].any()


def test_default_input_strategy_is_not_ported():
    """The default input strategy is ported now: PrecomputedFeatures, as in JAX."""
    from lhotse_tpu.dataset.input_strategies import PrecomputedFeatures as JPrecomputed
    from lhotse_tpu_torch.dataset.input_strategies import PrecomputedFeatures

    assert isinstance(JDataset().input_strategy, JPrecomputed)
    assert type(K2SpeechRecognitionDataset().input_strategy) is PrecomputedFeatures
