"""
The precomputed-features slice of the port at a small size, against the JAX
package: FLAC cuts → ``compute_and_store_features`` (single-process, fanned
out over two spawned processes) and ``compute_and_store_features_batch``
into ``lilcom_chunky`` archives → ``K2SpeechRecognitionDataset()`` with its
default ``PrecomputedFeatures`` → an AdamW step of a small encoder; and
``OnTheFlyFeatures`` over the same cuts.

Features the two packages compute separately are compared in LTC1 ticks
(2^-5): two float32 routes that differ by ~1e-5 can land on adjacent ticks,
so all but a small measured share are identical and the rest one tick apart.
Features decoded from the same bytes are compared bit for bit.
"""
import numpy as np
import pytest
import torch

import lhotse_tpu as J
from lhotse_tpu.dataset.input_strategies import OnTheFlyFeatures as JOnTheFly
from lhotse_tpu.dataset.speech_recognition import K2SpeechRecognitionDataset as JDataset
from lhotse_tpu.features.kaldi.extractors import Fbank as JFbank
from lhotse_tpu.features.kaldi.extractors import FbankConfig as JFbankConfig
from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.audio.flacio import write_flac
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures, PrecomputedFeatures
from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
from lhotse_tpu_torch.features import Fbank, FbankConfig
from lhotse_tpu_torch.supervision import SupervisionSegment

SR = 16000
TICK = 2.0**-5
# Share of feature values one tick apart between the packages' separately
# computed archives (the rest are identical); measured 1.4e-5 (1 of 69,920
# values) between the port and JAX, 0 between the port's batch and
# single-process archives.
TICK_SHARE = 1e-3
# The extractor's bound against the JAX device route (tests/test_torch_extractors.py).
EXTRACTOR_TOL = 3e-4


@pytest.fixture(scope="module")
def cuts(tmp_path_factory):
    """Six FLAC tone bursts of 0.6-2.4 s (bench.py::_synthesize_corpus's
    signal: four harmonics of an 80-220 Hz f0 over 0.01 noise), one
    supervision each, written by the port."""
    root = tmp_path_factory.mktemp("precomputed_corpus")
    rng = np.random.RandomState(1234)
    out = []
    for i in range(6):
        n = int(SR * rng.uniform(0.6, 2.4))
        t = np.arange(n) / SR
        f0 = rng.uniform(80, 220)
        wave = sum(np.sin(2 * np.pi * f0 * (h + 1) * t) / (h + 1) for h in range(4)) * 0.2
        path = root / f"u{i}.flac"
        write_flac(str(path), (wave + rng.randn(n) * 0.01).astype(np.float32), SR)
        cut = Recording.from_file(path).to_cut()
        cut.supervisions.append(SupervisionSegment(
            id=f"s{i}", recording_id=cut.recording_id, start=0.0, duration=cut.duration,
            text=f"text {i}"))
        out.append(cut)
    CutSet.from_cuts(out).to_file(root / "cuts.jsonl")
    return root / "cuts.jsonl"


def _extractor():
    return Fbank(FbankConfig(device="cpu"))


def _jax_extractor():
    return JFbank(JFbankConfig(device="tpu"))  # the device route, in XLA on the CPU


def _by_id(cutset):
    return {c.id: c for c in cutset}


def _assert_ticks(ours: np.ndarray, theirs: np.ndarray) -> None:
    diff = np.abs(ours - theirs)
    assert diff.max() <= TICK, diff.max()
    assert np.count_nonzero(diff) <= TICK_SHARE * diff.size, np.count_nonzero(diff) / diff.size


@pytest.fixture(scope="module")
def stored(cuts, tmp_path_factory):
    """The corpus extracted and stored by both packages (single process)."""
    root = tmp_path_factory.mktemp("stored")
    ours = CutSet.from_file(cuts).compute_and_store_features(_extractor(), root / "ours")
    ours.to_file(root / "ours.jsonl")
    theirs = J.CutSet.from_file(cuts).compute_and_store_features(
        _jax_extractor(), root / "jax", progress_bar=False)
    theirs.to_file(root / "jax.jsonl")
    return root


def test_single_process_extraction_equals_jax_in_ticks(stored):
    ours = _by_id(CutSet.from_file(stored / "ours.jsonl"))
    theirs = _by_id(J.CutSet.from_file(stored / "jax.jsonl"))
    assert sorted(ours) == sorted(theirs)
    for cid, cut in ours.items():
        jcut = theirs[cid]
        assert cut.features.storage_type == jcut.features.storage_type == "lilcom_chunky"
        assert cut.features.num_frames == jcut.features.num_frames
        assert {k: v for k, v in cut.features.to_dict().items() if not k.startswith("storage")} == {
            k: v for k, v in jcut.features.to_dict().items() if not k.startswith("storage")}
        _assert_ticks(cut.load_features(), jcut.load_features())


def test_fanout_over_spawned_processes_equals_single_process(cuts, stored, tmp_path):
    fanned = CutSet.from_file(cuts).compute_and_store_features(
        _extractor(), tmp_path / "fan", num_jobs=2)
    single = _by_id(CutSet.from_file(stored / "ours.jsonl"))
    fanned = list(fanned)
    assert sorted(c.id for c in fanned) == sorted(single)
    assert {c.features.storage_path for c in fanned} == {
        str(tmp_path / "fan" / "feats-0.lca"), str(tmp_path / "fan" / "feats-1.lca")}
    for cut in fanned:
        assert np.array_equal(cut.load_features(), single[cut.id].load_features())


def test_batch_extraction_equals_jax_and_resumes(cuts, stored, tmp_path):
    ours = CutSet.from_file(cuts).compute_and_store_features_batch(
        _extractor(), tmp_path / "batch", manifest_path=tmp_path / "batch.jsonl",
        batch_duration=3.0, num_workers=2)
    theirs = J.CutSet.from_file(cuts).compute_and_store_features_batch(
        _jax_extractor(), tmp_path / "jbatch", manifest_path=tmp_path / "jbatch.jsonl",
        batch_duration=3.0, num_workers=2)
    ours, theirs = _by_id(ours), _by_id(theirs)
    single = _by_id(CutSet.from_file(stored / "ours.jsonl"))
    assert sorted(ours) == sorted(theirs) == sorted(single)
    for cid, cut in ours.items():
        assert cut.features.num_frames == theirs[cid].features.num_frames
        _assert_ticks(cut.load_features(), theirs[cid].load_features())
        _assert_ticks(cut.load_features(), single[cid].load_features())
    # A second run over the same manifest skips every cut already written.
    size = (tmp_path / "batch.lca").stat().st_size
    again = CutSet.from_file(cuts).compute_and_store_features_batch(
        _extractor(), tmp_path / "batch", manifest_path=tmp_path / "batch.jsonl",
        batch_duration=3.0)
    assert (tmp_path / "batch.lca").stat().st_size == size
    assert sorted(c.id for c in again) == sorted(ours)


def _batches(path, cls):
    cutset = list(cls.from_file(path))
    return [cls.from_cuts(cutset[i : i + 3]) for i in range(0, len(cutset), 3)]


@pytest.mark.parametrize("archive", ["ours", "jax"])
def test_dataset_batches_equal_jax_on_one_archive(stored, archive):
    ours = K2SpeechRecognitionDataset()
    theirs = JDataset()
    assert isinstance(ours.input_strategy, PrecomputedFeatures)
    for a, b in zip(_batches(stored / f"{archive}.jsonl", CutSet),
                    _batches(stored / f"{archive}.jsonl", J.CutSet)):
        got, want = ours[a], theirs[b]
        assert got["inputs"].dtype == np.float32
        assert np.array_equal(got["inputs"], want["inputs"])
        assert got["supervisions"].keys() == want["supervisions"].keys()
        for k, v in got["supervisions"].items():
            if isinstance(v, np.ndarray):
                assert np.array_equal(v, want["supervisions"][k]), k
            else:
                assert v == want["supervisions"][k], k


def test_on_the_fly_features_equal_jax_device_route(cuts, stored):
    ours = K2SpeechRecognitionDataset(input_strategy=OnTheFlyFeatures(_extractor()))
    theirs = JDataset(input_strategy=JOnTheFly(_jax_extractor()))
    stored_ds = K2SpeechRecognitionDataset()
    for a, b, s in zip(_batches(cuts, CutSet), _batches(cuts, J.CutSet),
                       _batches(stored / "ours.jsonl", CutSet)):
        got, want, pre = ours[a], theirs[b], stored_ds[s]
        assert got["inputs"].shape == want["inputs"].shape == pre["inputs"].shape
        np.testing.assert_allclose(got["inputs"], want["inputs"], rtol=0, atol=EXTRACTOR_TOL)
        # On the fly against the same cuts' stored features: half a tick.
        assert np.abs(got["inputs"] - pre["inputs"]).max() <= TICK / 2 + 1e-6
        for k in ("sequence_idx", "start_frame", "num_frames"):
            assert np.array_equal(got["supervisions"][k], want["supervisions"][k])


def test_adamw_step_on_precomputed_batch_matches_optax(stored):
    import jax

    from lhotse_tpu.models import encoder as JE
    from lhotse_tpu_torch.models import encoder as PE
    from test_torch_encoder import (
        ADAMW_NEAR_EPS_LR, ADAMW_WELL_ATOL, ADAMW_WELL_RTOL, LOSS_RTOL, _configs, _port, _t,
        _update_errs)

    batch = _batches(stored / "ours.jsonl", CutSet)[0]
    feats, lens = PrecomputedFeatures()(batch)
    jfeats, jlens = J.dataset.input_strategies.PrecomputedFeatures()(
        _batches(stored / "ours.jsonl", J.CutSet)[0])
    assert np.array_equal(feats, jfeats) and np.array_equal(lens, jlens)
    jcfg, _ = _configs(torch.float32)
    params = JE.init_params(jax.random.PRNGKey(0), jcfg)
    j_init, j_step = JE.make_adamw_train_step(jcfg, lr=1e-3)
    p_init, p_step = PE.make_adamw_train_step(lr=1e-3)
    enc = _port(params, torch.float32)
    start, state, opt = params, j_init(params), p_init(enc)
    key = jax.random.PRNGKey(5)
    mask = _t(jax.random.bernoulli(key, jcfg.mask_prob, feats.shape[:2]))
    params, state, want = j_step(params, state, feats, lens, key)
    got = p_step(enc, opt, _t(feats), _t(lens).long(), mask)
    first_grads = {n: p.grad.abs().numpy().copy() for n, p in enc.named_parameters()}
    assert abs(float(got) - float(want)) <= LOSS_RTOL[torch.float32] * float(want)
    well_abs, well_rel, near_abs = _update_errs(start, params, enc, first_grads)
    assert well_abs <= ADAMW_WELL_ATOL and well_rel <= ADAMW_WELL_RTOL, (well_abs, well_rel)
    assert near_abs <= ADAMW_NEAR_EPS_LR * 1e-3
