"""
The port on a CUDA card: the fbank kernel against its plain PyTorch version;
the layers, augmenter, adpcm4 decode, sample cache, extractors (and their
features through a chunky archive, and an 8-channel 300 s session),
``OnTheFlyFeatures``, encoder, entry, WPE, and the SURT and diarization
datasets over the zipped samplers and stored features on the card against
the same port on the CPU; a piped Kaldi data dir through the CLI's
``feat extract-cuts-batch`` against the kernel's plain version; windows
of simulated meetings through the SURT dataset on the card; and the
augmenter fed by the MUSAN, RIRS_NOISES and AISHELL recipes, by a mux of
the THCHS-30 and KeSpeech recipes and by Switchboard-1 conversations on the
card against the CPU port.

Every test here needs a card and skips without one. The file imports
neither jax nor lhotse_tpu, so on the machine with the card (which has no
JAX) it runs without the test suite's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider
"""
import numpy as np
import pytest
import torch

from lhotse_tpu_torch.dataset.device_augment import CachedBatch, OnDeviceAugmenter
from lhotse_tpu_torch.dataset.device_cache import DeviceSampleCache
from lhotse_tpu_torch.dataset.signal_transforms import SpecAugment
from lhotse_tpu_torch.features.kaldi import extractors
from lhotse_tpu_torch.features.kaldi.layers import Wav2LogFilterBank, Wav2MFCC
from lhotse_tpu_torch.models import encoder as enc
from lhotse_tpu_torch.ops import fbank as ops
from lhotse_tpu_torch.ops import fbank_cuda, wire
from lhotse_tpu_torch.ops.wpe import dereverb_wpe

pytestmark = pytest.mark.cuda

LOGMEL_TOL = 5e-5  # the JAX package's own bound for the fused fbank
FEATURE_TOL = 1e-4  # the feature parity budget (BASELINE.md)
# The encoder's hidden states, as tests/test_torch_encoder.py holds the port to JAX.
ENCODER_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fbank kernel has no CPU build")
    # The plain versions compared against must be IEEE fp32: TF32 keeps ~3
    # decimal digits. Matmuls are fp32 by default; cuDNN convolutions are
    # TF32 by default, and the port's resampler turns that off itself, so
    # both flags are set here only to make the tests independent of defaults.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bank(n_mels):
    mel, _ = ops.get_mel_banks(n_mels, 512, 16000, 20.0, -400.0)
    fb = np.zeros((257, n_mels), np.float32)
    fb[:256] = mel.T
    return fb


def _audio(shape, seed=0):
    return (0.1 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


# Then the edges of the kernel's 128-frame tile and of its 128-filter
# chunks: more filters than one chunk, than the block's 256 threads (their
# bin ranges are found after the DFT), and filters with no bins at all.
@pytest.mark.parametrize("B,T,n_mels", [
    (1, 100, 23), (3, 1001, 80), (16, 1364, 80), (2, 1, 80),
    (2, 127, 80), (2, 128, 80), (2, 129, 80), (1, 1, 80), (2, 300, 128),
    (2, 300, 129), (3, 1001, 200), (2, 129, 256), (1, 130, 300)])
def test_kernel_matches_plain_version(cuda, B, T, n_mels):
    Mc, Ms = ops.dft_analysis_matrices(400, 512)
    x = torch.from_numpy(_audio((B, (T - 1) * 160 + 400), seed=T)).to(cuda)
    before = fbank_cuda.LAUNCHES
    out = fbank_cuda.fbank_logmel(x, Mc, Ms, _bank(n_mels))
    torch.cuda.synchronize()
    assert fbank_cuda.LAUNCHES == before + 1
    ref = fbank_cuda.reference_fbank(
        x, *(torch.from_numpy(np.ascontiguousarray(m)).to(cuda)
             for m in fbank_cuda._squeeze_nyquist(Mc, Ms, _bank(n_mels))))
    assert out.shape == (B, T, n_mels)
    assert (out - ref).abs().max().item() <= LOGMEL_TOL


def test_kernel_reads_a_strided_view(cuda):
    Mc, Ms = ops.dft_analysis_matrices(400, 512)
    big = torch.from_numpy(_audio((4, 30000))).to(cuda)
    view = big[:, 1000:21000]
    assert not view.is_contiguous()
    a = fbank_cuda.fbank_cuda(view, Mc, Ms, _bank(80))
    b = fbank_cuda.fbank_cuda(view.contiguous(), Mc, Ms, _bank(80))
    assert torch.equal(a, b)


def test_kernel_128_bin_route(cuda):
    """128 bins run as a cluster of two blocks; a 40-mel bank up to 3.9 kHz
    lies inside them."""
    Mc, Ms = ops.dft_analysis_matrices(400, 512)
    mel, _ = ops.get_mel_banks(40, 512, 16000, 20.0, 3900.0)
    assert not mel[:, 128:].any()
    mats = [torch.from_numpy(np.ascontiguousarray(m)).to(cuda)
            for m in (Mc[:, :128], Ms[:, :128], mel.T[:128])]
    x = torch.from_numpy(_audio((3, 200 * 160 + 400), seed=7)).to(cuda)
    out = fbank_cuda.fbank_cuda(x, *mats)
    ref = fbank_cuda.reference_fbank(x, *mats)
    assert out.shape == (3, 201, 40)
    assert (out - ref).abs().max().item() <= LOGMEL_TOL


def test_kernel_is_deterministic(cuda):
    """No atomics: two launches on the same input agree bit for bit."""
    Mc, Ms = ops.dft_analysis_matrices(400, 512)
    x = torch.from_numpy(_audio((8, 1363 * 160 + 400), seed=8)).to(cuda)
    a = fbank_cuda.fbank_cuda(x, Mc, Ms, _bank(80))
    b = fbank_cuda.fbank_cuda(x, Mc, Ms, _bank(80))
    assert torch.equal(a, b)


def test_kernel_near_silent_against_float64(cuda):
    """A 1 kHz tone at 0.3 over 1e-3 noise leaves mel bins whose DFT sums
    nearly cancel. Both fp32 routes are held to float64 frames on the card:
    the kernel may be no more than twice as far off as the plain version,
    which catches a lost digit (TF32 is some 1e3 times worse) and not a
    benign change of summation order."""
    B, T = 3, 1001
    N = (T - 1) * 160 + 400
    t = np.arange(N) / 16000.0
    rng = np.random.default_rng(9)
    x_np = (0.3 * np.sin(2 * np.pi * 1000.0 * t) + 1e-3 * rng.standard_normal((B, N)))
    x = torch.from_numpy(x_np.astype(np.float32)).to(cuda)
    Mc, Ms = ops.dft_analysis_matrices(400, 512)
    mats = fbank_cuda._squeeze_nyquist(Mc, Ms, _bank(80))
    f32 = [torch.from_numpy(np.ascontiguousarray(m)).to(cuda) for m in mats]
    f64 = [m.double() for m in f32]
    frames = x.double().unfold(-1, 400, 160)
    power = (frames @ f64[0]) ** 2 + (frames @ f64[1]) ** 2
    truth = torch.log(torch.clamp_min(power @ f64[2], ops.FLT_EPS))
    kernel_err = (fbank_cuda.fbank_cuda(x, *f32).double() - truth).abs().max().item()
    plain_err = (fbank_cuda.reference_fbank(x, *f32).double() - truth).abs().max().item()
    assert kernel_err <= 2 * plain_err, (kernel_err, plain_err)


def test_kernel_reads_unaligned_rows(cuda):
    """Rows that are not 16-byte aligned are staged by the threads, not by
    bulk copies; with an odd row stride the two routes mix in one launch."""
    Mc, Ms = ops.dft_analysis_matrices(400, 512)
    big = torch.from_numpy(_audio((4, 30001), seed=10)).to(cuda)
    view = big[:, 1:20001]
    assert [view[b].data_ptr() % 16 == 0 for b in range(4)] == [False, False, False, True]
    a = fbank_cuda.fbank_cuda(view, Mc, Ms, _bank(80))
    b = fbank_cuda.fbank_cuda(view.contiguous(), Mc, Ms, _bank(80))
    assert torch.equal(a, b)


def test_kernel_wrapper_refuses_what_it_cannot_take(cuda):
    Mc, Ms = ops.dft_analysis_matrices(400, 512)
    x = torch.zeros(2, 16000, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        fbank_cuda.fbank_cuda(x.double(), Mc, Ms, _bank(80))
    with pytest.raises(ValueError, match="unit time stride"):
        fbank_cuda.fbank_cuda(torch.zeros(16000, 2, device=cuda).t(), Mc, Ms, _bank(80))
    with pytest.raises(ValueError, match="mel filters"):
        fbank_cuda.fbank_cuda(x, Mc, Ms, np.zeros((257, 8193), np.float32))
    with pytest.raises(ValueError, match="128 or 256 bins"):
        wide = np.zeros((400, 384), np.float32)
        fbank_cuda.fbank_cuda(x, wide, wide, np.zeros((384, 80), np.float32))
    with pytest.raises(ValueError, match="pack_dft"):
        fbank_cuda.fbank_cuda(x, Mc, Ms, _bank(80), dft=torch.zeros(4, 400, 64, device=cuda))
    with pytest.raises(ValueError, match="Nyquist"):
        bad = _bank(80)
        bad[256, 3] = 1.0
        fbank_cuda.fbank_cuda(x, Mc, Ms, bad)


@pytest.mark.parametrize("layer_cls", [Wav2LogFilterBank, Wav2MFCC])
def test_layer_on_card_matches_cpu(cuda, layer_cls):
    x = _audio((3, 12345), seed=1)
    on_cpu = layer_cls(device="cpu")(torch.from_numpy(x))
    before = fbank_cuda.LAUNCHES
    on_card = layer_cls(device=cuda)(torch.from_numpy(x).to(cuda))
    assert fbank_cuda.LAUNCHES == before + 1
    torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=0, atol=FEATURE_TOL)


def test_augmenter_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(2)
    noise = _audio((4, 40000), seed=3)
    rir = (rng.standard_normal(800) * np.exp(-np.arange(800) / 100.0)).astype(np.float32)
    rir[5] = 1.0
    cfg = dict(buckets=[(1.0, 4), (2.0, 3)], speed_factor=1.1, noise_pool=noise, rir=rir,
               mix_prob=0.5, seed=1, wire_format="int16", specaugment=SpecAugment(seed=4))
    x, lens = _audio((3, 20000), seed=5), [20000, 15000, 4000]
    cpu_feats, cpu_lens = OnDeviceAugmenter(**cfg, device="cpu")(x, lens)
    card = OnDeviceAugmenter(**cfg, device=cuda)
    staged = card.stage(x, lens)
    assert staged.audio.device.type == "cuda"
    assert all(v.device.type == "cuda" for v in staged.kwargs.values())
    feats, feat_lens = card.compute(staged)
    assert torch.equal(feat_lens.cpu(), cpu_lens)
    torch.testing.assert_close(feats.cpu(), cpu_feats, rtol=0, atol=FEATURE_TOL)


def test_adpcm4_decode_bit_exact_on_card(cuda):
    audio = _audio((8, 64 * 500), seed=11) * 3.0  # clips in places
    audio[1] = 0.0
    packed = wire.encode_wire(audio, "adpcm4")
    on_card = wire.decode_wire(torch.from_numpy(packed).to(cuda), "adpcm4")
    assert on_card.device.type == "cuda"
    assert torch.equal(on_card.cpu(), torch.from_numpy(wire.adpcm4_decode_np(packed)))


@pytest.mark.parametrize("wire_format", ["int16", "adpcm4"])
def test_cached_and_wire_features_agree_on_card(cuda, wire_format):
    cfg = dict(buckets=[(1.0, 4)], speed_factor=1.1, noise_pool=_audio((2, 40000), seed=3),
               mix_prob=1.0, seed=2, wire_format=wire_format, device=cuda)
    cache = DeviceSampleCache(capacity_seconds=30)
    cached_aug, plain_aug = OnDeviceAugmenter(sample_cache=cache, **cfg), OnDeviceAugmenter(**cfg)
    x, lens, ids = _audio((3, 16000), seed=6), [16000, 12000, 9000], ["a", "b", "c"]
    for epoch in range(2):
        staged = cached_aug.stage(x, lens, ids=ids)
        assert isinstance(staged, CachedBatch) == (epoch == 1)
        feats, feat_lens = cached_aug.compute(staged)
        ref, ref_lens = plain_aug(x, lens)
        assert torch.equal(feat_lens, ref_lens)
        real = feat_lens > 0
        torch.testing.assert_close(feats[real], ref[real], rtol=0, atol=1e-5)
    assert cache.pool(16000, wire.wire_np_dtype(wire_format)).device.type == "cuda"


@pytest.mark.parametrize("kind", ["Fbank", "Mfcc"])
def test_extractor_on_card_launches_the_kernel(cuda, kind):
    items = [_audio((n,), seed=n) for n in (16000, 12345, 3000)]
    on_cpu = getattr(extractors, kind)(
        getattr(extractors, f"{kind}Config")(device="cpu")).extract_batch(items, 16000)
    ext = getattr(extractors, kind)(getattr(extractors, f"{kind}Config")(device="cuda"))
    before = fbank_cuda.LAUNCHES
    on_card = ext.extract_batch(items, 16000)
    assert fbank_cuda.LAUNCHES == before + 1
    for a, b in zip(on_card, on_cpu):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=FEATURE_TOL)


def test_extractor_wide_mel_bank_on_card(cuda):
    """200 mel filters, which the JAX package's kernel also takes, run on the
    kernel in two 128-filter chunks. (``Mfcc`` shares the kernel; its DCT
    over 200 log-mels near -140 carries float32 rounding past 1e-4.)"""
    cfg = dict(num_filters=200, low_freq=20.0, high_freq=-400.0)
    x = _audio((16000,), seed=12)
    on_cpu = extractors.Fbank(extractors.FbankConfig(device="cpu", **cfg)).extract(x, 16000)
    before = fbank_cuda.LAUNCHES
    on_card = extractors.Fbank(extractors.FbankConfig(device="cuda", **cfg)).extract(x, 16000)
    assert fbank_cuda.LAUNCHES == before + 1
    assert on_card.shape == on_cpu.shape == (100, 200)
    np.testing.assert_allclose(on_card, on_cpu, rtol=0, atol=FEATURE_TOL)


def test_extractor_kernel_failure_raises_on_card(cuda):
    """8193 mel filters meet the kernel route's conditions but exceed what
    the kernel's shared memory indexes: the card raises where the CPU takes
    the plain version."""
    cfg = dict(num_filters=8193, low_freq=20.0, high_freq=-400.0)
    x = _audio((16000,), seed=12)
    assert extractors.Fbank(extractors.FbankConfig(device="cpu", **cfg)).extract(
        x, 16000).shape == (100, 8193)
    with pytest.raises(ValueError, match="mel filters"):
        extractors.Fbank(extractors.FbankConfig(device="cuda", **cfg)).extract(x, 16000)


@pytest.mark.parametrize("kind", ["Fbank", "Mfcc", "Spectrogram", "LogSpectrogram"])
def test_extractor_default_runs_on_the_card(cuda, kind):
    ext = getattr(extractors, kind)()
    assert ext.config.device == "cuda"
    x = _audio((16000,), seed=13)
    before = fbank_cuda.LAUNCHES
    out = ext.extract(x, 16000)
    assert ext.extractor.device.type == "cuda"
    assert fbank_cuda.LAUNCHES == before + (kind in ("Fbank", "Mfcc"))
    ref = getattr(extractors, kind)(getattr(extractors, f"{kind}Config")(device="cpu")).extract(x, 16000)
    assert out.shape == ref.shape and np.isfinite(out).all()
    if kind in ("Fbank", "Mfcc"):
        np.testing.assert_allclose(out, ref, rtol=0, atol=FEATURE_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_on_card_matches_cpu(cuda, dtype):
    cfg = enc.EncoderConfig(num_layers=2, d_model=64, num_heads=4, ffn_dim=128, dtype=dtype)
    feats = torch.from_numpy(np.random.default_rng(14).standard_normal((3, 50, 80), np.float32))
    lens = torch.tensor([50, 30, 7])
    with torch.no_grad():
        on_cpu = enc.Encoder(cfg, device="cpu")(feats, lens)
        on_card = enc.Encoder(cfg, device=cuda)(feats.to(cuda), lens.to(cuda))
    assert on_card.dtype == dtype and on_card.device.type == "cuda"
    assert (on_card.float().cpu() - on_cpu.float()).abs().max().item() <= ENCODER_TOL[dtype]


def test_encoder_training_steps_on_card(cuda):
    """One SGD step and three AdamW steps in float32 on the card against the
    same steps on the CPU."""
    cfg = enc.EncoderConfig(num_layers=2, d_model=64, num_heads=4, ffn_dim=128, dtype=torch.float32)
    feats = torch.from_numpy(np.random.default_rng(15).standard_normal((4, 32, 80), np.float32))
    lens = torch.tensor([32, 20, 32, 11])
    gen = torch.Generator().manual_seed(3)
    masks = [enc.draw_mask(lens, 32, cfg.mask_prob, gen) for _ in range(4)]
    models = {d: enc.Encoder(cfg, device=d) for d in ("cpu", cuda)}
    start = {k: v.detach().clone() for k, v in models["cpu"].named_parameters()}
    losses = {}
    for d, model in models.items():
        f, l = feats.to(d), lens.to(d)
        init, step = enc.make_adamw_train_step(lr=1e-3)
        opt = init(model)
        losses[d] = [float(enc.sgd_train_step(model, f, l, masks[0].to(d), lr=1e-2))]
        for m in masks[1:]:
            losses[d].append(float(step(model, opt, f, l, m.to(d))))
            if d == "cpu" and len(losses[d]) == 2:  # the first AdamW step's gradients
                first_grads = {n: p.grad.abs().clone() for n, p in model.named_parameters()}
    np.testing.assert_allclose(losses[cuda], losses["cpu"], rtol=1e-5)
    # The updates since the start, at tests/test_torch_encoder.py's AdamW
    # bounds: tight where the first AdamW gradient is past 1e-6, up to lr
    # where it is near Adam's eps (a rounding difference may flip those).
    for (name, a), b in zip(models["cpu"].named_parameters(), models[cuda].parameters()):
        theirs, mine = a.detach() - start[name], b.detach().cpu() - start[name]
        well = first_grads[name] > 1e-6
        diff = mine - theirs
        well_abs, near_abs = (diff.abs() * well).max().item(), (diff.abs() * ~well).max().item()
        well_rel = ((diff * well).norm() / (theirs * well).norm()).item()
        assert well_abs <= 1e-5 and well_rel <= 1e-3 and near_abs <= 1e-3, (
            name, well_abs, well_rel, near_abs)


def test_entry_on_card_launches_the_kernel(cuda):
    from lhotse_tpu_torch import entry

    before = fbank_cuda.LAUNCHES
    fn, args = entry.entry()
    cpu_fn, cpu_args = entry.entry("cpu")
    with torch.no_grad():
        hidden, feat_lens = fn(*args)
        ref, ref_lens = cpu_fn(*cpu_args)
    assert fbank_cuda.LAUNCHES == before + 1
    assert hidden.device.type == "cuda" and torch.equal(feat_lens.cpu(), ref_lens)
    assert (hidden.float().cpu() - ref.float()).abs().max().item() <= ENCODER_TOL[torch.bfloat16]


def test_wpe_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(16)
    t = np.arange(16000) / 16000
    dry = 0.2 * sum(np.sin(2 * np.pi * 150 * (h + 1) * t) / (h + 1) for h in range(3))
    audio = np.stack([np.convolve(dry, np.r_[1.0, np.exp(-np.arange(1999) / 300.0)
                                            * rng.randn(1999) * 0.3])[:16000]
                      for _ in range(2)]).astype(np.float32)
    on_card = dereverb_wpe(audio)
    assert on_card.device.type == "cuda"
    ref = dereverb_wpe(audio, device="cpu").numpy()
    out = on_card.cpu().numpy()
    # tests/test_torch_wpe.py's bounds against the JAX function.
    assert np.corrcoef(out.ravel(), ref.ravel())[0, 1] > 0.99
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < 0.1
    batched = dereverb_wpe(np.stack([audio, audio])).cpu().numpy()
    np.testing.assert_allclose(batched[1], batched[0], atol=1e-6)


def _noisy_tones(n_items: int, seed: int = 7):
    """1-4 s of a 0.05 tone under 0.1 white noise: every mel bin carries
    energy. On bench.py's tone bursts over a 0.01 floor the lowest mel bins
    nearly cancel, and every float32 route is ~2.3e-4 from float64 there
    (the kernel and its plain version alike; chip_smoke.py phase 11).

    The kernel is held to its plain version on the card at the kernel's
    bound; the CPU route, whose DFT products are float64, to the feature
    budget: on these items the card's float32 routes are up to 5.2e-5 from
    it (NVIDIA H100 80GB HBM3)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_items):
        n = int(16000 * rng.uniform(1.0, 4.0))
        wave = np.sin(2 * np.pi * rng.uniform(100, 400) * np.arange(n) / 16000) * 0.05
        out.append((wave + rng.randn(n) * 0.1).astype(np.float32))
    return out


def _plain(extractor, items):
    """``extractor.extract_batch(items)`` with the kernel's plain version on
    the card in place of the kernel."""
    prepared = [extractor._prepare_item(x) for x in items]
    batch = np.zeros((len(prepared), max(len(p) for p in prepared)), np.float32)
    for i, p in enumerate(prepared):
        batch[i, : len(p)] = p
    Mc, Ms, fb, _ = extractor._layer()._fused_matrices()
    mats = fbank_cuda._squeeze_nyquist(*(fbank_cuda._as_f32(m, "cuda") for m in (Mc, Ms, fb)))
    out = fbank_cuda.reference_fbank(torch.from_numpy(batch).cuda(), *mats).cpu().numpy()
    return [out[i, : extractor._num_frames(len(x))] for i, x in enumerate(items)]


def test_extract_store_read_on_card_matches_cpu(cuda, tmp_path):
    """``extract_batch`` on the card (one kernel launch) against the CPU
    port, then the features through a chunky archive and back: within half
    an LTC1 tick of what was stored, and equal on a second decode."""
    from lhotse_tpu_torch.features.io import LilcomChunkyReader, LilcomChunkyWriter

    items = _noisy_tones(6)
    extractor = extractors.Fbank(extractors.FbankConfig(device="cuda"))
    fbank_cuda.LAUNCHES = 0
    feats = extractor.extract_batch(items, 16000)
    assert fbank_cuda.LAUNCHES == 1
    assert max(float(np.abs(a - b).max()) for a, b in zip(feats, _plain(extractor, items))) <= LOGMEL_TOL
    cpu = extractors.Fbank(extractors.FbankConfig(device="cpu")).extract_batch(items, 16000)
    assert max(float(np.abs(a - b).max()) for a, b in zip(feats, cpu)) <= FEATURE_TOL
    with LilcomChunkyWriter(tmp_path / "feats") as writer:
        keys = [writer.write(f"u{i}", f) for i, f in enumerate(feats)]
    reader = LilcomChunkyReader(writer.storage_path)
    for key, f in zip(keys, feats):
        got = reader.read(key)
        assert np.abs(got - f).max() <= 2.0**-6 + 1e-6
        assert np.array_equal(got, LilcomChunkyReader(writer.storage_path).read(key, 0, None))


def test_session_extract_on_card_matches_plain_version(cuda):
    """A 300 s, 8-channel array session (the shape of an AMI MDM meeting)
    through ``Fbank.extract``: one launch of 8 rows of 30,000 frames, held
    to the kernel's plain version on the card."""
    rng = np.random.default_rng(5678)
    n = 300 * 16000
    t = np.arange(n) / 16000
    tone = 0.2 * np.sin(2 * np.pi * 220 * t) * (np.sin(2 * np.pi * t / 7) > 0)
    session = (tone + 0.01 * rng.standard_normal((8, n))).astype(np.float32)
    extractor = extractors.Fbank(extractors.FbankConfig(device="cuda"))
    fbank_cuda.LAUNCHES = 0
    feats = extractor.extract(session, 16000)
    assert fbank_cuda.LAUNCHES == 1
    assert feats.shape == (8, 30000, 80) and np.isfinite(feats).all()
    plain = _plain(extractor, list(session))
    assert max(float(np.abs(a - b).max()) for a, b in zip(feats, plain)) <= LOGMEL_TOL


def test_on_the_fly_features_on_card_match_cpu(cuda, tmp_path):
    from lhotse_tpu_torch.audio import Recording
    from lhotse_tpu_torch.audio.flacio import write_flac
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures

    cuts = []
    for i, wave in enumerate(_noisy_tones(5, seed=8)):
        write_flac(str(tmp_path / f"u{i}.flac"), wave, 16000)
        cuts.append(Recording.from_file(tmp_path / f"u{i}.flac").to_cut())
    cuts = CutSet.from_cuts(cuts)
    extractor = extractors.Fbank(extractors.FbankConfig(device="cuda"))
    fbank_cuda.LAUNCHES = 0
    feats, lens = OnTheFlyFeatures(extractor)(cuts)
    assert fbank_cuda.LAUNCHES == 1
    audio = [c.load_audio()[0] for c in cuts]
    for f, p in zip(feats, _plain(extractor, audio)):
        assert np.abs(f[: len(p)] - p).max() <= LOGMEL_TOL
    cpu_feats, cpu_lens = OnTheFlyFeatures(extractors.Fbank(extractors.FbankConfig(device="cpu")))(cuts)
    assert np.array_equal(lens, cpu_lens)
    assert np.abs(feats - cpu_feats).max() <= FEATURE_TOL


def test_augmented_on_the_fly_features_on_card_match_cpu(cuda, tmp_path):
    """``perturb_speed(1.1).mix(noise, snr=(10, 20), mix_prob=0.5, seed=7)``
    into ``OnTheFlyFeatures`` on the card (chip_smoke.py phase 12 at a small
    size): one launch, the kernel against its plain version on the same
    mixed audio, and the batch against the CPU port's."""
    import random

    from lhotse_tpu_torch.audio import Recording
    from lhotse_tpu_torch.audio.flacio import write_flac
    from lhotse_tpu_torch.cut import CutSet, MixedCut
    from lhotse_tpu_torch.dataset.cut_transforms import CutMix
    from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
    from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset

    from lhotse_tpu_torch.supervision import SupervisionSegment

    for i, wave in enumerate(_noisy_tones(7, seed=12)):
        write_flac(str(tmp_path / f"u{i}.flac"), wave, 16000)
    cuts = [Recording.from_file(tmp_path / f"u{i}.flac").to_cut() for i in range(7)]
    for cut in cuts[:5]:
        cut.supervisions.append(SupervisionSegment(
            id=cut.id, recording_id=cut.recording_id, start=0.0, duration=cut.duration, text="x"))
    CutSet.from_cuts(cuts[:5]).to_file(tmp_path / "cuts.jsonl")
    noise = CutSet.from_cuts(cuts[5:])
    cuts = CutSet.from_jsonl_lazy(tmp_path / "cuts.jsonl").perturb_speed(1.1).mix(
        noise, snr=(10, 20), mix_prob=0.5, seed=7).to_eager()
    assert any(isinstance(c, MixedCut) for c in cuts)
    extractor = extractors.Fbank(extractors.FbankConfig(device="cuda"))
    fbank_cuda.LAUNCHES = 0
    feats, lens = OnTheFlyFeatures(extractor)(cuts)
    assert fbank_cuda.LAUNCHES == 1
    audio = [c.load_audio()[0] for c in cuts]
    for f, p in zip(feats, _plain(extractor, audio)):
        assert np.abs(f[: len(p)] - p).max() <= LOGMEL_TOL
    cpu_feats, cpu_lens = OnTheFlyFeatures(extractors.Fbank(extractors.FbankConfig(device="cpu")))(cuts)
    assert np.array_equal(lens, cpu_lens)
    assert np.abs(feats - cpu_feats).max() <= FEATURE_TOL
    # The CutMix transform in the dataset, on the card: one launch per batch.
    dataset = K2SpeechRecognitionDataset(
        cut_transforms=[CutMix(noise, p=1.0, seed=random.Random(0))],
        input_strategy=OnTheFlyFeatures(extractor))
    fbank_cuda.LAUNCHES = 0
    batch = dataset[CutSet.from_file(tmp_path / "cuts.jsonl").to_eager()]
    assert fbank_cuda.LAUNCHES == 1 and np.isfinite(batch["inputs"]).all()


def test_shar_batches_on_card(cuda, tmp_path):
    """chip_smoke.py phase 13 at a small size: FLAC cuts exported to Shar;
    one streaming batch extracted on the kernel (one launch) against the
    kernel's plain version; the indexed, shuffled reader reports constant
    time access and feeds ``OnTheFlyFeatures`` on the card."""
    import warnings

    from lhotse_tpu_torch.audio import Recording
    from lhotse_tpu_torch.audio.flacio import write_flac
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.dataset.input_strategies import AudioSamples, OnTheFlyFeatures
    from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
    from lhotse_tpu_torch.shar.readers import LazyIndexedSharIterator, LazySharIterator
    from lhotse_tpu_torch.supervision import SupervisionSegment

    cuts = []
    for i, wave in enumerate(_noisy_tones(6, seed=21)):
        write_flac(str(tmp_path / f"u{i}.flac"), wave, 16000)
        cut = Recording.from_file(tmp_path / f"u{i}.flac").to_cut()
        cut.supervisions.append(SupervisionSegment(
            id=cut.id, recording_id=cut.recording_id, start=0.0, duration=cut.duration))
        cuts.append(cut)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        CutSet.from_cuts(cuts).to_shar(tmp_path / "shar", fields={"recording": "flac"},
                                       shard_size=2, compress_jsonl=False)
    streaming = CutSet.from_shar(in_dir=tmp_path / "shar", indexed=False, shuffle_shards=True, seed=0)
    assert isinstance(streaming.data, LazySharIterator)
    batch = K2SpeechRecognitionDataset(return_cuts=True, input_strategy=AudioSamples())[
        streaming.to_eager()]
    lens = batch["supervisions"]["num_samples"]
    audio = [batch["inputs"][i, :n] for i, n in enumerate(lens)]
    extractor = extractors.Fbank(extractors.FbankConfig(device="cuda"))
    fbank_cuda.LAUNCHES = 0
    feats = extractor.extract_batch(audio, 16000)
    assert fbank_cuda.LAUNCHES == 1
    assert max(float(np.abs(a - b).max()) for a, b in zip(feats, _plain(extractor, audio))) <= LOGMEL_TOL
    indexed = CutSet.from_shar(in_dir=tmp_path / "shar", shuffle_shards=True, seed=0)
    assert isinstance(indexed.data, LazyIndexedSharIterator) and indexed.has_constant_time_access
    fbank_cuda.LAUNCHES = 0
    fly = K2SpeechRecognitionDataset(input_strategy=OnTheFlyFeatures(extractor))[indexed.to_eager()]
    assert fbank_cuda.LAUNCHES == 1 and fly["inputs"].shape[0] == 6
    assert np.isfinite(fly["inputs"]).all()


def test_recipe_batch_on_card_matches_plain_version(cuda, tmp_path):
    """A LibriSpeech-layout corpus through ``prepare_librispeech`` →
    ``CutSet.from_manifests(lazy=True)`` → ``SimpleCutSampler`` →
    ``OnTheFlyFeatures`` on the card (chip_smoke.py phase 14 at a small
    size): one launch per batch, the kernel against its plain version on the
    batch's audio, and the batch against the CPU port's."""
    import warnings

    from lhotse_tpu_torch.audio.flacio import write_flac
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.dataset import SimpleCutSampler
    from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
    from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
    from lhotse_tpu_torch.recipes import prepare_librispeech

    chapter = tmp_path / "LibriSpeech" / "dev-clean" / "19" / "198"
    chapter.mkdir(parents=True)
    lines = []
    for i, wave in enumerate(_noisy_tones(5, seed=30)):
        write_flac(str(chapter / f"19-198-{i:04d}.flac"), wave, 16000)
        lines.append(f"19-198-{i:04d} WORD NUMBER {i}")
    (chapter / "19-198.trans.txt").write_text("\n".join(lines) + "\n")
    manifests = prepare_librispeech(tmp_path / "LibriSpeech", output_dir=tmp_path / "manifests")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cuts = CutSet.from_manifests(
            **manifests["dev-clean"], lazy=True, output_path=tmp_path / "cuts.jsonl.gz")
    extractor = extractors.Fbank(extractors.FbankConfig(device="cuda"))
    dataset = K2SpeechRecognitionDataset(return_cuts=True, input_strategy=OnTheFlyFeatures(extractor))
    batches = list(SimpleCutSampler(cuts, max_duration=8.0, shuffle=True, seed=0))
    fbank_cuda.LAUNCHES = 0
    out = [dataset[b] for b in batches]
    assert fbank_cuda.LAUNCHES == len(batches) >= 2
    cpu = OnTheFlyFeatures(extractors.Fbank(extractors.FbankConfig(device="cpu")))
    for batch in out:
        cut_batch = CutSet.from_cuts(batch["supervisions"]["cut"])
        audio = [c.load_audio()[0] for c in cut_batch]
        for f, p in zip(batch["inputs"], _plain(extractor, audio)):
            assert np.abs(f[: len(p)] - p).max() <= LOGMEL_TOL
        cpu_feats, _ = cpu(cut_batch)
        assert np.abs(batch["inputs"] - cpu_feats).max() <= FEATURE_TOL
    assert sorted(t for b in out for t in b["supervisions"]["text"]) == sorted(
        line.split(maxsplit=1)[1] for line in lines)


@pytest.mark.parametrize("name", ["fbank", "kaldifeat-fbank"])
def test_reference_named_fbank_on_card_matches_plain_version(cuda, name):
    """The ``fbank`` (compliance) and ``kaldifeat-fbank`` extractors run the
    kernel on the card, held to its plain version on the card."""
    from lhotse_tpu_torch.features.base import get_extractor_type

    ext = get_extractor_type(name)()
    assert ext.device == torch.device("cuda")
    items = [_audio((n,), seed=n) for n in (16000, 12345, 3000)]
    fbank_cuda.LAUNCHES = 0
    feats = ext.extract_batch(items, 16000)
    assert fbank_cuda.LAUNCHES == (1 if name == "fbank" else len(items))
    delegate = ext._delegate(16000) if name == "fbank" else ext._impl
    plain = _plain(delegate, items)
    assert [f.shape for f in feats] == [p.shape for p in plain]
    assert max(float(np.abs(a - b).max()) for a, b in zip(feats, plain)) <= LOGMEL_TOL


@pytest.mark.parametrize("name", ["whisper-fbank", "librosa-fbank"])
def test_gemm_extractors_on_card_match_cpu(cuda, name):
    """Whisper's and librosa's STFT and mel GEMMs on the card (IEEE fp32)
    against the same port on the CPU, within tests/test_whisper_fbank.py's
    1e-4; no fbank kernel runs."""
    from lhotse_tpu_torch.features.base import get_extractor_type

    cls = get_extractor_type(name)
    sr = 16000 if name == "whisper-fbank" else 22050
    on_card, on_cpu = cls(), cls()
    on_cpu.to("cpu")
    assert on_card.device == torch.device("cuda")
    fbank_cuda.LAUNCHES = 0
    for n in (sr, int(1.7 * sr), 5000):
        x = _audio((n,), seed=n)
        a, b = on_card.extract(x, sr), on_cpu.extract(x, sr)
        assert a.shape == b.shape and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    assert fbank_cuda.LAUNCHES == 0


def _two_talker_cuts(tmp_path, prefix, n, seed):
    """``n`` FLAC cuts of 2-4 s of noisy tones, each with two overlapping
    supervisions of two speakers (the shape of a supervision group of a
    meeting)."""
    from lhotse_tpu_torch.audio import Recording
    from lhotse_tpu_torch.audio.flacio import write_flac
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.supervision import SupervisionSegment

    cuts = []
    for i, wave in enumerate(_noisy_tones(n, seed=seed)):
        write_flac(str(tmp_path / f"{prefix}{i}.flac"), wave, 16000)
        cut = Recording.from_file(tmp_path / f"{prefix}{i}.flac").to_cut()
        half = round(cut.duration / 2, 2)
        cut.supervisions = [
            SupervisionSegment(id=f"{prefix}{i}-a", recording_id=cut.recording_id, start=0.0,
                               duration=half + 0.3, text=f"FIRST {i}", speaker=f"{prefix}A"),
            SupervisionSegment(id=f"{prefix}{i}-b", recording_id=cut.recording_id, start=half,
                               duration=round(cut.duration - half, 2), text=f"SECOND {i}",
                               speaker=f"{prefix}B{i % 2}")]
        cuts.append(cut)
    return CutSet.from_cuts(cuts)


def test_zip_surt_batches_on_card_match_cpu(cuda, tmp_path):
    """``ZipSampler`` over two sources → ``K2SurtDataset`` with
    ``OnTheFlyFeatures`` on the card (chip_smoke.py phase 17 at a small
    size): one launch per batch, the kernel against its plain version on the
    batch's audio, the batch against the CPU port's, and the supervisions
    and per-channel text equal to the CPU dataset's on the same cuts."""
    from lhotse_tpu_torch.dataset import K2SurtDataset, SimpleCutSampler, ZipSampler
    from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures

    a, b = _two_talker_cuts(tmp_path, "a", 4, 41), _two_talker_cuts(tmp_path, "b", 4, 42)
    sampler = ZipSampler(SimpleCutSampler(a, max_duration=6.0), SimpleCutSampler(b, max_duration=6.0))
    extractor = extractors.Fbank(extractors.FbankConfig(device="cuda"))
    card = K2SurtDataset(num_channels=2, return_cuts=True, input_strategy=OnTheFlyFeatures(extractor))
    cpu = K2SurtDataset(num_channels=2, return_cuts=True, input_strategy=OnTheFlyFeatures(
        extractors.Fbank(extractors.FbankConfig(device="cpu"))))
    batches = list(sampler)
    fbank_cuda.LAUNCHES = 0
    out = [card[cuts] for cuts in batches]
    assert fbank_cuda.LAUNCHES == len(batches) >= 2
    for cuts, batch in zip(batches, out):
        audio = [c.load_audio()[0] for c in batch["cuts"]]
        for f, p in zip(batch["inputs"], _plain(extractor, audio)):
            assert np.abs(f[: len(p)] - p).max() <= LOGMEL_TOL
        want = cpu[cuts]
        assert np.abs(batch["inputs"] - want["inputs"]).max() <= FEATURE_TOL
        assert batch["text"] == want["text"]
        assert [[[s.id for s in ch] for ch in c] for c in batch["supervisions"]] == [
            [[s.id for s in ch] for ch in c] for c in want["supervisions"]]
        assert all(len(ch[1]) == 1 for ch in batch["supervisions"])  # the overlap's channel


def test_diarization_batch_on_card_matches_cpu(cuda, tmp_path):
    """Features extracted on the card into a chunky archive
    (``compute_and_store_features_batch``, the kernel) → a
    ``DiarizationDataset`` batch: ``speaker_activity`` (B, S, T) equal to
    the one over the CPU port's archive, and the features within the
    feature budget (and one LTC1 tick) of the CPU's."""
    from lhotse_tpu_torch.dataset import DiarizationDataset
    from lhotse_tpu_torch.features.io import LilcomChunkyWriter

    # One length for all: the dataset stacks the activity matrices.
    cuts = _two_talker_cuts(tmp_path, "d", 4, 43).truncate(max_duration=1.0, offset_type="start").to_eager()
    fbank_cuda.LAUNCHES = 0
    card = cuts.compute_and_store_features_batch(
        extractors.Fbank(extractors.FbankConfig(device="cuda")), tmp_path / "card",
        storage_type=LilcomChunkyWriter, num_workers=1).to_eager()
    assert fbank_cuda.LAUNCHES >= 1
    cpu = cuts.compute_and_store_features_batch(
        extractors.Fbank(extractors.FbankConfig(device="cpu")), tmp_path / "cpu",
        storage_type=LilcomChunkyWriter, num_workers=1).to_eager()
    got = DiarizationDataset(card, global_speaker_ids=True, min_speaker_dim=4)[card]
    want = DiarizationDataset(cpu, global_speaker_ids=True, min_speaker_dim=4)[cpu]
    assert np.array_equal(got["speaker_activity"], want["speaker_activity"])
    assert np.array_equal(got["features_lens"], want["features_lens"])
    assert got["speaker_activity"].shape == (4, 4, got["features"].shape[1])
    assert set(np.unique(got["speaker_activity"])) == {0.0, 1.0}
    assert np.abs(got["features"] - want["features"]).max() <= FEATURE_TOL + 2.0**-5


def _sphere_pairs(tmp_path, n, seed):
    """``n`` noisy tones written as SPHERE (pcm16 and ulaw in turn) with a
    supervision each carrying a ``translated_text``; the source side, and
    the same audio as AIFF for the target side, under the same stems."""
    from lhotse_tpu_torch.audio import RecordingSet
    from lhotse_tpu_torch.audio.aiffio import write_aiff
    from lhotse_tpu_torch.audio.sphio import write_sph
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet

    (tmp_path / "src").mkdir()
    (tmp_path / "tgt").mkdir()
    for i, wave in enumerate(_noisy_tones(n, seed=seed)):
        write_sph(tmp_path / "src" / f"u{i}.sph", wave, 16000, coding=("pcm16", "ulaw")[i % 2])
        write_aiff(tmp_path / "tgt" / f"u{i}.aiff", wave, 16000)

    def cuts(side, pattern):
        recs = RecordingSet.from_dir(tmp_path / side, pattern)
        return CutSet.from_manifests(recs, SupervisionSet.from_segments(
            SupervisionSegment(id=f"{r.id}-s", recording_id=r.id, start=0.0, duration=r.duration,
                               text=f"WORDS OF {r.id.upper()}",
                               custom={"translated_text": f"mots de {r.id}"}) for r in recs)).to_eager()

    return cuts("src", "*.sph"), cuts("tgt", "*.aiff")


def test_paired_translation_over_sphere_on_card_matches_plain(cuda, tmp_path):
    """SPHERE sources and AIFF targets → ``CutPairsSampler`` →
    ``K2Speech2TextTranslationDataset`` with ``OnTheFlyFeatures`` on the card
    (chip_smoke.py phase 18 at a small size): one launch per side and batch,
    every row within the feature budget of the kernel's plain version, and
    the batch's text, ``tgt_text`` and features against the CPU port's."""
    from lhotse_tpu_torch.dataset import CutPairsSampler, K2Speech2TextTranslationDataset
    from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures

    src, tgt = _sphere_pairs(tmp_path, 6, seed=31)
    extractor = extractors.Fbank(extractors.FbankConfig(device="cuda"))
    card = K2Speech2TextTranslationDataset(return_cuts=True, input_strategy=OnTheFlyFeatures(extractor))
    cpu = K2Speech2TextTranslationDataset(return_cuts=True, input_strategy=OnTheFlyFeatures(
        extractors.Fbank(extractors.FbankConfig(device="cpu"))))
    sampler = CutPairsSampler(src, tgt, max_source_duration=6.0, max_target_duration=6.0,
                              shuffle=True, seed=0)
    fbank_cuda.LAUNCHES = 0
    pairs = [(s, t, card[s], card[t]) for s, t in sampler]
    assert fbank_cuda.LAUNCHES == 2 * len(pairs) >= 4
    for s, t, got_s, got_t in pairs:
        assert [c.id for c in s] == [c.id for c in t]
        for cuts, got in ((s, got_s), (t, got_t)):
            sups = got["supervisions"]
            rows = [c for c in sups["cut"]]
            audio = [c.load_audio()[0] for c in rows]
            for i, p in zip(sups["sequence_idx"], _plain(extractor, audio)):
                assert np.abs(got["inputs"][int(i), : len(p)] - p).max() <= FEATURE_TOL
            want = cpu[cuts]
            assert sups["text"] == want["supervisions"]["text"]
            assert sups["tgt_text"] == want["supervisions"]["tgt_text"] == [
                f"mots de {c.recording_id}" for c in rows]
            assert np.abs(got["inputs"] - want["inputs"]).max() <= FEATURE_TOL


def test_premixed_separation_on_card_matches_cpu(cuda, tmp_path):
    """Two-speaker mixtures and their sources extracted on the card
    (``compute_and_store_features_batch``, the kernel) → a
    ``PreMixedSourceSeparationDataset`` batch: on the same stored features
    the CPU port's dataset gives masks equal to the card's; over the CPU
    port's own lossless archive the ideal ratio masks are within 1e-3 and
    the binary masks equal wherever the sources' masks part by more."""
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.dataset import PreMixedSourceSeparationDataset
    from lhotse_tpu_torch.features.io import NumpyFilesWriter
    from lhotse_tpu_torch.utils import fastcopy

    talkers = _two_talker_cuts(tmp_path, "p", 4, 47)
    sources, mixtures = [], []
    for k in range(2):
        a, b = talkers[2 * k], talkers[2 * k + 1]
        length = min(a.duration, b.duration)
        a, b = a.truncate(duration=length, preserve_id=True), b.truncate(duration=length, preserve_id=True)
        sources += [a, b]
        mixtures.append(fastcopy(a.mix(b), id=f"mix-{k}"))

    def dataset(featured):
        by_id = {c.id: c for c in featured}
        relabelled = [fastcopy(by_id[c.id], id=f"mix-{i // 2}-src{i % 2}", recording=None,
                               features=fastcopy(by_id[c.id].features, recording_id=f"mix-{i // 2}"))
                      for i, c in enumerate(sources)]
        with pytest.warns(UserWarning, match="not yet updated"):
            return PreMixedSourceSeparationDataset(
                CutSet.from_cuts(relabelled), CutSet.from_cuts(by_id[m.id] for m in mixtures))

    fbank_cuda.LAUNCHES = 0
    card = CutSet.from_cuts(sources + mixtures).compute_and_store_features_batch(
        extractors.Fbank(extractors.FbankConfig(device="cuda")), tmp_path / "card",
        manifest_path=tmp_path / "card.jsonl", storage_type=NumpyFilesWriter, num_workers=1).to_eager()
    assert fbank_cuda.LAUNCHES >= 1
    cpu = CutSet.from_cuts(sources + mixtures).compute_and_store_features_batch(
        extractors.Fbank(extractors.FbankConfig(device="cpu")), tmp_path / "cpu",
        storage_type=NumpyFilesWriter, num_workers=1).to_eager()
    got, reread, want = dataset(card), dataset(CutSet.from_file(tmp_path / "card.jsonl")), dataset(cpu)
    for i in range(len(got)):
        item, same, other = got[i], reread[i], want[i]
        assert item["sources"].shape[0] == 2
        np.testing.assert_allclose(item["real_mask"].sum(0), 1.0, rtol=0, atol=1e-6)
        for key in ("real_mask", "binary_mask", "mixture", "sources"):
            assert np.array_equal(item[key], same[key])
        assert np.abs(item["mixture"] - other["mixture"]).max() <= FEATURE_TOL
        assert np.abs(item["real_mask"] - other["real_mask"]).max() <= 1e-3
        clear = np.abs(other["real_mask"][0] - other["real_mask"][1]) > 1e-3
        assert np.array_equal(item["binary_mask"][clear], other["binary_mask"][clear])


def test_mp3_cut_on_the_fly_features_on_card(cuda, tmp_path):
    """A 48 kHz MP3 clip (a CommonVoice clip's shape, encoded by the port's
    LAME binding), resampled to 16 kHz and compressed with opus, through
    ``OnTheFlyFeatures`` on the card: one launch, the kernel against its
    plain version on the same decoded audio, and the batch against the CPU
    port's."""
    from lhotse_tpu_torch.audio import Recording, syscodecs
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures

    if not (syscodecs.mp3_available() and syscodecs.mp3_encode_available()
            and syscodecs.opus_available()):
        pytest.skip("needs the system codec libraries (mpg123, mp3lame, opus)")
    rng = np.random.RandomState(21)
    cuts = []
    for i, seconds in enumerate((1.3, 2.1)):
        n = int(48000 * seconds)
        wave = (0.1 * rng.randn(n) + 0.05 * np.sin(2 * np.pi * 300 * np.arange(n) / 48000))
        (tmp_path / f"c{i}.mp3").write_bytes(syscodecs.mp3_encode(wave.astype(np.float32), 48000))
        cut = Recording.from_file(tmp_path / f"c{i}.mp3").to_cut().resample(16000)
        cuts.append(cut.compress("opus", 0.5) if i else cut)
    cuts = CutSet.from_cuts(cuts)
    extractor = extractors.Fbank(extractors.FbankConfig(device="cuda"))
    fbank_cuda.LAUNCHES = 0
    feats, lens = OnTheFlyFeatures(extractor)(cuts)
    assert fbank_cuda.LAUNCHES == 1
    audio = [c.load_audio()[0] for c in cuts]
    for f, p in zip(feats, _plain(extractor, audio)):
        assert np.isfinite(f).all() and np.abs(f[: len(p)] - p).max() <= LOGMEL_TOL
    cpu_feats, cpu_lens = OnTheFlyFeatures(extractors.Fbank(extractors.FbankConfig(device="cpu")))(cuts)
    assert np.array_equal(lens, cpu_lens)
    assert np.abs(feats - cpu_feats).max() <= FEATURE_TOL


def test_piped_kaldi_dir_extract_cuts_batch_on_card(cuda, tmp_path):
    """A Kaldi data dir whose ``wav.scp`` pipes FLAC through ``cat`` →
    ``kaldi import`` → ``cut simple`` → ``feat extract-cuts-batch`` (no
    config: ``Fbank()`` on the card) into ``numpy_files``: one launch per
    batch, and the stored features against the kernel's plain version on
    the piped audio."""
    click = pytest.importorskip("click", reason="the CLI needs click")  # noqa: F841
    from lhotse_tpu_torch.audio.flacio import write_flac
    from lhotse_tpu_torch.bin.modes import cli
    from lhotse_tpu_torch.cut import CutSet

    kdir = tmp_path / "kdir"
    kdir.mkdir()
    scp, dur, spk = [], [], []
    for i, seconds in enumerate((1.3, 2.6, 0.7)):
        n = int(16000 * seconds)
        write_flac(str(tmp_path / f"u{i}.flac"), _audio(n, seed=i), 16000)
        scp.append(f"u{i} cat {tmp_path / f'u{i}.flac'} |")
        dur.append(f"u{i} {n / 16000}")
        spk.append(f"u{i} s{i}")
    for name, lines in (("wav.scp", scp), ("reco2dur", dur), ("utt2spk", spk)):
        (kdir / name).write_text("\n".join(lines) + "\n")
    m = tmp_path / "m"
    fbank_cuda.LAUNCHES = 0
    for argv in (["kaldi", "import", kdir, 16000, m],
                 ["cut", "simple", "-r", m / "recordings.jsonl.gz", "-s",
                  m / "supervisions.jsonl.gz", tmp_path / "cuts.jsonl.gz"],
                 ["feat", "extract-cuts-batch", "-j", 1, "--storage-type", "numpy_files",
                  tmp_path / "cuts.jsonl.gz", tmp_path / "feats.jsonl.gz", tmp_path / "storage"]):
        cli.main([str(a) for a in argv], standalone_mode=False)
    assert fbank_cuda.LAUNCHES == 1
    cuts = list(CutSet.from_file(tmp_path / "feats.jsonl.gz"))
    assert all(c.recording.sources[0].type == "command" for c in cuts)
    extractor = extractors.Fbank(extractors.FbankConfig(device="cuda"))
    audio = [c.load_audio()[0] for c in cuts]
    for cut, p in zip(cuts, _plain(extractor, audio)):
        f = cut.load_features()
        assert f.shape == p.shape and np.abs(f - p).max() <= LOGMEL_TOL


def test_simulated_meeting_windows_through_surt_on_card(cuda, tmp_path):
    """Conversational meetings simulated from FLAC utterances, reverberated
    with the fast random RIRs and cut into 4 s windows → ``K2SurtDataset``
    with ``OnTheFlyFeatures`` on the card (chip_smoke.py phase 21 at a small
    size): one launch per batch, the kernel against its plain version on
    each window's mixed audio, and the batch against the CPU port's."""
    from lhotse_tpu_torch.audio import Recording
    from lhotse_tpu_torch.audio.flacio import write_flac
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.dataset import K2SurtDataset, SimpleCutSampler
    from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
    from lhotse_tpu_torch.supervision import SupervisionSegment
    from lhotse_tpu_torch.utils import fix_random_seed
    from lhotse_tpu_torch.workflows import ConversationalMeetingSimulator

    cuts = []
    for i in range(8):
        write_flac(str(tmp_path / f"u{i}.flac"), _audio(16000 + 3000 * i, seed=i), 16000)
        c = Recording.from_file(tmp_path / f"u{i}.flac").to_cut()
        c.supervisions = [SupervisionSegment(id=f"s{i}", recording_id=c.recording_id, start=0.0,
                                             duration=c.duration, text=f"w{i}",
                                             speaker=f"spk{i % 4}")]
        cuts.append(c)
    fix_random_seed(0)
    sim = ConversationalMeetingSimulator()
    meetings = sim.reverberate(sim.simulate(CutSet.from_cuts(cuts), num_repeats=1,
                                            num_speakers_per_meeting=[2, 3],
                                            max_utterances_per_speaker=1))
    windows = CutSet.from_cuts(w for w in meetings.cut_into_windows(
        4.0, keep_excessive_supervisions=False) if w.supervisions)
    extractor = extractors.Fbank(extractors.FbankConfig(device="cuda"))
    card = K2SurtDataset(return_cuts=True, input_strategy=OnTheFlyFeatures(extractor))
    cpu = K2SurtDataset(return_cuts=True, input_strategy=OnTheFlyFeatures(
        extractors.Fbank(extractors.FbankConfig(device="cpu"))))
    batches = list(SimpleCutSampler(windows, max_duration=6.0))
    fbank_cuda.LAUNCHES = 0
    out = [card[b] for b in batches]
    assert fbank_cuda.LAUNCHES == len(batches) >= 2
    for b, batch in zip(batches, out):
        audio = [c.load_audio()[0] for c in batch["cuts"]]
        for f, p in zip(batch["inputs"], _plain(extractor, audio)):
            assert np.isfinite(f).all() and np.abs(f[: len(p)] - p).max() <= LOGMEL_TOL
        want = cpu[b]
        assert np.abs(batch["inputs"] - want["inputs"]).max() <= FEATURE_TOL
        assert batch["text"] == want["text"]


def test_musan_rir_fed_augmenter_on_card_matches_cpu(cuda, tmp_path):
    """A MUSAN layout's noise recordings (tiled or cut to 3 s) as the noise
    pool and a RIRS_NOISES ``real_rir`` response as the RIR, through
    ``prepare_musan`` and ``prepare_rir_noise``, into the augmenter on the
    card against the same augmenter on the CPU port."""
    from lhotse_tpu_torch.audio.wavio import write_wav
    from lhotse_tpu_torch.recipes import prepare_musan, prepare_rir_noise

    for i, seconds in enumerate((0.5, 2.5, 1.2, 3.4)):
        path = tmp_path / "musan" / "noise" / "free-sound" / f"noise-free-sound-{i:04d}.wav"
        path.parent.mkdir(parents=True, exist_ok=True)
        write_wav(path, _audio((1, int(seconds * 16000)), seed=20 + i), 16000)
    n = 4800
    rir = _audio((1, n), seed=9) * np.exp(-np.arange(n) / (n / 6.0)).astype(np.float32)
    rir[0, 32] = 1.0
    path = tmp_path / "RIRS_NOISES" / "real_rirs_isotropic_noises" / "RWCP_type4_rir_cirline.wav"
    path.parent.mkdir(parents=True)
    write_wav(path, rir, 16000)
    noise = prepare_musan(tmp_path / "musan", parts="noise")["noise"]["recordings"]
    (rec,) = prepare_rir_noise(tmp_path / "RIRS_NOISES", parts="real_rir")["real_rir"]["recordings"]
    pool = np.stack([np.resize(r.load_audio()[0], 48000) for r in noise])
    cfg = dict(buckets=[(2.0, 4)], speed_factor=1.1, noise_pool=pool, rir=rec.load_audio()[0],
               snr=(10, 20), mix_prob=0.5, seed=3, wire_format="int16",
               specaugment=SpecAugment(seed=7))
    x, lens = _audio((4, 32000), seed=5), [32000, 24000, 30000, 17000]
    cpu_feats, cpu_lens = OnDeviceAugmenter(**cfg, device="cpu")(x, lens)
    fbank_cuda.LAUNCHES = 0
    feats, feat_lens = OnDeviceAugmenter(**cfg, device=cuda)(x, lens)
    assert fbank_cuda.LAUNCHES == 1
    assert torch.equal(feat_lens.cpu(), cpu_lens)
    torch.testing.assert_close(feats.cpu(), cpu_feats, rtol=0, atol=FEATURE_TOL)


def test_aishell_fed_augmenter_on_card_matches_cpu(cuda, tmp_path):
    """An AISHELL layout of 8 utterances of 1-2 s through ``prepare_aishell``,
    in two batches of the 2 s x 4 bucket, into the augmenter on the card
    against the same augmenter on the CPU port."""
    from lhotse_tpu_torch.audio.wavio import write_wav
    from lhotse_tpu_torch.recipes import prepare_aishell

    data = tmp_path / "aishell" / "data_aishell"
    (data / "transcript").mkdir(parents=True)
    lines = []
    for i in range(8):
        part, spk = ("train", "train", "dev", "test")[i % 4], f"S{2 + i % 6:04d}"
        utt = f"BAC009{spk}W{i:04d}"
        (data / "wav" / part / spk).mkdir(parents=True, exist_ok=True)
        write_wav(data / "wav" / part / spk / f"{utt}.wav",
                  _audio((1, 16000 + 2000 * i), seed=40 + i), 16000)
        lines.append(f"{utt} 甚至 出现 交易 几乎 停滞 的 情况")
    (data / "transcript" / "aishell_transcript_v0.8.txt").write_text(
        "\n".join(lines) + "\n", encoding="utf-8")
    made = prepare_aishell(tmp_path / "aishell")
    recs = sorted((r for part in made.values() for r in part["recordings"]), key=lambda r: r.id)
    assert len(recs) == 8
    n = 4800
    rir = _audio((n,), seed=9) * np.exp(-np.arange(n) / (n / 6.0)).astype(np.float32)
    rir[32] = 1.0
    cfg = dict(buckets=[(2.0, 4)], speed_factor=1.1, noise_pool=_audio((4, 48000), seed=21),
               rir=rir, snr=(10, 20), mix_prob=0.5, seed=3, wire_format="int16",
               specaugment=SpecAugment(seed=7))
    cpu_aug, card_aug = OnDeviceAugmenter(**cfg, device="cpu"), OnDeviceAugmenter(**cfg, device=cuda)
    for i in (0, 4):
        audio = [r.load_audio()[0] for r in recs[i:i + 4]]
        lens = [len(a) for a in audio]
        x = np.zeros((4, max(lens)), np.float32)
        for k, a in enumerate(audio):
            x[k, : len(a)] = a
        cpu_feats, cpu_lens = cpu_aug(x, lens)
        fbank_cuda.LAUNCHES = 0
        feats, feat_lens = card_aug(x, lens)
        assert fbank_cuda.LAUNCHES == 1
        assert torch.equal(feat_lens.cpu(), cpu_lens)
        torch.testing.assert_close(feats.cpu(), cpu_feats, rtol=0, atol=FEATURE_TOL)


def test_zh_mux_fed_augmenter_on_card_matches_cpu(cuda, tmp_path):
    """A THCHS-30 layout (its splits as symbolic links into ``data``) and a
    KeSpeech layout of 4 utterances each through ``prepare_thchs_30`` and
    ``prepare_kespeech``, muxed by ``CutSet.mux``, in two batches of the
    2 s x 4 bucket, into the augmenter on the card against the same
    augmenter on the CPU port."""
    from lhotse_tpu_torch.audio.wavio import write_wav
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.recipes import prepare_kespeech, prepare_thchs_30

    data = tmp_path / "thchs" / "data_thchs30" / "data"
    data.mkdir(parents=True)
    task = tmp_path / "ke" / "Tasks" / "ASR" / "train_phase1"
    task.mkdir(parents=True)
    scp, text, dialect, spk = [], [], [], []
    for i in range(4):
        write_wav(data / f"A11_{i}.wav", _audio((1, 16000 + 3000 * i), seed=60 + i), 16000)
        (data / f"A11_{i}.wav.trn").write_text("绿 是 阳春\nlv4 shi4\nl v4\n", encoding="utf-8")
        split = data.parent / ("train", "train", "dev", "test")[i]
        split.mkdir(exist_ok=True)
        (split / f"A11_{i}.wav").symlink_to(f"../data/A11_{i}.wav")
        utt = f"1000{i}_7{i}"
        (tmp_path / "ke" / "Audio").mkdir(parents=True, exist_ok=True)
        write_wav(tmp_path / "ke" / "Audio" / f"{utt}.wav",
                  _audio((1, 18000 + 3000 * i), seed=70 + i), 16000)
        scp.append(f"{utt} Audio/{utt}.wav")
        text.append(f"{utt} <SPOKEN_NOISE>你好")
        dialect.append(f"{utt} Mandarin")
        spk.append(f"{utt} spk{i}")
    for name, lines in (("wav.scp", scp), ("text", text), ("utt2subdialect", dialect),
                        ("utt2spk", spk)):
        (task / name).write_text("\n".join(lines) + "\n", encoding="utf-8")
    sets = [CutSet.from_cuts(c for part in made.values() for c in CutSet.from_manifests(**part))
            for made in (prepare_thchs_30(tmp_path / "thchs"),
                         prepare_kespeech(tmp_path / "ke", dataset_parts=["train_phase1"]))]
    cuts = list(CutSet.mux(*sets, weights=[1, 1], seed=22))
    assert len(cuts) == 8
    n = 4800
    rir = _audio((n,), seed=9) * np.exp(-np.arange(n) / (n / 6.0)).astype(np.float32)
    rir[32] = 1.0
    cfg = dict(buckets=[(2.0, 4)], speed_factor=1.1, noise_pool=_audio((4, 48000), seed=21),
               rir=rir, snr=(10, 20), mix_prob=0.5, seed=3, wire_format="int16",
               specaugment=SpecAugment(seed=7))
    cpu_aug, card_aug = OnDeviceAugmenter(**cfg, device="cpu"), OnDeviceAugmenter(**cfg, device=cuda)
    for i in (0, 4):
        audio = [c.load_audio()[0] for c in cuts[i:i + 4]]
        lens = [len(a) for a in audio]
        x = np.zeros((4, max(lens)), np.float32)
        for k, a in enumerate(audio):
            x[k, : len(a)] = a
        cpu_feats, cpu_lens = cpu_aug(x, lens)
        fbank_cuda.LAUNCHES = 0
        feats, feat_lens = card_aug(x, lens)
        assert fbank_cuda.LAUNCHES == 1
        assert torch.equal(feat_lens.cpu(), cpu_lens)
        torch.testing.assert_close(feats.cpu(), cpu_feats, rtol=0, atol=FEATURE_TOL)



class _Float64Torch:
    """``torch`` for the port's chain modules with ``float32`` read as
    ``float64``: the same stages, in float64 (as tests/test_torch_host_loader.py)."""

    def __getattr__(self, name):
        return torch.float64 if name == "float32" else getattr(torch, name)


class _Float64Fbank:
    """The fbank kernel's function in float64, on the layer's float32 matrices."""

    frame_shift = 0.01

    def __init__(self):
        Mc, Ms, fb, _ = Wav2LogFilterBank(device="cpu")._fused_matrices()
        self.mats = [torch.as_tensor(m).double() for m in (Mc, Ms, fb)]

    def __call__(self, x):
        frames = fbank_cuda.edge_pad(x.double()).unfold(-1, 400, 160)
        Mc, Ms, fb = self.mats
        power = (frames @ Mc) ** 2 + (frames @ Ms) ** 2
        return torch.log(torch.clamp_min(power @ fb, ops.FLT_EPS))


def test_telephone_fed_augmenter_on_card_matches_cpu(cuda, tmp_path):
    """Two Switchboard-1 conversations of two-channel 8 kHz mu-law SPHERE
    with MS-State transcripts through ``prepare_switchboard``, trimmed to
    their supervisions (each side of a call its own channel) and resampled
    to 16 kHz, in two batches of the 2 s x 4 bucket, into the augmenter on
    the card against the same augmenter on the CPU port: within
    ``FEATURE_TOL`` in the mel bins below 4 kHz. Above 4 kHz the 8 kHz audio
    holds only the int16 wire's quantization floor (log mel -8 to -13),
    where the float32 audio stages' rounding shows: there each chain is held
    within 2e-3 of the same stages in float64 on the CPU. On an H100 the
    card's chain measured 1.03e-3 and 8.2e-4 from them on the two batches,
    the CPU's 5.4e-4 and 6.0e-4 (tests/test_torch_recipes_ldc.py holds the
    CPU port and JAX within 1e-3 there), the two chains 1.14e-3 apart, and
    3.1e-5 apart below 4 kHz."""
    from lhotse_tpu_torch.audio.sphio import write_sph
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.ops import augment, resample
    from lhotse_tpu_torch.recipes import prepare_switchboard

    audio_dir, trans = tmp_path / "swb1", tmp_path / "swb_ms98_transcriptions"
    audio_dir.mkdir()
    for k, conv in enumerate(("2001", "2005")):
        write_sph(audio_dir / f"sw0{conv}.sph", _audio((2, 4 * 8000), seed=50 + k), 8000,
                  coding="ulaw")
        for side in "AB":
            (trans / conv[:2] / conv).mkdir(parents=True, exist_ok=True)
            (trans / conv[:2] / conv / f"sw{conv}{side}-ms98-a-trans.text").write_text("".join(
                f"sw{conv}{side}-ms98-a-{i + 1:04d} {1.9 * i:.2f} {1.9 * i + 1.3:.2f} hello\n"
                for i in range(2)))
    made = prepare_switchboard(audio_dir, transcripts_dir=trans, absolute_paths=True)
    cuts = list(CutSet.from_manifests(**made).trim_to_supervisions(keep_overlapping=False)
                .resample(16000))
    assert len(cuts) == 8 and {c.channel for c in cuts} == {0, 1}
    fb = np.asarray(Wav2LogFilterBank(device="cpu")._fused_matrices()[2])
    band = fb[fb.shape[0] // 2:].max(axis=0) == 0  # the mel bins below 4 kHz
    n = 4800
    rir = _audio((n,), seed=9) * np.exp(-np.arange(n) / (n / 6.0)).astype(np.float32)
    rir[32] = 1.0
    cfg = dict(buckets=[(2.0, 4)], speed_factor=1.1, noise_pool=_audio((4, 48000), seed=21),
               rir=rir, snr=(10, 20), mix_prob=0.5, seed=3, wire_format="int16")
    spec = SpecAugment(seed=7)
    cpu_aug = OnDeviceAugmenter(**cfg, specaugment=spec, device="cpu")
    card_aug = OnDeviceAugmenter(**cfg, specaugment=spec, device=cuda)
    plain = OnDeviceAugmenter(**cfg, device="cpu", fbank=_Float64Fbank())
    for i in (0, 4):
        audio = [c.load_audio()[0] for c in cuts[i:i + 4]]
        lens = [len(a) for a in audio]
        x = np.zeros((4, max(lens)), np.float32)
        for k, a in enumerate(audio):
            x[k, : len(a)] = a
        staged = cpu_aug.stage(x, lens)
        cpu_feats, cpu_lens = cpu_aug.compute(staged)
        fbank_cuda.LAUNCHES = 0
        feats, feat_lens = card_aug(x, lens)
        assert fbank_cuda.LAUNCHES == 1
        assert torch.equal(feat_lens.cpu(), cpu_lens)
        feats = feats.cpu()
        torch.testing.assert_close(feats[..., band], cpu_feats[..., band], rtol=0,
                                   atol=FEATURE_TOL)
        conv_weight = resample._conv_weight
        saved = augment.torch, resample.torch, resample._conv_weight
        augment.torch = resample.torch = _Float64Torch()
        resample._conv_weight = lambda *a: conv_weight(*a).double()
        try:
            truth, _ = plain.compute(staged)
        finally:
            augment.torch, resample.torch, resample._conv_weight = saved
        # SpecAugment's masked cells are zero in both chains; the float64 stages have no masks.
        real = (torch.arange(truth.shape[1])[None, :] < cpu_lens[:, None])[..., None]
        kept = real & (feats != 0) & (cpu_feats != 0)
        for chain in (feats, cpu_feats):
            assert (chain.double() - truth).abs()[kept].max() <= 2e-3

def test_librimix_fed_augmenter_on_card_matches_cpu(cuda, tmp_path):
    """A Libri2Mix layout (``libri2mix_train-100.csv`` over 8 utterances of
    1-2 s and three WHAM! noises of 0.4-3 s, so that short noises are
    extended) through ``prepare_librimix``; its 8 noisy mixtures, loaded on
    the host, in two batches of the 2 s x 4 bucket into the augmenter on the
    card against the same augmenter on the CPU port."""
    from lhotse_tpu_torch.audio import Recording, RecordingSet
    from lhotse_tpu_torch.audio.wavio import write_wav
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.recipes import prepare_librimix

    names = [f"{100 + k}-{2000 + k}-{k:04d}" for k in range(8)]
    recs = []
    for k, name in enumerate(names):
        write_wav(tmp_path / f"{name}.wav", _audio((1, 16000 + 2000 * k), seed=60 + k), 16000)
        recs.append(Recording.from_file(tmp_path / f"{name}.wav"))
    (tmp_path / "ls").mkdir()
    CutSet.from_manifests(recordings=RecordingSet.from_recordings(recs)).to_file(
        tmp_path / "ls" / "librispeech_cutset_train-100.jsonl.gz")
    noises = []
    for k, n in enumerate((6400, 24000, 48000)):
        write_wav(tmp_path / f"noise{k}.wav", _audio((1, n), seed=70 + k), 16000)
        noises.append(Recording.from_file(tmp_path / f"noise{k}.wav"))
    (tmp_path / "wham").mkdir()
    for split in ("tr", "cv", "tt"):
        RecordingSet.from_recordings(noises).to_file(
            tmp_path / "wham" / f"wham_recordings_{split}.jsonl.gz")
    rows = ["mixture_ID,source_1_path,source_1_gain,source_2_path,source_2_gain,noise_path,"
            "noise_gain"]
    for k in range(8):
        a, b = names[k], names[(k + 3) % 8]
        rows.append(f"{a}_{b},x/{a}.wav,1.1,x/{b}.wav,0.9,tr/noise{k % 3}.wav,0.5")
    (tmp_path / "meta" / "Libri2Mix").mkdir(parents=True)
    (tmp_path / "meta" / "Libri2Mix" / "libri2mix_train-100.csv").write_text("\n".join(rows))
    made = prepare_librimix(tmp_path / "ls", tmp_path / "wham", tmp_path / "meta",
                            tmp_path / "work")
    cuts = list(made["libri2mix_train-100_noisy"]["cutset"])
    assert len(cuts) == 8 and len(list((tmp_path / "work").iterdir())) > 0
    n = 4800
    rir = _audio((n,), seed=9) * np.exp(-np.arange(n) / (n / 6.0)).astype(np.float32)
    rir[32] = 1.0
    cfg = dict(buckets=[(2.0, 4)], speed_factor=1.1, noise_pool=_audio((4, 48000), seed=21),
               rir=rir, snr=(10, 20), mix_prob=0.5, seed=3, wire_format="int16",
               specaugment=SpecAugment(seed=7))
    cpu_aug, card_aug = OnDeviceAugmenter(**cfg, device="cpu"), OnDeviceAugmenter(**cfg, device=cuda)
    for i in (0, 4):
        audio = [c.load_audio()[0] for c in cuts[i:i + 4]]
        lens = [len(a) for a in audio]
        x = np.zeros((4, max(lens)), np.float32)
        for k, a in enumerate(audio):
            x[k, : len(a)] = a
        cpu_feats, cpu_lens = cpu_aug(x, lens)
        fbank_cuda.LAUNCHES = 0
        feats, feat_lens = card_aug(x, lens)
        assert fbank_cuda.LAUNCHES == 1
        assert torch.equal(feat_lens.cpu(), cpu_lens)
        torch.testing.assert_close(feats.cpu(), cpu_feats, rtol=0, atol=FEATURE_TOL)


def test_global_mvn_and_randomized_smoothing_on_card(cuda, tmp_path):
    """``GlobalMVN.from_cuts`` with the fbank kernel against the CPU route's
    statistics, applied on the card in the features' dtype; and
    ``RandomizedSmoothing`` on a card batch ``torch.equal`` to the same
    transform's CPU result copied to the card (host draws, IEEE adds)."""
    from lhotse_tpu_torch import CutSet, Recording
    from lhotse_tpu_torch.audio.wavio import write_wav
    from lhotse_tpu_torch.dataset.signal_transforms import GlobalMVN, RandomizedSmoothing

    cuts = []
    for i in range(3):
        write_wav(tmp_path / f"m{i}.wav", _audio((8000 + 3000 * i,), seed=60 + i), 16000)
        cuts.append(Recording.from_file(tmp_path / f"m{i}.wav").to_cut())
    cuts = CutSet.from_cuts(cuts)
    fbank_cuda.LAUNCHES = 0
    mvn = GlobalMVN.from_cuts(cuts, extractor=extractors.Fbank(extractors.FbankConfig(device=cuda)))
    assert fbank_cuda.LAUNCHES == 3
    cpu_mvn = GlobalMVN.from_cuts(
        cuts, extractor=extractors.Fbank(extractors.FbankConfig(device="cpu")))
    np.testing.assert_allclose(mvn.norm_means, cpu_mvn.norm_means, rtol=0, atol=1e-5)
    np.testing.assert_allclose(mvn.norm_stds, cpu_mvn.norm_stds, rtol=0, atol=1e-5)
    feats = torch.from_numpy(_audio((2, 50, 80), seed=5) * 4)
    for dtype in (torch.float32, torch.bfloat16):
        on_card = mvn(feats.to(cuda, dtype))
        assert on_card.device.type == "cuda" and on_card.dtype == dtype
        torch.testing.assert_close(on_card.cpu(), mvn(feats.to(dtype)))
    audio = torch.from_numpy(_audio((4, 16000), seed=6))
    smoothed = RandomizedSmoothing(sigma=0.2, p=0.8, seed=3)(audio.to(cuda))
    expected = RandomizedSmoothing(sigma=0.2, p=0.8, seed=3)(audio)
    assert smoothed.device.type == "cuda" and torch.equal(smoothed, expected.to(cuda))
