"""
The port's augmentation ops and augment→fbank pipeline
(lhotse_tpu_torch.ops.augment) against the JAX package's, on the CPU.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lhotse_tpu.dataset.signal_transforms import SpecAugment as JSpecAugment
from lhotse_tpu.ops import augment as ja
from lhotse_tpu_torch.dataset.signal_transforms import SpecAugment
from lhotse_tpu_torch.features.kaldi.layers import Wav2LogFilterBank
from lhotse_tpu_torch.ops import augment as ta

SR = 16000


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    audio = (0.1 * rng.standard_normal((3, 4000))).astype(np.float32)
    noise = (0.05 * rng.standard_normal((3, 5000))).astype(np.float32)
    return {
        "audio": audio,
        "lens": np.array([4000, 2500, 3100], np.int64),
        "noise": noise,
        "noise_lens": np.array([5000, 3000, 1200], np.int64),
        "snr": np.array([10.0, 15.0, 20.0], np.float32),
        "offsets": np.array([0, 700, 3900], np.int64),
        "mix_mask": np.array([1.0, 0.0, 1.0], np.float32),
    }


def test_valid_mask_and_masked_energy(batch):
    lens = batch["lens"]
    assert np.array_equal(_np(ta.valid_mask(_t(lens), 4000)), np.asarray(ja.valid_mask(lens, 4000)))
    for lens_ in (lens, None):
        np.testing.assert_allclose(
            _np(ta.masked_energy(_t(batch["audio"]), None if lens_ is None else _t(lens_))),
            np.asarray(ja.masked_energy(batch["audio"], lens_)), rtol=1e-6, atol=0)


def test_snr_mix_gain_and_zero_energy_fallback():
    ref = np.array([1.0, 0.0, 2.0, 0.5], np.float32)
    noise = np.array([0.5, 1.0, 0.0, 2.0], np.float32)
    snr = np.array([10.0, 5.0, 0.0, -3.0], np.float32)
    ours = _np(ta.snr_mix_gain(_t(ref), _t(noise), _t(snr)))
    np.testing.assert_allclose(ours, np.asarray(ja.snr_mix_gain(ref, noise, snr)), rtol=1e-6)
    assert ours[1] == ours[2] == 1.0
    np.testing.assert_allclose(_np(ta.snr_mix_gain(_t(ref), _t(noise), 12.0)),
                               np.asarray(ja.snr_mix_gain(ref, noise, 12.0)), rtol=1e-6)


def test_place_at_offsets(batch):
    ours = ta.place_at_offsets(_t(batch["noise"]), _t(batch["noise_lens"]), _t(batch["offsets"]),
                               4000)
    theirs = ja.place_at_offsets(batch["noise"], batch["noise_lens"], batch["offsets"], 4000)
    assert np.array_equal(_np(ours), np.asarray(theirs))


MIX_CASES = {
    "plain": dict(),
    "noise_lens": dict(noise_lens=True),
    "offsets_and_mask": dict(noise_lens=True, offsets=True, mix_mask=True),
    "offsets_no_lens": dict(offsets=True),
    "short_noise": dict(short=True),
    "reference_energy": dict(reference_energy=True, mix_mask=True),
}


@pytest.mark.parametrize("case", MIX_CASES)
def test_mix_noise_matches_jax(batch, case):
    opts = MIX_CASES[case]
    noise = batch["noise"][:, :3000] if opts.get("short") else batch["noise"]
    kw = {
        "noise_lens": batch["noise_lens"] if opts.get("noise_lens") else None,
        "offsets": batch["offsets"] if opts.get("offsets") else None,
        "mix_mask": batch["mix_mask"] if opts.get("mix_mask") else None,
        "reference_energy": (np.array([0.01, 0.02, 0.0], np.float32)
                             if opts.get("reference_energy") else None),
    }
    theirs = np.asarray(ja.mix_noise(batch["audio"], batch["lens"], noise, snr=batch["snr"], **kw))
    ours = ta.mix_noise(_t(batch["audio"]), _t(batch["lens"]), _t(noise), snr=_t(batch["snr"]),
                        **{k: None if v is None else _t(v) for k, v in kw.items()})
    np.testing.assert_allclose(_np(ours), theirs, rtol=0, atol=1e-5)


def _rir(L=600, seed=1):
    rng = np.random.default_rng(seed)
    rir = (rng.standard_normal(L) * np.exp(-np.arange(L) / 80.0)).astype(np.float32)
    rir[7] = 2.0
    return rir


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("kind", ["static", "dynamic_shared", "dynamic_batched"])
def test_reverb_rir_matches_jax(batch, normalize, kind):
    audio, lens = batch["audio"], batch["lens"]
    rir_lens = None
    if kind == "static":  # a 1-D numpy RIR: the peak is found on the host
        rir_j = rir_t = _rir()
    elif kind == "dynamic_shared":  # a device RIR: argmax + gather
        rir_j, rir_t = jnp.asarray(_rir()), _t(_rir())
    else:
        rirs = np.stack([_rir(seed=s) for s in range(3)])
        rirs[1, 400:] = 0.0
        rir_lens = np.array([600, 400, 550], np.int64)
        rir_j, rir_t = rirs, _t(rirs)
    theirs = np.asarray(ja.reverb_rir(audio, rir_j, audio_lens=lens, rir_lens=rir_lens,
                                      normalize=normalize))
    ours = ta.reverb_rir(_t(audio), rir_t, audio_lens=_t(lens),
                         rir_lens=None if rir_lens is None else _t(rir_lens), normalize=normalize)
    # FFT convolution: pocketfft in both, transforms of another length order.
    np.testing.assert_allclose(_np(ours), theirs, rtol=0, atol=2e-5)


def test_apply_specaugment_matches_jax():
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((3, 200, 40)).astype(np.float32)
    warp, tmask, fmask = JSpecAugment(seed=3, p=1.0, time_warp_factor=20).draw_batch(3, 200, 40)
    warp = warp.astype(np.float32)
    theirs = np.asarray(ja.apply_specaugment(jnp.asarray(feats), warp, tmask, fmask))
    ours = ta.apply_specaugment(_t(feats), _t(warp), _t(tmask), _t(fmask))
    # The mask fill value is a mean over the batch row: another sum order.
    np.testing.assert_allclose(_np(ours), theirs, rtol=0, atol=1e-6)
    assert np.abs(theirs - feats).max() > 1e-3  # the draw did something


def test_specaugment_call_applies_on_tensor():
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((2, 300, 80)).astype(np.float32)
    ours = SpecAugment(seed=7, p=1.0)(_t(feats))
    theirs = np.asarray(JSpecAugment(seed=7, p=1.0)(jnp.asarray(feats)))
    assert isinstance(ours, torch.Tensor) and ours.shape == feats.shape
    np.testing.assert_allclose(_np(ours), theirs, rtol=0, atol=1e-6)


@pytest.mark.parametrize("supervised", [False, True])
def test_specaugment_draws_bit_identical(supervised):
    for b, t, f in [(4, 300, 80), (2, 50, 23)]:
        segs = np.array([[0, 10, t - 20], [1, 0, t]]) if supervised else None
        ours = SpecAugment(seed=11).draw_batch(b, t, f, supervision_segments=segs)
        theirs = JSpecAugment(seed=11).draw_batch(b, t, f, supervision_segments=segs)
        for a, c in zip(ours, theirs):
            assert a.dtype == c.dtype and np.array_equal(a, c)


def test_resolve_fbank_layer():
    assert isinstance(ta.resolve_fbank_layer(None, SR, "cpu"), Wav2LogFilterBank)
    layer = Wav2LogFilterBank(num_filters=40, device="cpu")
    assert ta.resolve_fbank_layer(layer, SR, "cpu") is layer
    with pytest.raises(ValueError, match="layer"):
        ta.resolve_fbank_layer(42, SR, "cpu")


class _JaxKernelRoute:
    """The default JAX fbank layer's kernel route (what the JAX pipeline
    computes on a TPU) in the JAX package's own XLA ops: symmetric-padded
    frames through the folded matrices, power, mel, log. On the CPU the JAX
    layer takes its explicit-preprocessing route instead, which is up to
    2.4e-4 from a float64 computation in near-silent low mel bins
    (tests/test_torch_layers.py); the port takes the kernel route on every
    device, so this is the like-for-like reference."""

    frame_shift = 0.01

    def __init__(self):
        from lhotse_tpu.features.kaldi.layers import Wav2LogFilterBank as JLayer

        self.Mc, self.Ms, self.fb, _ = JLayer()._fused_matrices()

    def __call__(self, x):
        from lhotse_tpu.ops import fbank as jops

        frames = jops.frame_signal(x, 400, 160, snip_edges=False)
        return jops.mel_fbank_from_power(jops.power_spectrum_gemm(frames, self.Mc, self.Ms), self.fb)


@pytest.mark.parametrize("wire_format", ["float32", "int16"])
@pytest.mark.parametrize("per_call_rir", [False, True])
def test_full_chain_matches_jax(wire_format, per_call_rir):
    from lhotse_tpu.ops.wire import encode_wire

    rng = np.random.default_rng(9)
    B, T = 3, SR
    audio = (0.1 * rng.standard_normal((B, T))).astype(np.float32)
    lens = np.array([T, 12000, 9000], np.int64)
    audio[1, 12000:] = 0.0
    audio[2, 9000:] = 0.0
    rir = _rir()
    t_p = (T * 10 + 10) // 11
    n_frames = (t_p + 80) // 160
    warp, tmask, fmask = JSpecAugment(seed=2, p=1.0).draw_batch(B, n_frames, 80)
    kwargs = {
        "gains": np.array([0.9, 1.05, 1.1], np.float32),
        "noise": (0.05 * rng.standard_normal((B, t_p))).astype(np.float32),
        "snr": np.array([10.0, 12.0, 18.0], np.float32),
        "mix_mask": np.array([1.0, 1.0, 0.0], np.float32),
        "warp_src": warp.astype(np.float32),
        "time_mask": tmask,
        "freq_mask": fmask,
    }
    build = dict(sampling_rate=SR, speed_factor=1.1, wire_format=wire_format,
                 rir=None if per_call_rir else rir)
    wire = encode_wire(audio, wire_format)
    call_rir = {"rir": rir} if per_call_rir else {}
    jfeats, jlens = ja.make_augment_fbank_pipeline(**build, fbank=_JaxKernelRoute())(
        wire, lens, **kwargs, **call_rir)
    pipe = ta.make_augment_fbank_pipeline(**build, device="cpu")
    feats, feat_lens = pipe(
        _t(wire), _t(lens), **{k: _t(v) for k, v in kwargs.items()},
        **{k: _t(v) for k, v in call_rir.items()})
    assert tuple(feats.shape) == np.asarray(jfeats).shape == (B, n_frames, 80)
    assert np.array_equal(_np(feat_lens), np.asarray(jlens))
    # The feature parity budget (BASELINE.md).
    np.testing.assert_allclose(_np(feats), np.asarray(jfeats), rtol=0, atol=1e-4)
    # Numpy inputs are accepted and copied to the device too. (A per-call
    # numpy RIR would take the static-peak path: keep the tensor one.)
    feats_np, _ = pipe(wire, lens, **kwargs, **{k: _t(v) for k, v in call_rir.items()})
    assert torch.equal(feats_np, feats)
