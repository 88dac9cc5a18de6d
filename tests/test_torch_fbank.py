"""
The port's fbank math and fused-fbank wrappers (lhotse_tpu_torch.ops.fbank,
lhotse_tpu_torch.ops.fbank_cuda) against the JAX package's, on the CPU.

The same numpy arrays, made from a seed, go through the JAX function (CPU
backend; the Pallas kernel in interpret mode) and through the port with CPU
tensors, where the wrappers take the kernel's plain PyTorch version.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lhotse_tpu.ops import fbank as jops
from lhotse_tpu.ops import fbank_pallas as jpallas
from lhotse_tpu_torch.ops import fbank as tops
from lhotse_tpu_torch.ops import fbank_cuda

# The JAX package's own bound for the fused fbank (tests/test_fbank_pallas.py).
LOGMEL_TOL = 5e-5


def _bank(n_mels):
    mel, _ = jops.get_mel_banks(n_mels, 512, 16000, 20.0, -400.0)
    fb = np.zeros((257, n_mels), np.float32)
    fb[:256] = mel.T
    return fb


@pytest.fixture(scope="module")
def matrices():
    Mc, Ms = jops.dft_analysis_matrices(400, 512)
    return Mc, Ms, _bank(80)


# -- numpy builders: copies equal their originals -------------------------------

BUILDERS = [
    ("dft_analysis_matrices", (400, 512)),
    ("dft_analysis_matrices", (400, 512, "hamming", False, 0.0)),
    ("raw_dft_matrices", (512, 512)),
    ("get_mel_banks", (80, 512, 16000, 20.0, -400.0)),
    ("get_mel_banks", (23, 512, 8000, 0.0, 0.0)),
    ("create_mel_scale", (40, 512, 16000, 20.0, -400.0, True)),
    ("make_dct_matrix", (13, 23)),
    ("make_lifter", (13, 22)),
    ("make_lifter", (13, 0)),
    ("frame_preprocessing_matrix", (400, True, 0.97)),
] + [("create_frame_window", (400, w)) for w in jops.available_windows()]


@pytest.mark.parametrize("name,args", BUILDERS, ids=[f"{n}{a}" for n, a in BUILDERS])
def test_builder_copy_equals_original(name, args):
    ours, theirs = getattr(tops, name)(*args), getattr(jops, name)(*args)
    ours = ours if isinstance(ours, tuple) else (ours,)
    theirs = theirs if isinstance(theirs, tuple) else (theirs,)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(a, b)


# -- framing ---------------------------------------------------------------------


@pytest.mark.parametrize("n,left,right", [
    (10, 3, 4), (10, 0, 0), (5, 12, 0), (5, 0, 17), (3, 7, 9), (1, 4, 4)])
def test_symmetric_pad_matches_numpy(n, left, right):
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    ours = tops.symmetric_pad(torch.from_numpy(x), left, right).numpy()
    assert np.array_equal(ours, np.pad(x, ((0, 0), (left, right)), mode="symmetric"))


@pytest.mark.parametrize("frame,shift,n,snip", [
    (400, 160, 16000, False),
    (400, 160, 12345, False),
    (400, 160, 12345, True),
    (400, 160, 100, False),  # shorter than the 120-sample left pad
    (400, 160, 50, False),  # no frame at all
    (200, 160, 1000, False),  # npad_right < 0: pad left only, then cut
    (200, 160, 30, False),
])
def test_frame_signal_matches_jax(frame, shift, n, snip):
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    ours = tops.frame_signal(torch.from_numpy(x), frame, shift, snip).numpy()
    theirs = np.asarray(jops.frame_signal(jnp.asarray(x), frame, shift, snip))
    assert ours.shape == theirs.shape
    assert np.array_equal(ours, theirs)


# -- power and mel ops -------------------------------------------------------------


@pytest.fixture(scope="module")
def frames():
    return (0.05 * np.random.default_rng(7).standard_normal((2, 12, 400))).astype(np.float32)


def _close(ours, theirs, tol=1e-5):
    # fp32 sums of up to 512 terms in another order: 1e-5 relative and absolute.
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), rtol=tol, atol=tol)


@pytest.mark.parametrize("use_fft_mag", [False, True])
def test_power_spectrum_gemm(frames, use_fft_mag):
    Mc, Ms = jops.dft_analysis_matrices(400, 512)
    ours = tops.power_spectrum_gemm(
        torch.from_numpy(frames), torch.from_numpy(Mc), torch.from_numpy(Ms), use_fft_mag)
    _close(ours, jops.power_spectrum_gemm(jnp.asarray(frames), Mc, Ms, use_fft_mag))


@pytest.mark.parametrize("use_fft_mag", [False, True])
def test_power_spectrum_rfft(frames, use_fft_mag):
    w = jops.create_frame_window(400).astype(np.float32)
    ours = tops.power_spectrum_rfft(
        torch.from_numpy(frames), 512, torch.from_numpy(w), use_fft_mag=use_fft_mag)
    _close(ours, jops.power_spectrum_rfft(jnp.asarray(frames), 512, w, use_fft_mag=use_fft_mag))


def test_mel_and_mfcc(frames):
    Mc, Ms = jops.dft_analysis_matrices(400, 512)
    fb = _bank(23)
    ps = np.asarray(jops.power_spectrum_gemm(jnp.asarray(frames), Mc, Ms))
    ours = tops.mel_fbank_from_power(torch.from_numpy(ps), torch.from_numpy(fb))
    theirs = jops.mel_fbank_from_power(jnp.asarray(ps), fb)
    _close(ours, theirs)
    dct = jops.make_dct_matrix(13, 23).astype(np.float32)
    lifter = jops.make_lifter(13, 22).astype(np.float32)
    logmel = np.asarray(theirs)
    _close(tops.mfcc_from_logmel(torch.from_numpy(logmel), torch.from_numpy(dct),
                                 torch.from_numpy(lifter)),
           jops.mfcc_from_logmel(jnp.asarray(logmel), dct, lifter))
    _close(tops.mfcc_from_logmel(torch.from_numpy(logmel), torch.from_numpy(dct), None),
           jops.mfcc_from_logmel(jnp.asarray(logmel), dct, None))


@pytest.mark.parametrize("floor", [jops.EPSILON, 0.0, 1.0])
def test_frame_log_energy(frames, floor):
    _close(tops.frame_log_energy(torch.from_numpy(frames), floor),
           jops.frame_log_energy(jnp.asarray(frames), floor))


# -- the fused fbank: plain version against the JAX reference and kernel --------


def test_reference_fbank_matches_jax_reference_and_pallas(matrices):
    Mc, Ms, fb = matrices
    B, num_frames = 2, jpallas.BLOCK_T * 2
    N = num_frames * jpallas.HOP + jpallas.ROW
    audio = (0.1 * np.random.RandomState(0).randn(B, N)).astype(np.float32)
    cut = num_frames * jpallas.HOP + (jpallas.FRAME_LEN - jpallas.HOP)
    pallas = np.asarray(jpallas.fbank_pallas(jnp.asarray(audio), Mc, Ms, fb, interpret=True))
    jref = np.asarray(jpallas.reference_fbank(jnp.asarray(audio[:, :cut]), Mc, Ms, fb))
    ours = fbank_cuda.reference_fbank(
        torch.from_numpy(audio[:, :cut]), *fbank_cuda._squeeze_nyquist(Mc, Ms, fb)).numpy()
    assert ours.shape == (B, num_frames, 80)
    assert np.abs(ours - jref).max() <= LOGMEL_TOL
    assert np.abs(ours - pallas).max() <= LOGMEL_TOL
    # fbank_fused keeps the JAX package's (B, T * 160 + 640) input contract.
    fused = fbank_cuda.fbank_fused(torch.from_numpy(audio), Mc, Ms, fb).numpy()
    assert fused.shape == pallas.shape
    assert np.abs(fused - pallas).max() <= LOGMEL_TOL


def test_zero_padded_tail_matches_pallas(matrices):
    Mc, Ms, fb = matrices
    true_frames, num_frames = 100, jpallas.BLOCK_T
    real = (0.1 * np.random.RandomState(2).randn(
        1, true_frames * jpallas.HOP + jpallas.FRAME_LEN - jpallas.HOP)).astype(np.float32)
    audio = np.zeros((1, num_frames * jpallas.HOP + jpallas.ROW), np.float32)
    audio[:, : real.shape[1]] = real
    pallas = np.asarray(jpallas.fbank_pallas(jnp.asarray(audio), Mc, Ms, fb, interpret=True))
    ours = fbank_cuda.fbank_logmel(torch.from_numpy(real), Mc, Ms, fb).numpy()
    assert ours.shape == (1, true_frames, 80)
    assert np.abs(ours - pallas[:, :true_frames]).max() <= LOGMEL_TOL
    # The bucket-padded audio gives the same rows for the real frames.
    padded = fbank_cuda.fbank_fused(torch.from_numpy(audio), Mc, Ms, fb).numpy()
    assert np.abs(padded[:, :true_frames] - pallas[:, :true_frames]).max() <= LOGMEL_TOL


def test_23_mel_bank_matches_pallas():
    from lhotse_tpu.features.kaldi.layers import Wav2MFCC

    Mc, Ms, fb_lanes, n_mels = Wav2MFCC(sampling_rate=16000)._fused_matrices()
    assert n_mels == 23
    num_frames = jpallas.BLOCK_T
    audio = (0.1 * np.random.RandomState(5).randn(
        1, num_frames * jpallas.HOP + jpallas.ROW)).astype(np.float32)
    pallas = np.asarray(jpallas.fbank_pallas(
        jnp.asarray(audio), Mc, Ms, fb_lanes, interpret=True))[..., :n_mels]
    # The port takes the bank at its own width: no lane padding.
    ours = fbank_cuda.fbank_fused(torch.from_numpy(audio), Mc, Ms, fb_lanes[:, :n_mels]).numpy()
    assert ours.shape == (1, num_frames, 23)
    assert np.abs(ours - pallas).max() <= LOGMEL_TOL


@pytest.mark.parametrize("n", [16000, 12345, 300, 100])
@pytest.mark.parametrize("snip_edges", [False, True])
def test_fbank_fused_padded_matches_jax_frames(matrices, n, snip_edges):
    Mc, Ms, fb = matrices
    x = (0.1 * np.random.default_rng(n).standard_normal((2, n))).astype(np.float32)
    frames = jops.frame_signal(jnp.asarray(x), 400, 160, snip_edges)
    theirs = np.asarray(jops.mel_fbank_from_power(jops.power_spectrum_gemm(frames, Mc, Ms), fb))
    ours = fbank_cuda.fbank_fused_padded(torch.from_numpy(x), Mc, Ms, fb,
                                         snip_edges=snip_edges).numpy()
    assert ours.shape == theirs.shape
    # The same frames in float64 hold the port to the bound on every case.
    f = np.asarray(frames, np.float64)
    power = (f @ Mc.astype(np.float64)) ** 2 + (f @ Ms.astype(np.float64)) ** 2
    truth = np.log(np.maximum(power @ fb.astype(np.float64), tops.FLT_EPS))
    assert np.abs(ours - truth).max(initial=0.0) <= LOGMEL_TOL  # snip_edges=True, n < 400: no frame
    if not snip_edges:
        # Two float32 paths can differ by more than either differs from
        # float64 in a near-silent mel bin, where the DFT sums cancel: at
        # n=12345 with snip_edges=True the port is 1.3e-5 from float64, the
        # JAX GEMM path 6.6e-5. The snip_edges=False cases, the layers'
        # default, stay inside the bound against JAX directly.
        assert np.abs(ours - theirs).max() <= LOGMEL_TOL


@pytest.mark.parametrize("bins", [256, 128])
def test_pack_dft_layout(matrices, bins):
    """The kernel's packed operand: row k of quarter q is Mc[k, 64q:64q+64]
    then Ms[k, 64q:64q+64]."""
    Mc, Ms, _ = matrices
    Mc, Ms = torch.from_numpy(Mc[:, :bins].copy()), torch.from_numpy(Ms[:, :bins].copy())
    packed = fbank_cuda.pack_dft(Mc, Ms)
    assert packed.shape == (bins // 64, 400, 128) and packed.is_contiguous()
    for q in range(bins // 64):
        assert torch.equal(packed[q, :, :64], Mc[:, 64 * q:64 * q + 64])
        assert torch.equal(packed[q, :, 64:], Ms[:, 64 * q:64 * q + 64])


def test_nonzero_nyquist_row_raises(matrices):
    Mc, Ms, fb = matrices
    bad = fb.copy()
    bad[256, 0] = 1.0
    with pytest.raises(ValueError, match="Nyquist"):
        fbank_cuda.fbank_logmel(torch.zeros(1, 16000), Mc, Ms, bad)
    with pytest.raises(ValueError, match="bin count"):
        fbank_cuda._squeeze_nyquist(Mc[:, :200], Ms[:, :200], fb[:200])


def test_cpu_route_launches_no_kernel(matrices):
    Mc, Ms, fb = matrices
    before = fbank_cuda.LAUNCHES
    fbank_cuda.fbank_fused_padded(torch.zeros(1, 16000), Mc, Ms, fb)
    assert fbank_cuda.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA kernel"):
        fbank_cuda.fbank_cuda(torch.zeros(1, 16000), Mc, Ms, fb)
