"""
The port on a CUDA card: the fbank kernel against its plain PyTorch version,
and the layers and augmenter on the card against the same port on the CPU.

Every test here needs a card and skips without one. The file imports
neither jax nor lhotse_tpu, so on the machine with the card (which has no
JAX) it runs without the test suite's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider
"""
import numpy as np
import pytest
import torch

from lhotse_tpu_torch.dataset.device_augment import OnDeviceAugmenter
from lhotse_tpu_torch.dataset.signal_transforms import SpecAugment
from lhotse_tpu_torch.features.kaldi.layers import Wav2LogFilterBank, Wav2MFCC
from lhotse_tpu_torch.ops import fbank as ops
from lhotse_tpu_torch.ops import fbank_cuda

pytestmark = pytest.mark.cuda

LOGMEL_TOL = 5e-5  # the JAX package's own bound for the fused fbank
FEATURE_TOL = 1e-4  # the feature parity budget (BASELINE.md)


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


@pytest.mark.parametrize("B,T,n_mels", [(1, 100, 23), (3, 1001, 80), (16, 1364, 80), (2, 1, 80)])
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


def test_kernel_wrapper_refuses_what_it_cannot_take(cuda):
    Mc, Ms = ops.dft_analysis_matrices(400, 512)
    x = torch.zeros(2, 16000, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        fbank_cuda.fbank_cuda(x.double(), Mc, Ms, _bank(80))
    with pytest.raises(ValueError, match="unit time stride"):
        fbank_cuda.fbank_cuda(torch.zeros(16000, 2, device=cuda).t(), Mc, Ms, _bank(80))
    with pytest.raises(ValueError, match="mel filters"):
        fbank_cuda.fbank_cuda(x, Mc, Ms, np.zeros((257, 200), np.float32))
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
