"""
Fused log-mel fbank: the hand-written CUDA kernel of ``csrc/fbank.cu`` and
its plain PyTorch version (port of ``lhotse_tpu/ops/fbank_pallas.py``).

Frame i of a (B, N) batch is samples [160 i, 160 i + 400). The kernel folds
framing → (preprocessing-folded) DFT → power spectrum → mel product →
eps-floored log into one launch; the frames matrix never reaches device
memory. It takes raw audio of any length N >= 400 and masks its own ragged
frame tail, so the TPU layout of the JAX package (the 640-sample row view,
the four phase-shifted DFT copies and the ``BLOCK_T`` frame buckets) has no
counterpart here.

Dispatch is by the tensor's device and nothing else: a CPU tensor takes
:func:`reference_fbank`, a CUDA tensor launches the kernel
(:func:`fbank_cuda`) or raises. There is no silent fallback. ``LAUNCHES``
counts the kernel's launches, so a run can show that it went through it.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from lhotse_tpu_torch import _build
from lhotse_tpu_torch.ops import fbank as ops

FRAME_LEN = 400
HOP = 160
# fbank_fused's input contract, kept from the JAX package: num_frames * HOP + ROW samples.
ROW = 640
FLT_EPS = ops.FLT_EPS
QUARTER = 64  # bins per block of the kernel; a cluster of bins // 64 blocks per frame tile

LAUNCHES = 0  # kernel launches; fbank_cuda adds one per launch


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fbank")
    lib.fbank_logmel_f32.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    lib.fbank_logmel_f32.restype = ctypes.c_int
    lib.fbank_logmel_max_mels.argtypes = []
    lib.fbank_logmel_max_mels.restype = ctypes.c_int
    return lib


def _as_f32(m, device: torch.device) -> torch.Tensor:
    if isinstance(m, np.ndarray):
        m = torch.from_numpy(np.ascontiguousarray(m, dtype=np.float32))
    return m.to(device=device, dtype=torch.float32)


def _squeeze_nyquist(Mc, Ms, mel_fb):
    """Drop the Nyquist bin (zero mel row by construction) -> 256-bin products."""
    bins = Mc.shape[1]
    if bins == 257:
        if mel_fb[256].any():
            raise ValueError("The fbank kernel requires a zero Nyquist mel row (257-bin input).")
        return Mc[:, :256], Ms[:, :256], mel_fb[:256]
    if bins % 128 == 0:
        return Mc, Ms, mel_fb
    raise ValueError(f"Unsupported spectrum bin count for the fbank kernel: {bins}")


def pack_dft(Mc: torch.Tensor, Ms: torch.Tensor) -> torch.Tensor:
    """The kernel's layout of the DFT operand: (400, bins) ``Mc`` and ``Ms``
    -> (bins // 64, 400, 128), where row k of quarter q holds
    ``Mc[k, 64q:64q+64]`` then ``Ms[k, 64q:64q+64]``. Sixteen rows of a
    quarter are then one contiguous 8 KB bulk copy."""
    K, bins = Mc.shape
    parts = [m.reshape(K, bins // QUARTER, QUARTER) for m in (Mc, Ms)]
    return torch.cat(parts, dim=2).transpose(0, 1).contiguous()


def reference_fbank(audio: torch.Tensor, Mc, Ms, mel_fb, eps: float = FLT_EPS) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: snip-edges frames
    as an ``unfold`` view, the two DFT products, power, the mel product and
    the log. (B, N) -> (B, (N - 400) // 160 + 1, n_mels)."""
    Mc, Ms, mel_fb = (_as_f32(m, audio.device) for m in (Mc, Ms, mel_fb))
    frames = ops.frame_signal(audio, FRAME_LEN, HOP, snip_edges=True)
    ps = ops.power_spectrum_gemm(frames, Mc, Ms)
    return torch.log(torch.clamp_min(torch.matmul(ps, mel_fb), eps))


def fbank_cuda(audio: torch.Tensor, Mc, Ms, mel_fb, *, eps: float = FLT_EPS,
               dft: torch.Tensor = None) -> torch.Tensor:
    """
    Launch the fused kernel on ``torch.cuda.current_stream()``.

    :param audio: (B, N) float32 CUDA tensor with unit stride along time;
        every snip-edges frame, ``(N - 400) // 160 + 1`` of them, is computed.
    :param Mc/Ms: (400, bins) folded DFT analysis matrices (bins = 257 with a
        zero-Nyquist mel row, or 128 or 256).
    :param mel_fb: (bins, n_mels) mel filterbank, n_mels up to
        ``fbank_logmel_max_mels()`` (8192).
    :param dft: ``pack_dft`` of the 128- or 256-bin ``Mc``/``Ms``, as the
        layers hold it; packed here when not given.
    :return: (B, num_frames, n_mels) float32 log-mel features.
    """
    global LAUNCHES
    if audio.device.type != "cuda":
        raise ValueError(f"fbank_cuda launches a CUDA kernel; got a tensor on {audio.device}.")
    device = audio.device
    Mc, Ms, mel_fb = _squeeze_nyquist(*(_as_f32(m, device) for m in (Mc, Ms, mel_fb)))
    Mc, Ms, mel_fb = Mc.contiguous(), Ms.contiguous(), mel_fb.contiguous()
    lib = _lib()
    if audio.dtype != torch.float32 or audio.dim() != 2 or audio.stride(1) != 1:
        raise ValueError(
            f"audio must be a (B, N) float32 tensor with unit time stride; got "
            f"{tuple(audio.shape)} {audio.dtype} strides {audio.stride()}.")
    B, N = audio.shape
    bins = Mc.shape[1]
    n_mels = mel_fb.shape[1]
    if Mc.shape != (FRAME_LEN, bins) or Ms.shape != Mc.shape or mel_fb.shape[0] != bins:
        raise ValueError(
            f"Mc/Ms must be ({FRAME_LEN}, bins) and mel_fb (bins, n_mels); got "
            f"{tuple(Mc.shape)}, {tuple(Ms.shape)}, {tuple(mel_fb.shape)}.")
    if bins not in (2 * QUARTER, 4 * QUARTER):
        raise ValueError(f"The fbank kernel takes 128 or 256 bins; got {bins}.")
    if not 1 <= n_mels <= lib.fbank_logmel_max_mels():
        raise ValueError(
            f"The fbank kernel takes 1..{lib.fbank_logmel_max_mels()} mel filters; got {n_mels}.")
    if not 1 <= B <= 65535:
        raise ValueError(f"The fbank kernel takes 1..65535 utterances per launch; got {B}.")
    if dft is None:
        dft = pack_dft(Mc, Ms)
    if (dft.shape != (bins // QUARTER, FRAME_LEN, 2 * QUARTER) or dft.dtype != torch.float32
            or dft.device != device or not dft.is_contiguous() or dft.data_ptr() % 16):
        raise ValueError(
            f"dft must be pack_dft(Mc, Ms): a contiguous, 16-byte aligned float32 "
            f"({bins // QUARTER}, {FRAME_LEN}, {2 * QUARTER}) tensor on {device}.")
    num_frames = (N - FRAME_LEN) // HOP + 1 if N >= FRAME_LEN else 0
    out = torch.empty((B, num_frames, n_mels), dtype=torch.float32, device=device)
    if num_frames == 0:
        return out
    with torch.cuda.device(device):
        err = lib.fbank_logmel_f32(
            audio.data_ptr(), dft.data_ptr(), mel_fb.data_ptr(), out.data_ptr(),
            B, N, audio.stride(0), num_frames, bins, n_mels, eps,
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fbank kernel launch failed with CUDA error {err}.")
    LAUNCHES += 1
    return out


def fbank_logmel(audio: torch.Tensor, Mc, Ms, mel_fb, *, eps: float = FLT_EPS,
                 dft: torch.Tensor = None) -> torch.Tensor:
    """Log-mel of every snip-edges frame of (B, N) audio: the kernel for a
    CUDA tensor (``dft`` as in :func:`fbank_cuda`), the plain version for a
    CPU tensor."""
    if audio.device.type == "cuda":
        return fbank_cuda(audio, Mc, Ms, mel_fb, eps=eps, dft=dft)
    if audio.device.type == "cpu":
        Mc, Ms, mel_fb = _squeeze_nyquist(*(_as_f32(m, audio.device) for m in (Mc, Ms, mel_fb)))
        return reference_fbank(audio, Mc, Ms, mel_fb, eps=eps)
    raise ValueError(f"No fbank route for a tensor on {audio.device}.")


def edge_pad(x: torch.Tensor, snip_edges: bool = False) -> torch.Tensor:
    """The snip_edges=False symmetric edge padding of ``ops.frame_signal``:
    (B, N) -> (B, (T - 1) * 160 + 400) with T = (N + 80) // 160, so that the
    snip-edges frames of the result are the frames of ``x``. With
    ``snip_edges`` the audio is returned as it is."""
    if snip_edges:
        return x
    N = x.shape[-1]
    num_frames = (N + HOP // 2) // HOP
    new_n = (num_frames - 1) * HOP + FRAME_LEN
    npad_left = (FRAME_LEN - HOP) // 2
    npad_right = new_n - N - npad_left
    if npad_right >= 0:
        return ops.symmetric_pad(x, npad_left, npad_right)
    return ops.symmetric_pad(x, npad_left, 0)[:, :new_n]


def fbank_fused_padded(
    x: torch.Tensor, Mc, Ms, mel_fb, *, snip_edges: bool = False, eps: float = FLT_EPS,
    dft: torch.Tensor = None,
) -> torch.Tensor:
    """Fused fbank over raw (B, N) audio with the frame count of
    ``ops.frame_signal``: the snip_edges=False edge padding, then
    :func:`fbank_logmel`."""
    return fbank_logmel(edge_pad(x, snip_edges), Mc, Ms, mel_fb, eps=eps, dft=dft)


def fbank_fused(audio: torch.Tensor, Mc, Ms, mel_fb, *, eps: float = FLT_EPS) -> torch.Tensor:
    """Fused fbank over the JAX package's padded contract: (B, T * 160 + 640)
    audio -> (B, T, n_mels); the trailing samples past frame T - 1 are not read."""
    num_frames = (audio.shape[1] - ROW) // HOP
    return fbank_logmel(audio[:, : num_frames * HOP + (FRAME_LEN - HOP)], Mc, Ms, mel_fb, eps=eps)
