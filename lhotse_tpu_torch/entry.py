"""
The single-card entry point of the port (counterpart of the JAX package's
``__graft_entry__.entry`` and ``_fbank_encode``): raw audio through the
80-mel log-fbank layer (the fbank kernel for a CUDA tensor) into the
Transformer encoder.

    fn, args = entry()            # on the card
    hidden, feat_lens = fn(*args)

The JAX package's multi-chip dry-run (``dryrun_multichip``) is not ported
yet: it also needs ``OnTheFlyFeatures`` and Shar, which the port's copy of
the host data layer does not have.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from lhotse_tpu_torch.features.kaldi.layers import Wav2LogFilterBank
from lhotse_tpu_torch.models.encoder import Encoder, EncoderConfig

# The JAX entry's encoder and example batch: 4 clips of 4 s.
ENTRY_CONFIG = EncoderConfig(num_layers=2, d_model=128, num_heads=4, ffn_dim=512)
ENTRY_BATCH, ENTRY_SAMPLES = 4, 16000 * 4


def fbank_encode(audio: torch.Tensor, audio_lens: torch.Tensor, encoder: Encoder,
                 fbank: Wav2LogFilterBank) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    (B, N) float32 audio → (B, T, d_model) hidden states and the (B,) frame
    counts ``(audio_lens + 80) // 160`` (the snip_edges=False rule), which
    mask the padding out of attention.
    """
    feats = fbank(audio)
    feat_lens = (audio_lens + 80) // 160
    return encoder(feats, feat_lens), feat_lens


def entry(device="cuda") -> Tuple[Callable, tuple]:
    """``(fbank_encode, (audio, audio_lens, encoder, fbank))`` on ``device``,
    at the JAX entry's configuration and example batch (numpy seed 0; the
    encoder's weights from a generator seeded with 0)."""
    rng = np.random.RandomState(0)
    audio = rng.randn(ENTRY_BATCH, ENTRY_SAMPLES).astype(np.float32) * 0.1
    lens = np.array([ENTRY_SAMPLES, ENTRY_SAMPLES - 400, ENTRY_SAMPLES, 32000], np.int64)
    encoder = Encoder(ENTRY_CONFIG, device=device)
    fbank = Wav2LogFilterBank(sampling_rate=16000, device=device)
    args = (torch.from_numpy(audio).to(device), torch.from_numpy(lens).to(device), encoder, fbank)
    return fbank_encode, args
