"""
The port's entry (lhotse_tpu_torch.entry) on the CPU against the JAX
package's ``__graft_entry__.entry()``: the same example audio and lengths,
the JAX encoder's weights copied in, ``jax.jit(_fbank_encode)`` against
``fbank_encode``.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).parent.parent))

import __graft_entry__ as ge  # noqa: E402
from lhotse_tpu.features.kaldi.layers import Wav2LogFilterBank as JaxFbank  # noqa: E402
from lhotse_tpu.models import encoder as J  # noqa: E402
from lhotse_tpu_torch import entry as E  # noqa: E402
from lhotse_tpu_torch.convert import encoder_state_from_jax  # noqa: E402
from lhotse_tpu_torch.models.encoder import Encoder  # noqa: E402

# bf16 hidden states after the final layer norm, as test_torch_encoder.py's
# forward bound; measured 4.7e-2 here (three bf16 roundings near 4, each
# 2**-5 apart on either side), so the float32 case below is the tight check
# of the fbank → encoder chain.
BF16_TOL = 5e-2
# Measured 2.7e-5, with the two packages' features up to 3.5e-4 apart (the
# JAX layer's CPU route in near-silent mel bins, see test_torch_layers.py).
F32_TOL = 1e-4


def test_fbank_encode_matches_jax_entry():
    jfn, (audio, audio_lens, params) = ge.entry()
    want = np.asarray(jax.jit(jfn)(audio, audio_lens, params), np.float32)
    fn, (p_audio, p_lens, encoder, fbank) = E.entry("cpu")
    assert np.array_equal(p_audio.numpy(), audio) and np.array_equal(p_lens.numpy(), audio_lens)
    encoder_state_from_jax(encoder, params)
    with torch.no_grad():
        hidden, feat_lens = fn(p_audio, p_lens, encoder, fbank)
    assert hidden.shape == want.shape == (4, 400, 128)
    assert hidden.dtype == torch.bfloat16
    assert np.abs(hidden.float().numpy() - want).max() <= BF16_TOL
    # The snip_edges=False frame counts, as the JAX entry computes them.
    assert feat_lens.tolist() == ((audio_lens + 80) // 160).tolist() == [400, 398, 400, 200]


def test_fbank_encode_matches_jax_entry_in_float32():
    """The same chain with a float32 encoder on both sides: JAX's fbank
    features and frame counts through ``forward`` against the port's
    ``fbank_encode``, on the entry's audio and copied weights."""
    _, (audio, audio_lens, params) = ge.entry()
    jcfg = J.EncoderConfig(num_layers=2, d_model=128, num_heads=4, ffn_dim=512, dtype=jnp.float32)
    feats = JaxFbank(sampling_rate=16000)(audio)
    want = np.asarray(jax.jit(lambda p, f, n: J.forward(p, f, n, jcfg))(
        params, feats, (audio_lens + 80) // 160))
    fn, (p_audio, p_lens, _, fbank) = E.entry("cpu")
    encoder = Encoder(dataclasses.replace(E.ENTRY_CONFIG, dtype=torch.float32), device="cpu")
    encoder_state_from_jax(encoder, params)
    with torch.no_grad():
        hidden, _ = fn(p_audio, p_lens, encoder, fbank)
    assert hidden.dtype == torch.float32 and hidden.shape == want.shape == (4, 400, 128)
    assert np.abs(hidden.numpy() - want).max() <= F32_TOL


def test_entry_is_the_jax_entry_config():
    cfg = E.ENTRY_CONFIG
    _, (_, _, params) = ge.entry()
    jcfg = {"d_model": params["input_proj"].shape[1], "num_layers": len(params["layers"]),
            "num_heads": params["layers"][0]["wqkv"].shape[2],
            "ffn_dim": params["layers"][0]["w1"].shape[1]}
    assert {k: getattr(cfg, k) for k in jcfg} == jcfg == {
        "d_model": 128, "num_layers": 2, "num_heads": 4, "ffn_dim": 512}
