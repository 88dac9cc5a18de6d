"""
Batch visualization (copied from ``lhotse_tpu/dataset/vis.py``):
``plot_batch`` draws a batch's features or waveforms with its supervision
spans. Needs matplotlib, imported at call time.
"""
from typing import Any, Mapping

import numpy as np


def plot_batch(batch: Mapping[str, Any], supervisions: bool = True, text=True):
    import matplotlib.pyplot as plt

    batch_size = _get_one_of(batch, "features", "audio", "inputs").shape[0]
    fig, axes = plt.subplots(batch_size, figsize=(16, batch_size), sharex=True)
    if batch_size == 1:
        axes = [axes]

    def _plot_features(key):
        feats = batch[key]
        feat_actors = []
        for idx in range(batch_size):
            feat_actors.append(axes[idx].imshow(np.asarray(feats[idx]).transpose()))
            axes[idx].invert_yaxis()
        fig.tight_layout(h_pad=2)
        fig.colorbar(feat_actors[-1], ax=axes)

    if "features" in batch:
        _plot_features(key="features")

    if "audio" in batch:
        # Waveform view.
        audio = np.asarray(batch["audio"])
        for idx in range(batch_size):
            wave = audio[idx]
            if wave.ndim == 2:  # (channels, samples): overlay channels
                for ch in wave:
                    axes[idx].plot(ch, linewidth=0.5)
            else:
                axes[idx].plot(wave, linewidth=0.5)
            axes[idx].set_ylim(-1.05, 1.05)
        fig.tight_layout(h_pad=2)

    if "inputs" in batch:
        if len(batch["inputs"].shape) == 3:
            _plot_features(key="inputs")
        else:
            raise NotImplementedError(
                "We could not infer what does the key 'inputs' represent yet."
            )

    if supervisions and "supervisions" in batch:
        sups = batch["supervisions"]
        for idx in range(len(sups["sequence_idx"])):
            seq_idx = int(sups["sequence_idx"][idx])
            if all(k in sups for k in ("start_frame", "num_frames")):
                start, end = (
                    sups["start_frame"][idx], sups["start_frame"][idx] + sups["num_frames"][idx])
            elif all(k in sups for k in ("start_sample", "num_samples")):
                start, end = (
                    sups["start_sample"][idx], sups["start_sample"][idx] + sups["num_samples"][idx])
            else:
                raise ValueError(
                    "Cannot plot supervisions: missing 'start_frame/sample' and "
                    "'num_frames/samples' fields."
                )
            axes[seq_idx].axvspan(
                start, end, fill=False, edgecolor="red", linestyle="--", linewidth=4)
            if text and "text" in sups:
                # Place the label just inside the top of whatever axis this
                # is (feature panels span mel bins, waveforms span [-1, 1]).
                y = axes[seq_idx].get_ylim()[1] * 0.9
                axes[seq_idx].text(start, y, sups["text"][idx])
    return fig


def _get_one_of(d, *keys):
    for k in keys:
        if k in d:
            return d[k]
