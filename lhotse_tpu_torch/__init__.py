"""
PyTorch/CUDA port of :mod:`lhotse_tpu`: the host data path and the on-device
augment→fbank→encoder path.

The module paths and public names mirror the JAX package, so
``lhotse_tpu/ops/augment.py`` has its counterpart in
``lhotse_tpu_torch/ops/augment.py``. The port imports ``torch`` and numpy
only: never ``jax`` and never ``lhotse_tpu``. The host data layer it needs
(manifests, NIST SPHERE/WAV/FLAC/AIFF audio, ``CutSet``, ``DynamicBucketingSampler``,
``K2SpeechRecognitionDataset`` with ``AudioSamples``, ``DataLoader``, the
stored features, the host augmentation: recording transforms,
``PaddingCut``/``MixedCut`` and the cut transforms, Shar, and the recipe
path: ``RecordingSet``/``SupervisionSet``, ``CutSet.from_manifests``, the
trimming and windowing, ``SimpleCutSampler``/``BucketingSampler`` and the
LibriSpeech recipe, the multi-channel meeting path: ``MultiCut``, the
host ``DereverbWPE`` transform and the AMI recipe, and the extractors under
the reference's names: ``fbank``, ``mfcc``, ``spectrogram``, the kaldifeat,
Whisper and librosa fbanks, and the paired and remaining task datasets:
``CutPairsSampler``, speech translation, source separation, TTS with
``TokenCollater``, audio tagging and the unsupervised datasets, and Kaldi
data dirs with piped ``command`` audio sources) is copied function by
function from the JAX package's modules of the same
paths; a copied body that reaches a part not copied yet raises
``NotImplementedError``. The tests hold each copy to its original.

The command line, ``lhotse-tpu-torch`` (``python -m
lhotse_tpu_torch.bin.lhotse_tpu_torch``), mirrors the JAX package's over
the ported paths; it alone needs click.

The one hand-written kernel is the fused log-mel fbank
(:mod:`lhotse_tpu_torch.ops.fbank_cuda`, CUDA C++ in ``csrc/fbank.cu``),
built with ``nvcc`` at first use. A CPU tensor takes the kernel's plain
PyTorch version; a CUDA tensor launches the kernel or raises.

Data-parallel training runs one process per rank joined by
``torch.distributed``; the encoder's tensor-parallel placement is
``models.encoder.param_shardings`` over a ("data", "model")
``DeviceMesh``, and ``entry.dryrun_multichip(n)`` checks the whole
multi-rank step over ``n`` spawned gloo ranks on the CPU.
"""
