"""
Smoke run of the PyTorch port on one CUDA card: builds the fbank kernel
and the host C libraries (FLAC, the ``dsp`` wire encoders, the LTC1 feature
codec) from this checkout, holds the kernel against its plain PyTorch
version, drives the on-device augment→fbank path through
``OnDeviceAugmenter`` at the 15 s × 256 bucket with the int16 and the
adpcm4 wire (the C encoder's bytes against the numpy encoder's), through
the device sample cache over two epochs fed by ``transfer_stream``, and
through the ``Fbank`` and ``Mfcc`` extractors on the card; then the model
path (int16 audio → the augmenter → ``Encoder(EncoderConfig())`` in bf16:
a forward at 15 s × 64, 20 AdamW steps and one SGD step at 15 s × 32, both
batches' features held against the chain with the kernel's plain version),
the ``entry()`` fbank→encoder entry (its fbank layer against the plain
version, its output against the CPU port), WPE of a 2-channel 10 s signal
against the CPU port, the host data path into the trainer step (a
160-recording FLAC corpus through ``CutSet.from_jsonl_lazy``,
``DynamicBucketingSampler``, ``K2SpeechRecognitionDataset`` and
``DataLoader`` into the augmenter and an AdamW step of
``Encoder(EncoderConfig())``, with a mid-epoch resume, and the same over
the device sample cache), and the precomputed-features path on the same
corpus (``compute_and_store_features_batch`` on the kernel into a
``lilcom_chunky`` archive, that archive through
``K2SpeechRecognitionDataset()`` into the AdamW step, and
``OnTheFlyFeatures`` on the kernel into the step); then the augmented
training path (the corpus speed-perturbed and mixed with a 4 x 10 s FLAC
noise pool through ``OnTheFlyFeatures`` on the kernel into the AdamW step
for two epochs, and ``CutMix`` on the stored features, the noise pool's
features extracted on the kernel into the same archive); then the Shar
corpus path (phase 11's manifest exported to Shar shards with their
``.idx`` files; the streaming reader split across the two worker processes
of a ``torch.utils.data.DataLoader`` through ``IterableDatasetWrapper``,
the kernel on each batch in this process, into the AdamW step for two
epochs; the indexed reader, shuffled, through ``OnTheFlyFeatures`` on the
kernel, with a mid-epoch resume through the seek backend; the stored
features from the shards into the step); then the recipe path (a
LibriSpeech-layout corpus directory through ``prepare_librispeech``,
``fix_manifests`` and the lazy ``CutSet.from_manifests`` into
``SimpleCutSampler`` and ``OnTheFlyFeatures`` on the kernel, into the
AdamW step, with a mid-epoch resume; long-form sessions with RTTM turns
extracted whole on the kernel, trimmed to their supervisions and read back
in part from the archive through ``BucketingSampler``, and cut into 10 s
windows through ``OnTheFlyFeatures`` on the kernel); then the
multi-channel meeting path (an AMI-layout corpus of four 240 s meetings
with an 8-channel array and 4 headsets through ``prepare_ami``: whole
8-channel sessions extracted on the kernel into a ``lilcom_chunky``
archive, the array segments trimmed with ``keep_all_channels=True`` and
split by ``to_mono()`` into ``OnTheFlyFeatures`` on the kernel and the
AdamW step, the headsets trimmed to each speaker's channel likewise, the
host WPE over 8-channel segments and a multi-channel RIR fan-out through
the kernel); then the data-parallel path (two ranks in processes of their
own on the one card, joined by gloo, each over its partition of the e2e
corpus's sampler through ``OnTheFlyFeatures`` on the kernel into the AdamW
step, the gradients averaged by ``all_reduce`` and the parameters held
``torch.equal`` across the ranks after every step; and
``dryrun_multichip(4)``, the tensor-parallel dry-run over 4 CPU ranks);
the extractors under the reference's names on the card beside the Kaldi
ones; then the signal-effects and multi-source, multi-talker training path
on the meeting corpus (its supervision groups through ``K2SurtDataset``,
its 15 s windows through ``VadDataset`` and, their features extracted on
the kernel into an archive, through ``DiarizationDataset``; the headset
cuts loudness-normalised and the single-microphone cuts narrowbanded
through ``ZipSampler``, ``RoundRobinSampler`` with
``WeightedSimpleCutSampler`` and ``StatelessSampler``, then
``CutConcatenate``, ``ClippingTransform`` and ``LowpassUsingResampling``
into ``OnTheFlyFeatures`` on the kernel, with a resume; each batch into
the AdamW step); then the paired-cut, SPHERE/AIFF and remaining
task-dataset path on the recipe corpora (the utterances rewritten as
SPHERE pcm16, SPHERE ulaw and AIFF into ``OnTheFlyFeatures``; noisy/clean
pairs through ``CutPairsSampler`` with a resume; the translation, TTS,
tagging and unsupervised datasets on the kernel; two-speaker mixtures and
their sources extracted on the kernel and read back by the pre-mixed and
dynamically mixed separation datasets; chunks of the sessions, rewritten
as SPHERE, from two forked workers of a ``torch.utils.data.DataLoader``;
each batch into the AdamW step); then the lossy-codec corpus path on the
same utterances, after a line naming the system codec libraries this
machine loads (the utterances written as a CommonVoice release of 48 kHz
MP3 clips through ``prepare_commonvoice``, ``resample(16000)`` and
``OnTheFlyFeatures`` on the kernel, with a resume; the same cuts through
the ``Compress`` cut transform over opus, mp3 and vorbis; the utterances
as Opus Shar shards through ``LazySharIterator``, every member equal to
the codec's round trip of its source; Vorbis, Opus and MP3 files through
``Recording.from_file``, ``info`` and ``save_audio``; each batch into the
AdamW step; a leg whose library does not load is left out and named); then
Kaldi interop on the same corpora, after a line saying whether click
imports and which of ``cat`` and ``gzip`` are found (the utterances and the
sessions written as Kaldi data dirs whose ``wav.scp`` pipes FLAC through
``cat`` and a gzipped WAV through ``gzip -dc``, through the
``lhotse-tpu-torch`` commands run in this process: ``kaldi import``,
``validate-pair``, ``fix``, ``cut simple``, ``cut trim-to-supervisions``,
``feat extract-cuts-batch`` on the kernel, ``shar export`` and ``shar
compute-features`` on the kernel, ``kaldi export``; the stored features and
``OnTheFlyFeatures`` over the piped cuts, with ``AudioCache`` off and on
and a resume; each batch into the AdamW step; the run stops if click,
which the CLI needs, does not import); then the meeting simulation and
sharded-manifest paths; then the noise, RIR and far-field meeting recipes,
after a line saying whether ``sox`` is found (MUSAN and RIRS_NOISES
layouts through ``prepare_musan`` and ``prepare_rir_noise``, as functions
and through the CLI, into the augmenter's noise pool and RIR at the
15 s × 256 bucket with the int16 wire; the utterances through ``CutMix``
over the MUSAN noise and ``ReverbWithImpulseResponse`` over the real and
BUT Reverb DB RIRs into ``OnTheFlyFeatures`` on the kernel and the AdamW
step, with a resume, and one batch under WHAM! noise; a session of about
30 s of each of AISHELL-4, AliMeeting, ICSI, NOTSOFAR-1, LibriCSS, CHiME-6
and DiPCo at its published channel count through its recipe, as function
and CLI, ``trim_to_supervisions(keep_all_channels=True)``, ``to_mono()``
and ``OnTheFlyFeatures`` on the kernel into the step, and the AISHELL-4
session extracted whole into ``lilcom_chunky``); then the single-stream
ASR, TTS and speaker corpora, after a line naming MLS's Opus route as
left out (an AISHELL layout of 256 utterances of 2-15 s through
``prepare_aishell``, as function and CLI, into the augmenter at the
15 s × 256 bucket with phase 23's MUSAN pool and RIR; three TED-LIUM 3
SPHERE talks of 3-5 minutes through ``prepare_tedlium``, the lazy
``CutSet.from_manifests``, ``trim_to_supervisions`` and
``DynamicBucketingSampler`` into ``OnTheFlyFeatures`` on the kernel and the
AdamW step, with a resume; YesNo, AISHELL-2, TED-LIUM 2, Libri-Light, MLS,
People's Speech, SPGISpeech and TIMIT through their recipes into the same
training path, LibriTTS, LibriTTS-R, LJSpeech and VCTK into
``SpeechSynthesisDataset`` with a ``TokenCollater``, and VoxCeleb1's trial
pairs through ``CutPairsSampler``, each resampled to 16 kHz where it is
not); then two corpora muxed into training (the LibriSpeech and AISHELL
cuts through ``CutSet.mux``, ``DynamicBucketingSampler``,
``OnTheFlyFeatures`` on the kernel, ``GlobalMVN`` and ``SpecAugment`` into
the AdamW step, resumed from a ``DataloaderCheckpoint`` JSON file; the Shar
shards through ``CutSet.infinite_mux`` into the step, resumed as the JAX
package's loader resumes it; ``RandomizedSmoothing`` on the card against
the CPU); then the Chinese corpora (the members of icefall's multi_zh-hans
mix that the port prepares, THCHS-30, ST-CMDS, Primewords, MagicData,
aidatatang_200zh, KeSpeech, AISHELL and AISHELL-2, 32 utterances each
through their recipes, as function and CLI, and ``CutSet.mux`` into the
augmenter at the 15 s × 256 bucket with phase 23's MUSAN pool and RIR and
into ``DynamicBucketingSampler`` and ``OnTheFlyFeatures`` on the kernel
into the AdamW step; TAL-ASR, TAL-CSASR, CDSD, SpeechIO, XBMU-AMDO31 and
MDCC through their recipes into the step, AISHELL-3, Baker and
WenetSpeech4TTS into ``SpeechSynthesisDataset``); then the LDC telephone and
broadcast corpora (8 Switchboard-1 conversations of 5 minutes and 8 Fisher
English calls cut to 5 minutes, two-channel 8 kHz mu-law SPHERE, through their
recipes, as function and CLI, ``trim_to_supervisions``, ``resample(16000)``
and ``CutSet.mux`` into the augmenter at the 15 s × 256 bucket with phase
23's MUSAN pool and RIR; Eval2000, CALLHOME English and Egyptian, Fisher
Spanish, GALE Arabic and Mandarin, MGB-2 and 1997 Broadcast News through
their recipes into the step); then the overlapped-speech, diarization and
earnings-call corpora and the CHiME-6 array synchroniser (256 Libri2Mix
rows over the LibriSpeech utterances and WHAM! noises through
``prepare_librimix`` into the augmenter at the 15 s × 256 bucket, their
sources and mixtures into stored features and a separation dataset,
LibriSpeechMix into SURT training, DIHARD III and VoxConverse sessions into
diarization training, a raw CHiME-5 dev split synchronised by
``prepare_chime6(perform_array_sync=True)`` into the step, MiniLibriMix,
and Spatial LibriSpeech and Earnings-21/22 where pandas and the MP3
libraries are found); then the speech-translation and multilingual corpora
(MuST-C ``en-de``, 8 talks of 300 s, through ``prepare_must_c`` and
``trim_to_supervisions`` into the augmenter at the 15 s × 256 bucket with
phase 23's MUSAN pool and RIR; IWSLT 2022 Tunisian Arabic calls as 8 kHz
SPHERE through ``prepare_iwslt22_ta(normalize_text=True)``, resampled, and
GigaST's German translations of GigaSpeech segments through
``prepare_gigast``, both into ``K2Speech2TextTranslationDataset`` with
``OnTheFlyFeatures`` on the kernel and the AdamW step, the first with a
resume; mTEDx, GigaSpeech 2, CSJ (through a transcript directory), Emilia
(into ``SpeechSynthesisDataset``), BVCC (rated utterances) and, where the
Vorbis libraries load, VoxPopuli into the step); then the large ASR
training corpora (KsponSpeech, 256 headerless int16 PCM utterances of 2-15
s, through ``prepare_ksponspeech`` into the augmenter at the 15 s × 256
bucket; NSC parts 3 and 1, BABEL Cantonese, Heroico, ICMC-ASR ``ihm`` and
``sdm``, ReazonSpeech and, where the MP3 libraries load, Bengali.AI Speech
into the step; ICMC-ASR ``mdm``'s four-channel recordings through the
multi-channel route); then the TTS, accented-speech and children's corpora
(CMU Kids, 256 utterances of 2-15 s as 16 kHz SPHERE from 16 children,
through ``prepare_cmu_kids`` into the augmenter at the 15 s × 256 bucket;
Hi-Fi TTS, EARS, DailyTalk, CMU ARCTIC, CMU Indic and ADEPT into
``SpeechSynthesisDataset``; L2-ARCTIC's read and suitcase parts, CSLU Kids,
GRID and otoSpeech into the step); and checks what comes out.

    python3 chip_smoke.py

It needs a CUDA card and the checkout beside it; without either it exits
non-zero and prints no result. It imports neither ``jax`` nor
``lhotse_tpu``. Every check raises on failure, so a zero exit means every
phase passed. The line before the last is a JSON record of the kernel
(launches on the main path, max-abs error against the plain version, per
call times by CUDA events and device times by ``torch.profiler`` for the
kernel and its plain version at each shape, its bound at each shape (the
mel product counted over each filter's nonzero bins, as the kernel runs it), the
near-silent check against float64, and ``launches_by_path``: the kernel's
launches on each path, ``augment_int16``, ``augment_adpcm4``, ``cached``,
``extractor_fbank``, ``extractor_mfcc``, ``model``, ``entry``, ``e2e``,
``e2e_cached``, ``precomputed_extract``, ``precomputed_train`` (0: it
reads stored features), ``on_the_fly``, ``augmented_on_the_fly``,
``precomputed_mix_extract``, ``precomputed_mix`` (0: it mixes stored
features), ``shar_on_the_fly``, ``shar_indexed``, ``shar_precomputed``
(0: it reads stored features), ``recipe_on_the_fly``, ``long_form_extract``,
``long_form_trimmed`` (0: it reads stored features),
``long_form_windows``, ``ami_mdm_extract``, ``ami_mdm_on_the_fly``,
``ami_ihm_on_the_fly``, ``ami_mdm_wpe``, ``ami_rir_fanout``,
``extractor_named_fbank``, ``extractor_named_mfcc``,
``extractor_named_kaldifeat-fbank``, ``extractor_named_kaldifeat-mfcc``,
``dp_on_the_fly`` (both ranks' launches), ``ami_surt_on_the_fly``,
``ami_vad_on_the_fly``, ``ami_diarization_extract``, ``ami_diarization``
(0: it reads stored features), ``multi_source_zip``,
``multi_source_round_robin``, ``multi_source_stateless``,
``sphere_aiff_on_the_fly``, ``paired_enhancement`` (both sides' launches),
``speech_translation_on_the_fly``, ``tts_on_the_fly``,
``separation_extract``, ``separation_premixed`` and ``separation_dynamic``
(0: they read stored features), ``unsupervised_on_the_fly`` (one launch
per cut), ``tagging_on_the_fly``, ``recording_chunks``,
``commonvoice_on_the_fly``, ``commonvoice_compress``,
``shar_opus_on_the_fly``, ``kaldi_extract``, ``kaldi_precomputed`` (0: it
reads stored features), ``kaldi_on_the_fly``, ``kaldi_on_the_fly_cached``,
``kaldi_shar``, ``meeting_sim_surt``, ``from_files_on_the_fly``,
``idxpack_on_the_fly``, ``webdataset_on_the_fly``,
``musan_rir_device_chain``, ``musan_rir_on_the_fly``, ``meeting_aishell4``,
``meeting_ali_meeting``, ``meeting_icsi``, ``meeting_notsofar1``,
``meeting_libricss``, ``meeting_chime6``, ``meeting_dipco``,
``meeting_aishell4_extract``, ``aishell_device_chain``,
``tedlium_long_form`` and ``corpus_<name>`` for ``yesno``, ``aishell2``,
``tedlium2``, ``librilight``, ``mls``, ``peoples_speech``, ``spgispeech``,
``timit``, ``libritts``, ``librittsr``, ``ljspeech``, ``vctk`` and
``voxceleb1`` (both sides' launches), ``mux_on_the_fly``,
``infinite_mux_shar``, ``zh_multi_device_chain``, ``zh_multi_on_the_fly``
and ``corpus_<name>`` for ``tal_asr``, ``tal_csasr``, ``cdsd``,
``speechio``, ``xbmu_amdo31``, ``mdcc``, ``aishell3``, ``baker_zh`` and
``wenetspeech4tts``, ``swbd_fisher_device_chain`` and ``corpus_<name>`` for
``eval2000``, ``callhome_english``, ``callhome_egyptian``,
``fisher_spanish``, ``gale_arabic``, ``gale_mandarin``, ``mgb2`` and
``broadcast_news``, ``librimix_device_chain``,
``librimix_separation_extract``, ``librimix_separation`` (0: it reads
stored features), ``librispeechmix_surt``, ``dihard3_diarization_extract``,
``dihard3_diarization`` and ``voxconverse_diarization`` (0: they read
stored features), ``voxconverse_diarization_extract``,
``chime6_array_sync``, ``corpus_librimix_mini`` and, where they run,
``corpus_spatial_librispeech``, ``corpus_earnings21`` and
``corpus_earnings22``, ``must_c_device_chain``, ``iwslt22_ta_translation``,
``gigast_translation`` and ``corpus_<name>`` for ``mtedx``,
``gigaspeech2``, ``csj``, ``emilia``, ``bvcc`` and, where it runs,
``voxpopuli``, ``ksponspeech_device_chain``, ``corpus_<name>`` for
``nsc_part3``, ``nsc_part1``, ``babel``, ``heroico``, ``icmcasr_ihm``,
``icmcasr_sdm``, ``reazonspeech`` and, where it runs, ``bengaliai_speech``,
``icmcasr_mdm``, ``cmu_kids_device_chain`` and ``corpus_<name>`` for
``hifitts``, ``ears``, ``daily_talk``, ``cmu_arctic``, ``cmu_indic``,
``adept``, ``l2_arctic_read``, ``l2_arctic_suitcase``, ``cslu_kids``,
``grid`` and ``oto_speech``); the last line is
``{"ok": true, "device": {...}}``. The corpus, the archive and the
libraries' builds go under ``build/`` in the checkout.
"""
import json
import math
import queue
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SR = 16000
SPEED = 1.1
KERNEL_TOL = 5e-5  # the JAX package's own bound for the fused fbank (tests/test_fbank_pallas.py)
CHAIN_TOL = 1e-4  # the feature parity budget (BASELINE.md)
CACHE_TOL = 1e-5  # cached vs wire features (tests/test_device_cache.py's bound)
TIMING_RUNS = 10
BUCKET = (15.0, 256)
# The encoder's bf16 hidden states against the CPU port, as the CPU tests
# hold the port to JAX (tests/test_torch_entry.py); float32 at 1e-4.
ENTRY_BF16_TOL = 5e-2
ENTRY_F32_TOL = 1e-4
# WPE on the card against the CPU port, at tests/test_torch_wpe.py's bounds
# against the JAX function.
WPE_CORR, WPE_REL = 0.99, 0.1
# The card's peaks (H100 SXM data sheet, dense): float32 outside the tensor
# cores, and HBM.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def _device_ms(fn, kernel: str = "") -> float:
    """Device time per call of ``fn`` from ``torch.profiler`` over
    ``TIMING_RUNS`` calls after one warm-up: the sum of the device
    activities whose name contains ``kernel`` (all of them when empty)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # The card's CUPTI tracing now and then hands back a window without its
    # device activities; such a window is traced again, up to three times.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(TIMING_RUNS):
                fn()
            torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.events()
                 if e.device_type == DeviceType.CUDA and kernel in e.name)
        if us > 0:
            return us / 1000.0 / TIMING_RUNS
    raise AssertionError(f"torch.profiler recorded no device time for {kernel or 'the call'}")


def _device_busy(fn):
    """Run ``fn`` once under ``torch.profiler``, tracing the device's
    activities only (a trace of the host's operators adds seconds per
    epoch to the wall and to the trace's processing, and the busy share
    needs none of them). Returns its host-clock wall ms, the ms in which
    the device was busy (the union of the intervals of its device
    activities: kernels, copies, sets) and the device ms by activity name.
    ``fn`` runs once, so a window that the card's CUPTI tracing hands back
    without its device activities (as it now and then does, see
    ``_device_ms``) cannot be traced again: its busy ms are NaN, "not
    measured", and the phase's own checks still decide."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, reach = 0.0, -math.inf
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in events):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    if not busy_us > 0:
        print("torch.profiler handed back this window without device activities: its device "
              "busy share is not measured (nan)")
        return wall_ms, math.nan, by_name
    return wall_ms, busy_us / 1e3, by_name


def _near_silent_errors(device, ops, fbank_cuda) -> tuple:
    """Max-abs error from float64 of the kernel and of its plain version on
    a 3 x 1001-frame 1 kHz tone at 0.3 over 1e-3 white noise, whose low mel
    bins nearly cancel; the truth is the same frames through float64
    matrices on the card."""
    B, T = 3, 1001
    N = (T - 1) * 160 + 400
    t = np.arange(N) / SR
    x_np = 0.3 * np.sin(2 * np.pi * 1000.0 * t) + 1e-3 * np.random.default_rng(9).standard_normal((B, N))
    x = torch.from_numpy(x_np.astype(np.float32)).to(device)
    Mc, Ms = ops.dft_analysis_matrices(400, 512)
    f32 = [torch.from_numpy(np.ascontiguousarray(m)).to(device)
           for m in fbank_cuda._squeeze_nyquist(Mc, Ms, _mel_bank(80, ops))]
    f64 = [m.double() for m in f32]
    frames = x.double().unfold(-1, 400, 160)
    power = (frames @ f64[0]) ** 2 + (frames @ f64[1]) ** 2
    truth = torch.log(torch.clamp_min(power @ f64[2], ops.FLT_EPS))
    kernel = fbank_cuda.fbank_cuda(x, *f32).double()
    plain = fbank_cuda.reference_fbank(x, *f32).double()
    return (kernel - truth).abs().max().item(), (plain - truth).abs().max().item()


def _median_ms(fn) -> float:
    """Median of ``TIMING_RUNS`` CUDA-event timings of ``fn`` after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _mel_bank(n_mels: int, ops) -> np.ndarray:
    mel, _ = ops.get_mel_banks(n_mels, 512, SR, 20.0, -400.0)
    fb = np.zeros((257, n_mels), np.float32)
    fb[:256] = mel.T
    return fb


def _mel_macs(fb: torch.Tensor) -> int:
    """Multiply-adds per frame of the mel product as the kernel does it: each
    filter over the bins from its first to its last nonzero weight."""
    nz = fb != 0
    bins = torch.arange(fb.shape[0], device=fb.device)[:, None]
    first = torch.where(nz, bins, fb.shape[0]).amin(0)
    last = torch.where(nz, bins, -1).amax(0)
    return int((last - first + 1).clamp_min(0).sum())


def _expected_feat_lens(lens: np.ndarray) -> np.ndarray:
    """ceil(lens · 16000 / 17600) samples after speed 1.1, then the hop rule."""
    return (-(-lens * 10 // 11) + 80) // 160


def _check_chain(staged, feats, feat_lens, wire_format, rir, device, fbank_cuda,
                 path: str = "") -> float:
    """Max-abs of the path's features against the same chain with the
    kernel's plain version on the card (these plain runs launch no kernel);
    raises past ``CHAIN_TOL`` or on other ``feat_lens``."""
    path = path or f"{wire_format} path"
    from lhotse_tpu_torch.features.kaldi.layers import Wav2LogFilterBank
    from lhotse_tpu_torch.ops.augment import make_augment_fbank_pipeline

    plain_pipe = make_augment_fbank_pipeline(
        sampling_rate=SR, speed_factor=SPEED, wire_format=wire_format, rir=rir, device=device,
        fbank=_PlainFbank(Wav2LogFilterBank(device=device), fbank_cuda))
    plain_feats, plain_lens = plain_pipe(staged.audio, staged.lens, **staged.kwargs)
    err = (plain_feats - feats).abs().max().item()
    print(f"{path} vs the same chain with the plain fbank: max_abs_err {err!r} (tol {CHAIN_TOL})")
    if not err <= CHAIN_TOL or not torch.equal(plain_lens, feat_lens):
        raise AssertionError(f"the {path} disagrees with the plain chain")
    return err


def _phase_adpcm4(common, batch, rir, device, fbank_cuda, smi: str) -> int:
    """4. The adpcm4 wire at the full bucket: the stage's encode (the C
    encoder) against the numpy encoder byte for byte, the card's decode of
    the staged batch against the numpy decode bit for bit, the features
    against the plain chain. Returns the kernel's launches on the path."""
    from lhotse_tpu_torch.dataset import device_augment
    from lhotse_tpu_torch.dataset.device_augment import OnDeviceAugmenter
    from lhotse_tpu_torch.ops import wire

    aug = OnDeviceAugmenter(buckets=[BUCKET], wire_format="adpcm4", **common)
    audio, lens = batch
    encoded = []

    def timed_encode(x, wire_format):  # the stage's own encode, timed
        t = time.perf_counter()
        out = wire.encode_wire(x, wire_format)
        encoded.append((time.perf_counter() - t, x, out))
        return out

    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    device_augment.encode_wire = timed_encode
    try:
        staged = aug.stage(audio, lens)
    finally:
        device_augment.encode_wire = wire.encode_wire
    stage_ms = (time.perf_counter() - t0) * 1e3
    feats, feat_lens = aug.compute(staged)
    torch.cuda.synchronize()
    launches = fbank_cuda.LAUNCHES
    elapsed = time.perf_counter() - t0
    encode_s, encode_in, encode_out = encoded[0]
    t = time.perf_counter()
    numpy_out = wire._adpcm4_encode_np(encode_in)
    numpy_ms = (time.perf_counter() - t) * 1e3
    if not np.array_equal(encode_out, numpy_out):
        raise AssertionError("the C adpcm4 encoder's bytes differ from the numpy encoder's")
    decoded = wire.decode_wire(staged.audio, "adpcm4")
    if not torch.equal(decoded.cpu(), torch.from_numpy(wire.adpcm4_decode_np(staged.audio.cpu().numpy()))):
        raise AssertionError("the card's adpcm4 decode differs from adpcm4_decode_np")
    decode_ms = _device_ms(lambda: wire.decode_wire(staged.audio, "adpcm4"))
    width = tuple(staged.audio.shape)
    print(f"[{smi}] adpcm4 {BUCKET[0]:g} s x {BUCKET[1]}: wire {width} uint8 ({wire.wire_bytes_per_sample('adpcm4')} B/sample); "
          f"host encode {encode_s * 1e3!r} ms (C encoder; bytes equal to the numpy encoder's, which "
          f"took {numpy_ms!r} ms), stage {stage_ms!r} ms; decode on the card "
          f"bit-exact, device {decode_ms!r} ms per batch (torch.profiler); "
          f"{float(lens.sum()) / SR / elapsed!r} audio-s/s (stage + compute); "
          f"fbank kernel launches {launches}")
    frames = (math.ceil(int(BUCKET[0] * SR) * 10 / 11) + 80) // 160
    if tuple(feats.shape) != (BUCKET[1], frames, 80) or not torch.isfinite(feats).all():
        raise AssertionError(f"adpcm4 features {tuple(feats.shape)} wrong or not finite")
    if not np.array_equal(feat_lens.cpu().numpy(), _expected_feat_lens(lens)):
        raise AssertionError("adpcm4 feat_lens differ from the hop rule")
    _check_chain(staged, feats, feat_lens, "adpcm4", common["rir"], device, fbank_cuda)
    return launches


def _produce(stage, epoch_batches, ids_of, placeholder: bool):
    """A producer thread that stages the epoch's batches with
    ``transfer=False`` (an epoch of a fully cached corpus stages from
    ``(B, 0)`` placeholders, as a cache-aware input strategy gives them), and
    a generator over what it staged. The generator re-raises the thread's
    error and joins it."""
    out = queue.Queue(maxsize=2)

    def run():
        try:
            for i, (audio, lens) in enumerate(epoch_batches):
                if placeholder:
                    audio = np.zeros((audio.shape[0], 0), np.float32)
                out.put(stage(audio, lens, ids=ids_of(i), transfer=False))
        except Exception as e:  # handed to the consumer, which raises it
            out.put(e)
        out.put(None)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def items():
        try:
            while (item := out.get()) is not None:
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            thread.join(timeout=60)
            if thread.is_alive():
                raise AssertionError("the producer thread did not stop")

    return items()


def _phase_cache(common, cache_batches, device, fbank_cuda) -> int:
    """5. The sample cache over two epochs, fed through ``transfer_stream``
    by a producer thread, and a third (cached) epoch under ``torch.profiler``
    for the device's busy share. Returns the kernel's launches in the cached
    epoch."""
    from lhotse_tpu_torch.dataset.device_augment import CachedBatch, OnDeviceAugmenter, StagedBatch
    from lhotse_tpu_torch.dataset.device_cache import DeviceSampleCache
    from lhotse_tpu_torch.dataset.loader import transfer_stream

    n, (sec, bsz) = len(cache_batches), BUCKET
    cache = DeviceSampleCache(capacity_seconds=n * bsz * sec)
    aug = OnDeviceAugmenter(buckets=[BUCKET], wire_format="int16", sample_cache=cache, **common)

    def ids_of(i):
        return [f"b{i}_{k}" for k in range(bsz)]

    def run_epoch(placeholder):
        staged, outs = [], []
        for s in transfer_stream(_produce(aug.stage, cache_batches, ids_of, placeholder),
                                 lookahead=2, device=device):
            staged.append(s)
            outs.append(aug.compute(s))
        return staged, outs

    audio_sec = sum(float(lens.sum()) for _, lens in cache_batches) / SR
    epochs, launches = [], 0
    for epoch in range(2):
        torch.cuda.synchronize()
        fbank_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        staged, outs = run_epoch(epoch == 1)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = fbank_cuda.LAUNCHES
        if epoch == 0 and not all(isinstance(s, StagedBatch) and s.insert_slots is not None
                                  for s in staged):
            raise AssertionError("epoch 1 of the cache phase was not all misses with inserts")
        if epoch == 1 and not all(isinstance(s, CachedBatch) for s in staged):
            raise AssertionError("epoch 2 of the cache phase was not all cached")
        epochs.append((staged, outs))
        print(f"sample cache epoch {epoch + 1}: {n} batches of {sec:g} s x {bsz}, {audio_sec!r} audio-s in "
              f"{elapsed!r} s: {audio_sec / elapsed!r} audio-s/s; fbank kernel launches {launches}")
    if launches < n:
        raise AssertionError(f"the cached epoch launched the fbank kernel {launches} times")
    stats = cache.stats()
    print(f"sample cache: hit rate {stats['hit_rate']!r}, {stats['resident_items']} items resident, "
          f"memory_bytes {stats['memory_bytes']}")
    wall_ms, busy_ms, by_name = _device_busy(lambda: run_epoch(True))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"sample cache epoch 3 (cached, under torch.profiler): wall {wall_ms!r} ms, device busy "
          f"{busy_ms!r} ms ({busy_ms / n!r} ms per batch, {busy_ms / wall_ms!r} of the wall); "
          f"device ms by activity: " + "; ".join(f"{k[:60]} {v!r}" for k, v in top))

    # Epoch 2 against a cache-less augmenter with the same seed, at the
    # counters epoch 2 was staged with.
    cached, cached_outs = epochs[1]
    ref = OnDeviceAugmenter(buckets=[BUCKET], wire_format="int16", **common)
    ref.load_state_dict({"seed": 0, "next_counter": cached[0].aug_counter})
    err = 0.0
    for (audio, lens), (feats, feat_lens) in zip(cache_batches, cached_outs):
        ref_feats, ref_lens = ref(audio, lens)
        if not torch.equal(ref_lens, feat_lens):
            raise AssertionError("cached feat_lens differ from the cache-less augmenter's")
        real = feat_lens > 0
        err = max(err, (feats[real] - ref_feats[real]).abs().max().item())
    grouped = aug.compute_grouped(cached[:2])
    group_equal = all(torch.equal(g, o[0]) for (g, _), o in zip(grouped, cached_outs))
    print(f"cached epoch vs the cache-less augmenter: max_abs_err {err!r} (tol {CACHE_TOL}); "
          f"compute_grouped of 2 cached batches equal to compute: {group_equal}")
    if not err <= CACHE_TOL or not group_equal:
        raise AssertionError("the cached path disagrees with the wire path")
    if aug.state_dict(after=cached[0])["next_counter"] != cached[0].aug_counter + 1:
        raise AssertionError("state_dict(after=cached_batch) is not its counter + 1")
    return launches


def _phase_extractors(device, fbank_cuda, ops) -> dict:
    """6. ``Fbank`` and ``Mfcc`` extraction on the card against the same
    extractors on the CPU (the port's plain route). Returns the kernel's
    launches per extractor."""
    from lhotse_tpu_torch.features.kaldi import extractors

    rng = np.random.default_rng(6)
    items = [(0.1 * rng.standard_normal(n)).astype(np.float32)
             for n in rng.integers(1 * SR, 20 * SR + 1, size=8)]
    audio_sec = sum(len(x) for x in items) / SR
    launches = {}
    for kind in ("Fbank", "Mfcc"):
        cls, cfg_cls = getattr(extractors, kind), getattr(extractors, f"{kind}Config")
        on_card = cls(cfg_cls(device=device))
        torch.cuda.synchronize()
        fbank_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        feats = on_card.extract_batch(items, SR)
        first_s = time.perf_counter() - t0
        launches[f"extractor_{kind.lower()}"] = fbank_cuda.LAUNCHES
        t0 = time.perf_counter()
        on_card.extract_batch(items, SR)
        warm_s = time.perf_counter() - t0
        ref = cls(cfg_cls(device="cpu")).extract_batch(items, SR)
        err = max(float(np.abs(a - b).max()) for a, b in zip(feats, ref))
        snip = cls(cfg_cls(device=device, snip_edges=True)).extract_batch(items, SR)
        want = [ops.compute_num_frames_pad(len(x), 160) for x in items]
        want_snip = [ops.compute_num_frames_snip(len(x), 400, 160) for x in items]
        print(f"{kind} extractor on the card, 8 items of 1-20 s: max_abs_err vs the CPU route "
              f"{err!r} (tol {CHAIN_TOL}); {audio_sec / first_s!r} audio-s/s first call, "
              f"{audio_sec / warm_s!r} audio-s/s second call; fbank kernel launches "
              f"{launches[f'extractor_{kind.lower()}']}")
        if [f.shape[0] for f in feats] != want or [f.shape[0] for f in snip] != want_snip:
            raise AssertionError(f"{kind} frame counts differ from _num_frames")
        if not err <= CHAIN_TOL or not all(np.isfinite(f).all() for f in feats):
            raise AssertionError(f"{kind} on the card disagrees with the CPU route")
    launches.update(_phase_named_extractors(items, fbank_cuda))
    return launches


def _phase_named_extractors(items, fbank_cuda) -> dict:
    """6b. The extractors under the reference's names at their defaults (on
    the card) against the same extractors on the CPU: ``fbank``, ``mfcc``
    (compliance) and ``kaldifeat-fbank``/``kaldifeat-mfcc`` on the fbank
    kernel, ``whisper-fbank`` and ``librosa-fbank`` on fp32 GEMMs (no
    kernel). Returns the kernel's launches of the first four."""
    from lhotse_tpu_torch.features.base import get_extractor_type

    launches = {}
    for name in ("fbank", "mfcc", "kaldifeat-fbank", "kaldifeat-mfcc", "whisper-fbank",
                 "librosa-fbank"):
        cls = get_extractor_type(name)
        on_card, on_cpu = cls(), cls()
        on_cpu.to("cpu")
        sr = 22050 if name == "librosa-fbank" else SR
        torch.cuda.synchronize()
        fbank_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        feats = [on_card.extract(x, sr) for x in items]
        elapsed = time.perf_counter() - t0
        n = fbank_cuda.LAUNCHES
        err = max(float(np.abs(a - on_cpu.extract(x, sr)).max()) for a, x in zip(feats, items))
        audio_s = sum(len(x) for x in items) / sr
        print(f"{name} ({cls.__name__}) on {on_card.device}: {len(items)} items, max_abs_err vs "
              f"the CPU port {err!r} (tol {CHAIN_TOL}); {audio_s / elapsed!r} audio-s/s (first "
              f"call of each item included); fbank kernel launches {n}")
        uses_kernel = name not in ("whisper-fbank", "librosa-fbank")
        if on_card.device.type != "cuda" or n != (len(items) if uses_kernel else 0):
            raise AssertionError(f"{name}: not on the card, or kernel launches {n} are off")
        if not err <= CHAIN_TOL or not all(np.isfinite(f).all() for f in feats):
            raise AssertionError(f"{name} on the card disagrees with the CPU port")
        if uses_kernel:
            launches[f"extractor_named_{name}"] = n
    return launches


def _int16_batch(rng, bsz: int, sec: int):
    """A (bsz, sec) batch of 0.1-scale noise with lengths from half of sec to sec."""
    lens = rng.integers(sec * SR // 2, sec * SR + 1, size=bsz)
    lens[0] = sec * SR
    return rng.standard_normal((bsz, sec * SR), np.float32) * 0.1, lens


def _phase_model(common, rng, device, fbank_cuda, sec: int = 15, train_b: int = 32,
                 fwd_b: int = 64) -> int:
    """7. The model path at full width: int16 batches through the augmenter
    (the fbank kernel) into ``Encoder(EncoderConfig())`` in bf16; a forward
    at 15 s x 64 with no grad, then 20 AdamW steps and one SGD step at
    15 s x 32. Both batches' features are then held against the plain chain.
    Returns the kernel's launches on the path."""
    from lhotse_tpu_torch.dataset.device_augment import OnDeviceAugmenter
    from lhotse_tpu_torch.models import encoder as enc_mod

    cfg = enc_mod.EncoderConfig()
    aug32 = OnDeviceAugmenter(buckets=[(sec, train_b)], wire_format="int16", **common)
    aug64 = OnDeviceAugmenter(buckets=[(sec, fwd_b)], wire_format="int16", **common)
    batch32, batch64 = _int16_batch(rng, train_b, sec), _int16_batch(rng, fwd_b, sec)
    model = enc_mod.Encoder(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(7)
    frames = (math.ceil(sec * SR * 10 / 11) + 80) // 160

    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    staged64 = aug64.stage(*batch64)
    feats64, lens64 = aug64.compute(staged64)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        hidden = model(feats64, lens64)
    torch.cuda.synchronize()
    fwd_peak = torch.cuda.max_memory_allocated()
    staged32 = aug32.stage(*batch32)
    feats, feat_lens = aug32.compute(staged32)
    init, adamw_step = enc_mod.make_adamw_train_step(lr=1e-3)
    opt = init(model)

    def masks(n):
        return [enc_mod.draw_mask(feat_lens, frames, cfg.mask_prob, gen) for _ in range(n)]

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [float(adamw_step(model, opt, feats, feat_lens, m)) for m in masks(15)]
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 15
    step_masks = masks(5)
    _, busy_ms, by_name = _device_busy(
        lambda: losses.extend(float(adamw_step(model, opt, feats, feat_lens, m)) for m in step_masks))
    train_peak = torch.cuda.max_memory_allocated()
    sgd_loss = float(enc_mod.sgd_train_step(model, feats, feat_lens, masks(1)[0], lr=1e-3))
    torch.cuda.synchronize()
    launches = fbank_cuda.LAUNCHES

    with torch.no_grad():
        fwd_ms = _device_ms(lambda: model(feats64, lens64))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"model path: features {tuple(feats64.shape)} -> hidden {tuple(hidden.shape)} {hidden.dtype}; "
          f"forward at {sec} s x {fwd_b} {fwd_ms!r} ms device (torch.profiler), peak memory "
          f"{fwd_peak!r} B; AdamW at {sec} s x {train_b}: losses {losses[0]!r} -> {losses[-1]!r} over "
          f"{len(losses)} steps, {busy_ms / 5!r} ms device per step (torch.profiler, 5 steps), "
          f"{wall_ms!r} ms wall per step (15 steps), peak memory {train_peak!r} B; SGD loss "
          f"{sgd_loss!r}; fbank kernel launches {launches}")
    print("model step device ms by activity (5 steps): "
          + "; ".join(f"{k[:60]} {v!r}" for k, v in top))
    for t, b in ((feats64, fwd_b), (feats, train_b)):
        if tuple(t.shape) != (b, frames, 80) or not torch.isfinite(t).all():
            raise AssertionError(f"model-path features {tuple(t.shape)} wrong or not finite")
    for staged, f, n, b in ((staged64, feats64, lens64, fwd_b), (staged32, feats, feat_lens, train_b)):
        _check_chain(staged, f, n, "int16", common["rir"], device, fbank_cuda,
                     path=f"model path's {sec} s x {b} features")
    if tuple(hidden.shape) != (fwd_b, frames, cfg.d_model) or not torch.isfinite(hidden).all():
        raise AssertionError(f"hidden states {tuple(hidden.shape)} wrong or not finite")
    if not all(math.isfinite(x) for x in losses + [sgd_loss]) or not losses[-1] < losses[0]:
        raise AssertionError(f"the AdamW loss did not fall or is not finite: {losses}, {sgd_loss}")
    return launches


def _phase_entry(device, fbank_cuda) -> int:
    """8. ``entry()`` on the card: its fbank layer (the kernel) against the
    kernel's plain version on the entry's audio; then the whole entry
    against the same entry on the CPU port, bf16 at the entry's
    configuration, and a float32 encoder at a small size on the same
    features. Returns the kernel's launches on the path."""
    from lhotse_tpu_torch import entry as entry_mod
    from lhotse_tpu_torch.models.encoder import Encoder, EncoderConfig

    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    fn, (audio, audio_lens, encoder, fbank) = entry_mod.entry(device)
    with torch.no_grad():
        hidden, feat_lens = fn(audio, audio_lens, encoder, fbank)
    torch.cuda.synchronize()
    launches = fbank_cuda.LAUNCHES
    with torch.no_grad():
        feats = fbank(audio)
        fbank_err = (feats - _PlainFbank(fbank, fbank_cuda)(audio)).abs().max().item()
    cpu_fn, cpu_args = entry_mod.entry("cpu")
    with torch.no_grad():
        cpu_hidden, cpu_lens = cpu_fn(*cpu_args)
        # float32 at a small size, on the card's features on both sides: the
        # encoder alone (the features differ by the kernel's ~1e-5).
        cfg = EncoderConfig(num_layers=2, d_model=64, num_heads=4, ffn_dim=128, dtype=torch.float32)
        f32 = Encoder(cfg, device=device)(feats, feat_lens).cpu()
        f32_cpu = Encoder(cfg, device="cpu")(feats.cpu(), cpu_lens)
    bf16_err = (hidden.float().cpu() - cpu_hidden.float()).abs().max().item()
    f32_err = (f32 - f32_cpu).abs().max().item()
    print(f"entry: fbank layer {tuple(feats.shape)} vs the kernel's plain version max_abs_err "
          f"{fbank_err!r} (tol {KERNEL_TOL}); hidden {tuple(hidden.shape)} {hidden.dtype}, feat_lens "
          f"{feat_lens.tolist()}; card vs CPU port max_abs_err bf16 {bf16_err!r} (tol "
          f"{ENTRY_BF16_TOL}), float32 {f32_err!r} (tol {ENTRY_F32_TOL}); fbank kernel launches "
          f"{launches}")
    if not fbank_err <= KERNEL_TOL:
        raise AssertionError(f"the entry's fbank disagrees with the plain version: {fbank_err}")
    if tuple(hidden.shape) != (4, 400, 128) or not torch.isfinite(hidden).all():
        raise AssertionError(f"entry output {tuple(hidden.shape)} wrong or not finite")
    if not torch.equal(feat_lens.cpu(), cpu_lens) or feat_lens.tolist() != [400, 398, 400, 200]:
        raise AssertionError(f"entry feat_lens {feat_lens.tolist()} differ")
    if not bf16_err <= ENTRY_BF16_TOL or not f32_err <= ENTRY_F32_TOL:
        raise AssertionError("the card's entry disagrees with the CPU port's")
    return launches


def _reverberant(channels: int, seconds: float, seed: int) -> np.ndarray:
    """tests/test_ops_wpe.py's signal: three harmonics of 150 Hz, amplitude-
    modulated at 3 Hz, through a decaying random RIR per channel."""
    rng = np.random.RandomState(seed)
    n = int(SR * seconds)
    t = np.arange(n) / SR
    dry = sum(np.sin(2 * np.pi * 150 * (h + 1) * t) / (h + 1) for h in range(3))
    dry = (0.2 * dry * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)
    out = []
    for _ in range(channels):
        rir = np.exp(-np.arange(2000) / 300.0) * rng.randn(2000) * 0.3
        rir[0] = 1.0
        out.append(np.convolve(dry, rir)[:n])
    return np.stack(out).astype(np.float32)


def _phase_wpe(device) -> None:
    """9. WPE of a 2-channel 10 s reverberant signal on the card against
    the CPU port."""
    from lhotse_tpu_torch.ops.wpe import dereverb_wpe

    audio = _reverberant(channels=2, seconds=10.0, seed=0)
    x = torch.from_numpy(audio).to(device)
    out = dereverb_wpe(x).cpu().numpy()
    ref = dereverb_wpe(audio, device="cpu").numpy()
    corr = float(np.corrcoef(out.ravel(), ref.ravel())[0, 1])
    rel = float(np.linalg.norm(out - ref) / np.linalg.norm(ref))
    e_ratio = float(np.sum(out ** 2) / np.sum(audio ** 2))
    ms = _device_ms(lambda: dereverb_wpe(x))
    print(f"WPE 2 x 10 s on the card: {ms!r} ms device (torch.profiler); vs the CPU port "
          f"correlation {corr!r} (> {WPE_CORR}), relative error {rel!r} (< {WPE_REL}); output "
          f"energy / input energy {e_ratio!r}")
    if out.shape != audio.shape or not np.isfinite(out).all():
        raise AssertionError("WPE output wrong or not finite")
    if not corr > WPE_CORR or not rel < WPE_REL or not e_ratio < 1.0:
        raise AssertionError("WPE on the card disagrees with the CPU port")


# -- 10. the host data path into the trainer step -------------------------------
# bench.py:528 (the e2e legs' shape vocabulary) and bench.py::_synthesize_corpus.
E2E_BUCKETS = [(6.0, 41), (9.0, 28), (12.0, 21), (14.0, 19)]
E2E_RECORDINGS = 160
E2E_SECONDS = (4.0, 14.0)  # the corpus's uniform duration range


def _tone_burst(rng, duration: float, sr: int = SR) -> np.ndarray:
    """``bench.py::_synthesize_corpus``'s signal: four harmonics of an
    80-220 Hz f0 over 0.01 white noise, ``duration`` seconds at ``sr`` Hz."""
    n = int(sr * duration)
    t = np.arange(n) / sr
    f0 = rng.uniform(80, 220)
    wave = sum(np.sin(2 * np.pi * f0 * (h + 1) * t) / (h + 1) for h in range(4)) * 0.2
    wave += rng.randn(n) * 0.01
    return wave.astype(np.float32)


def _synthesize_corpus(root: Path, n_recordings: int, n_noise: int = 4) -> tuple:
    """``bench.py::_synthesize_corpus`` with the port: FLAC tone bursts of
    uniform 4-14 s at 16 kHz (numpy seed 1234), one supervision each, then a
    pool of ``n_noise`` 10 s bursts drawn after them from the same generator,
    written with ``write_flac`` and ``CutSet.to_file``. Returns the paths of
    the two manifests."""
    from lhotse_tpu_torch.audio import Recording
    from lhotse_tpu_torch.audio.flacio import write_flac
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.supervision import SupervisionSegment

    rng = np.random.RandomState(1234)
    cuts = []
    for i in range(n_recordings):
        duration = float(rng.uniform(*E2E_SECONDS))
        path = root / f"utt{i:04d}.flac"
        write_flac(str(path), _tone_burst(rng, duration), SR)
        cut = Recording.from_file(path).to_cut()
        cut.supervisions.append(SupervisionSegment(
            id=f"sup{i:04d}", recording_id=cut.recording_id, start=0.0, duration=cut.duration,
            text="synthetic"))
        cuts.append(cut)
    path = root / "cuts.jsonl"
    CutSet.from_cuts(cuts).to_file(path)
    noise = []
    for i in range(n_noise):
        write_flac(str(root / f"noise{i:02d}.flac"), _tone_burst(rng, 10.0), SR)
        noise.append(Recording.from_file(root / f"noise{i:02d}.flac").to_cut())
    noise_path = root / "noise.jsonl"
    CutSet.from_cuts(noise).to_file(noise_path)
    return path, noise_path


def _e2e_augmenter(device, sample_cache=None):
    """The augmenter of ``bench.py::bench_e2e_tpu`` (bench.py:531-559) on
    ``device``, and its RIR."""
    from lhotse_tpu_torch.dataset.device_augment import OnDeviceAugmenter
    from lhotse_tpu_torch.dataset.signal_transforms import SpecAugment

    rng_init = np.random.RandomState(99)
    L = SR // 2
    rir = (np.exp(-np.arange(L) / (L / 6.0)) * rng_init.randn(L) * 0.5).astype(np.float32)
    rir[L // 50] = 1.0
    noise = (rng_init.randn(4, 10 * SR) * 0.05).astype(np.float32)
    aug = OnDeviceAugmenter(
        E2E_BUCKETS, sampling_rate=SR, speed_factor=SPEED, gain_range=(0.8, 1.2),
        noise_pool=noise, snr=(10, 20), mix_prob=1.0, rir=rir, wire_format="int16", seed=0,
        specaugment=SpecAugment(seed=0), sample_cache=sample_cache, device=device)
    return aug, rir


def _e2e_loader(cuts_path: Path, aug, device, cached: bool = False):
    """The sampler, dataset and loader of ``bench.py:568-600``: lazy cuts,
    ``FixedBucketBatchSizeConstraint`` over the bucket vocabulary, shuffled
    with seed 0, ``K2SpeechRecognitionDataset`` with ``AudioSamples`` (with
    ``CacheAwareAudioSamples`` when ``cached``), the augmenter's
    ``stage(..., transfer=False)`` in the main thread and the copy to the
    card two batches ahead. Each item is ``(staged, cut ids, lens,
    placeholder)``."""
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.dataset.device_cache import CacheAwareAudioSamples, batch_cut_info
    from lhotse_tpu_torch.dataset.input_strategies import AudioSamples
    from lhotse_tpu_torch.dataset.loader import DataLoader
    from lhotse_tpu_torch.dataset.sampling.dynamic_bucketing import (
        DynamicBucketingSampler, FixedBucketBatchSizeConstraint)
    from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
    from lhotse_tpu_torch.tracing import trace_span

    sampler = DynamicBucketingSampler(
        CutSet.from_jsonl_lazy(cuts_path),
        constraint=FixedBucketBatchSizeConstraint(
            max_seq_len_buckets=[ub for ub, _ in E2E_BUCKETS],
            batch_sizes=[bsz for _, bsz in E2E_BUCKETS]),
        num_buckets=None, duration_bins=[ub for ub, _ in E2E_BUCKETS[:-1]],
        buffer_size=max(E2E_RECORDINGS, 16), shuffle=True, seed=0, world_size=1, rank=0)
    strategy = CacheAwareAudioSamples(aug) if cached else AudioSamples()
    dataset = K2SpeechRecognitionDataset(return_cuts=True, input_strategy=strategy)

    def stage(batch):
        ids, lens = batch_cut_info(batch)
        with trace_span("augmenter.stage"):
            staged = aug.stage(batch["inputs"], lens, ids=ids if cached else None, transfer=False)
        return staged, ids, lens, batch["inputs"].shape[1] == 0

    loader = DataLoader(sampler, dataset, prefetch_batches=3, main_apply_fn=stage,
                        transfer_lookahead=2, checkpoint_objects=[aug], device=device)
    return loader, sampler


class _Trainer:
    """One AdamW step of ``Encoder(EncoderConfig())`` per batch of
    features, with masks from a seeded generator on the card."""

    def __init__(self, device):
        from lhotse_tpu_torch.models import encoder as enc_mod

        self.enc = enc_mod
        self.cfg = enc_mod.EncoderConfig()
        self.model = enc_mod.Encoder(self.cfg, device=device)
        init, self.adamw_step = enc_mod.make_adamw_train_step(lr=1e-3)
        self.opt = init(self.model)
        self.gen = torch.Generator(device=device).manual_seed(10)

    def step(self, feats, feat_lens) -> float:
        mask = self.enc.draw_mask(feat_lens, feats.shape[1], self.cfg.mask_prob, self.gen)
        return float(self.adamw_step(self.model, self.opt, feats, feat_lens, mask))


def _run_epoch(loader, aug, trainer, on_batch=None) -> dict:
    """Consume one epoch of ``loader``: features on the card (the fbank
    kernel), then the trainer's step. ``on_batch(i, item, feats,
    feat_lens)`` sees each batch before its step."""
    items, losses, wait_s, audio_s = [], [], 0.0, 0.0
    it = iter(loader)
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            break
        wait_s += time.perf_counter() - t
        staged, ids, lens, placeholder = item
        feats, feat_lens = aug.compute(staged)
        if on_batch is not None:
            on_batch(len(items), item, feats, feat_lens)
        losses.append(trainer.step(feats, feat_lens))
        items.append((type(staged).__name__, list(ids), np.asarray(lens), placeholder,
                      getattr(staged, "insert_slots", None) is not None))
        audio_s += float(np.sum(lens)) / SR
    torch.cuda.synchronize()
    return {"items": items, "losses": losses, "wait_s": wait_s, "audio_s": audio_s,
            "elapsed_s": time.perf_counter() - t0}


def _host_split(report: dict, n: int, wait_s: float) -> str:
    def ms(span):
        return report.get(span, {}).get("total_s", 0.0) * 1e3 / n

    return (f"host ms per batch: decode+collate (dataset.assemble, loader thread) "
            f"{ms('dataset.assemble')!r} (of which audio.decode {ms('audio.decode')!r}), "
            f"stage {ms('augmenter.stage')!r}, consumer's wait in next() (stage and the copy "
            f"included) {wait_s * 1e3 / n!r}")


def _phase_e2e(cuts_path: Path, device, fbank_cuda, smi: str) -> dict:
    """10. The host data path into the trainer step, as a trainer runs it:
    a FLAC corpus read back lazily into ``DynamicBucketingSampler`` →
    ``K2SpeechRecognitionDataset`` → ``DataLoader`` (staging and the copy
    two batches ahead) → the augmenter (the fbank kernel) → an AdamW step of
    ``Encoder(EncoderConfig())``. Path ``e2e``: one timed epoch (cut
    coverage, bucket sizes, the first batch against the plain chain, a
    falling loss, one launch per batch), a second under ``torch.profiler``
    for the busy share, and a mid-epoch resume from ``loader.state_dict()``
    after batch 3 into a fresh sampler, augmenter and loader. Path
    ``e2e_cached``: the same loader over a ``DeviceSampleCache`` with
    ``CacheAwareAudioSamples``, two epochs, the second all hits. Returns
    the kernel's launches per path."""
    from lhotse_tpu_torch.caching import set_caching_enabled
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.dataset.device_cache import DeviceSampleCache
    from lhotse_tpu_torch.dataset.input_strategies import AudioSamples
    from lhotse_tpu_torch.tracing import reset_tracing, set_tracing_enabled, tracing_report

    set_caching_enabled(True)  # the decoded-audio LRU, as bench.py's e2e legs
    set_tracing_enabled(True)
    all_cuts = list(CutSet.from_jsonl_lazy(cuts_path))
    trainer = _Trainer(device)

    # -- e2e: the timed epoch ----------------------------------------------
    aug, rir = _e2e_augmenter(device)
    loader, sampler = _e2e_loader(cuts_path, aug, device)
    kept = {}

    def keep(i, item, feats, feat_lens):
        staged = item[0]
        if i == 0:
            kept["first"] = (staged, feats.clone(), feat_lens.clone())
        if i == 2:  # three batches consumed
            kept["ckpt"] = loader.state_dict()
        if i in (3, 4):
            kept[i] = (item[1], staged.audio.cpu().numpy(),
                       {k: v.cpu().numpy() for k, v in staged.kwargs.items()}, feats.clone())

    reset_tracing()
    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    run = _run_epoch(loader, aug, trainer, on_batch=keep)
    launches = fbank_cuda.LAUNCHES
    n = len(run["items"])
    split = _host_split(tracing_report(), n, run["wait_s"])
    ids = [i for _, batch_ids, *_ in run["items"] for i in batch_ids]
    print(f"[{smi}] e2e epoch: {n} batches, {run['audio_s']!r} audio-s in {run['elapsed_s']!r} s "
          f"(host clock, AdamW steps included): {run['audio_s'] / run['elapsed_s']!r} audio-s/s; "
          f"losses {run['losses'][0]!r} -> {run['losses'][-1]!r}; fbank kernel launches {launches}")
    print(f"[{smi}] e2e {split}")
    if sorted(ids) != sorted(c.id for c in all_cuts):
        raise AssertionError("the e2e epoch did not bring every cut exactly once")
    for _, batch_ids, lens, _, _ in run["items"]:
        ub, size = next((ub, size) for ub, size in E2E_BUCKETS if lens.max() <= ub * SR)
        if len(batch_ids) > size:
            raise AssertionError(f"a {ub:g} s batch of {len(batch_ids)} exceeds its size {size}")
    if launches != n:
        raise AssertionError(f"the e2e path launched the fbank kernel {launches} times for {n} batches")
    losses = run["losses"]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"the e2e loss did not fall or is not finite: {losses}")
    staged0, feats0, lens0 = kept["first"]
    _check_chain(staged0, feats0, lens0, "int16", rir, device, fbank_cuda,
                 path="e2e first batch")

    # -- e2e: a second epoch under torch.profiler ------------------------------
    sampler.set_epoch(1)
    wall_ms, busy_ms, by_name = _device_busy(lambda: _run_epoch(loader, aug, trainer))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"[{smi}] e2e epoch 2 under torch.profiler: wall {wall_ms!r} ms, device busy "
          f"{busy_ms!r} ms ({busy_ms / wall_ms!r} of the wall); device ms by activity: "
          + "; ".join(f"{k[:60]} {v!r}" for k, v in top))

    # -- e2e: mid-epoch resume into a fresh sampler, augmenter and loader ------
    aug2, _ = _e2e_augmenter(device)
    loader2, _ = _e2e_loader(cuts_path, aug2, device)
    loader2.load_state_dict(kept["ckpt"])
    it2 = iter(loader2)
    for i in (3, 4):
        staged, batch_ids, _, _ = next(it2)
        feats, _ = aug2.compute(staged)
        want_ids, want_audio, want_draws, want_feats = kept[i]
        same = (batch_ids == want_ids and np.array_equal(staged.audio.cpu().numpy(), want_audio)
                and set(staged.kwargs) == set(want_draws)
                and all(np.array_equal(v.cpu().numpy(), want_draws[k])
                        for k, v in staged.kwargs.items())
                and torch.equal(feats, want_feats))
        if not same:
            raise AssertionError(f"batch {i + 1} after the resume differs from the first run")
    it2.close()
    print(f"e2e mid-epoch resume from loader.state_dict() after batch 3: batches 4 and 5 "
          f"equal (cut ids, wire audio, draws, torch.equal features)")

    # -- e2e_cached: two epochs over the device sample cache -------------------
    cache = DeviceSampleCache(capacity_seconds=2 * 3600)
    aug_c, _ = _e2e_augmenter(device, sample_cache=cache)
    loader_c, sampler_c = _e2e_loader(cuts_path, aug_c, device, cached=True)
    cached_out = []

    def keep_cached(i, item, feats, feat_lens):
        cached_out.append((item[0].aug_counter, list(item[1]), feats.clone()))

    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    epochs = []
    for epoch in range(2):
        sampler_c.set_epoch(epoch)
        cached_out.clear()
        reset_tracing()
        epochs.append(_run_epoch(loader_c, aug_c, trainer, on_batch=keep_cached))
        report = tracing_report()
        r = epochs[-1]
        print(f"[{smi}] e2e_cached epoch {epoch + 1}: {len(r['items'])} batches, "
              f"{r['audio_s']!r} audio-s in {r['elapsed_s']!r} s: "
              f"{r['audio_s'] / r['elapsed_s']!r} audio-s/s (AdamW steps included); "
              f"{_host_split(report, len(r['items']), r['wait_s'])}")
    launches_cached = fbank_cuda.LAUNCHES
    first, second = epochs
    if not all(kind == "StagedBatch" and inserted and not ph
               for kind, _, _, ph, inserted in first["items"]):
        raise AssertionError("e2e_cached epoch 1 was not all misses with inserts")
    if not all(kind == "CachedBatch" and ph for kind, _, _, ph, _ in second["items"]):
        raise AssertionError("e2e_cached epoch 2 was not all hits with (B, 0) placeholders")
    if tracing_report().get("audio.decode", {}).get("calls", 0):
        raise AssertionError("e2e_cached epoch 2 decoded audio on the host")
    n_cached = len(first["items"]) + len(second["items"])
    if launches_cached != n_cached:
        raise AssertionError(
            f"e2e_cached launched the fbank kernel {launches_cached} times for {n_cached} batches")
    # Epoch 2 against a cache-less augmenter on the decoded audio, at the
    # counters epoch 2 was staged with.
    ref, _ = _e2e_augmenter(device)
    ref.load_state_dict({"seed": 0, "next_counter": cached_out[0][0]})
    by_id = {c.id: c for c in all_cuts}
    err = 0.0
    for _, batch_ids, feats in cached_out:
        audio, lens = AudioSamples()(CutSet.from_cuts([by_id[i] for i in batch_ids]))
        ref_feats, ref_lens = ref(audio, lens)
        real = ref_lens > 0
        err = max(err, (feats[real] - ref_feats[real]).abs().max().item())
    print(f"e2e_cached epoch 2 vs the wire path: max_abs_err {err!r} (tol {CACHE_TOL}); "
          f"hit rate {cache.stats()['hit_rate']!r}, memory_bytes {cache.memory_bytes()}; "
          f"fbank kernel launches {launches_cached}")
    if not err <= CACHE_TOL:
        raise AssertionError("e2e_cached epoch 2 disagrees with the wire path")
    set_tracing_enabled(False)
    set_caching_enabled(False)
    return {"e2e": launches, "e2e_cached": launches_cached}


# -- 11. the precomputed-features path -------------------------------------------
LTC1_TICK = 2.0**-5  # the chunky archive's quantum at tick_power=-5
LOG_EPSILON = math.log(1e-10)  # the feature-domain padding of the collators


def _plain_extract(extractor, items) -> list:
    """``extractor.extract_batch(items)`` with the kernel's plain version on
    the card in place of the kernel: the same prepared, zero-padded batch,
    the same squeezed matrices, each item sliced to its frame count."""
    from lhotse_tpu_torch.ops import fbank_cuda

    device = extractor.device
    prepared = [extractor._prepare_item(np.asarray(x, np.float32)) for x in items]
    batch = np.zeros((len(prepared), max(len(p) for p in prepared)), np.float32)
    for i, p in enumerate(prepared):
        batch[i, : len(p)] = p
    Mc, Ms, fb, _ = extractor._layer()._fused_matrices()
    mats = fbank_cuda._squeeze_nyquist(*(fbank_cuda._as_f32(m, device) for m in (Mc, Ms, fb)))
    out = fbank_cuda.reference_fbank(torch.from_numpy(batch).to(device), *mats).cpu().numpy()
    return [out[i, : extractor._num_frames(len(x))] for i, x in enumerate(items)]


class _RecordFirstBatch:
    """Wraps ``extractor.extract_batch`` to keep the first call's items and
    features."""

    def __init__(self, extractor):
        self.first = None
        inner = extractor.extract_batch

        def extract_batch(items, sampling_rate, **kw):
            out = inner(items, sampling_rate, **kw)
            if self.first is None:
                self.first = ([np.asarray(x).copy() for x in items], [np.asarray(f).copy() for f in out])
            return out

        extractor.extract_batch = extract_batch


def _sampler_over(cuts, world_size: int = 1, rank: int = 0):
    """Phase 10's ``DynamicBucketingSampler`` (buckets, constraint, shuffle
    with seed 0) over another manifest of the same cuts, or a lazy CutSet;
    rank ``rank``'s partition of ``world_size``."""
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.dataset.sampling.dynamic_bucketing import (
        DynamicBucketingSampler, FixedBucketBatchSizeConstraint)

    return DynamicBucketingSampler(
        cuts if isinstance(cuts, CutSet) else CutSet.from_jsonl_lazy(cuts),
        constraint=FixedBucketBatchSizeConstraint(
            max_seq_len_buckets=[ub for ub, _ in E2E_BUCKETS],
            batch_sizes=[bsz for _, bsz in E2E_BUCKETS]),
        num_buckets=None, duration_bins=[ub for ub, _ in E2E_BUCKETS[:-1]],
        buffer_size=max(E2E_RECORDINGS, 16), shuffle=True, seed=0, world_size=world_size,
        rank=rank)


def _train_epoch(loader, trainer, device, on_batch=None) -> dict:
    """One epoch of ``K2SpeechRecognitionDataset`` batches of features (one
    supervision per cut) into the trainer's AdamW step on ``device``."""
    ids, losses, wait_s, audio_s = [], [], 0.0, 0.0
    it = iter(loader)
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            break
        wait_s += time.perf_counter() - t
        cuts = batch["supervisions"]["cut"]
        feats = torch.from_numpy(batch["inputs"]).to(device)
        feat_lens = torch.from_numpy(
            np.asarray(batch["supervisions"]["num_frames"], np.int64)).to(device)
        if on_batch is not None:
            on_batch(len(losses), cuts, batch)
        losses.append(trainer.step(feats, feat_lens))
        ids.extend(c.id for c in cuts)
        audio_s += sum(c.duration for c in cuts)
    torch.cuda.synchronize()
    return {"ids": ids, "losses": losses, "wait_s": wait_s, "audio_s": audio_s,
            "elapsed_s": time.perf_counter() - t0}


def _check_epoch(name: str, run: dict, all_ids: list) -> None:
    if sorted(run["ids"]) != sorted(all_ids):
        raise AssertionError(f"the {name} epoch did not bring every cut exactly once")
    losses = run["losses"]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"the {name} loss did not fall or is not finite: {losses}")


def _phase_precomputed(cuts_path: Path, workdir: Path, device, fbank_cuda, smi: str) -> tuple:
    """11. The precomputed-features path at full width, on phase 10's FLAC
    corpus. ``precomputed_extract``: ``CutSet.compute_and_store_features_batch``
    with ``Fbank(device="cuda")`` into the default ``lilcom_chunky`` archive
    (first batch against the kernel's plain version, the archive against the
    kernel's output, a second decode equal to the first).
    ``precomputed_train``: the written manifest through phase 10's sampler,
    ``K2SpeechRecognitionDataset()`` (its default ``PrecomputedFeatures``)
    and ``DataLoader(prefetch_batches=3)`` into an AdamW step of
    ``Encoder(EncoderConfig())`` per batch (no kernel launch), a second epoch
    under ``torch.profiler``. ``on_the_fly``: the FLAC manifest through the
    same sampler with ``OnTheFlyFeatures(Fbank(device="cuda"))`` into the
    same step (one launch per batch; the first batch against the plain
    version, the CPU route and the precomputed batch of the same cuts).
    Returns the kernel's launches per path and the largest kernel-vs-plain
    error."""
    from lhotse_tpu_torch.caching import set_caching_enabled
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures, PrecomputedFeatures
    from lhotse_tpu_torch.dataset.loader import DataLoader
    from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
    from lhotse_tpu_torch.features import Fbank, FbankConfig
    from lhotse_tpu_torch.tracing import reset_tracing, set_tracing_enabled, tracing_report

    set_caching_enabled(False)  # every read decodes its bytes anew
    all_ids = [c.id for c in CutSet.from_jsonl_lazy(cuts_path)]

    # -- precomputed_extract ------------------------------------------------------
    extractor = Fbank(FbankConfig(device=device))
    recorder = _RecordFirstBatch(extractor)
    feats_cuts = workdir / "feats_cuts.jsonl"
    set_tracing_enabled(True)
    reset_tracing()
    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    stored = CutSet.from_jsonl_lazy(cuts_path).compute_and_store_features_batch(
        extractor, workdir / "feats", manifest_path=feats_cuts, batch_duration=600,
        num_workers=4)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    launches_extract = fbank_cuda.LAUNCHES
    report = tracing_report()
    read_extract_s = report.get("CutSet.compute_and_store_features_batch", {}).get("total_s", 0.0)
    decode_s = report.get("audio.decode", {}).get("total_s", 0.0)
    stored = {c.id: c for c in stored}
    audio_s = sum(c.duration for c in stored.values())
    archive = workdir / "feats.lca"
    f32_bytes = sum(4 * c.features.num_frames * c.features.num_features for c in stored.values())
    items, kernel_out = recorder.first
    plain = _plain_extract(extractor, items)
    extract_err = max(float(np.abs(a - b).max()) for a, b in zip(kernel_out, plain))
    first_ids = [i for i in all_ids if i in stored][: len(items)]
    archive_err, redecode_equal = 0.0, True
    for cid, k in zip(first_ids, kernel_out):
        got = stored[cid].load_features()
        archive_err = max(archive_err, float(np.abs(got - k).max()))
        redecode_equal &= np.array_equal(got, stored[cid].load_features())
    print(f"[{smi}] precomputed_extract: {len(stored)} cuts, {audio_s!r} audio-s extracted and "
          f"stored in {extract_s!r} s: {audio_s / extract_s!r} audio-s/s (host clock, FLAC decode, "
          f"kernel, LTC1 encode and the archive write included); fbank kernel launches "
          f"{launches_extract}; archive {archive.stat().st_size} B, "
          f"{archive.stat().st_size / f32_bytes!r} of float32 ({f32_bytes} B); of the wall, "
          f"read + extract {read_extract_s!r} s (FLAC decode {decode_s!r} s summed over the 4 "
          f"read threads), the rest the writer thread's LTC1 encode and write")
    print(f"precomputed_extract first batch ({len(items)} cuts): kernel vs its plain version "
          f"max_abs_err {extract_err!r} (tol {KERNEL_TOL}); archive vs the kernel's output "
          f"{archive_err!r} (tol {LTC1_TICK / 2 + 1e-6!r}); a second decode equal: {redecode_equal}")
    if sorted(stored) != sorted(all_ids):
        raise AssertionError("precomputed_extract did not store every cut")
    if launches_extract < 1 or not extract_err <= KERNEL_TOL:
        raise AssertionError("precomputed_extract: the kernel did not run or disagrees with plain")
    if not archive_err <= LTC1_TICK / 2 + 1e-6 or not redecode_equal:
        raise AssertionError("the archive's features disagree with the kernel's output")

    # -- precomputed_train ---------------------------------------------------------
    trainer = _Trainer(device)
    dataset = K2SpeechRecognitionDataset(return_cuts=True)
    if not isinstance(dataset.input_strategy, PrecomputedFeatures):
        raise AssertionError("K2SpeechRecognitionDataset() does not default to PrecomputedFeatures")
    sampler = _sampler_over(feats_cuts)
    loader = DataLoader(sampler, dataset, prefetch_batches=3)
    first_pre = {}

    def keep_pre(i, cuts, batch):
        if i == 0:
            first_pre["ids"] = [c.id for c in cuts]

    reset_tracing()
    fbank_cuda.LAUNCHES = 0
    run = _train_epoch(loader, trainer, device, on_batch=keep_pre)
    launches_train = fbank_cuda.LAUNCHES
    n = len(run["losses"])
    read_ms = tracing_report().get("dataset.assemble", {}).get("total_s", 0.0) * 1e3 / n
    sampler.set_epoch(1)
    wall_ms, busy_ms, by_name = _device_busy(lambda: _train_epoch(loader, trainer, device))
    print(f"[{smi}] precomputed_train epoch: {n} batches, {run['audio_s']!r} audio-s in "
          f"{run['elapsed_s']!r} s (host clock, AdamW steps included): "
          f"{run['audio_s'] / run['elapsed_s']!r} audio-s/s; losses {run['losses'][0]!r} -> "
          f"{run['losses'][-1]!r}; host ms per batch of the feature read (dataset.assemble, "
          f"loader thread) {read_ms!r}, consumer's wait in next() {run['wait_s'] * 1e3 / n!r}; "
          f"epoch 2 under torch.profiler: wall {wall_ms!r} ms, device busy {busy_ms!r} ms "
          f"({busy_ms / wall_ms!r} of the wall); fbank kernel launches {launches_train}")
    _check_epoch("precomputed_train", run, all_ids)
    if launches_train != 0:
        raise AssertionError(f"precomputed_train launched the fbank kernel {launches_train} times")

    # -- on_the_fly -----------------------------------------------------------------
    fly_extractor = Fbank(FbankConfig(device=device))
    fly_recorder = _RecordFirstBatch(fly_extractor)
    loader = DataLoader(_sampler_over(cuts_path), K2SpeechRecognitionDataset(
        return_cuts=True, input_strategy=OnTheFlyFeatures(fly_extractor)), prefetch_batches=3)
    first_fly = {}

    def keep_fly(i, cuts, batch):
        if i == 0:
            first_fly["cuts"] = CutSet.from_cuts(cuts)
            first_fly["inputs"] = batch["inputs"]

    reset_tracing()
    fbank_cuda.LAUNCHES = 0
    run = _train_epoch(loader, trainer, device, on_batch=keep_fly)
    launches_fly = fbank_cuda.LAUNCHES
    n = len(run["losses"])
    assemble_ms = tracing_report().get("dataset.assemble", {}).get("total_s", 0.0) * 1e3 / n
    set_tracing_enabled(False)
    items, kernel_out = fly_recorder.first
    plain_out = _plain_extract(fly_extractor, items)
    fly_plain_err = max(float(np.abs(a - b).max()) for a, b in zip(kernel_out, plain_out))
    # The CPU route takes its DFT products in float64. Where a tone's
    # leakage nearly cancels in the lowest mel bins, every float32 route is
    # ~2e-4 from it; the kernel must lose no more than its plain version.
    cpu_feats, _ = OnTheFlyFeatures(Fbank(FbankConfig(device="cpu")))(first_fly["cuts"])
    cpu_err = float(np.abs(first_fly["inputs"] - cpu_feats).max())
    plain_batch = np.full_like(first_fly["inputs"], LOG_EPSILON)
    for i, f in enumerate(plain_out):
        plain_batch[i, : len(f)] = f
    plain_cpu_err = float(np.abs(plain_batch - cpu_feats).max())
    pre_feats, _ = PrecomputedFeatures()(CutSet.from_cuts(
        [stored[c.id] for c in first_fly["cuts"]]))
    pre_err = float(np.abs(first_fly["inputs"] - pre_feats).max())
    print(f"[{smi}] on_the_fly epoch: {n} batches, {run['audio_s']!r} audio-s in "
          f"{run['elapsed_s']!r} s (host clock, AdamW steps included): "
          f"{run['audio_s'] / run['elapsed_s']!r} audio-s/s; losses {run['losses'][0]!r} -> "
          f"{run['losses'][-1]!r}; host ms per batch of decode+extract+collate "
          f"(dataset.assemble) {assemble_ms!r}; fbank kernel launches {launches_fly}")
    print(f"on_the_fly first batch: kernel vs its plain version {fly_plain_err!r} (tol {KERNEL_TOL}); "
          f"vs the CPU route (float64 DFT products) {cpu_err!r}, where the plain version is "
          f"{plain_cpu_err!r} (tol: {KERNEL_TOL} or twice the plain version's); vs the "
          f"precomputed batch of the same "
          f"cuts {pre_err!r} (tol {LTC1_TICK / 2 + KERNEL_TOL!r})")
    _check_epoch("on_the_fly", run, all_ids)
    if launches_fly != n:
        raise AssertionError(f"on_the_fly launched the fbank kernel {launches_fly} times for {n} batches")
    if not fly_plain_err <= KERNEL_TOL or not cpu_err <= max(KERNEL_TOL, 2 * plain_cpu_err):
        raise AssertionError("on_the_fly features disagree with the plain version or the CPU route")
    if not pre_err <= LTC1_TICK / 2 + KERNEL_TOL:
        raise AssertionError("on_the_fly features disagree with the precomputed batch")
    launches = {"precomputed_extract": launches_extract, "precomputed_train": launches_train,
                "on_the_fly": launches_fly}
    return launches, max(extract_err, fly_plain_err)


# -- 12. the augmented training path ----------------------------------------------
MIXED_SHARE = (0.35, 0.65)  # mix_prob 0.5 over 160 cuts


def _span_ms(report: dict, n: int) -> str:
    return ", ".join(
        f"{span} {report.get(span, {}).get('total_s', 0.0) * 1e3 / n!r}"
        for span in ("audio.decode", "audio.transforms", "dataset.assemble"))


def _augmented_epochs(loader, sampler, trainer, device, on_batch) -> tuple:
    """Two epochs: the first timed on the host clock with tracing, the
    second under ``torch.profiler`` for the device's busy share."""
    from lhotse_tpu_torch.tracing import reset_tracing, tracing_report

    reset_tracing()
    run = _train_epoch(loader, trainer, device, on_batch=lambda i, c, b: on_batch(0, i, c, b))
    report = tracing_report()
    sampler.set_epoch(1)
    second = {}

    def epoch2():
        second.update(_train_epoch(loader, trainer, device,
                                   on_batch=lambda i, c, b: on_batch(1, i, c, b)))

    wall_ms, busy_ms, _ = _device_busy(epoch2)
    return run, second, report, busy_ms / wall_ms


def _phase_augmented(cuts_path: Path, noise_path: Path, feats_cuts: Path, workdir: Path, device,
                     fbank_cuda, smi: str) -> tuple:
    """12. The augmented training path at full width, on phase 10's corpus
    and its noise pool. ``augmented_on_the_fly``: the shape of
    ``bench.py::bench_host_pipeline`` (bench.py:309-340),
    ``CutSet.from_jsonl_lazy(cuts).perturb_speed(1.1).mix(noise, snr=(10, 20),
    mix_prob=0.5, seed=7)`` with the decoded-audio LRU on → phase 10's
    sampler → ``K2SpeechRecognitionDataset`` with
    ``OnTheFlyFeatures(Fbank(device="cuda"))`` → ``DataLoader`` → an AdamW
    step per batch, two epochs (every perturbed cut once per epoch, a mixed
    share near one half, one launch per batch, the first batch against the
    kernel's plain version on the same mixed audio, a falling loss).
    ``precomputed_mix_extract``: the noise pool's features extracted on the
    kernel into phase 11's archive. ``precomputed_mix``: phase 11's stored
    manifest through ``CutMix(noise with features, p=0.5, snr=(10, 20),
    preserve_id=True, seed=7)`` and ``PrecomputedFeatures`` into the step,
    two epochs (no launch; mixed features never below the lead track's
    stored features by more than half a tick). Returns the kernel's launches
    per path and the largest kernel-vs-plain error."""
    from lhotse_tpu_torch.caching import set_caching_enabled
    from lhotse_tpu_torch.cut import CutSet, MixedCut
    from lhotse_tpu_torch.dataset.cut_transforms import CutMix
    from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
    from lhotse_tpu_torch.dataset.loader import DataLoader
    from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
    from lhotse_tpu_torch.features import Fbank, FbankConfig
    from lhotse_tpu_torch.tracing import reset_tracing, set_tracing_enabled, tracing_report

    sup_ids = sorted(f"{s.id}_sp1.1" for c in CutSet.from_jsonl_lazy(cuts_path) for s in c.supervisions)
    n_cuts = len(sup_ids)

    # -- augmented_on_the_fly ------------------------------------------------------
    set_caching_enabled(True)  # bench.py's setting: the noise pool is re-read per mixed cut
    augmented = CutSet.from_jsonl_lazy(cuts_path).perturb_speed(1.1).mix(
        CutSet.from_file(noise_path), snr=(10, 20), mix_prob=0.5, seed=7)
    extractor = Fbank(FbankConfig(device=device))
    recorder = _RecordFirstBatch(extractor)
    sampler = _sampler_over(augmented)
    loader = DataLoader(sampler, K2SpeechRecognitionDataset(
        return_cuts=True, input_strategy=OnTheFlyFeatures(extractor)), prefetch_batches=3)
    seen = ([], [])
    mixed = [0, 0]

    def count(epoch, i, cuts, batch):
        seen[epoch].extend(s.id for c in cuts for s in c.supervisions)
        mixed[epoch] += sum(isinstance(c, MixedCut) for c in cuts)

    trainer = _Trainer(device)
    set_tracing_enabled(True)
    fbank_cuda.LAUNCHES = 0
    run, run2, report, busy = _augmented_epochs(loader, sampler, trainer, device, count)
    launches_aug = fbank_cuda.LAUNCHES
    set_caching_enabled(False)
    n = len(run["losses"])
    n_batches = n + len(run2["losses"])
    items, kernel_out = recorder.first
    plain_out = _plain_extract(extractor, items)
    aug_err = max(float(np.abs(a - b).max()) for a, b in zip(kernel_out, plain_out))
    losses = run["losses"] + run2["losses"]
    share = [m / n_cuts for m in mixed]
    print(f"[{smi}] augmented_on_the_fly epoch 1: {n} batches, {run['audio_s']!r} audio-s in "
          f"{run['elapsed_s']!r} s (host clock, AdamW steps included): "
          f"{run['audio_s'] / run['elapsed_s']!r} audio-s/s; host ms per batch (loader thread) "
          f"{_span_ms(report, n)}; epoch 2 under torch.profiler: {run2['audio_s'] / run2['elapsed_s']!r} "
          f"audio-s/s, device busy {busy!r} of the wall; mixed share {share[0]!r} / {share[1]!r}; "
          f"fbank kernel launches {launches_aug} for {n_batches} batches; losses {losses[0]!r} -> "
          f"{losses[-1]!r}")
    print(f"augmented_on_the_fly first batch ({len(items)} cuts of mixed audio): kernel vs its "
          f"plain version max_abs_err {aug_err!r} (tol {KERNEL_TOL})")
    for epoch in (0, 1):
        if sorted(seen[epoch]) != sup_ids:
            raise AssertionError(f"augmented epoch {epoch + 1} did not bring every perturbed cut once")
        if not MIXED_SHARE[0] <= share[epoch] <= MIXED_SHARE[1]:
            raise AssertionError(f"augmented epoch {epoch + 1}: mixed share {share[epoch]} off {MIXED_SHARE}")
    if launches_aug != n_batches:
        raise AssertionError(f"augmented_on_the_fly launched {launches_aug} times for {n_batches} batches")
    if not aug_err <= KERNEL_TOL:
        raise AssertionError("augmented_on_the_fly: the kernel disagrees with its plain version")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"the augmented loss did not fall or is not finite: {losses}")

    # -- precomputed_mix_extract ----------------------------------------------------
    noise_feats_path = workdir / "noise_feats.jsonl"
    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    noise_feats = CutSet.from_file(noise_path).compute_and_store_features_batch(
        Fbank(FbankConfig(device=device)), workdir / "feats", manifest_path=noise_feats_path,
        batch_duration=600, num_workers=4)
    torch.cuda.synchronize()
    launches_noise = fbank_cuda.LAUNCHES
    noise_feats = noise_feats.to_eager()
    print(f"precomputed_mix_extract: {len(noise_feats)} noise cuts stored into the archive; "
          f"fbank kernel launches {launches_noise}")
    if len(noise_feats) != 4 or launches_noise < 1:
        raise AssertionError("precomputed_mix_extract did not store the noise pool on the kernel")

    # -- precomputed_mix --------------------------------------------------------------
    cut_mix = CutMix(noise_feats, p=0.5, snr=(10, 20), preserve_id=True, seed=7)
    sampler = _sampler_over(feats_cuts)
    loader = DataLoader(sampler, K2SpeechRecognitionDataset(
        return_cuts=True, cut_transforms=[cut_mix]), prefetch_batches=3)
    all_ids = sorted(c.id for c in CutSet.from_jsonl_lazy(feats_cuts))
    # CutMix pads each mixed cut to the batch's longest: rates count the corpus's audio.
    corpus_s = sum(c.duration for c in CutSet.from_jsonl_lazy(feats_cuts))
    ids, pmixed, below = ([], []), [0, 0], []

    def check(epoch, i, cuts, batch):
        ids[epoch].extend(c.id for c in cuts)
        pmixed[epoch] += sum(isinstance(c, MixedCut) for c in cuts)
        if epoch == 0 and i == 0:
            for row, cut in enumerate(cuts):
                if isinstance(cut, MixedCut):
                    lead = cut.tracks[0].cut.load_features()
                    below.append(float(np.max(lead - batch["inputs"][row, : len(lead)])))

    trainer = _Trainer(device)
    fbank_cuda.LAUNCHES = 0
    run, run2, report, busy = _augmented_epochs(loader, sampler, trainer, device, check)
    launches_mix = fbank_cuda.LAUNCHES
    set_tracing_enabled(False)
    n = len(run["losses"])
    losses = run["losses"] + run2["losses"]
    share = [m / len(all_ids) for m in pmixed]
    worst_below = max(below) if below else float("nan")
    print(f"[{smi}] precomputed_mix epoch 1: {n} batches, {corpus_s!r} audio-s of the corpus "
          f"({run['audio_s']!r} after CutMix's padding) in {run['elapsed_s']!r} s (host clock, AdamW "
          f"steps included): {corpus_s / run['elapsed_s']!r} audio-s/s; host ms per batch (loader "
          f"thread) {_span_ms(report, n)}; epoch 2 under torch.profiler: {corpus_s / run2['elapsed_s']!r} "
          f"audio-s/s, device busy {busy!r} of the wall; mixed share {share[0]!r} / {share[1]!r}; "
          f"fbank kernel launches {launches_mix}; losses {losses[0]!r} -> {losses[-1]!r}")
    print(f"precomputed_mix first batch: {len(below)} mixed cuts, the lead track's stored features "
          f"above the mix by at most {worst_below!r} (tol {LTC1_TICK / 2!r})")
    for epoch in (0, 1):
        if sorted(ids[epoch]) != all_ids:
            raise AssertionError(f"precomputed_mix epoch {epoch + 1} did not bring every cut once")
        if not MIXED_SHARE[0] <= share[epoch] <= MIXED_SHARE[1]:
            raise AssertionError(f"precomputed_mix epoch {epoch + 1}: mixed share {share[epoch]}")
    if not below or not worst_below <= LTC1_TICK / 2:
        raise AssertionError("precomputed_mix: a mix fell below its lead track's features")
    if launches_mix != 0:
        raise AssertionError(f"precomputed_mix launched the fbank kernel {launches_mix} times")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"the precomputed_mix loss did not fall or is not finite: {losses}")
    launches = {"augmented_on_the_fly": launches_aug, "precomputed_mix_extract": launches_noise,
                "precomputed_mix": launches_mix}
    return launches, aug_err


# -- 13. the Shar corpus path ---------------------------------------------------------
SHAR_SHARD_SIZE = 20  # 160 cuts -> 8 shards


def _shar_bytes(out: Path) -> dict:
    """Bytes on disk per Shar field (``cuts``, ``recording``, ``features``)
    and of the ``.idx`` sidecars."""
    sizes = {}
    for p in out.iterdir():
        key = "idx" if p.suffix == ".idx" else p.name.split(".")[0]
        sizes[key] = sizes.get(key, 0) + p.stat().st_size
    return sizes


def _padded(feats: list) -> tuple:
    """A list of (frames, mels) arrays -> the (B, T, mels) numpy batch padded
    with ``LOG_EPSILON`` and the frame counts."""
    lens = [len(f) for f in feats]
    batch = np.full((len(feats), max(lens), feats[0].shape[1]), LOG_EPSILON, np.float32)
    for i, f in enumerate(feats):
        batch[i, : len(f)] = f
    return batch, lens


def _pad_feats(feats: list, device):
    """``_padded`` on ``device``."""
    batch, lens = _padded(feats)
    return torch.from_numpy(batch).to(device), torch.tensor(lens, dtype=torch.int64, device=device)


def _streaming_epoch(loader, extractor, trainer, device) -> dict:
    """One epoch of ``torch.utils.data.DataLoader`` batches of audio from
    the workers: the fbank kernel on each in this process, the padded
    features into the trainer's step. Returns the cut ids, each cut's shard
    and worker, the losses and the host-clock times."""
    ids, shard_workers, losses, wait_s, audio_s = [], {}, [], 0.0, 0.0
    it = iter(loader)
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            break
        wait_s += time.perf_counter() - t
        cuts = batch["supervisions"]["cut"]
        items = [batch["inputs"][i, : c.num_samples] for i, c in enumerate(cuts)]
        feats, feat_lens = _pad_feats(extractor.extract_batch(items, SR), device)
        losses.append(trainer.step(feats, feat_lens))
        for c in cuts:
            ids.append(c.id)
            shard_workers.setdefault(str(c.shard_origin), set()).add(c.dataloading_info["worker_id"])
        audio_s += sum(c.duration for c in cuts)
    torch.cuda.synchronize()
    return {"ids": ids, "shard_workers": shard_workers, "losses": losses, "wait_s": wait_s,
            "audio_s": audio_s, "elapsed_s": time.perf_counter() - t0}


def _phase_shar(cuts_path: Path, feats_cuts: Path, workdir: Path, device, fbank_cuda,
                smi: str) -> tuple:
    """13. The Shar corpus path at full width, on phase 10's corpus and
    phase 11's stored features. ``shar_export``: phase 11's manifest through
    ``to_shar(fields={"recording": "flac", "features": "lilcom"},
    shard_size=20, compress_jsonl=False)`` (8 shards with their ``.idx``
    files; audio read back equal to the FLAC sources, features within one
    LTC1 tick of the archive's). ``shar_on_the_fly``: the cuts and
    recording shards through ``CutSet.from_shar(split_for_dataloading=True,
    shuffle_shards=True, seed=0)`` → phase 10's sampler →
    ``IterableDatasetWrapper(K2SpeechRecognitionDataset(AudioSamples()))`` →
    ``torch.utils.data.DataLoader(batch_size=None, num_workers=2)`` (forked
    workers, host work only), ``Fbank(device="cuda").extract_batch`` on each
    batch in this process and an AdamW step, two epochs (each cut once per
    epoch, each shard read by one worker, both workers used).
    ``shar_indexed``: the indexed shards, shuffled (``LazyIndexedSharIterator``)
    → the sampler → ``OnTheFlyFeatures`` on the card → ``DataLoader`` → the
    step; a checkpoint after batch 3 resumed in a fresh loader through the
    seek backend, equal batches. ``shar_precomputed``: the features shards
    through ``K2SpeechRecognitionDataset()`` into the step, no launch.
    Returns the kernel's launches per path and the largest kernel-vs-plain
    error."""
    from lhotse_tpu_torch.caching import set_caching_enabled
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.dataset.dataloading import make_worker_init_fn
    from lhotse_tpu_torch.dataset.input_strategies import AudioSamples, OnTheFlyFeatures
    from lhotse_tpu_torch.dataset.iterable_dataset import IterableDatasetWrapper
    from lhotse_tpu_torch.dataset.loader import DataLoader
    from lhotse_tpu_torch.dataset.sampling import checkpoint_backends, dynamic_bucketing
    from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
    from lhotse_tpu_torch.features import Fbank, FbankConfig
    from lhotse_tpu_torch.shar.readers import LazyIndexedSharIterator
    from lhotse_tpu_torch.tracing import reset_tracing, set_tracing_enabled, tracing_report

    set_caching_enabled(False)
    all_ids = sorted(c.id for c in CutSet.from_jsonl_lazy(cuts_path))
    out = workdir / "shar"

    # -- shar_export -----------------------------------------------------------------
    t0 = time.perf_counter()
    paths = CutSet.from_jsonl_lazy(feats_cuts).to_shar(
        out, fields={"recording": "flac", "features": "lilcom"}, shard_size=SHAR_SHARD_SIZE,
        compress_jsonl=False)
    export_s = time.perf_counter() - t0
    sizes = _shar_bytes(out)
    n_idx = len(list(out.glob("*.idx")))
    sources = {c.id: c for c in CutSet.from_jsonl_lazy(feats_cuts)}
    audio_equal, feat_err, feats_identical = True, 0.0, True
    for cut in CutSet.from_shar(in_dir=out):
        src = sources[cut.id]
        audio_equal &= np.array_equal(cut.load_audio(), src.load_audio())
        got, want = cut.load_features(), src.load_features()
        feat_err = max(feat_err, float(np.abs(got - want).max()))
        feats_identical &= np.array_equal(got, want)
    audio_s = sum(c.duration for c in sources.values())
    print(f"[{smi}] shar_export: {len(sources)} cuts, {audio_s!r} audio-s into "
          f"{len(paths['cuts'])} shards in {export_s!r} s: {audio_s / export_s!r} audio-s/s (host "
          f"clock: FLAC and LTC1 decode, FLAC and LTC1 encode, tar writes and indexing); bytes per "
          f"field {sizes}; {n_idx} .idx files; audio read back equal to the FLAC sources: "
          f"{audio_equal}; features vs phase 11's archive max_abs {feat_err!r} (tol {LTC1_TICK!r}), "
          f"identical: {feats_identical}")
    n_shards = math.ceil(len(all_ids) / SHAR_SHARD_SIZE)
    if sorted(sources) != all_ids or len(paths["cuts"]) != n_shards or n_idx != 3 * n_shards:
        raise AssertionError(f"shar_export wrote {len(paths['cuts'])} shards, {n_idx} indexes")
    if not audio_equal or not feat_err <= LTC1_TICK:
        raise AssertionError("shar_export: the shards' data disagree with their sources")

    # -- shar_on_the_fly -----------------------------------------------------------------
    streaming = CutSet.from_shar(
        fields={"cuts": paths["cuts"], "recording": paths["recording"]}, indexed=False,
        split_for_dataloading=True, shuffle_shards=True, seed=0)
    wrapper = IterableDatasetWrapper(
        K2SpeechRecognitionDataset(return_cuts=True, input_strategy=AudioSamples()),
        _sampler_over(streaming))
    loader = torch.utils.data.DataLoader(
        wrapper, batch_size=None, num_workers=2, worker_init_fn=make_worker_init_fn(seed=0),
        multiprocessing_context="fork")
    extractor = Fbank(FbankConfig(device=device))
    recorder = _RecordFirstBatch(extractor)
    trainer = _Trainer(device)
    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    wrapper.set_epoch(0)
    run = _streaming_epoch(loader, extractor, trainer, device)
    wrapper.set_epoch(1)
    run2 = {}
    wall_ms, busy_ms, _ = _device_busy(
        lambda: run2.update(_streaming_epoch(loader, extractor, trainer, device)))
    launches_stream = fbank_cuda.LAUNCHES
    n_batches = len(run["losses"]) + len(run2["losses"])
    items, kernel_out = recorder.first
    stream_err = max(float(np.abs(a - b).max()) for a, b in zip(kernel_out, _plain_extract(extractor, items)))
    losses = run["losses"] + run2["losses"]
    print(f"[{smi}] shar_on_the_fly (torch DataLoader, 2 forked workers, the kernel in the main "
          f"process) epoch 1: {len(run['losses'])} batches, {run['audio_s']!r} audio-s in "
          f"{run['elapsed_s']!r} s: {run['audio_s'] / run['elapsed_s']!r} audio-s/s; consumer's "
          f"wait in next() {run['wait_s'] * 1e3 / len(run['losses'])!r} ms per batch (the "
          f"dataset.assemble and audio.decode spans run in the worker processes: not collected); "
          f"epoch 2 under torch.profiler {run2['audio_s'] / run2['elapsed_s']!r} audio-s/s, device "
          f"busy {busy_ms / wall_ms!r} of the wall; fbank kernel launches {launches_stream} for "
          f"{n_batches} batches; losses {losses[0]!r} -> {losses[-1]!r}; first batch kernel vs plain "
          f"{stream_err!r} (tol {KERNEL_TOL})")
    for epoch, r in enumerate((run, run2)):
        if sorted(r["ids"]) != all_ids:
            raise AssertionError(f"shar_on_the_fly epoch {epoch + 1} did not bring every cut once")
        workers = r["shard_workers"]
        if len(workers) != n_shards or any(len(w) != 1 for w in workers.values()) or set().union(
                *workers.values()) != {0, 1}:
            raise AssertionError(f"shar_on_the_fly epoch {epoch + 1}: shards by worker {workers}")
    if launches_stream != n_batches or not stream_err <= KERNEL_TOL:
        raise AssertionError("shar_on_the_fly: launches or the kernel's result are off")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"the shar_on_the_fly loss did not fall or is not finite: {losses}")

    # -- shar_indexed --------------------------------------------------------------------
    def indexed_loader():
        cuts = CutSet.from_shar(in_dir=out, shuffle_shards=True, seed=0)
        if not (isinstance(cuts.data, LazyIndexedSharIterator) and cuts.has_constant_time_access):
            raise AssertionError(f"from_shar did not open the indexed reader: {type(cuts.data)}")
        fly = Fbank(FbankConfig(device=device))
        return DataLoader(_sampler_over(cuts), K2SpeechRecognitionDataset(
            return_cuts=True, input_strategy=OnTheFlyFeatures(fly)), prefetch_batches=3), fly

    loader, fly = indexed_loader()
    fly_recorder = _RecordFirstBatch(fly)
    batches, state, losses, ids = [], None, [], []
    set_tracing_enabled(True)
    reset_tracing()
    fbank_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    for i, batch in enumerate(loader):
        cuts = batch["supervisions"]["cut"]
        feats = torch.from_numpy(batch["inputs"]).to(device)
        feat_lens = torch.from_numpy(np.asarray(batch["supervisions"]["num_frames"], np.int64)).to(device)
        losses.append(trainer.step(feats, feat_lens))
        batches.append(([c.id for c in cuts], batch["inputs"]))
        ids += [c.id for c in cuts]
        if i == 2:
            state = loader.state_dict()
    torch.cuda.synchronize()
    indexed_s = time.perf_counter() - t0
    launches_indexed = fbank_cuda.LAUNCHES
    report = tracing_report()
    set_tracing_enabled(False)
    n = len(batches)
    items, kernel_out = fly_recorder.first
    indexed_err = max(float(np.abs(a - b).max()) for a, b in zip(kernel_out, _plain_extract(fly, items)))
    chosen = []
    real_plan = dynamic_bucketing.plan_resume
    dynamic_bucketing.plan_resume = lambda *a, **k: chosen.append(real_plan(*a, **k)) or chosen[-1]
    try:
        resumed_loader, _ = indexed_loader()
        resumed_loader.load_state_dict(state)
        resumed = []
        fbank_cuda.LAUNCHES = 0
        wall_ms, resumed_busy_ms, _ = _device_busy(lambda: resumed.extend(
            ([c.id for c in b["supervisions"]["cut"]], b["inputs"]) for b in resumed_loader))
        launches_resumed = fbank_cuda.LAUNCHES
    finally:
        dynamic_bucketing.plan_resume = real_plan
    resume_equal = len(resumed) == n - 3 and all(
        a_ids == b_ids and torch.equal(torch.from_numpy(a), torch.from_numpy(b))
        for (a_ids, a), (b_ids, b) in zip(resumed, batches[3:]))
    seek = len(chosen) == 1 and isinstance(chosen[0], checkpoint_backends.SeekResume)
    print(f"[{smi}] shar_indexed (LazyIndexedSharIterator, shuffled; OnTheFlyFeatures on the card): "
          f"{n} batches, {audio_s!r} audio-s in {indexed_s!r} s: {audio_s / indexed_s!r} audio-s/s; "
          f"host ms per batch {_span_ms(report, n)}; fbank kernel launches {launches_indexed}; "
          f"first batch kernel vs plain {indexed_err!r}; resumed after batch 3 through "
          f"{type(chosen[0]).__name__ if chosen else None}: {len(resumed)} batches equal to the "
          f"uninterrupted run's: {resume_equal}, launches {launches_resumed}, device busy "
          f"{resumed_busy_ms / wall_ms!r} of the resumed run's wall (torch.profiler)")
    if sorted(ids) != all_ids or launches_indexed != n or not indexed_err <= KERNEL_TOL:
        raise AssertionError("shar_indexed: coverage, launches or the kernel's result are off")
    if not seek or not resume_equal or launches_resumed != n - 3:
        raise AssertionError(f"shar_indexed resume: seek {seek}, equal {resume_equal}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"the shar_indexed loss is not finite: {losses}")

    # -- shar_precomputed ------------------------------------------------------------------
    stored = CutSet.from_shar(fields={"cuts": paths["cuts"], "features": paths["features"]})
    loader = DataLoader(_sampler_over(stored), K2SpeechRecognitionDataset(return_cuts=True),
                        prefetch_batches=3)
    set_tracing_enabled(True)
    reset_tracing()
    fbank_cuda.LAUNCHES = 0
    run = _train_epoch(loader, trainer, device)
    launches_pre = fbank_cuda.LAUNCHES
    report = tracing_report()
    set_tracing_enabled(False)
    n = len(run["losses"])
    print(f"[{smi}] shar_precomputed (features shards, memory_lilcom): {n} batches, "
          f"{run['audio_s']!r} audio-s in {run['elapsed_s']!r} s: "
          f"{run['audio_s'] / run['elapsed_s']!r} audio-s/s; host ms per batch "
          f"{_span_ms(report, n)}; fbank kernel launches {launches_pre}")
    if sorted(run["ids"]) != all_ids or launches_pre != 0:
        raise AssertionError("shar_precomputed: coverage or launches are off")
    if not all(math.isfinite(x) for x in run["losses"]):
        raise AssertionError(f"the shar_precomputed loss is not finite: {run['losses']}")
    launches = {"shar_on_the_fly": launches_stream, "shar_indexed": launches_indexed,
                "shar_precomputed": launches_pre}
    return launches, max(stream_err, indexed_err)


# -- 14. the recipe path ---------------------------------------------------------------
# Two LibriSpeech splits of 4 speakers x 2 chapters x 10 utterances of 4-14 s
# (160 utterances, phase 10's scale; dev-clean has 2,703), and 8 sessions of
# 120 s with 16 segments of 3-8 s each (talk- and meeting-style long form).
RECIPE_SPLITS = ("dev-clean", "test-clean")
RECIPE_SPEAKERS, RECIPE_CHAPTERS, RECIPE_UTTERANCES = 4, 2, 10
LONG_SESSIONS, LONG_SECONDS, LONG_SEGMENTS = 8, 120.0, 16
LONG_OVERLAPS = ((3, 4), (10, 11))  # segment pairs that overlap by 1 s in each session
WINDOW_SECONDS = 10.0
RECIPE_WORDS = ("ALPHA", "BRAVO", "CHARLIE", "DELTA", "ECHO", "FOXTROT", "GOLF", "HOTEL")


def _synthesize_recipe_corpora(root: Path) -> tuple:
    """The two corpora of phase 14, as FLAC tone bursts (numpy seed 4321).
    A LibriSpeech tree under ``root / "LibriSpeech"``: per chapter a
    ``.trans.txt`` and, for the first chapter of each split, a
    LibriSpeech-Alignments ``.alignment.txt``. The long form: the sessions'
    RecordingSet and SupervisionSet as ``.jsonl.gz`` manifests (times on a
    10 ms grid, every other segment with word alignments, speakers
    alternating) and the same turns as an RTTM file. Returns the LibriSpeech
    directory and the paths of the two manifests and of the RTTM file."""
    from lhotse_tpu_torch.audio import Recording, RecordingSet
    from lhotse_tpu_torch.audio.flacio import write_flac
    from lhotse_tpu_torch.supervision import AlignmentItem, SupervisionSegment, SupervisionSet

    rng = np.random.RandomState(4321)

    def words():
        return [RECIPE_WORDS[i] for i in rng.randint(0, len(RECIPE_WORDS), rng.randint(3, 12))]

    corpus = root / "LibriSpeech"
    for s, split in enumerate(RECIPE_SPLITS):
        for k in range(RECIPE_SPEAKERS):
            speaker = str(100 + 10 * s + k)
            for c in range(RECIPE_CHAPTERS):
                chapter = str(2000 + 100 * s + 10 * k + c)
                where = corpus / split / speaker / chapter
                where.mkdir(parents=True)
                lines, alignments = [], []
                for u in range(RECIPE_UTTERANCES):
                    utt = f"{speaker}-{chapter}-{u:04d}"
                    duration = float(rng.uniform(*E2E_SECONDS))
                    write_flac(str(where / f"{utt}.flac"), _tone_burst(rng, duration), SR)
                    text = words()
                    lines.append(f"{utt} {' '.join(text)}")
                    ends = np.floor(np.linspace(0, duration, len(text) + 1)[1:] * 1000) / 1000
                    alignments.append(f'{utt} "{",".join(text)}" "{",".join(map(str, ends))}"')
                (where / f"{speaker}-{chapter}.trans.txt").write_text("\n".join(lines) + "\n")
                if k == 0 and c == 0:
                    (where / f"{speaker}-{chapter}.alignment.txt").write_text(
                        "\n".join(alignments) + "\n")

    long_dir = root / "long"
    long_dir.mkdir()
    recordings, segments, rttm = [], [], []
    for r in range(LONG_SESSIONS):
        rid = f"session{r:02d}"
        write_flac(str(long_dir / f"{rid}.flac"), _tone_burst(rng, LONG_SECONDS), SR)
        recordings.append(Recording.from_file(long_dir / f"{rid}.flac"))
        while True:  # the segments and their pauses (the first a lead-in) within the session
            spans = np.round(rng.uniform(3.0, 8.0, LONG_SEGMENTS), 2)
            pauses = np.round(rng.uniform(0.5, 3.0, LONG_SEGMENTS), 2)
            if spans.sum() + pauses.sum() <= LONG_SECONDS - 0.5:
                break
        starts = np.cumsum(pauses) + np.concatenate([[0.0], np.cumsum(spans)[:-1]])
        for first, second in LONG_OVERLAPS:
            starts[second] = starts[first] + spans[first] - 1.0
        for i, (start, span) in enumerate(zip(np.round(starts, 2), spans)):
            start, span, text = float(start), float(span), words()
            step = round(span / len(text), 4)
            alignment = None if i % 2 else {"word": [
                AlignmentItem(w, round(start + j * step, 4), step) for j, w in enumerate(text)]}
            speaker = f"{rid}-{'ab'[i % 2]}"
            segments.append(SupervisionSegment(
                id=f"{rid}-{i:02d}", recording_id=rid, start=start, duration=span, channel=0,
                text=" ".join(text), speaker=speaker, language="English", alignment=alignment))
            rttm.append(f"SPEAKER {rid} 0 {start:.2f} {span:.2f} <NA> <NA> {speaker} <NA> <NA>")
    RecordingSet.from_recordings(recordings).to_file(root / "long_recordings.jsonl.gz")
    SupervisionSet.from_segments(segments).to_file(root / "long_supervisions.jsonl.gz")
    (root / "long.rttm").write_text("\n".join(rttm) + "\n")
    return (corpus, root / "long_recordings.jsonl.gz", root / "long_supervisions.jsonl.gz",
            root / "long.rttm")


FLY_MAX_DURATION = 180.0  # the on-the-fly legs' batches, in seconds of audio


def _fly_with_resume(name, cuts_path, trainer, device, fbank_cuda, smi, spans=None) -> tuple:
    """``SimpleCutSampler(max_duration=FLY_MAX_DURATION, shuffle=True, seed=0)`` over the
    cuts at ``cuts_path`` (or over a fresh ``CutSet`` from ``cuts_path()``
    where it is callable) → ``K2SpeechRecognitionDataset`` with
    ``OnTheFlyFeatures`` on the card → ``DataLoader`` → an AdamW step per
    batch, one epoch; then a resume after batch 3 whose batches must be
    ``torch.equal`` to the first run's, under ``torch.profiler`` for the
    device's busy share. ``spans``, where given, receives the tracing report
    of the first epoch and its batch count. Returns the launches of the epoch
    and the first batch's kernel-vs-plain error."""
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.dataset import SimpleCutSampler
    from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
    from lhotse_tpu_torch.dataset.loader import DataLoader
    from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
    from lhotse_tpu_torch.features import Fbank, FbankConfig
    from lhotse_tpu_torch.tracing import reset_tracing, tracing_report

    make_cuts = cuts_path if callable(cuts_path) else (lambda: CutSet.from_file(cuts_path))

    def loader_and_extractor():
        fly = Fbank(FbankConfig(device=device))
        sampler = SimpleCutSampler(make_cuts(), max_duration=FLY_MAX_DURATION, shuffle=True, seed=0)
        dataset = K2SpeechRecognitionDataset(return_cuts=True, input_strategy=OnTheFlyFeatures(fly))
        return DataLoader(sampler, dataset, prefetch_batches=3), fly

    all_ids = [c.id for c in make_cuts()]
    loader, fly = loader_and_extractor()
    recorder = _RecordFirstBatch(fly)
    kept, state = [], {}

    def keep(i, batch_cuts, batch):
        kept.append(([c.id for c in batch_cuts], batch["inputs"]))
        if i == 2:
            state["ckpt"] = loader.state_dict()

    reset_tracing()
    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    run = _train_epoch(loader, trainer, device, on_batch=keep)
    launches = fbank_cuda.LAUNCHES
    n = len(run["losses"])
    if spans is not None:
        spans.update(report=tracing_report(), batches=n)
    assemble_ms = tracing_report().get("dataset.assemble", {}).get("total_s", 0.0) * 1e3 / n
    items, kernel_out = recorder.first
    err = max(float(np.abs(a - b).max()) for a, b in zip(kernel_out, _plain_extract(fly, items)))
    resumed_loader, _ = loader_and_extractor()
    resumed_loader.load_state_dict(state["ckpt"])
    resumed = []
    fbank_cuda.LAUNCHES = 0
    wall_ms, busy_ms, _ = _device_busy(lambda: resumed.extend(
        ([c.id for c in b["supervisions"]["cut"]], b["inputs"]) for b in resumed_loader))
    launches_resumed = fbank_cuda.LAUNCHES
    resume_equal = len(resumed) == n - 3 and all(
        a_ids == b_ids and torch.equal(torch.from_numpy(a), torch.from_numpy(b))
        for (a_ids, a), (b_ids, b) in zip(resumed, kept[3:]))
    print(f"[{smi}] {name}: {len(all_ids)} cuts, epoch {n} batches, {run['audio_s']!r} "
          f"audio-s (one channel per cut) in {run['elapsed_s']!r} s (host clock, AdamW steps "
          f"included): {run['audio_s'] / run['elapsed_s']!r} audio-s/s; losses {run['losses'][0]!r} -> "
          f"{run['losses'][-1]!r}; host ms per batch of decode+extract+collate (dataset.assemble) "
          f"{assemble_ms!r}; fbank kernel launches {launches}; first batch kernel vs plain {err!r} "
          f"(tol {KERNEL_TOL}); resumed after batch 3: {len(resumed)} batches torch.equal to the "
          f"uninterrupted run's: {resume_equal}, launches {launches_resumed}, device busy "
          f"{busy_ms / wall_ms!r} of the resumed run's wall (torch.profiler)")
    _check_epoch(name, run, all_ids)
    if launches != n or not err <= KERNEL_TOL:
        raise AssertionError(f"{name}: launches or the kernel's result are off")
    if not resume_equal or launches_resumed != n - 3:
        raise AssertionError(f"{name}: the resumed batches differ from the first run's")
    return launches, err


class _WindowFeatures:
    """The dataset of ``long_form_windows``: the input strategy's features
    of each window with its frame count and cuts, in the layout
    ``_train_epoch`` reads. ``K2SpeechRecognitionDataset`` refuses windows,
    whose supervisions run past their bounds; the masked-prediction step
    needs no transcript."""

    def __init__(self, strategy):
        self.strategy = strategy

    def __getitem__(self, cuts):
        cuts = cuts.sort_by_duration(ascending=False)
        feats, lens = self.strategy(cuts)
        return {"inputs": feats, "supervisions": {"cut": list(cuts), "num_frames": lens}}


def _phase_recipe(workdir: Path, device, fbank_cuda, smi: str) -> tuple:
    """14. The recipe path at full width: a corpus directory through the
    LibriSpeech recipe into training, and long-form sessions through
    trimming and windowing. ``recipe_on_the_fly``: ``prepare_librispeech``
    → ``fix_manifests`` and ``validate_recordings_and_supervisions`` →
    ``CutSet.from_manifests(lazy=True)`` (no leftover-supervision warning)
    → ``SimpleCutSampler(max_duration=180, shuffle=True, seed=0)`` →
    ``K2SpeechRecognitionDataset(OnTheFlyFeatures(Fbank(device="cuda")))``
    → ``DataLoader`` → an AdamW step per batch, one epoch, then a resume
    after batch 3 whose batches are ``torch.equal`` to the uninterrupted
    run's. ``long_form_extract``: the sessions' manifests (the RTTM file
    read back through ``SupervisionSet.from_rttm`` against them) →
    ``from_manifests`` → ``compute_and_store_features_batch`` into
    ``lilcom_chunky``, whole sessions. ``long_form_trimmed``:
    ``trim_to_supervisions(keep_overlapping=False)`` on the featured
    sessions (128 cuts of one supervision, each cut's features equal to the
    frames of its session's matrix) → ``BucketingSampler(num_buckets=4,
    max_duration=180)`` → ``K2SpeechRecognitionDataset()`` (partial reads of
    the archive) → the step, two epochs, no launch. ``long_form_windows``:
    ``cut_into_windows(10.0)`` on the sessions (96 windows that keep every
    supervision and its time) → ``BucketingSampler`` → ``OnTheFlyFeatures``
    on the card → the step, two epochs. Returns the kernel's launches per
    path and the largest kernel-vs-plain error."""
    import warnings

    from lhotse_tpu_torch.audio import RecordingSet
    from lhotse_tpu_torch.caching import set_caching_enabled
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.dataset import BucketingSampler
    from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
    from lhotse_tpu_torch.dataset.loader import DataLoader
    from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
    from lhotse_tpu_torch.features import Fbank, FbankConfig
    from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
    from lhotse_tpu_torch.recipes import prepare_librispeech
    from lhotse_tpu_torch.supervision import SupervisionSet
    from lhotse_tpu_torch.tracing import reset_tracing, set_tracing_enabled, tracing_report
    from lhotse_tpu_torch.utils import compute_num_frames

    set_caching_enabled(False)
    t0 = time.perf_counter()
    corpus, long_recs, long_sups, rttm = _synthesize_recipe_corpora(workdir)
    n_utts = len(RECIPE_SPLITS) * RECIPE_SPEAKERS * RECIPE_CHAPTERS * RECIPE_UTTERANCES
    print(f"recipe corpora: {n_utts} LibriSpeech utterances and {LONG_SESSIONS} x "
          f"{LONG_SECONDS:g} s sessions written in {time.perf_counter() - t0!r} s")
    trainer = _Trainer(device)

    # -- recipe_on_the_fly ---------------------------------------------------------------
    t0 = time.perf_counter()
    parts = prepare_librispeech(corpus, output_dir=workdir / "manifests", num_jobs=4)
    recordings, supervisions = [], []
    for split in RECIPE_SPLITS:
        recs, sups = fix_manifests(parts[split]["recordings"], parts[split]["supervisions"])
        validate_recordings_and_supervisions(recs, sups)
        recordings += list(recs)
        supervisions += list(sups)
    cuts_path = workdir / "recipe_cuts.jsonl.gz"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cuts = CutSet.from_manifests(
            RecordingSet.from_recordings(recordings), SupervisionSet.from_segments(supervisions),
            lazy=True, output_path=cuts_path)
    prepare_s = time.perf_counter() - t0
    leftovers = [str(w.message) for w in caught if "not attached" in str(w.message)]
    n_cuts = sum(1 for _ in cuts)
    with_ali = sum(1 for s in supervisions if s.alignment)
    print(f"[{smi}] recipe_on_the_fly: prepare_librispeech, fix, validate and the lazy "
          f"from_manifests of {n_cuts} utterances ({with_ali} with word alignments) in "
          f"{prepare_s!r} s; leftover-supervision warnings {len(leftovers)}")
    if leftovers or n_cuts != n_utts or with_ali != len(RECIPE_SPLITS) * RECIPE_UTTERANCES:
        raise AssertionError(f"recipe_on_the_fly: the manifest join is off: {leftovers}")
    set_tracing_enabled(True)
    launches_fly, fly_err = _fly_with_resume(
        "recipe_on_the_fly", cuts_path, trainer, device, fbank_cuda, smi)

    # -- long_form_extract ---------------------------------------------------------------
    session_sups = SupervisionSet.from_file(long_sups).to_eager()
    turns = sorted((s.recording_id, s.start, s.duration, s.speaker)
                   for s in SupervisionSet.from_rttm(rttm))
    if turns != sorted((s.recording_id, s.start, s.duration, s.speaker) for s in session_sups):
        raise AssertionError("the RTTM turns read back differ from the sessions' supervisions")
    sessions = CutSet.from_manifests(RecordingSet.from_file(long_recs), session_sups)
    extractor = Fbank(FbankConfig(device=device))
    recorder = _RecordFirstBatch(extractor)
    stored = {}
    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    wall_ms, busy_ms, _ = _device_busy(lambda: stored.update(
        (c.id, c) for c in sessions.compute_and_store_features_batch(
            extractor, workdir / "long_feats", manifest_path=workdir / "long_feats.jsonl",
            batch_duration=600, num_workers=4)))
    launches_extract = fbank_cuda.LAUNCHES
    items, kernel_out = recorder.first
    extract_err = max(float(np.abs(a - b).max())
                      for a, b in zip(kernel_out, _plain_extract(extractor, items)))
    session_s = sum(c.duration for c in sessions)
    full = {c.recording_id: c.load_features() for c in stored.values()}
    archive_err = max(float(np.abs(full[c.recording_id] - k).max())
                      for c, k in zip(list(sessions)[: len(kernel_out)], kernel_out))
    print(f"[{smi}] long_form_extract: {len(stored)} sessions, {session_s!r} audio-s extracted and "
          f"stored in {wall_ms!r} ms under torch.profiler: {session_s / wall_ms * 1e3!r} audio-s/s; "
          f"{launches_extract} batches, fbank kernel launches {launches_extract}; device busy "
          f"{busy_ms / wall_ms!r} of the wall; no loader (dataset.assemble: none); first batch "
          f"kernel vs plain {extract_err!r} (tol {KERNEL_TOL}), archive vs the kernel's output "
          f"{archive_err!r} (tol {LTC1_TICK / 2 + 1e-6!r}); RTTM turns equal to the supervisions")
    if len(stored) != LONG_SESSIONS or launches_extract != math.ceil(session_s / 600):
        raise AssertionError(f"long_form_extract: {len(stored)} sessions, {launches_extract} launches")
    if not extract_err <= KERNEL_TOL or not archive_err <= LTC1_TICK / 2 + 1e-6:
        raise AssertionError("long_form_extract: the kernel or the archive disagrees")

    # -- long_form_trimmed ----------------------------------------------------------------
    trimmed = CutSet.from_cuts(stored[c.id] for c in sessions).trim_to_supervisions(
        keep_overlapping=False).to_eager()
    slices_equal = True
    for cut in trimmed:
        left = compute_num_frames(cut.start, frame_shift=cut.frame_shift, sampling_rate=SR)
        slices_equal &= np.array_equal(
            cut.load_features(), full[cut.recording_id][left: left + cut.num_frames])
    sampler = BucketingSampler(trimmed, num_buckets=4, max_duration=180, shuffle=True, seed=0)
    loader = DataLoader(sampler, K2SpeechRecognitionDataset(return_cuts=True), prefetch_batches=3)
    reset_tracing()
    fbank_cuda.LAUNCHES = 0
    run = _train_epoch(loader, trainer, device)
    n = len(run["losses"])
    read_ms = tracing_report().get("dataset.assemble", {}).get("total_s", 0.0) * 1e3 / n
    sampler.set_epoch(1)
    wall_ms, busy_ms, _ = _device_busy(
        lambda: run.update(second=_train_epoch(loader, trainer, device)))
    launches_trimmed = fbank_cuda.LAUNCHES
    print(f"[{smi}] long_form_trimmed: {len(trimmed)} cuts of one supervision each, features equal "
          f"to their sessions' matrix slices: {slices_equal}; epoch {n} batches, {run['audio_s']!r} "
          f"audio-s in {run['elapsed_s']!r} s: {run['audio_s'] / run['elapsed_s']!r} audio-s/s; host "
          f"ms per batch of the partial feature reads (dataset.assemble) {read_ms!r}; epoch 2 under "
          f"torch.profiler: device busy {busy_ms / wall_ms!r} of the wall; fbank kernel launches "
          f"{launches_trimmed}")
    if len(trimmed) != LONG_SESSIONS * LONG_SEGMENTS or any(len(c.supervisions) != 1 for c in trimmed):
        raise AssertionError(f"long_form_trimmed: {len(trimmed)} cuts")
    if not slices_equal or launches_trimmed != 0:
        raise AssertionError("long_form_trimmed: features off their sessions' or a kernel launch")
    for r in (run, run["second"]):
        if sorted(r["ids"]) != sorted(c.id for c in trimmed) or not all(map(math.isfinite, r["losses"])):
            raise AssertionError("long_form_trimmed: coverage or the loss is off")

    # -- long_form_windows -----------------------------------------------------------------
    windows = sessions.cut_into_windows(duration=WINDOW_SECONDS).to_eager()
    source_ids = {s.id for c in sessions for s in c.supervisions}
    window_ids = {s.id for c in windows for s in c.supervisions}
    inside = sum(s.duration for c in windows for s in c.trimmed_supervisions)
    total = sum(s.duration for c in sessions for s in c.supervisions)
    win = Fbank(FbankConfig(device=device))
    recorder = _RecordFirstBatch(win)
    sampler = BucketingSampler(windows, num_buckets=4, max_duration=180, shuffle=True, seed=0)
    loader = DataLoader(sampler, _WindowFeatures(OnTheFlyFeatures(win)), prefetch_batches=3)
    reset_tracing()
    fbank_cuda.LAUNCHES = 0
    run = _train_epoch(loader, trainer, device)
    n = len(run["losses"])
    assemble_ms = tracing_report().get("dataset.assemble", {}).get("total_s", 0.0) * 1e3 / n
    sampler.set_epoch(1)
    wall_ms, busy_ms, _ = _device_busy(
        lambda: run.update(second=_train_epoch(loader, trainer, device)))
    launches_windows = fbank_cuda.LAUNCHES
    set_tracing_enabled(False)
    n_batches = n + len(run["second"]["losses"])
    items, kernel_out = recorder.first
    window_err = max(float(np.abs(a - b).max()) for a, b in zip(kernel_out, _plain_extract(win, items)))
    print(f"[{smi}] long_form_windows: {len(windows)} windows of {WINDOW_SECONDS:g} s keep "
          f"{len(window_ids)} of {len(source_ids)} supervisions, {inside!r} of {total!r} supervised "
          f"s; epoch {n} batches, {run['audio_s']!r} audio-s in {run['elapsed_s']!r} s: "
          f"{run['audio_s'] / run['elapsed_s']!r} audio-s/s; host ms per batch of decode+extract+"
          f"collate (dataset.assemble) {assemble_ms!r}; epoch 2 under torch.profiler: device busy "
          f"{busy_ms / wall_ms!r} of the wall; fbank kernel launches {launches_windows} for "
          f"{n_batches} batches; first batch kernel vs plain {window_err!r} (tol {KERNEL_TOL})")
    if len(windows) != LONG_SESSIONS * int(LONG_SECONDS / WINDOW_SECONDS):
        raise AssertionError(f"long_form_windows: {len(windows)} windows")
    if window_ids != source_ids or not abs(inside - total) <= 1e-6:
        raise AssertionError("long_form_windows: the windows lost supervision")
    if launches_windows != n_batches or not window_err <= KERNEL_TOL:
        raise AssertionError("long_form_windows: launches or the kernel's result are off")
    for r in (run, run["second"]):
        if sorted(r["ids"]) != sorted(c.id for c in windows) or not all(map(math.isfinite, r["losses"])):
            raise AssertionError("long_form_windows: coverage or the loss is off")
    launches = {"recipe_on_the_fly": launches_fly, "long_form_extract": launches_extract,
                "long_form_trimmed": launches_trimmed, "long_form_windows": launches_windows}
    return launches, max(fly_err, extract_err, window_err)


# -- 15. the multi-channel meeting path ------------------------------------------
# An AMI-layout corpus: four meetings of 240 s (two full-corpus train
# meetings, dev ES2011a, test ES2004a), each with the 8 channels of Array1
# and 4 headsets as 16 kHz int16 WAV files, four speakers taking turns of
# 3-8 s that overlap by up to 1 s. AMI's sessions run about 30 minutes and
# the corpus about 100 h; 4 x 8 x 240 s = 7,680 array channel-seconds (phase
# 2 holds the kernel at a 300 s session's 8 x 30,000 frames).
AMI_MEETINGS = ("ES2002a", "ES2002b", "ES2011a", "ES2004a")
AMI_SECONDS = 240.0
AMI_ARRAY, AMI_HEADSETS = 8, 4
AMI_TURN_SECONDS = (3.0, 8.0)
AMI_GAP_SECONDS = (-1.0, 1.5)  # a negative gap overlaps the next speaker's turn
AMI_SIDE_SEGMENTS = 4  # the segments of the WPE and RIR fan-out legs
# The host numpy WPE against the device WPE (ops/wpe.py) on the same
# audio, at tests/test_torch_wpe.py::test_matches_host_wpe's bounds: the
# two differ in their power floor (1e-10 against 1e-6) and precision.
WPE_HOST_CORR, WPE_HOST_REL = 0.95, 0.4


def _synthesize_ami_corpus(root: Path) -> Path:
    """Phase 15's corpus (numpy seed 5678) in the AMI layout:
    ``<meeting>/audio/<meeting>.Array1-0<k>.wav`` and ``.Headset-<k>.wav``,
    and the NXT annotations ``ami_public_manual_1.6.2`` (``meetings.xml``,
    per-speaker ``segments`` and ``words`` XML as in
    tests/test_recipes_tranche16.py). Each speaker's turns are tone bursts
    (four harmonics of an 80-220 Hz f0); a headset hears its speaker and,
    at 0.05, the others; each array channel hears every speaker with its own
    gain and a delay of up to 1 ms; every channel has its own 0.01 noise
    floor. Returns the corpus directory."""
    rng = np.random.default_rng(5678)
    n = int(AMI_SECONDS * SR)
    ann = root / "ami_public_manual_1.6.2"
    for sub in ("corpusResources", "segments", "words"):
        (ann / sub).mkdir(parents=True)
    meetings_xml = ['<?xml version="1.0"?>', "<meetings>"]
    from lhotse_tpu_torch.audio.wavio import write_wav

    for mi, meet in enumerate(AMI_MEETINGS):
        turns, t, spk = [], 0.5, 0
        while True:
            span = round(float(rng.uniform(*AMI_TURN_SECONDS)), 2)
            if t + span > AMI_SECONDS - 0.5:
                break
            turns.append((spk, round(t, 2), round(t + span, 2)))
            t = max(t + span + float(rng.uniform(*AMI_GAP_SECONDS)), turns[-1][1] + 0.5)
            spk = (spk + int(rng.integers(1, AMI_HEADSETS))) % AMI_HEADSETS
        f0 = rng.uniform(80, 220, AMI_HEADSETS)
        dry = np.zeros((AMI_HEADSETS, n), np.float32)
        for s, start, end in turns:
            lo, hi = int(start * SR), int(end * SR)
            tt = np.arange(hi - lo) / SR
            dry[s, lo:hi] += 0.2 * sum(
                np.sin(2 * np.pi * f0[s] * (h + 1) * tt) / (h + 1) for h in range(4))
        audio_dir = root / meet / "audio"
        audio_dir.mkdir(parents=True)
        total = dry.sum(axis=0)
        for k in range(AMI_HEADSETS):
            x = dry[k] + 0.05 * (total - dry[k]) + 0.01 * rng.standard_normal(n, np.float32)
            write_wav(str(audio_dir / f"{meet}.Headset-{k}.wav"), x, SR)
        for m in range(AMI_ARRAY):
            x = 0.01 * rng.standard_normal(n, np.float32)
            for k, (gain, delay) in enumerate(zip(rng.uniform(0.5, 1.0, AMI_HEADSETS),
                                                  rng.integers(0, 17, AMI_HEADSETS))):
                x[delay:] += gain * dry[k, : n - delay]
            write_wav(str(audio_dir / f"{meet}.Array1-0{m + 1}.wav"), x, SR)
        meetings_xml.append(f'  <meeting observation="{meet}">')
        for k in range(AMI_HEADSETS):
            agent = "ABCD"[k]
            meetings_xml.append(
                f'    <speaker nxt_agent="{agent}" global_name="{"MF"[k % 2]}EE{mi}{k}" '
                f'channel="{k}"/>')
            segments, words = [], []
            for s, start, end in turns:
                if s != k:
                    continue
                segments.append(f'  <segment transcriber_start="{start}" transcriber_end="{end}"/>')
                text = [RECIPE_WORDS[i] for i in rng.integers(0, len(RECIPE_WORDS),
                                                              int(rng.integers(3, 12)))]
                step = (end - start) / len(text)
                for j, w in enumerate(text):
                    ws, we = round(start + j * step, 3), round(start + (j + 1) * step - 0.05, 3)
                    words.append(f'  <w starttime="{ws}" endtime="{we}">{w.lower()}</w>')
            (ann / "segments" / f"{meet}.{agent}.segments.xml").write_text(
                '<?xml version="1.0"?>\n<segmentation>\n' + "\n".join(segments)
                + "\n</segmentation>")
            (ann / "words" / f"{meet}.{agent}.words.xml").write_text(
                '<?xml version="1.0"?>\n<words>\n' + "\n".join(words) + "\n</words>")
        meetings_xml.append("  </meeting>")
    meetings_xml.append("</meetings>")
    (ann / "corpusResources" / "meetings.xml").write_text("\n".join(meetings_xml))
    return root


class _RecordExtract:
    """Wraps ``extractor.extract`` to keep every call's input and output."""

    def __init__(self, extractor):
        self.calls = []
        inner = extractor.extract

        def extract(samples, sampling_rate):
            out = inner(samples, sampling_rate)
            self.calls.append((np.asarray(samples).copy(), np.asarray(out).copy()))
            return out

        extractor.extract = extract


def _extract_errors(extractor, calls) -> float:
    """The largest distance of the recorded kernel outputs from the kernel's
    plain version on the card, per channel row."""
    return max(
        float(np.abs(out - np.stack(_plain_extract(extractor, list(samples)))).max())
        for samples, out in calls)


def _phase_meetings(workdir: Path, device, fbank_cuda, smi: str) -> tuple:
    """15. The multi-channel meeting path on an AMI-layout corpus.
    ``ami_mdm_extract``: ``prepare_ami(mic="mdm")`` → ``from_manifests``
    (one 8-channel ``MultiCut`` per meeting) → ``compute_and_store_features``
    into ``lilcom_chunky``: one ``Fbank.extract`` of the (8, N) session per
    launch, one (8, T, 80) matrix per session, held to the kernel's plain
    version and read back within half an LTC1 tick. ``ami_mdm_on_the_fly``:
    the train sessions' features → ``trim_to_supervisions(
    keep_overlapping=False, keep_all_channels=True)`` (each MultiCut's
    ``load_features`` equal to its slice of the session matrix; a JSONL round
    trip; ``to_mono`` and ``combine_same_recording_channels`` back) →
    ``to_mono()``, 8 MonoCuts per segment → ``_fly_with_resume``.
    ``ami_ihm_on_the_fly``: ``prepare_ami(mic="ihm")`` → 4-channel headset
    MultiCuts → ``trim_to_supervisions(keep_overlapping=False)`` → MonoCuts
    on each supervision's headset → ``_fly_with_resume``. ``ami_mdm_wpe``:
    ``dereverb_wpe()`` on 4 MultiCut segments, the host numpy transform
    over all 8 channels, then the kernel; the transform's output against
    the device WPE on the same audio. ``ami_rir_fanout``: ``prepare_ami(
    mic="sdm")`` → 4 single-channel windows → ``reverb_rir`` with an
    8-channel RIR → 8-channel MultiCuts → the kernel. Returns the kernel's
    launches per path, the largest kernel-vs-plain error and the paths of
    the manifests ``prepare_ami`` wrote, by microphone setting and
    partition."""
    from lhotse_tpu_torch.audio import Recording
    from lhotse_tpu_torch.audio.wavio import write_wav
    from lhotse_tpu_torch.caching import set_caching_enabled
    from lhotse_tpu_torch.cut import CutSet, MonoCut, MultiCut
    from lhotse_tpu_torch.features import Fbank, FbankConfig
    from lhotse_tpu_torch.features.io import LilcomChunkyWriter
    from lhotse_tpu_torch.ops.wpe import dereverb_wpe
    from lhotse_tpu_torch.recipes import prepare_ami
    from lhotse_tpu_torch.tracing import set_tracing_enabled
    from lhotse_tpu_torch.utils import compute_num_frames

    set_caching_enabled(False)
    set_tracing_enabled(True)
    t0 = time.perf_counter()
    corpus = _synthesize_ami_corpus(workdir / "amicorpus")
    print(f"AMI corpus: {len(AMI_MEETINGS)} meetings x {AMI_SECONDS:g} s, {AMI_ARRAY} array "
          f"channels and {AMI_HEADSETS} headsets, written in {time.perf_counter() - t0!r} s")
    trainer = _Trainer(device)
    launches = {}

    # -- ami_mdm_extract -------------------------------------------------------------
    t0 = time.perf_counter()
    mdm = prepare_ami(corpus, output_dir=workdir / "ami_manifests", mic="mdm")
    sessions = CutSet.from_cuts(
        c for part in ("train", "dev", "test")
        for c in CutSet.from_manifests(**mdm[part]))
    prepare_s = time.perf_counter() - t0
    if [type(c) for c in sessions] != [MultiCut] * len(AMI_MEETINGS) or any(
            c.channel != list(range(AMI_ARRAY)) for c in sessions):
        raise AssertionError("ami_mdm_extract: the sessions are not 8-channel MultiCuts")
    extractor = Fbank(FbankConfig(device=device))
    recorder = _RecordExtract(extractor)
    featured = {}

    def extract():
        with LilcomChunkyWriter(workdir / "ami_feats") as storage:
            featured.update((c.recording_id, c.compute_and_store_features(extractor, storage))
                            for c in sessions)

    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    wall_ms, busy_ms, _ = _device_busy(extract)
    launches["ami_mdm_extract"] = fbank_cuda.LAUNCHES
    channel_s = sum(c.duration * c.num_channels for c in sessions)
    extract_err = _extract_errors(extractor, recorder.calls)
    matrices = {rid: c.load_features() for rid, c in featured.items()}
    archive_err = max(float(np.abs(matrices[c.recording_id] - out).max())
                      for c, (_, out) in zip(sessions, recorder.calls))
    shapes = {tuple(m.shape) for m in matrices.values()}
    print(f"[{smi}] ami_mdm_extract: prepare_ami(mic='mdm') and from_manifests of "
          f"{len(sessions)} sessions in {prepare_s!r} s; {channel_s!r} channel-s extracted and "
          f"stored in {wall_ms!r} ms under torch.profiler: {channel_s / wall_ms * 1e3!r} "
          f"channel-s/s; stored matrices {sorted(shapes)}; fbank kernel launches "
          f"{launches['ami_mdm_extract']}; device busy {busy_ms / wall_ms!r} of the wall; kernel "
          f"vs plain {extract_err!r} (tol {KERNEL_TOL}), archive vs the kernel's output "
          f"{archive_err!r} (tol {LTC1_TICK / 2 + 1e-6!r})")
    frames = compute_num_frames(AMI_SECONDS, 0.01, SR)
    if launches["ami_mdm_extract"] != len(AMI_MEETINGS) or shapes != {(AMI_ARRAY, frames, 80)}:
        raise AssertionError("ami_mdm_extract: launches or the stored shapes are off")
    if not extract_err <= KERNEL_TOL or not archive_err <= LTC1_TICK / 2 + 1e-6:
        raise AssertionError("ami_mdm_extract: the kernel or the archive disagrees")

    # -- ami_mdm_on_the_fly ---------------------------------------------------------
    train_ids = {r.id for r in mdm["train"]["recordings"]}
    trimmed = CutSet.from_cuts(featured[rid] for rid in sorted(train_ids)).trim_to_supervisions(
        keep_overlapping=False, keep_all_channels=True).to_eager()
    slices_equal = all(
        np.array_equal(c.load_features(), matrices[c.recording_id][
            :, compute_num_frames(c.start, 0.01, SR):][:, : c.num_frames]) for c in trimmed)
    trimmed.to_file(workdir / "ami_mdm_segments.jsonl.gz")
    round_trip = [c.to_dict() for c in CutSet.from_file(workdir / "ami_mdm_segments.jsonl.gz")] == [
        c.to_dict() for c in trimmed]
    monos = CutSet.from_cuts(m for c in trimmed for m in c.to_mono())
    combined = monos.combine_same_recording_channels()
    recombined = [(c.recording_id, c.start, c.duration, c.channel) for c in combined] == [
        (c.recording_id, c.start, c.duration, c.channel) for c in trimmed]
    monos.to_file(workdir / "ami_mdm_monos.jsonl.gz")
    print(f"[{smi}] ami_mdm_on_the_fly: {len(trimmed)} 8-channel segments, features equal to "
          f"their sessions' slices: {slices_equal}; JSONL round trip equal: {round_trip}; "
          f"to_mono -> {len(monos)} MonoCuts, combine_same_recording_channels gives the segments "
          f"back: {recombined}")
    if {type(c) for c in trimmed} != {MultiCut} or {type(c) for c in monos} != {MonoCut}:
        raise AssertionError("ami_mdm_on_the_fly: the cut types are off")
    if len(monos) != AMI_ARRAY * len(trimmed) or not (slices_equal and round_trip and recombined):
        raise AssertionError("ami_mdm_on_the_fly: the trimmed segments are off")
    launches["ami_mdm_on_the_fly"], mdm_err = _fly_with_resume(
        "ami_mdm_on_the_fly", workdir / "ami_mdm_monos.jsonl.gz", trainer, device, fbank_cuda, smi)

    # -- ami_ihm_on_the_fly --------------------------------------------------------
    ihm = prepare_ami(corpus, output_dir=workdir / "ami_manifests", mic="ihm")["train"]
    headsets = CutSet.from_manifests(**ihm)
    if any(not isinstance(c, MultiCut) or c.num_channels != AMI_HEADSETS for c in headsets):
        raise AssertionError("ami_ihm_on_the_fly: the headsets are not grouped into MultiCuts")
    ihm_cuts = headsets.trim_to_supervisions(keep_overlapping=False).to_eager()
    on_own_headset = all(
        isinstance(c, MonoCut) and c.channel == c.supervisions[0].channel for c in ihm_cuts)
    if not on_own_headset or len(ihm_cuts) != len(ihm["supervisions"]):
        raise AssertionError("ami_ihm_on_the_fly: the cuts are not on their speakers' headsets")
    ihm_cuts.to_file(workdir / "ami_ihm_cuts.jsonl.gz")
    # A fresh model: its loss must fall within this shorter epoch.
    launches["ami_ihm_on_the_fly"], ihm_err = _fly_with_resume(
        "ami_ihm_on_the_fly", workdir / "ami_ihm_cuts.jsonl.gz", _Trainer(device), device,
        fbank_cuda, smi)

    # -- ami_mdm_wpe -------------------------------------------------------------------
    segments = [c.drop_features() for c in list(trimmed)[:AMI_SIDE_SEGMENTS]]
    wpe_cuts = [c.dereverb_wpe() for c in segments]
    wpe_ext = Fbank(FbankConfig(device=device))
    recorder = _RecordExtract(wpe_ext)
    outputs = []

    def wpe_leg():
        for c in wpe_cuts:
            audio = c.load_audio()
            outputs.append(audio)
            wpe_ext.extract(audio, SR)

    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    wall_ms, busy_ms, _ = _device_busy(wpe_leg)
    launches["ami_mdm_wpe"] = fbank_cuda.LAUNCHES
    wpe_err = _extract_errors(wpe_ext, recorder.calls)
    wpe_s = sum(c.duration * c.num_channels for c in wpe_cuts)
    raw = segments[0].load_audio()
    on_card = dereverb_wpe(torch.from_numpy(raw).to(device)).cpu().numpy()
    corr = float(np.corrcoef(outputs[0].ravel(), on_card.ravel())[0, 1])
    rel = float(np.linalg.norm(outputs[0] - on_card) / np.linalg.norm(on_card))
    subset_equal = np.array_equal(wpe_cuts[0].to_mono()[3].load_audio(), outputs[0][3:4])
    print(f"[{smi}] ami_mdm_wpe: dereverb_wpe() of {len(wpe_cuts)} 8-channel segments, "
          f"{wpe_s!r} channel-s through the host WPE and the kernel in {wall_ms!r} ms under "
          f"torch.profiler: {wpe_s / wall_ms * 1e3!r} channel-s/s; fbank kernel launches "
          f"{launches['ami_mdm_wpe']}; device busy {busy_ms / wall_ms!r} of the wall; kernel vs "
          f"plain {wpe_err!r} (tol {KERNEL_TOL}); host WPE vs the device WPE on the first "
          f"segment: correlation {corr!r} (> {WPE_HOST_CORR}), relative error {rel!r} "
          f"(< {WPE_HOST_REL}); to_mono() after dereverb_wpe() gives the 8-channel result's row: "
          f"{subset_equal}")
    if launches["ami_mdm_wpe"] != len(wpe_cuts) or not wpe_err <= KERNEL_TOL:
        raise AssertionError("ami_mdm_wpe: launches or the kernel's result are off")
    if not all(np.isfinite(o).all() and o.shape[0] == AMI_ARRAY for o in outputs):
        raise AssertionError("ami_mdm_wpe: the host WPE output is off")
    if not corr > WPE_HOST_CORR or not rel < WPE_HOST_REL or not subset_equal:
        raise AssertionError("ami_mdm_wpe: the host WPE disagrees with the device WPE")

    # -- ami_rir_fanout ----------------------------------------------------------------
    sdm = prepare_ami(corpus, output_dir=workdir / "ami_manifests", mic="sdm")["train"]
    # The single-microphone sessions trimmed to their supervisions: MonoCuts
    # on channel 0 (the supervisions name it as a list, [0]).
    singles = list(CutSet.from_manifests(**sdm).trim_to_supervisions(keep_overlapping=False))
    if not all(isinstance(c, MonoCut) and c.channel == 0 for c in singles):
        raise AssertionError("ami_rir_fanout: the trimmed sdm cuts are not MonoCuts on channel 0")
    rng = np.random.default_rng(5679)
    taps = np.arange(SR // 2)
    rir = np.stack([np.exp(-taps / 1600.0) * rng.standard_normal(SR // 2) * 0.05
                    for _ in range(AMI_ARRAY)])
    rir[np.arange(AMI_ARRAY), rng.integers(0, 17, AMI_ARRAY)] = 1.0
    write_wav(str(workdir / "rir8.wav"), rir.astype(np.float32), SR, subtype="float32")
    rir_rec = Recording.from_file(workdir / "rir8.wav")
    fanned = [c.reverb_rir(rir_recording=rir_rec, rir_channels=list(range(AMI_ARRAY)))
              for c in singles[:AMI_SIDE_SEGMENTS]]
    if not all(isinstance(c, MultiCut) and c.channel == list(range(AMI_ARRAY)) for c in fanned):
        raise AssertionError("ami_rir_fanout: the fan-out did not give 8-channel MultiCuts")
    rir_ext = Fbank(FbankConfig(device=device))
    recorder = _RecordExtract(rir_ext)
    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    wall_ms, busy_ms, _ = _device_busy(
        lambda: [rir_ext.extract(c.load_audio(), SR) for c in fanned])
    launches["ami_rir_fanout"] = fbank_cuda.LAUNCHES
    rir_err = _extract_errors(rir_ext, recorder.calls)
    rir_s = sum(c.duration * c.num_channels for c in fanned)
    one = singles[0].reverb_rir(rir_recording=rir_rec, rir_channels=[5]).load_audio()
    row_equal = np.array_equal(one, recorder.calls[0][0][5:6])
    print(f"[{smi}] ami_rir_fanout: {len(fanned)} single-channel segments through an "
          f"{AMI_ARRAY}-channel RIR, {rir_s!r} channel-s reverberated and extracted in "
          f"{wall_ms!r} ms under torch.profiler: {rir_s / wall_ms * 1e3!r} channel-s/s; fbank "
          f"kernel launches {launches['ami_rir_fanout']}; device busy {busy_ms / wall_ms!r} of "
          f"the wall; kernel vs plain {rir_err!r} (tol {KERNEL_TOL}); channel 5 equal to the "
          f"RIR's channel 5 alone: {row_equal}")
    if launches["ami_rir_fanout"] != len(fanned) or not rir_err <= KERNEL_TOL or not row_equal:
        raise AssertionError("ami_rir_fanout: launches, the kernel or the fan-out are off")
    set_tracing_enabled(False)
    manifests = {
        mic: {part: {kind: workdir / "ami_manifests" / f"ami-{mic}_{kind}_{part}.jsonl.gz"
                     for kind in ("recordings", "supervisions")}
              for part in ("train", "dev", "test")}
        for mic in ("mdm", "ihm", "sdm")}
    return launches, max(extract_err, mdm_err, ihm_err, wpe_err, rir_err), manifests


# -- 17. the signal-effects and multi-source, multi-talker training path ---------------------

SURT_MAX_PAUSE = 0.0  # s between supervisions that still join one group
SURT_MAX_GROUP = 20.0  # s: the B·8·T² attention scores of a 300 s group need ≈29 GB per layer
TASK_MAX_DURATION = 180.0  # the task legs' batches, in seconds of audio
VAD_WINDOW = 15.0
MS_MAX_DURATION = 90.0  # each source's share of a multi-source batch
MS_ZIP_SECONDS = 200.0  # of each source in multi_source_zip: an epoch of three batches
MS_RESUME_AFTER = 2
STATELESS_BATCHES = 3


class _KeepCuts:
    """Wraps a dataset to keep the cuts of every batch it assembles."""

    def __init__(self, dataset):
        self.dataset, self.cuts = dataset, []

    def __getitem__(self, cuts):
        self.cuts.append(list(cuts))
        return self.dataset[cuts]


def _close_and_join(it, threads_before: set) -> None:
    """Closes a ``DataLoader`` iterator that was left mid-epoch and waits for
    the producer thread it started (one not in ``threads_before``).
    ``DataLoader`` waits 5 s for its producer, as the JAX package's does; a
    producer inside a longer batch (a lowpass kernel build) outlives that
    wait, finishes its batch, and launches the kernel while the next leg
    counts its launches."""
    it.close()
    for thread in set(threading.enumerate()) - threads_before:
        if thread.name.endswith("(_produce)"):
            thread.join()


def _task_epoch(batches, trainer, device, unpack, on_batch=None) -> dict:
    """One pass over ``batches`` (a loader, or any iterable of dataset
    batches): ``unpack(batch)`` gives the features (B, T, F), their frame
    counts and the batch's seconds of audio; then the trainer's AdamW step.
    ``on_batch(i, batch)`` sees each batch after its step."""
    kept, losses, wait_s, audio_s = [], [], 0.0, 0.0
    it = iter(batches)
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            break
        wait_s += time.perf_counter() - t
        feats, lens, seconds = unpack(batch)
        losses.append(trainer.step(
            torch.from_numpy(np.ascontiguousarray(feats, np.float32)).to(device),
            torch.from_numpy(np.asarray(lens, np.int64)).to(device)))
        kept.append(batch)
        audio_s += seconds
        if on_batch is not None:
            on_batch(len(kept) - 1, batch)
    torch.cuda.synchronize()
    return {"batches": kept, "losses": losses, "wait_s": wait_s, "audio_s": audio_s,
            "elapsed_s": time.perf_counter() - t0}


def _leg(name, batches, trainer, device, fbank_cuda, unpack, smi, unit="audio",
         on_batch=None) -> dict:
    """``_task_epoch`` once under ``torch.profiler`` with the host spans on:
    prints the rate, the device's busy share, the host ms per batch by span
    and the kernel's launches."""
    from lhotse_tpu_torch.tracing import reset_tracing, tracing_report

    run = {}
    reset_tracing()
    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    wall_ms, busy_ms, _ = _device_busy(
        lambda: run.update(_task_epoch(batches, trainer, device, unpack, on_batch)))
    run.update(launches=fbank_cuda.LAUNCHES, report=tracing_report(), wall_ms=wall_ms,
               busy=busy_ms / wall_ms)
    n = len(run["losses"])
    if not n or not all(math.isfinite(x) for x in run["losses"]):
        raise AssertionError(f"{name}: no batch, or a loss that is not finite: {run['losses']}")
    print(f"[{smi}] {name}: {n} batches, {run['audio_s']!r} {unit}-s in {wall_ms!r} ms under "
          f"torch.profiler (AdamW steps included): {run['audio_s'] / wall_ms * 1e3!r} {unit}-s/s; "
          f"device busy {run['busy']!r} of the wall; host ms per batch: "
          f"{_span_ms(run['report'], n)}; consumer's wait per batch "
          f"{run['wait_s'] * 1e3 / n!r} ms; losses {run['losses'][0]!r} -> {run['losses'][-1]!r}; "
          f"fbank kernel launches {run['launches']}")
    return run


def _first_batch_err(recorder, extractor) -> float:
    items, kernel_out = recorder.first
    return max(float(np.abs(a - b).max())
               for a, b in zip(kernel_out, _plain_extract(extractor, items)))


def _activity_reference(cuts, speakers: dict) -> np.ndarray:
    """(B, S, T) speaker activity written out from the supervisions: 1 from
    each supervision's first frame (its start over the frame shift, rounded)
    to its last (its end, likewise), clipped to the cut; at least 4 rows."""
    out = np.zeros((len(cuts), max(len(speakers), 4), max(c.num_frames for c in cuts)))
    for i, c in enumerate(cuts):
        for s in c.supervisions:
            lo = round(s.start / c.frame_shift) if s.start > 0 else 0
            hi = round(s.end / c.frame_shift) if s.end < c.duration else c.num_frames
            out[i, speakers[s.speaker], lo:hi] = 1
    return out


def _ami_cuts(manifests: dict, mic: str, parts=("train",)):
    from lhotse_tpu_torch.audio import RecordingSet
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.supervision import SupervisionSet

    return CutSet.from_cuts(
        c for part in parts for c in CutSet.from_manifests(
            recordings=RecordingSet.from_file(manifests[mic][part]["recordings"]),
            supervisions=SupervisionSet.from_file(manifests[mic][part]["supervisions"])))


def _head(cuts, seconds: float) -> list:
    """The first cuts of ``cuts`` whose durations add up to ``seconds``."""
    out, total = [], 0.0
    for c in cuts:
        if total >= seconds:
            break
        out.append(c)
        total += c.duration
    return out


def _frames_of(cuts, width: int) -> list:
    """Each cut's frame count at the 10 ms shift, at most ``width``."""
    from lhotse_tpu_torch.utils import compute_num_frames

    return [min(compute_num_frames(c.duration, 0.01, SR), width) for c in cuts]


def _rows_of(batch) -> tuple:
    """A ``K2SpeechRecognitionDataset`` batch's features, the frame count of
    each row's cut (a concatenated cut holds several supervisions) and its
    seconds of audio."""
    sups = batch["supervisions"]
    rows = {int(i): c for i, c in zip(sups["sequence_idx"], sups["cut"])}
    cuts = [rows[i] for i in range(batch["inputs"].shape[0])]
    return batch["inputs"], _frames_of(cuts, batch["inputs"].shape[1]), sum(c.duration for c in cuts)


def _phase_multi_source(workdir: Path, manifests: dict, device, fbank_cuda, smi: str) -> tuple:
    """17. The signal-effects and multi-source, multi-talker training path,
    on phase 15's AMI corpus and manifests, each batch into an AdamW step of
    ``Encoder(EncoderConfig())``. ``ami_surt_on_the_fly``: the ``sdm``
    sessions → ``trim_to_supervision_groups`` → the groups of at most 20 s →
    ``SimpleCutSampler(max_duration=180)`` → ``K2SurtDataset(num_channels=2)``
    with ``OnTheFlyFeatures`` on the card; the supervisions and text of each
    batch against the CPU port's dataset on the same cuts.
    ``ami_vad_on_the_fly``: the sessions in 15 s windows → ``VadDataset``
    with ``OnTheFlyFeatures``; ``is_voice`` against the CPU port's masks.
    ``ami_diarization_extract``: the windows →
    ``compute_and_store_features_batch`` on the card into ``lilcom_chunky``;
    ``ami_diarization``: the stored features → ``DiarizationDataset(
    global_speaker_ids=True, min_speaker_dim=4)``; ``speaker_activity``
    against a raster written out from the supervisions.
    ``multi_source_zip``: the ``ihm`` supervision cuts ``normalize_loudness(
    -23.0)`` and the ``sdm`` ones ``narrowband("mulaw")`` →
    ``ZipSampler`` of two ``SimpleCutSampler(max_duration=90)`` →
    ``CutConcatenate``, ``ClippingTransform`` and ``LowpassUsingResampling``
    → ``K2SpeechRecognitionDataset`` with ``OnTheFlyFeatures``, with a resume
    after batch 2 through a fresh loader that must give the uninterrupted
    run's batch 3 (``torch.equal``); the lowpass's resampling-kernel builds
    and the resampler caches' size. ``multi_source_round_robin``:
    ``RoundRobinSampler(WeightedSimpleCutSampler(ihm), SimpleCutSampler(sdm))``
    → ``CutConcatenate`` and ``ClippingTransform`` → the same dataset.
    ``multi_source_stateless``: ``StatelessSampler`` over both sources as
    uncompressed JSONL (scales 1 and 2), 3 batches into the same dataset;
    two samplers of one seed agree, ranks 0 and 1 of two differ. Returns the
    kernel's launches per path and the largest kernel-vs-plain error."""
    import itertools
    import os

    from lhotse_tpu_torch.augmentation import resample
    from lhotse_tpu_torch.caching import set_caching_enabled
    from lhotse_tpu_torch.cut import CutSet, MixedCut
    from lhotse_tpu_torch.dataset import (
        DiarizationDataset, K2SurtDataset, RoundRobinSampler, SimpleCutSampler, StatelessSampler,
        VadDataset, WeightedSimpleCutSampler, ZipSampler)
    from lhotse_tpu_torch.dataset.cut_transforms import (
        ClippingTransform, CutConcatenate, LowpassUsingResampling)
    from lhotse_tpu_torch.dataset.input_strategies import AudioSamples, OnTheFlyFeatures
    from lhotse_tpu_torch.dataset.loader import DataLoader
    from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
    from lhotse_tpu_torch.features import Fbank, FbankConfig
    from lhotse_tpu_torch.features.io import LilcomChunkyWriter
    from lhotse_tpu_torch.tracing import set_tracing_enabled, trace_span

    set_caching_enabled(False)
    set_tracing_enabled(True)
    launches, errs = {}, []

    def fly():
        extractor = Fbank(FbankConfig(device=device))
        return extractor, _RecordFirstBatch(extractor)

    # -- ami_surt_on_the_fly ---------------------------------------------------------
    sessions = _ami_cuts(manifests, "sdm", ("train", "dev", "test")).to_eager()
    groups = sessions.trim_to_supervision_groups(max_pause=SURT_MAX_PAUSE).to_eager()
    kept = CutSet.from_cuts(c for c in groups if c.duration <= SURT_MAX_GROUP)
    extractor, recorder = fly()
    loader = DataLoader(
        SimpleCutSampler(kept, max_duration=TASK_MAX_DURATION, shuffle=True, seed=0),
        K2SurtDataset(num_channels=2, return_cuts=True, input_strategy=OnTheFlyFeatures(extractor)),
        prefetch_batches=3)
    print(f"[{smi}] ami_surt_on_the_fly: {len(sessions)} sdm sessions, "
          f"trim_to_supervision_groups(max_pause={SURT_MAX_PAUSE}) -> {len(groups)} groups, "
          f"{len(kept)} kept (<= {SURT_MAX_GROUP} s, {sum(c.duration for c in kept)!r} s), "
          f"{len(groups) - len(kept)} dropped")
    run = _leg("ami_surt_on_the_fly", loader, _Trainer(device), device, fbank_cuda,
               lambda b: (b["inputs"], b["input_lens"], sum(c.duration for c in b["cuts"])), smi)
    launches["ami_surt_on_the_fly"] = run["launches"]
    err = _first_batch_err(recorder, extractor)
    cpu = K2SurtDataset(num_channels=2, return_cuts=True, input_strategy=AudioSamples())

    def sups(batch):
        return [[[s.to_dict() for s in ch] for ch in cut] for cut in batch["supervisions"]]

    same = all(b["text"] == want["text"] and sups(b) == sups(want)
               for b, want in ((b, cpu[b["cuts"]]) for b in run["batches"]))
    overlapped = sum(1 for b in run["batches"] for cut in b["supervisions"] if cut[1])
    n_cuts = sum(len(b["cuts"]) for b in run["batches"])
    print(f"[{smi}] ami_surt_on_the_fly: {n_cuts} groups in the epoch, {overlapped} with a "
          f"supervision on channel 1; supervisions and text equal to the CPU port's dataset on "
          f"the same cuts: {same}; first batch kernel vs plain {err!r} (tol {CHAIN_TOL})")
    if run["launches"] != len(run["batches"]) or n_cuts != len(kept):
        raise AssertionError("ami_surt_on_the_fly: launches or the epoch's cuts are off")
    if not same or not overlapped or not err <= CHAIN_TOL:
        raise AssertionError("ami_surt_on_the_fly: the supervisions, text or features are off")
    errs.append(err)

    # -- ami_vad_on_the_fly ----------------------------------------------------------
    windows = sessions.cut_into_windows(VAD_WINDOW).to_eager()
    extractor, recorder = fly()
    loader = DataLoader(
        SimpleCutSampler(windows, max_duration=TASK_MAX_DURATION, shuffle=True, seed=0),
        VadDataset(input_strategy=OnTheFlyFeatures(extractor)), prefetch_batches=3)
    run = _leg("ami_vad_on_the_fly", loader, _Trainer(device), device, fbank_cuda,
               lambda b: (b["inputs"], b["input_lens"], sum(c.duration for c in b["cut"])), smi)
    launches["ami_vad_on_the_fly"] = run["launches"]
    err = _first_batch_err(recorder, extractor)
    cpu = OnTheFlyFeatures(Fbank(FbankConfig(device="cpu")))
    masks_equal = all(np.array_equal(b["is_voice"], cpu.supervision_masks(b["cut"]))
                      for b in run["batches"])
    voiced = float(np.mean([b["is_voice"].mean() for b in run["batches"]]))
    print(f"[{smi}] ami_vad_on_the_fly: {len(windows)} windows of {VAD_WINDOW:g} s; is_voice equal "
          f"to the CPU port's masks: {masks_equal}, voiced share {voiced!r}; first batch kernel "
          f"vs plain {err!r} (tol {CHAIN_TOL})")
    if run["launches"] != len(run["batches"]) or not masks_equal or not 0 < voiced < 1:
        raise AssertionError("ami_vad_on_the_fly: launches or the masks are off")
    if not err <= CHAIN_TOL:
        raise AssertionError("ami_vad_on_the_fly: the kernel disagrees with its plain version")
    errs.append(err)

    # -- ami_diarization_extract and ami_diarization ----------------------------------
    extractor, recorder = fly()
    stored = {}

    def extract():
        stored["cuts"] = windows.compute_and_store_features_batch(
            extractor, workdir / "diarization_feats", storage_type=LilcomChunkyWriter).to_eager()

    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    wall_ms, busy_ms, _ = _device_busy(extract)
    launches["ami_diarization_extract"] = fbank_cuda.LAUNCHES
    err = _first_batch_err(recorder, extractor)
    featured = stored["cuts"]
    seconds = sum(c.duration for c in featured)
    shapes = {c.load_features().shape for c in list(featured)[:4]}
    print(f"[{smi}] ami_diarization_extract: {len(featured)} windows, {seconds!r} audio-s "
          f"extracted and stored in {wall_ms!r} ms under torch.profiler: "
          f"{seconds / wall_ms * 1e3!r} audio-s/s; device busy {busy_ms / wall_ms!r} of the wall; "
          f"fbank kernel launches {launches['ami_diarization_extract']}; stored shapes "
          f"{sorted(shapes)}; first batch kernel vs plain {err!r} (tol {CHAIN_TOL})")
    if not launches["ami_diarization_extract"] >= 1 or not err <= CHAIN_TOL:
        raise AssertionError("ami_diarization_extract: launches or the kernel's result are off")
    errs.append(err)
    dataset = _KeepCuts(DiarizationDataset(featured, global_speaker_ids=True, min_speaker_dim=4))
    loader = DataLoader(
        SimpleCutSampler(featured, max_duration=TASK_MAX_DURATION, shuffle=True, seed=0), dataset,
        prefetch_batches=3)
    run = _leg("ami_diarization", loader, _Trainer(device), device, fbank_cuda,
               lambda b: (b["features"], b["features_lens"],
                          float(np.sum(b["features_lens"])) * 0.01), smi)
    launches["ami_diarization"] = run["launches"]
    speakers = dataset.dataset.speakers
    activity_equal = all(
        np.array_equal(b["speaker_activity"], _activity_reference(cuts, speakers))
        for cuts, b in zip(dataset.cuts, run["batches"]))
    shapes = {b["speaker_activity"].shape[1:] for b in run["batches"]}
    print(f"[{smi}] ami_diarization: {len(speakers)} speakers; speaker_activity (B, S, T) shapes "
          f"{sorted(shapes)}, equal to the raster of the supervisions: {activity_equal}, -100 "
          f"entries {sum(int((b['speaker_activity'] == -100).sum()) for b in run['batches'])}")
    if run["launches"] != 0 or not activity_equal or len(dataset.cuts) != len(run["batches"]):
        raise AssertionError("ami_diarization: launches or the speaker activity are off")

    # -- multi_source_zip ------------------------------------------------------------
    ihm = _ami_cuts(manifests, "ihm").trim_to_supervisions(keep_overlapping=False).to_eager()
    sdm = _ami_cuts(manifests, "sdm").trim_to_supervisions(keep_overlapping=False).to_eager()
    ihm_all = ihm.normalize_loudness(-23.0).to_eager()
    sdm_all = sdm.narrowband("mulaw").to_eager()
    ihm_src = CutSet.from_cuts(_head(ihm_all, MS_ZIP_SECONDS))
    sdm_src = CutSet.from_cuts(_head(sdm_all, MS_ZIP_SECONDS))

    def zip_loader():
        extractor = Fbank(FbankConfig(device=device))
        transforms = [CutConcatenate(gap=1.0), ClippingTransform(gain_db=(0.0, 12.0), p=0.5, seed=12),
                      LowpassUsingResampling(p=0.2, seed=13)]
        sampler = ZipSampler(
            SimpleCutSampler(ihm_src, max_duration=MS_MAX_DURATION, shuffle=True, seed=0),
            SimpleCutSampler(sdm_src, max_duration=MS_MAX_DURATION, shuffle=True, seed=1))
        dataset = K2SpeechRecognitionDataset(
            cut_transforms=transforms, return_cuts=True,
            input_strategy=OnTheFlyFeatures(extractor))
        return DataLoader(sampler, dataset, prefetch_batches=1,
                          checkpoint_objects=transforms[1:]), extractor

    builds = {"n": 0, "s": 0.0}
    build_kernel = resample._sinc_resample_kernel

    def timed_build(*args, **kwargs):
        t = time.perf_counter()
        try:
            return build_kernel(*args, **kwargs)
        finally:
            builds["n"] += 1
            builds["s"] += time.perf_counter() - t

    resample._sinc_resample_kernel = timed_build
    try:
        loader, extractor = zip_loader()
        recorder = _RecordFirstBatch(extractor)
        state = {}

        def checkpoint(i, batch):
            if i == MS_RESUME_AFTER - 1:
                state["ckpt"] = loader.state_dict()


        run = _leg("multi_source_zip", loader, _Trainer(device), device, fbank_cuda, _rows_of, smi,
                   on_batch=checkpoint)
        launches["multi_source_zip"] = run["launches"]
        err = _first_batch_err(recorder, extractor)
        first_builds = dict(builds)
        resumed_loader, _ = zip_loader()
        resumed_loader.load_state_dict(state["ckpt"])
        it = iter(resumed_loader)
        threads = set(threading.enumerate())
        t = time.perf_counter()
        resumed = next(it)
        resume_s = time.perf_counter() - t
        _close_and_join(it, threads)
    finally:
        resample._sinc_resample_kernel = build_kernel
    want = run["batches"][MS_RESUME_AFTER]
    resume_equal = torch.equal(torch.from_numpy(resumed["inputs"]), torch.from_numpy(want["inputs"])) \
        and resumed["supervisions"]["text"] == want["supervisions"]["text"]
    cut_ids = {c.id: c for b in run["batches"] for c in b["supervisions"]["cut"]}
    lowpassed = sum("_lowpassed" in i for i in cut_ids)
    clipped = sum("_cl" in i for i in cut_ids)
    concatenated = sum(isinstance(c, MixedCut) for c in cut_ids.values())
    cache_bytes = sum(k.nbytes for k, _ in resample._KERNEL_CACHE.values())
    transforms_s = run["report"].get("audio.transforms", {}).get("total_s", 0.0)
    print(f"[{smi}] multi_source_zip: sources {len(ihm_src)} ihm cuts normalize_loudness(-23.0) "
          f"and {len(sdm_src)} sdm cuts narrowband('mulaw'); {len(cut_ids)} cuts in the epoch, "
          f"{concatenated} concatenated, {clipped} clipped, {lowpassed} lowpassed; host s in the "
          f"audio.transforms span {transforms_s!r}; resampling-kernel builds {first_builds['n']} "
          f"in {first_builds['s']!r} s (with the resume: {builds['n']} in {builds['s']!r} s); "
          f"resampler caches after the leg: {len(resample._KERNEL_CACHE)} kernels of "
          f"{cache_bytes} bytes, {len(resample._RESAMPLERS)} resamplers (bound "
          f"{resample.CACHE_SIZE}); resumed after batch {MS_RESUME_AFTER} through a fresh loader "
          f"in {resume_s!r} s: its batch torch.equal to the uninterrupted run's: {resume_equal}; "
          f"first batch kernel vs plain {err!r} (tol {CHAIN_TOL})")
    if run["launches"] != len(run["batches"]) or len(run["batches"]) <= MS_RESUME_AFTER:
        raise AssertionError("multi_source_zip: launches or the batch count are off")
    if not resume_equal or not err <= CHAIN_TOL or not lowpassed or not concatenated:
        raise AssertionError("multi_source_zip: the resume, the kernel or the transforms are off")
    if len(resample._KERNEL_CACHE) > resample.CACHE_SIZE:
        raise AssertionError("multi_source_zip: the resampler cache outgrew its bound")
    errs.append(err)

    # -- multi_source_round_robin ----------------------------------------------------
    def dataset_with(extractor):
        return K2SpeechRecognitionDataset(
            cut_transforms=[CutConcatenate(gap=1.0),
                            ClippingTransform(gain_db=(0.0, 12.0), p=0.5, seed=14)],
            return_cuts=True, input_strategy=OnTheFlyFeatures(extractor))

    extractor, recorder = fly()
    sampler = RoundRobinSampler(
        WeightedSimpleCutSampler(ihm_all, [c.duration for c in ihm_all], num_samples=len(ihm_all) // 2,
                                 max_duration=MS_MAX_DURATION, seed=0),
        SimpleCutSampler(sdm_all, max_duration=MS_MAX_DURATION, shuffle=True, seed=1))
    run = _leg("multi_source_round_robin", DataLoader(sampler, dataset_with(extractor), prefetch_batches=3),
               _Trainer(device), device, fbank_cuda, _rows_of, smi)
    launches["multi_source_round_robin"] = run["launches"]
    err = _first_batch_err(recorder, extractor)
    origins = ["ihm" if "_ln" in b["supervisions"]["cut"][0].id else "sdm" for b in run["batches"]]
    print(f"[{smi}] multi_source_round_robin: batch sources {''.join(o[0] for o in origins)} "
          f"(i = ihm, s = sdm); first batch kernel vs plain {err!r} (tol {CHAIN_TOL})")
    if run["launches"] != len(run["batches"]) or origins[:4] != ["ihm", "sdm"] * 2:
        raise AssertionError("multi_source_round_robin: launches or the alternation are off")
    if not err <= CHAIN_TOL:
        raise AssertionError("multi_source_round_robin: the kernel disagrees with its plain version")
    errs.append(err)

    # -- multi_source_stateless ------------------------------------------------------
    ihm_all.to_file(workdir / "ms_ihm.jsonl")
    sdm_all.to_file(workdir / "ms_sdm.jsonl")

    def stateless(rank=None):
        saved = {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE")}
        if rank is not None:
            os.environ.update(RANK=str(rank), WORLD_SIZE="2")
        try:
            return StatelessSampler(
                [(workdir / "ms_ihm.jsonl", 1.0), (workdir / "ms_sdm.jsonl", 2.0)],
                index_path=workdir / "ms.idx", base_seed=0, max_duration=MS_MAX_DURATION)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def first_ids(sampler):
        return [[c.id for c in b] for b in itertools.islice(iter(sampler), STATELESS_BATCHES)]

    same_seed = first_ids(stateless()) == first_ids(stateless())
    ranks_differ = first_ids(stateless(0)) != first_ids(stateless(1))
    extractor, recorder = fly()
    dataset = dataset_with(extractor)

    def assembled():
        for cuts in itertools.islice(iter(stateless()), STATELESS_BATCHES):
            with trace_span("dataset.assemble"):
                batch = dataset[cuts]
            yield batch

    run = _leg("multi_source_stateless", assembled(), _Trainer(device), device, fbank_cuda,
               _rows_of, smi)
    launches["multi_source_stateless"] = run["launches"]
    err = _first_batch_err(recorder, extractor)
    print(f"[{smi}] multi_source_stateless: two samplers of base_seed 0 give the same first "
          f"{STATELESS_BATCHES} batches: {same_seed}; ranks 0 and 1 of world_size 2 differ: "
          f"{ranks_differ}; first batch kernel vs plain {err!r} (tol {CHAIN_TOL})")
    if run["launches"] != STATELESS_BATCHES or not same_seed or not ranks_differ:
        raise AssertionError("multi_source_stateless: launches or the seeding are off")
    if not err <= CHAIN_TOL:
        raise AssertionError("multi_source_stateless: the kernel disagrees with its plain version")
    errs.append(err)
    set_tracing_enabled(False)
    return launches, max(errs)
# -- 18. the paired-cut, SPHERE/AIFF and remaining task-dataset path -------------------
PAIRED_SNR = 10.0  # dB of the session noise under each utterance of paired_enhancement
PAIRED_RESUME_AFTER = 2
SEP_PAIRS = 40  # 2-speaker mixtures of utterance pairs
SEP_BATCH = 8  # mixtures per separation step
CHUNK_SECONDS, CHUNK_SHIFT, CHUNK_BATCH = 10.0, 5.0, 16
TAG_EVENTS = ("Speech", "Music", "Speech;Music", "Noise")
# A fixed word map over RECIPE_WORDS: the made-up "translation" only carries text.
TRANSLATION = {w: w[::-1].lower() for w in RECIPE_WORDS}


def _translate(text: str) -> str:
    """The word map applied in reversed word order."""
    return " ".join(TRANSLATION[w] for w in reversed(text.split()))


class _WithCuts:
    """Wraps a dataset whose batch holds no cuts (``DynamicUnsupervisedDataset``
    returns the collated matrix alone) to hand the step its cuts."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __getitem__(self, cuts):
        return {"features": self.dataset[cuts], "cuts": list(cuts)}


class _RecordFirstExtract:
    """Wraps ``extractor.extract`` to keep the first ``n`` calls' items and
    features in the layout of ``_RecordFirstBatch.first``. They are held to
    the plain version as one batch: the kernel's rows do not depend on the
    batch, but the plain version's GEMMs pick their algorithm by shape, and
    in the near-cancelling lowest mel bins of a tone burst two float32
    orders part by up to 2.3e-4 (one item alone: 1.43e-4 from a batch's)."""

    def __init__(self, extractor, n: int = 8):
        self.first = ([], [])
        inner = extractor.extract

        def extract(samples, sampling_rate):
            out = inner(samples, sampling_rate)
            if len(self.first[0]) < n:
                self.first[0].append(np.asarray(samples).reshape(-1).copy())
                self.first[1].append(np.asarray(out).copy())
            return out

        extractor.extract = extract


def _cpu_port_err(kernel_feats, extractor, items, cpu_feats) -> tuple:
    """Max-abs of the card's features from the CPU port's (whose DFT
    products are float64) and of the kernel's plain version's from them;
    a tonal bin may part the float32 routes from float64 by more than
    ``CHAIN_TOL``, so the card is held to twice the plain version's."""
    plain = _plain_extract(extractor, items)
    err = max(float(np.abs(k - c).max()) for k, c in zip(kernel_feats, cpu_feats))
    plain_err = max(float(np.abs(p - c).max()) for p, c in zip(plain, cpu_feats))
    return err, plain_err


def _phase_paired(workdir: Path, device, fbank_cuda, smi: str) -> tuple:
    """18. The paired-cut, SPHERE/AIFF and remaining task-dataset path, on
    phase 14's corpora (its 160 LibriSpeech utterances and 8 sessions of
    120 s), each batch into an AdamW step of ``Encoder(EncoderConfig())``.
    ``sphere_aiff_on_the_fly``: the utterances rewritten by the port's
    writers, a third each as SPHERE pcm16, SPHERE ulaw and AIFF →
    ``RecordingSet.from_dir`` → the recipe's supervisions →
    ``CutSet.from_manifests`` → ``SimpleCutSampler(max_duration=180)`` →
    ``K2SpeechRecognitionDataset`` with ``OnTheFlyFeatures`` on the card; the
    pcm16 SPHERE and AIFF audio ``np.array_equal`` to the FLAC source, their
    features ``torch.equal`` to the FLAC twins' in the same batches; the
    sessions written as SPHERE pcm16 and cut into 10 s windows, whose
    partial reads equal the FLAC windows'. ``paired_enhancement``: each
    utterance mixed at 10 dB with a span of a session (the source side)
    against the clean utterance (the target side) through
    ``CutPairsSampler``, ``OnTheFlyFeatures`` on the card on each side, the
    step on the source; a fresh sampler loads the state after batch 2 and
    gives the next two pairs of batches ``torch.equal``.
    ``speech_translation_on_the_fly``: ``K2Speech2TextTranslationDataset``
    over the utterances with a ``translated_text`` each. ``tts_on_the_fly``:
    ``SpeechSynthesisDataset`` with ``TokenCollater`` tokens.
    ``separation_extract``: 40 two-speaker mixtures and their sources through
    ``compute_and_store_features_batch`` on the card into ``lilcom_chunky``;
    ``separation_premixed`` and ``separation_dynamic`` read them back through
    ``PreMixedSourceSeparationDataset`` and
    ``DynamicallyMixedSourceSeparationDataset`` into a step on the mixtures.
    ``unsupervised_on_the_fly``: ``DynamicUnsupervisedDataset`` with the card
    ``Fbank``; ``tagging_on_the_fly``: ``AudioTaggingDataset`` with an
    ``audio_event`` per supervision; ``recording_chunks``:
    ``RecordingChunkIterableDataset`` over the SPHERE sessions (10 s chunks
    every 5 s) through a ``torch.utils.data.DataLoader`` with two forked
    workers sharded by ``audio_chunk_worker_init_fn``, the kernel in this
    process. Returns the kernel's launches per path and the largest
    kernel-vs-plain error."""
    import copy
    import warnings

    from lhotse_tpu_torch.audio import RecordingSet
    from lhotse_tpu_torch.audio.aiffio import write_aiff
    from lhotse_tpu_torch.audio.sphio import write_sph
    from lhotse_tpu_torch.caching import set_caching_enabled
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.dataset import (
        AudioTaggingDataset, CutPairsSampler, DynamicallyMixedSourceSeparationDataset,
        DynamicUnsupervisedDataset, K2Speech2TextTranslationDataset,
        PreMixedSourceSeparationDataset, RecordingChunkIterableDataset, SimpleCutSampler,
        SpeechSynthesisDataset, TokenCollater, audio_chunk_collate, audio_chunk_worker_init_fn)
    from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
    from lhotse_tpu_torch.dataset.loader import DataLoader
    from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
    from lhotse_tpu_torch.features import Fbank, FbankConfig
    from lhotse_tpu_torch.features.io import LilcomChunkyWriter
    from lhotse_tpu_torch.supervision import SupervisionSet
    from lhotse_tpu_torch.tracing import set_tracing_enabled, trace_span
    from lhotse_tpu_torch.utils import fastcopy

    set_caching_enabled(False)
    set_tracing_enabled(True)
    launches, errs = {}, []

    def fly():
        extractor = Fbank(FbankConfig(device=device))
        return extractor, _RecordFirstBatch(extractor)

    def loader_over(cuts, dataset):
        return DataLoader(SimpleCutSampler(cuts, max_duration=FLY_MAX_DURATION, shuffle=True, seed=0),
                          dataset, prefetch_batches=3)

    def batch_cuts(batch):
        return batch["supervisions"]["cut"]

    # -- sphere_aiff_on_the_fly ------------------------------------------------------
    t0 = time.perf_counter()
    flac = sorted(CutSet.from_file(workdir / "recipe_cuts.jsonl.gz"), key=lambda c: c.recording_id)
    flac_by_rec = {c.recording_id: c for c in flac}
    audio_dir = workdir / "sphere_aiff"
    audio_dir.mkdir()
    kinds = {}
    for i, cut in enumerate(flac):
        samples, kind = cut.recording.load_audio(), ("pcm16", "ulaw", "aiff")[i % 3]
        if kind == "aiff":
            write_aiff(audio_dir / f"{cut.recording_id}.aiff", samples, SR)
        else:
            write_sph(audio_dir / f"{cut.recording_id}.sph", samples, SR, coding=kind)
        kinds[cut.recording_id] = kind
    recordings = RecordingSet.from_recordings(
        list(RecordingSet.from_dir(audio_dir, "*.sph")) + list(RecordingSet.from_dir(audio_dir, "*.aiff")))
    cuts = CutSet.from_manifests(
        recordings, SupervisionSet.from_segments(s for c in flac for s in c.supervisions)).to_eager()
    lossless_equal = all(
        np.array_equal(r.load_audio(), flac_by_rec[r.id].recording.load_audio())
        for r in recordings if kinds[r.id] != "ulaw")
    long = RecordingSet.from_file(workdir / "long_recordings.jsonl.gz").to_eager()
    sessions_dir = workdir / "sessions_sph"
    sessions_dir.mkdir()
    for rec in long:
        write_sph(sessions_dir / f"{rec.id}.sph", rec.load_audio(), SR)
    sph_sessions = RecordingSet.from_dir(sessions_dir, "*.sph").to_eager()
    session_sups = SupervisionSet.from_file(workdir / "long_supervisions.jsonl.gz").to_eager()

    def windows_of(recs):
        return sorted(CutSet.from_manifests(recs, session_sups).cut_into_windows(WINDOW_SECONDS),
                      key=lambda c: (c.recording_id, c.start))

    windows, flac_windows = windows_of(sph_sessions), windows_of(long)
    windows_equal = len(windows) == len(flac_windows) == LONG_SESSIONS * int(
        LONG_SECONDS / WINDOW_SECONDS) and all(
        np.array_equal(a.load_audio(), b.load_audio()) for a, b in zip(windows, flac_windows))
    print(f"[{smi}] sphere_aiff_on_the_fly: {len(cuts)} utterances rewritten ({sum(k == 'pcm16' for k in kinds.values())} "
          f"SPHERE pcm16, {sum(k == 'ulaw' for k in kinds.values())} SPHERE ulaw, "
          f"{sum(k == 'aiff' for k in kinds.values())} AIFF) and {len(sph_sessions)} sessions as SPHERE "
          f"pcm16 in {time.perf_counter() - t0!r} s; pcm16 SPHERE and AIFF audio equal to the FLAC "
          f"source: {lossless_equal}; {len(windows)} session windows of {WINDOW_SECONDS:g} s read at "
          f"their offsets equal to the FLAC windows: {windows_equal}")
    if len(cuts) != len(flac) or not lossless_equal or not windows_equal:
        raise AssertionError("sphere_aiff_on_the_fly: the rewritten audio is off")
    extractor, recorder = fly()
    run = _leg("sphere_aiff_on_the_fly", loader_over(cuts, K2SpeechRecognitionDataset(
        return_cuts=True, input_strategy=OnTheFlyFeatures(extractor))), _Trainer(device), device,
        fbank_cuda, _rows_of, smi)
    launches["sphere_aiff_on_the_fly"] = run["launches"]
    err = _first_batch_err(recorder, extractor)
    twin = K2SpeechRecognitionDataset(return_cuts=True, input_strategy=OnTheFlyFeatures(extractor))
    twins_equal, compared = True, 0
    for batch in run["batches"][:2]:
        flac_batch = twin[CutSet.from_cuts(flac_by_rec[c.recording_id] for c in batch_cuts(batch))]
        rows = {c.recording_id: int(i) for i, c in zip(batch["supervisions"]["sequence_idx"], batch_cuts(batch))}
        flac_rows = {c.recording_id: int(i) for i, c in zip(
            flac_batch["supervisions"]["sequence_idx"], batch_cuts(flac_batch))}
        for rid, row in rows.items():
            if kinds[rid] != "ulaw":
                compared += 1
                twins_equal &= torch.equal(torch.from_numpy(batch["inputs"][row]),
                                           torch.from_numpy(flac_batch["inputs"][flac_rows[rid]]))
    seen = sorted(c.recording_id for b in run["batches"] for c in batch_cuts(b))
    print(f"[{smi}] sphere_aiff_on_the_fly: features of {compared} pcm16 SPHERE and AIFF cuts in the "
          f"first two batches torch.equal to their FLAC twins' (the same batches through the "
          f"kernel): {twins_equal}; first batch kernel vs plain {err!r} (tol {CHAIN_TOL})")
    if run["launches"] != len(run["batches"]) or seen != sorted(kinds):
        raise AssertionError("sphere_aiff_on_the_fly: launches or the epoch's cuts are off")
    if not twins_equal or not compared or not err <= CHAIN_TOL:
        raise AssertionError("sphere_aiff_on_the_fly: the features are off")
    errs.append(err)

    # -- paired_enhancement ---------------------------------------------------------------
    rng = np.random.RandomState(18)
    noise = [r.to_cut() for r in sph_sessions]  # SPHERE: each span is a partial read
    noisy = []
    for i, c in enumerate(flac):
        session = noise[i % len(noise)]
        offset = round(float(rng.uniform(0.0, session.duration - c.duration - 0.01)), 2)
        span = session.truncate(offset=offset, duration=c.duration)
        noisy.append(c.mix(span, snr=PAIRED_SNR, preserve_id="left"))
    src, tgt = CutSet.from_cuts(noisy), CutSet.from_cuts(flac)

    def pairs():
        return CutPairsSampler(src, tgt, max_source_duration=FLY_MAX_DURATION,
                               max_target_duration=FLY_MAX_DURATION, shuffle=True, seed=0)

    src_ext, src_rec = fly()
    tgt_ext, tgt_rec = fly()
    src_ds = K2SpeechRecognitionDataset(return_cuts=True, input_strategy=OnTheFlyFeatures(src_ext))
    tgt_ds = K2SpeechRecognitionDataset(return_cuts=True, input_strategy=OnTheFlyFeatures(tgt_ext))

    def paired(sampler):
        for s, t in sampler:
            with trace_span("dataset.assemble"):
                batch = {"source": src_ds[s], "target": tgt_ds[t]}
            yield batch

    sampler, state = pairs(), {}

    def keep_state(i, batch):
        if i == PAIRED_RESUME_AFTER - 1:
            state["sampler"] = copy.deepcopy(sampler.state_dict())

    run = _leg("paired_enhancement", paired(sampler), _Trainer(device), device, fbank_cuda,
               lambda b: _rows_of(b["source"]), smi, on_batch=keep_state)
    launches["paired_enhancement"] = run["launches"]
    src_err, tgt_err = _first_batch_err(src_rec, src_ext), _first_batch_err(tgt_rec, tgt_ext)
    aligned = all([c.id for c in batch_cuts(b["source"])] == [c.id for c in batch_cuts(b["target"])]
                  for b in run["batches"])
    mixed = all(type(c).__name__ == "MixedCut" for b in run["batches"] for c in batch_cuts(b["source"]))
    resumed_sampler = pairs()
    resumed_sampler.load_state_dict(copy.deepcopy(state["sampler"]))
    resumed = [b for _, b in zip(range(2), paired(resumed_sampler))]
    want = run["batches"][PAIRED_RESUME_AFTER: PAIRED_RESUME_AFTER + 2]
    resume_equal = len(resumed) == len(want) == 2 and all(
        [c.id for c in batch_cuts(a[side])] == [c.id for c in batch_cuts(b[side])]
        and torch.equal(torch.from_numpy(a[side]["inputs"]), torch.from_numpy(b[side]["inputs"]))
        for a, b in zip(resumed, want) for side in ("source", "target"))
    seen = sorted(c.id for b in run["batches"] for c in batch_cuts(b["source"]))
    print(f"[{smi}] paired_enhancement: {len(run['batches'])} pairs of batches, source and target ids "
          f"aligned: {aligned}, every source a MixedCut: {mixed}; a fresh sampler loaded after batch "
          f"{PAIRED_RESUME_AFTER} gives the next two pairs of batches torch.equal to the "
          f"uninterrupted run's: {resume_equal}; first batch kernel vs plain: source {src_err!r}, "
          f"target {tgt_err!r} (tol {CHAIN_TOL})")
    if run["launches"] != 2 * len(run["batches"]) or seen != sorted(c.id for c in flac):
        raise AssertionError("paired_enhancement: launches or the epoch's cuts are off")
    if not (aligned and mixed and resume_equal) or not max(src_err, tgt_err) <= CHAIN_TOL:
        raise AssertionError("paired_enhancement: the pairs, the resume or the features are off")
    errs += [src_err, tgt_err]

    # -- speech_translation_on_the_fly ---------------------------------------------------------
    translated = CutSet.from_cuts(fastcopy(c, supervisions=[
        fastcopy(s, custom=dict(s.custom or {}, translated_text=_translate(s.text)))
        for s in c.supervisions]) for c in flac)
    extractor, recorder = fly()
    run = _leg("speech_translation_on_the_fly", loader_over(translated, K2Speech2TextTranslationDataset(
        return_cuts=True, input_strategy=OnTheFlyFeatures(extractor))), _Trainer(device), device,
        fbank_cuda, _rows_of, smi)
    launches["speech_translation_on_the_fly"] = run["launches"]
    err = _first_batch_err(recorder, extractor)
    texts_ok = all(
        b["supervisions"]["text"] == [s.text for c in batch_cuts(b) for s in c.supervisions]
        and b["supervisions"]["tgt_text"] == [_translate(t) for t in b["supervisions"]["text"]]
        for b in run["batches"])
    first = run["batches"][0]
    cpu = K2Speech2TextTranslationDataset(return_cuts=True, input_strategy=OnTheFlyFeatures(
        Fbank(FbankConfig(device="cpu"))))[CutSet.from_cuts(batch_cuts(first))]
    same_text = all(cpu["supervisions"][k] == first["supervisions"][k] for k in ("text", "tgt_text"))
    rows = _frames_of(batch_cuts(first), first["inputs"].shape[1])
    items, kernel_out = recorder.first
    cpu_err, plain_cpu_err = _cpu_port_err(
        kernel_out, extractor, items, [cpu["inputs"][i, :n] for i, n in enumerate(rows)])
    print(f"[{smi}] speech_translation_on_the_fly: text and tgt_text of every batch those of its "
          f"supervisions: {texts_ok}; first batch's text and tgt_text equal to the CPU port's: "
          f"{same_text}; first batch kernel vs plain {err!r} (tol {CHAIN_TOL}), vs the CPU port "
          f"{cpu_err!r} where the plain version is {plain_cpu_err!r}")
    if run["launches"] != len(run["batches"]) or not (texts_ok and same_text):
        raise AssertionError("speech_translation_on_the_fly: launches or the text are off")
    if not err <= CHAIN_TOL or not cpu_err <= max(CHAIN_TOL, 2 * plain_cpu_err):
        raise AssertionError("speech_translation_on_the_fly: the features are off")
    errs.append(err)

    # -- tts_on_the_fly --------------------------------------------------------------------------
    collater = TokenCollater(tgt)
    extractor, recorder = fly()
    run = _leg("tts_on_the_fly", loader_over(tgt, SpeechSynthesisDataset(
        feature_input_strategy=OnTheFlyFeatures(extractor), return_cuts=True)), _Trainer(device),
        device, fbank_cuda, lambda b: (b["features"], b["features_lens"],
                                       float(np.sum(b["audio_lens"])) / SR), smi)
    launches["tts_on_the_fly"] = run["launches"]
    err = _first_batch_err(recorder, extractor)
    inverse_ok = all(
        collater.inverse(*collater(CutSet.from_cuts(b["cut"]))) == [c.supervisions[0].text for c in b["cut"]]
        and b["text"] == [c.supervisions[0].text for c in b["cut"]] for b in run["batches"])
    first = run["batches"][0]
    cpu_cuts = CutSet.from_cuts(first["cut"])
    cpu = SpeechSynthesisDataset(feature_input_strategy=OnTheFlyFeatures(
        Fbank(FbankConfig(device="cpu"))), return_cuts=True)[cpu_cuts]
    tokens, jlens = collater(cpu_cuts)
    cpu_tokens = TokenCollater(tgt)(cpu_cuts)
    same = (np.array_equal(cpu["audio"], first["audio"]) and np.array_equal(tokens, cpu_tokens[0])
            and np.array_equal(jlens, cpu_tokens[1]) and cpu["text"] == first["text"])
    items, kernel_out = recorder.first
    cpu_err, plain_cpu_err = _cpu_port_err(
        kernel_out, extractor, items, [cpu["features"][i, :n] for i, n in enumerate(first["features_lens"])])
    print(f"[{smi}] tts_on_the_fly: vocabulary of {len(collater.idx2token)} tokens; inverse() gives "
          f"back every supervision's text: {inverse_ok}; first batch's audio, tokens and text equal "
          f"to the CPU port's: {same}; first batch kernel vs plain {err!r} (tol {CHAIN_TOL}), vs the "
          f"CPU port {cpu_err!r} where the plain version is {plain_cpu_err!r}")
    if run["launches"] != len(run["batches"]) or not (inverse_ok and same):
        raise AssertionError("tts_on_the_fly: launches, tokens or audio are off")
    if not err <= CHAIN_TOL or not cpu_err <= max(CHAIN_TOL, 2 * plain_cpu_err):
        raise AssertionError("tts_on_the_fly: the features are off")
    errs.append(err)

    # -- separation_extract, separation_premixed, separation_dynamic --------------------------
    sources, mixtures = [], []
    for k in range(SEP_PAIRS):
        a, b = flac[2 * k], flac[2 * k + 1]
        length = min(a.duration, b.duration)
        a, b = a.truncate(duration=length, preserve_id=True), b.truncate(duration=length, preserve_id=True)
        sources += [a, b]
        mixtures.append(fastcopy(a.mix(b), id=f"mix-{k:03d}"))
    extractor, recorder = fly()
    stored = {}

    def extract():
        stored["cuts"] = CutSet.from_cuts(sources + mixtures).compute_and_store_features_batch(
            extractor, workdir / "separation_feats", manifest_path=workdir / "separation.jsonl",
            storage_type=LilcomChunkyWriter).to_eager()

    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    wall_ms, busy_ms, _ = _device_busy(extract)
    launches["separation_extract"] = fbank_cuda.LAUNCHES
    err = _first_batch_err(recorder, extractor)
    seconds = sum(c.duration for c in sources + mixtures)
    print(f"[{smi}] separation_extract: {len(sources)} sources and {len(mixtures)} mixtures, "
          f"{seconds!r} audio-s extracted and stored in {wall_ms!r} ms under torch.profiler: "
          f"{seconds / wall_ms * 1e3!r} audio-s/s; device busy {busy_ms / wall_ms!r} of the wall; "
          f"fbank kernel launches {launches['separation_extract']}; no loader (dataset.assemble: "
          f"none); first batch kernel vs plain {err!r} (tol {CHAIN_TOL})")
    if not launches["separation_extract"] >= 1 or not err <= CHAIN_TOL:
        raise AssertionError("separation_extract: launches or the kernel's result are off")
    errs.append(err)

    def split(featured):
        by_id = {c.id: c for c in featured}
        src_feats = [by_id[c.id] for c in sources]
        return src_feats, [by_id[m.id] for m in mixtures]

    def premixed(featured):
        src_feats, mix_feats = split(featured)
        relabelled = [fastcopy(c, id=f"{mixtures[i // 2].id}-src{i % 2}", recording=None,
                               features=fastcopy(c.features, recording_id=mixtures[i // 2].id))
                      for i, c in enumerate(src_feats)]
        return PreMixedSourceSeparationDataset(CutSet.from_cuts(relabelled), CutSet.from_cuts(mix_feats))

    def dynamic(featured):
        src_feats, _ = split(featured)
        mixed_feats = [fastcopy(src_feats[2 * k].mix(src_feats[2 * k + 1]), id=f"dmix-{k:03d}")
                       for k in range(SEP_PAIRS)]
        return DynamicallyMixedSourceSeparationDataset(CutSet.from_cuts(src_feats), CutSet.from_cuts(mixed_feats))

    def sep_batches(dataset):
        for lo in range(0, len(dataset), SEP_BATCH):
            with trace_span("dataset.assemble"):
                items = [dataset[i] for i in range(lo, min(lo + SEP_BATCH, len(dataset)))]
            yield items

    def sep_rows(items):
        feats, lens = _padded([it["mixture"] for it in items])
        return feats, lens, sum(lens) * 0.01

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "not yet updated to use the new sampling mechanism"
        datasets = {"separation_premixed": premixed(stored["cuts"]),
                    "separation_dynamic": dynamic(stored["cuts"])}
        reread = CutSet.from_file(workdir / "separation.jsonl").to_eager()
        cpu_sets = {"separation_premixed": premixed(reread), "separation_dynamic": dynamic(reread)}
    for name, dataset in datasets.items():
        run = _leg(name, sep_batches(dataset), _Trainer(device), device, fbank_cuda, sep_rows, smi,
                   unit="mixture")
        launches[name] = run["launches"]
        items = [it for b in run["batches"] for it in b]
        # The masks are powers over their sum plus EPSILON (1e-10): where the
        # sources' power is small (the pre-emphasised lowest mel bins) they
        # sum to P / (P + EPSILON), short of 1.
        short = max(float(np.abs(it["real_mask"].sum(0) - 1.0).max()) for it in items)
        mask_err = 0.0
        for it in items:
            power = np.exp(it["sources"]).sum(0)
            mask_err = max(mask_err, float(np.abs(it["real_mask"].sum(0) - power / (power + 1e-10)).max()))
        cpu = cpu_sets[name]
        masks_equal = len(items) == len(cpu) == SEP_PAIRS and all(
            np.array_equal(it["real_mask"], cpu[i]["real_mask"])
            and np.array_equal(it["binary_mask"], cpu[i]["binary_mask"]) for i, it in enumerate(items))
        print(f"[{smi}] {name}: {len(items)} mixtures of {items[0]['sources'].shape[0]} sources; "
              f"real_mask sums over the sources to P / (P + EPSILON) within {mask_err!r} (tol 1e-6), "
              f"to 1 within {short!r}; masks equal to the CPU port's dataset on the manifest read "
              f"back: {masks_equal}")
        if run["launches"] != 0 or not mask_err <= 1e-6 or not masks_equal:
            raise AssertionError(f"{name}: a launch, or the masks are off")

    # -- unsupervised_on_the_fly ------------------------------------------------------------------
    extractor = Fbank(FbankConfig(device=device))
    first_extract = _RecordFirstExtract(extractor)
    run = _leg("unsupervised_on_the_fly", loader_over(tgt, _WithCuts(DynamicUnsupervisedDataset(
        feature_extractor=extractor))), _Trainer(device), device, fbank_cuda,
        lambda b: (b["features"], _frames_of(b["cuts"], b["features"].shape[1]),
                   sum(c.duration for c in b["cuts"])), smi)
    launches["unsupervised_on_the_fly"] = run["launches"]
    err = _first_batch_err(first_extract, extractor)
    n_cuts = sum(len(b["cuts"]) for b in run["batches"])
    print(f"[{smi}] unsupervised_on_the_fly: {n_cuts} cuts, one launch per cut "
          f"({run['launches']}); the first {len(first_extract.first[0])} cuts' kernel features vs "
          f"the plain version over them as one batch {err!r} (tol {CHAIN_TOL})")
    if run["launches"] != n_cuts or n_cuts != len(flac) or not err <= CHAIN_TOL:
        raise AssertionError("unsupervised_on_the_fly: launches or the kernel's result are off")
    errs.append(err)

    # -- tagging_on_the_fly -------------------------------------------------------------------------
    tagged = CutSet.from_cuts(fastcopy(c, supervisions=[
        fastcopy(s, custom=dict(s.custom or {}, audio_event=TAG_EVENTS[i % len(TAG_EVENTS)]))
        for s in c.supervisions]) for i, c in enumerate(flac))
    extractor, recorder = fly()
    run = _leg("tagging_on_the_fly", loader_over(tagged, AudioTaggingDataset(
        return_cuts=True, input_strategy=OnTheFlyFeatures(extractor))), _Trainer(device), device,
        fbank_cuda, _rows_of, smi)
    launches["tagging_on_the_fly"] = run["launches"]
    err = _first_batch_err(recorder, extractor)
    events_ok = all(b["supervisions"]["audio_event"] == [s.audio_event for c in batch_cuts(b)
                                                         for s in c.supervisions] for b in run["batches"])
    counts = {e: sum(b["supervisions"]["audio_event"].count(e) for b in run["batches"]) for e in TAG_EVENTS}
    print(f"[{smi}] tagging_on_the_fly: audio_event of every batch that of its supervisions: "
          f"{events_ok}, counts {counts}; first batch kernel vs plain {err!r} (tol {CHAIN_TOL})")
    if run["launches"] != len(run["batches"]) or not events_ok or sum(counts.values()) != len(flac):
        raise AssertionError("tagging_on_the_fly: launches or the labels are off")
    if not err <= CHAIN_TOL:
        raise AssertionError("tagging_on_the_fly: the kernel disagrees with its plain version")
    errs.append(err)

    # -- recording_chunks -------------------------------------------------------------------------
    chunks = RecordingChunkIterableDataset(sph_sessions, chunk_size=CHUNK_SECONDS, chunk_shift=CHUNK_SHIFT)
    loader = torch.utils.data.DataLoader(
        chunks, batch_size=CHUNK_BATCH, num_workers=2, worker_init_fn=audio_chunk_worker_init_fn,
        collate_fn=audio_chunk_collate, multiprocessing_context="fork")
    total = {r.id: r.num_samples for r in sph_sessions}
    extractor, recorder = fly()

    def chunk_batches():
        for b in loader:
            lens = [min(int(CHUNK_SECONDS * SR), total[rid] - int(round(float(t) * SR)))
                    for rid, t in zip(b["recording_id"], b["begin_time"])]
            feats = extractor.extract_batch(list(b["audio"]), SR, lengths=np.array(lens))
            feats, frames = _padded(list(feats))
            yield {"keys": list(zip(b["recording_id"], b["begin_time"].tolist())), "feats": feats,
                   "frames": frames, "seconds": sum(lens) / SR}

    run = _leg("recording_chunks", chunk_batches(), _Trainer(device), device, fbank_cuda,
               lambda b: (b["feats"], b["frames"], b["seconds"]), smi)
    launches["recording_chunks"] = run["launches"]
    err = _first_batch_err(recorder, extractor)
    keys = [k for b in run["batches"] for k in b["keys"]]
    expected = sorted((r.id, float(s)) for r in sph_sessions
                      for s in np.arange(0.0, r.duration, CHUNK_SHIFT))
    print(f"[{smi}] recording_chunks: torch DataLoader, 2 workers, multiprocessing context "
          f"{loader.multiprocessing_context.get_start_method()!r}; {len(keys)} chunks of "
          f"{CHUNK_SECONDS:g} s every {CHUNK_SHIFT:g} s over {len(sph_sessions)} SPHERE sessions, each "
          f"exactly once: {sorted(keys) == expected}; the decode spans run in the worker processes "
          f"(not collected); first batch kernel vs plain {err!r} (tol {CHAIN_TOL})")
    if sorted(keys) != expected or run["launches"] != len(run["batches"]) or not err <= CHAIN_TOL:
        raise AssertionError("recording_chunks: the chunks, launches or the kernel's result are off")
    errs.append(err)
    set_tracing_enabled(False)
    return launches, max(errs)


# -- 19. the lossy-codec corpus path -------------------------------------------
CV_RELEASE = "cv-corpus-13.0-2023-03-09"
CV_SR = 48000  # CommonVoice ships 48 kHz mono MP3 clips
CV_SPLITS = ("train", "dev", "test")
CV_RESUME_AFTER = 3
CV_AGES, CV_GENDERS, CV_ACCENTS = ("twenties", "fifties", ""), ("male", "female", ""), ("us", "", "india")
COMPRESS_CODECS = ("opus", "mp3", "vorbis")
COMPRESS_SEED = 19
COMPRESSED_SHARE = (0.35, 0.65)  # p=0.5 over 160 cuts
MP3_CORR = 0.95  # a 192 kbps MP3 round trip of a tone burst against its source
CODEC_CHECK_FILES = 3
# The libraries each leg needs (syscodecs' availability probes).
LOSSY_LEG_NEEDS = {
    "commonvoice_on_the_fly": ("mp3", "mp3_encode"),
    "commonvoice_compress": ("mp3", "mp3_encode", "opus", "vorbis", "vorbis_encode"),
    "shar_opus_on_the_fly": ("opus",),
    "codec_check": ("mp3", "mp3_encode", "opus", "vorbis", "vorbis_encode"),
}


def _corr(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def _codec_of(cut):
    """The codec of the ``Compress`` transform a cut's recording ends with,
    or None."""
    chain = cut.recording.transforms or []
    last = chain[-1] if chain else None
    if isinstance(last, dict):
        return last["kwargs"]["codec"] if last["name"] == "Compress" else None
    return last.codec if type(last).__name__ == "Compress" else None


def _write_commonvoice(flac, lang: Path) -> dict:
    """Phase 14's utterances as a CommonVoice release's language directory:
    each one resampled to 48 kHz and encoded as a mono MP3 clip under
    ``clips/`` (on a thread pool: the codec and resampler calls release the
    interpreter's lock), every tenth in ``dev.tsv``, the next in
    ``test.tsv``, the rest in ``train.tsv``, with the release's columns; the
    first train sentence opens a quote it never closes. Returns each
    utterance's sentence by recording id."""
    from concurrent.futures import ThreadPoolExecutor

    from lhotse_tpu_torch.audio import syscodecs
    from lhotse_tpu_torch.augmentation import resample_array

    (lang / "clips").mkdir(parents=True)

    def encode(cut):
        clip = resample_array(cut.recording.load_audio(), SR, CV_SR)
        (lang / "clips" / f"{cut.recording_id}.mp3").write_bytes(syscodecs.mp3_encode(clip, CV_SR))

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(encode, flac))
    rows = {split: ["client_id\tpath\tsentence\tup_votes\tdown_votes\tage\tgender\taccents"]
            for split in CV_SPLITS}
    sentences, opened = {}, False
    for i, cut in enumerate(flac):
        split = CV_SPLITS[1 + i % 10] if i % 10 < 2 else "train"
        text = cut.supervisions[0].text
        if split == "train" and not opened:
            text, opened = f'"{text}', True
        sentences[cut.recording_id] = text
        k = i % 3
        rows[split].append(f"{cut.recording_id.split('-')[0]}\t{cut.recording_id}.mp3\t{text}\t2\t0\t"
                           f"{CV_AGES[k]}\t{CV_GENDERS[k]}\t{CV_ACCENTS[k]}")
    for split, lines in rows.items():
        (lang / f"{split}.tsv").write_text("\n".join(lines) + "\n")
    return sentences


def _phase_lossy(workdir: Path, device, fbank_cuda, smi: str) -> tuple:
    """19. The lossy-codec corpus path, on phase 14's corpora (its 160
    LibriSpeech utterances), each batch into an AdamW step of
    ``Encoder(EncoderConfig())``. First a line of which system codec
    libraries load on this machine; a leg whose library does not load is
    left out and named, and no other format runs under its name.
    ``commonvoice_on_the_fly``: the utterances written as a CommonVoice
    release (48 kHz mono MP3 clips, ``{train,dev,test}.tsv``, one quote
    left open) → ``prepare_commonvoice`` → ``CutSet.from_manifests`` →
    ``resample(16000)`` → ``SimpleCutSampler(max_duration=180)`` →
    ``K2SpeechRecognitionDataset`` with ``OnTheFlyFeatures`` on the card,
    with a resume after batch 3 whose batches are ``torch.equal`` to the
    uninterrupted run's. ``commonvoice_compress``: the same cuts through the
    ``Compress`` cut transform (opus, mp3 and vorbis, levels in (0.1, 0.9),
    p=0.5, a fixed seed); a compressed cut of each codec reads as the
    ``Compress`` round trip of its uncompressed cut's audio.
    ``shar_opus_on_the_fly``: the utterances exported to Shar with the
    recording in opus, read by ``LazySharIterator`` into
    ``OnTheFlyFeatures`` on the card; every member decodes to
    ``opus_decode(opus_encode(source))``. ``codec_check``: Vorbis ``.ogg``
    and ``.opus`` files through ``Recording.from_file`` and ``info`` with and
    without ``force_opus_sampling_rate=16000``, and ``save_audio`` to
    ``.mp3``, ``.ogg`` and ``.opus`` read back, with no step. Returns the
    kernel's launches per path and the largest kernel-vs-plain error."""
    from collections import Counter
    from concurrent.futures import ThreadPoolExecutor

    from lhotse_tpu_torch.audio import Recording, RecordingSet, info, save_audio, syscodecs
    from lhotse_tpu_torch.augmentation import Compress as CompressTransform
    from lhotse_tpu_torch.caching import set_caching_enabled
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.dataset import SimpleCutSampler
    from lhotse_tpu_torch.dataset.cut_transforms import Compress
    from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
    from lhotse_tpu_torch.dataset.loader import DataLoader
    from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
    from lhotse_tpu_torch.features import Fbank, FbankConfig
    from lhotse_tpu_torch.recipes import prepare_commonvoice
    from lhotse_tpu_torch.shar.readers import LazySharIterator
    from lhotse_tpu_torch.supervision import SupervisionSet
    from lhotse_tpu_torch.tracing import set_tracing_enabled

    set_caching_enabled(False)
    set_tracing_enabled(True)
    available = {"mp3": syscodecs.mp3_available(), "mp3_encode": syscodecs.mp3_encode_available(),
                 "vorbis": syscodecs.vorbis_available(),
                 "vorbis_encode": syscodecs.vorbis_encode_available(),
                 "opus": syscodecs.opus_available()}
    missing = {leg: [lib for lib in needs if not available[lib]]
               for leg, needs in LOSSY_LEG_NEEDS.items()}
    for leg, libs in missing.items():
        if libs:
            print(f"[{smi}] {leg}: left out, as this machine does not load the library behind "
                  f"{', '.join(f'{lib}_available()' for lib in libs)}")
    print(f"[{smi}] system codecs: mp3_available() {available['mp3']}, mp3_encode_available() "
          f"{available['mp3_encode']}, vorbis_available() {available['vorbis']}, "
          f"vorbis_encode_available() {available['vorbis_encode']}, opus_available() "
          f"{available['opus']}; sonames loaded {syscodecs.loaded_sonames()}")
    runs = [leg for leg, libs in missing.items() if not libs]
    launches, errs = {}, []
    flac = sorted(CutSet.from_file(workdir / "recipe_cuts.jsonl.gz"), key=lambda c: c.recording_id)
    flac_by_rec = {c.recording_id: c for c in flac}

    def fly(cuts, cut_transforms=None, shuffle=True):
        extractor = Fbank(FbankConfig(device=device))
        dataset = K2SpeechRecognitionDataset(
            return_cuts=True, cut_transforms=cut_transforms,
            input_strategy=OnTheFlyFeatures(extractor))
        sampler = SimpleCutSampler(cuts, max_duration=FLY_MAX_DURATION, shuffle=shuffle, seed=0)
        return DataLoader(sampler, dataset, prefetch_batches=3), extractor, _RecordFirstBatch(extractor)

    def batch_cuts(batch):
        return batch["supervisions"]["cut"]

    def check_leg(name, run, err, want_ids, ids_of=lambda c: c.id):
        seen = sorted(ids_of(c) for b in run["batches"] for c in batch_cuts(b))
        if run["launches"] != len(run["batches"]) or seen != sorted(want_ids):
            raise AssertionError(f"{name}: launches or the epoch's cuts are off")
        if not err <= KERNEL_TOL or not all(np.isfinite(b["inputs"]).all() for b in run["batches"]):
            raise AssertionError(f"{name}: the kernel's result or the features are off")
        launches[name] = run["launches"]
        errs.append(err)

    cv_path = workdir / "cv_cuts.jsonl.gz"
    if "commonvoice_on_the_fly" in runs:
        # -- commonvoice_on_the_fly ---------------------------------------------------
        t0 = time.perf_counter()
        lang = workdir / "commonvoice" / CV_RELEASE / "en"
        sentences = _write_commonvoice(flac, lang)
        clip_bytes = sum(p.stat().st_size for p in (lang / "clips").iterdir())
        print(f"[{smi}] commonvoice_on_the_fly: {len(flac)} utterances rewritten as 48 kHz mono MP3 "
              f"clips ({clip_bytes} bytes) and three TSVs in {time.perf_counter() - t0!r} s")
        t0 = time.perf_counter()
        parts = prepare_commonvoice(lang.parent, workdir / "cv_manifests", languages="en",
                                    num_jobs=8)["en"]
        recordings = RecordingSet.from_recordings(
            r for split in CV_SPLITS for r in parts[split]["recordings"])
        supervisions = SupervisionSet.from_segments(
            s for split in CV_SPLITS for s in parts[split]["supervisions"])
        CutSet.from_manifests(recordings, supervisions).resample(SR).to_file(cv_path)
        prepare_s = time.perf_counter() - t0
        cv_cuts = CutSet.from_file(cv_path).to_eager()
        texts_equal = {s.recording_id: s.text for s in supervisions} == sentences
        shapes_equal = all(
            (r.sampling_rate, r.num_channels, r.num_samples)
            == (CV_SR, 1, flac_by_rec[r.id].recording.num_samples * CV_SR // SR) for r in recordings)
        corrs = [_corr(c.load_audio(), flac_by_rec[c.recording_id].load_audio()) for c in cv_cuts[:8]]
        per_split = ", ".join(f"{split} {len(parts[split]['recordings'])}" for split in CV_SPLITS)
        print(f"[{smi}] commonvoice_on_the_fly: prepare_commonvoice of {len(recordings)} clips "
              f"({per_split}) and the 16 kHz cuts in {prepare_s!r} s; 48 kHz mono clips of 3x the source's "
              f"samples: {shapes_equal}; sentences as written (one open quote): {texts_equal}; "
              f"decoded and resampled audio of 8 cuts against the FLAC source: correlation "
              f"min {min(corrs)!r} (at least {MP3_CORR})")
        if len(recordings) != len(flac) or not shapes_equal or not texts_equal:
            raise AssertionError("commonvoice_on_the_fly: the prepared manifests are off")
        if not min(corrs) >= MP3_CORR:
            raise AssertionError("commonvoice_on_the_fly: the decoded audio is off its source")
        loader, extractor, recorder = fly(CutSet.from_file(cv_path))
        state = {}

        def keep_state(i, batch):
            if i == CV_RESUME_AFTER - 1:
                state["ckpt"] = loader.state_dict()

        run = _leg("commonvoice_on_the_fly", loader, _Trainer(device), device, fbank_cuda,
                   _rows_of, smi, on_batch=keep_state)
        err = _first_batch_err(recorder, extractor)
        resumed_loader, _, _ = fly(CutSet.from_file(cv_path))
        resumed_loader.load_state_dict(state["ckpt"])
        resumed = list(resumed_loader)
        want = run["batches"][CV_RESUME_AFTER:]
        resume_equal = len(resumed) == len(want) > 0 and all(
            [c.id for c in batch_cuts(a)] == [c.id for c in batch_cuts(b)]
            and torch.equal(torch.from_numpy(a["inputs"]), torch.from_numpy(b["inputs"]))
            for a, b in zip(resumed, want))
        print(f"[{smi}] commonvoice_on_the_fly: first batch kernel vs plain {err!r} (tol "
              f"{KERNEL_TOL}); resumed after batch {CV_RESUME_AFTER}: {len(resumed)} batches "
              f"torch.equal to the uninterrupted run's: {resume_equal}; losses "
              f"{run['losses'][0]!r} -> {run['losses'][-1]!r}")
        check_leg("commonvoice_on_the_fly", run, err, [c.id for c in cv_cuts])
        if not resume_equal:
            raise AssertionError("commonvoice_on_the_fly: the resumed batches differ")

    if "commonvoice_compress" in runs:
        # -- commonvoice_compress -----------------------------------------------------
        compress = Compress(codecs=list(COMPRESS_CODECS), compression_level=(0.1, 0.9), p=0.5,
                            seed=COMPRESS_SEED)
        loader, extractor, recorder = fly(CutSet.from_file(cv_path), cut_transforms=[compress])
        run = _leg("commonvoice_compress", loader, _Trainer(device), device, fbank_cuda, _rows_of,
                   smi)
        err = _first_batch_err(recorder, extractor)
        cuts = [c for b in run["batches"] for c in batch_cuts(b)]
        drawn = Counter(_codec_of(c) for c in cuts)
        share = 1.0 - drawn[None] / len(cuts)
        source = {c.id: c for c in CutSet.from_file(cv_path)}
        firsts = {}
        for c in cuts:
            firsts.setdefault(_codec_of(c), c)
        rounds_equal = True
        for codec, c in firsts.items():
            if codec is None:
                continue
            last = c.recording.transforms[-1]
            transform = CompressTransform(**last["kwargs"]) if isinstance(last, dict) else last
            want = transform(source[c.id.rsplit("_", 2)[0]].load_audio(), SR)
            rounds_equal &= np.array_equal(c.load_audio(), want)
        counts = {codec or "none": n for codec, n in drawn.items()}
        n = len(run["batches"])
        transforms_ms = run["report"].get("audio.transforms", {}).get("total_s", 0.0) * 1e3 / n
        assemble_ms = run["report"].get("dataset.assemble", {}).get("total_s", 0.0) * 1e3 / n
        print(f"[{smi}] commonvoice_compress: codecs drawn {counts}, "
              f"compressed share {share!r} (p=0.5); a compressed cut of each codec equal to the "
              f"Compress round trip of its source cut's audio: {rounds_equal}; first batch kernel "
              f"vs plain {err!r} (tol {KERNEL_TOL}); host ms per batch in audio.transforms "
              f"{transforms_ms!r} and dataset.assemble {assemble_ms!r}")
        check_leg("commonvoice_compress", run, err, list(source),
                  ids_of=lambda c: c.id.rsplit("_", 2)[0] if _codec_of(c) else c.id)
        if set(drawn) != {None, *COMPRESS_CODECS} or not COMPRESSED_SHARE[0] <= share <= COMPRESSED_SHARE[1]:
            raise AssertionError(f"commonvoice_compress: the draws are off: {drawn}")
        if not rounds_equal:
            raise AssertionError("commonvoice_compress: a compressed cut is not its round trip")

    if "shar_opus_on_the_fly" in runs:
        # -- shar_opus_on_the_fly -----------------------------------------------------
        shar_dir = workdir / "shar_opus"
        t0 = time.perf_counter()
        paths = CutSet.from_cuts(flac).to_shar(
            shar_dir, fields={"recording": "opus"}, shard_size=40, compress_jsonl=False)
        export_s = time.perf_counter() - t0
        opus_bytes = sum(Path(p).stat().st_size for p in paths["recording"])
        members = list(LazySharIterator(in_dir=shar_dir))

        def member_equal(cut):
            want, _ = syscodecs.opus_decode(
                syscodecs.opus_encode(flac_by_rec[cut.recording_id].load_audio(), SR),
                force_sampling_rate=SR)
            return np.array_equal(cut.load_audio(), want)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            equal = list(pool.map(member_equal, members))
        print(f"[{smi}] shar_opus_on_the_fly: {len(flac)} utterances exported to "
              f"{len(paths['recording'])} Shar shards with the recording in opus ({opus_bytes} "
              f"bytes) in {export_s!r} s; every member decoded from memory equal to "
              f"opus_decode(opus_encode(source)): {all(equal)} ({len(equal)} members, checked in "
              f"{time.perf_counter() - t0!r} s)")
        if len(members) != len(flac) or not all(equal):
            raise AssertionError("shar_opus_on_the_fly: the shards' audio is off its sources")
        loader, extractor, recorder = fly(CutSet(cuts=LazySharIterator(in_dir=shar_dir)),
                                          shuffle=False)
        run = _leg("shar_opus_on_the_fly", loader, _Trainer(device), device, fbank_cuda, _rows_of,
                   smi)
        err = _first_batch_err(recorder, extractor)
        print(f"[{smi}] shar_opus_on_the_fly: first batch kernel vs plain {err!r} (tol {KERNEL_TOL})")
        check_leg("shar_opus_on_the_fly", run, err, [c.id for c in flac])

    if "codec_check" in runs:
        # -- codec_check ---------------------------------------------------------------
        check_dir = workdir / "codec_check"
        check_dir.mkdir()
        rows = []
        for cut in flac[:CODEC_CHECK_FILES]:
            x, n = cut.load_audio(), cut.recording.num_samples
            for suffix, native in ((".mp3", SR), (".ogg", SR), (".opus", 48000)):
                path = check_dir / f"{cut.recording_id}{suffix}"
                save_audio(path, x, SR)
                for force in (None, SR):
                    rec = Recording.from_file(path, force_opus_sampling_rate=force)
                    meta = info(path, force_opus_sampling_rate=force)
                    rate = force if suffix == ".opus" and force else native
                    audio = rec.load_audio()
                    back = audio if rate == SR else Recording.from_file(
                        path, force_opus_sampling_rate=SR).load_audio()
                    rows.append((path.name, force, rec.sampling_rate == meta.samplerate == rate,
                                 rec.num_samples == meta.frames == n * rate // SR,
                                 audio.shape == (1, rec.num_samples), _corr(back, x)))
        worst = min(r[5] for r in rows)
        ok = all(r[2] and r[3] and r[4] for r in rows)
        print(f"[{smi}] codec_check: save_audio to .mp3, .ogg (Vorbis) and .opus of "
              f"{CODEC_CHECK_FILES} utterances, each read back through Recording.from_file and info "
              f"with and without force_opus_sampling_rate={SR}: {len(rows)} reads with the rate, "
              f"length and shape expected: {ok}; correlation with the source min {worst!r} (at "
              f"least {MP3_CORR})")
        if not ok or not worst >= MP3_CORR:
            raise AssertionError(f"codec_check: a read is off: {rows}")
    set_tracing_enabled(False)
    return launches, max(errs, default=0.0)


# -- 20. Kaldi data-dir interop, piped audio sources and the CLI ----------------------
KALDI_SHAR_SHARD_SIZE = 40  # 160 utterances -> 4 shards
KALDI_SPANS = ("sampler.next", "dataset.assemble", "collation.read_audio", "audio.decode",
               "audio.pipe", "CutSet.compute_and_store_features_batch")


def _span_line(report: dict, n: int, unit: str = "batch") -> str:
    """Host ms per ``unit`` of each span that ran, and the pipe's share of
    ``audio.decode`` (``audio.pipe`` runs inside it)."""
    parts = [f"{name} {report[name]['total_s'] * 1e3 / n!r}" for name in KALDI_SPANS
             if name in report]
    decode = report.get("audio.decode", {}).get("total_s", 0.0)
    pipe = report.get("audio.pipe", {}).get("total_s", 0.0)
    pipes = report.get("audio.pipe", {}).get("calls", 0)
    return (f"host ms per {unit} by span: {', '.join(parts)}; {pipes} pipe runs, the pipe's share "
            f"of audio.decode {pipe / decode if decode else math.nan!r}")


class _RecordFirstCall:
    """Patches ``cls.extract_batch`` for the ``with`` block to keep the first
    call's extractor, items and features: the CLI builds its extractor
    itself."""

    def __init__(self, cls):
        self.cls, self.first = cls, None

    def __enter__(self):
        self.own = self.cls.__dict__.get("extract_batch")
        inner = self.cls.extract_batch

        def extract_batch(extractor, items, sampling_rate, **kw):
            out = inner(extractor, items, sampling_rate, **kw)
            if self.first is None:
                self.first = (extractor, [np.asarray(x).copy() for x in items],
                              [np.asarray(f).copy() for f in out])
            return out

        self.cls.extract_batch = extract_batch
        return self

    def __exit__(self, *exc):
        if self.own is None:
            del self.cls.extract_batch
        else:
            self.cls.extract_batch = self.own


def _write_kaldi_dirs(workdir: Path, gzip_found: bool) -> tuple:
    """Phase 14's corpora as two Kaldi data dirs. ``kaldi_utts``: the 160
    LibriSpeech utterances, one recording each; even lines of ``wav.scp``
    name int16 WAV copies of the FLAC files, odd lines pipe the FLAC file
    through ``cat``, and, where gzip is found, the first line pipes a
    gzipped WAV copy through ``gzip -dc``; with ``text``, ``utt2spk``,
    ``spk2gender`` and ``reco2dur`` and no ``segments``. ``kaldi_sessions``:
    the 8 sessions of 120 s piped through ``cat``, ``segments`` from their
    turns (the RTTM file's), the last running to the end of its recording
    (an end of -1), with ``text``, ``utt2spk`` and ``reco2dur``. Returns
    the two directories and each recording's source file for the audio
    checks."""
    import gzip
    import shutil

    from lhotse_tpu_torch.audio import RecordingSet
    from lhotse_tpu_torch.audio.wavio import write_wav
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.supervision import SupervisionSet

    utts_dir, sess_dir, wavs = workdir / "kaldi_utts", workdir / "kaldi_sessions", workdir / "kaldi_wav"
    for d in (utts_dir, sess_dir, wavs):
        d.mkdir()
    source_of = {}
    scp, reco2dur, text, utt2spk, spk2gender = [], [], [], [], {}
    cuts = sorted(CutSet.from_file(workdir / "recipe_cuts.jsonl.gz"), key=lambda c: c.recording_id)
    for i, cut in enumerate(cuts):
        rid, flac = cut.recording_id, cut.recording.sources[0].source
        (sup,) = cut.supervisions
        source_of[rid] = flac
        if i % 2:
            scp.append(f"{rid} cat {flac} |")
        else:
            wav = wavs / f"{rid}.wav"
            write_wav(str(wav), cut.recording.load_audio(), SR)
            if i == 0 and gzip_found:
                with open(wav, "rb") as src, gzip.open(f"{wav}.gz", "wb") as dst:
                    shutil.copyfileobj(src, dst)
                scp.append(f"{rid} gzip -dc {wav}.gz |")
            else:
                scp.append(f"{rid} {wav}")
        reco2dur.append(f"{rid} {cut.recording.duration}")
        text.append(f"{rid} {sup.text}")
        utt2spk.append(f"{rid} {sup.speaker}")
        spk2gender[sup.speaker] = "mf"[int(sup.speaker) % 2]
    files = {"wav.scp": scp, "reco2dur": reco2dur, "text": text, "utt2spk": utt2spk,
             "spk2gender": [f"{s} {g}" for s, g in sorted(spk2gender.items())]}
    for name, lines in files.items():
        (utts_dir / name).write_text("\n".join(lines) + "\n")

    recordings = sorted(RecordingSet.from_file(workdir / "long_recordings.jsonl.gz"),
                        key=lambda r: r.id)
    turns = sorted(SupervisionSet.from_file(workdir / "long_supervisions.jsonl.gz"),
                   key=lambda s: s.id)
    for r in recordings:
        source_of[r.id] = r.sources[0].source
    segments = [f"{s.id} {s.recording_id} {s.start:.2f} {s.end:.2f}" for s in turns]
    segments[-1] = f"{turns[-1].id} {turns[-1].recording_id} {turns[-1].start:.2f} -1"
    files = {"wav.scp": [f"{r.id} cat {r.sources[0].source} |" for r in recordings],
             "reco2dur": [f"{r.id} {r.duration}" for r in recordings], "segments": segments,
             "text": [f"{s.id} {s.text}" for s in turns],
             "utt2spk": [f"{s.id} {s.speaker}" for s in turns]}
    for name, lines in files.items():
        (sess_dir / name).write_text("\n".join(lines) + "\n")
    return utts_dir, sess_dir, source_of


def _phase_kaldi(workdir: Path, device, fbank_cuda, smi: str) -> tuple:
    """20. Kaldi data-dir interop, piped ``command`` audio sources and the
    ``lhotse-tpu-torch`` CLI, on phase 14's corpora written as two Kaldi
    data dirs (see ``_write_kaldi_dirs``), each batch into an AdamW step of
    ``Encoder(EncoderConfig())``. First a line of whether click imports and
    which of ``cat`` and ``gzip`` are found; the phase fails if click does
    not import. Each step is the CLI command run in this process
    (``cli.main([...], standalone_mode=False)``, so that the kernel's
    launches count here), and ``validate-pair`` also runs as ``python3 -m
    lhotse_tpu_torch.bin.lhotse_tpu_torch`` in a subprocess.
    ``kaldi_import``: ``kaldi import`` of both
    dirs, ``validate-pair``, ``fix``, ``cut simple`` and ``cut
    trim-to-supervisions`` (sessions); the manifests equal the library
    calls', and every recording's audio, piped or not, is
    ``np.array_equal`` to its source file's. ``kaldi_extract``: ``feat
    extract-cuts-batch`` (``Fbank()`` on the card, ``lilcom_chunky``) of the
    trimmed sessions and the whole utterances, the first batch against the
    kernel's plain version. ``kaldi_precomputed``: the stored features →
    ``K2SpeechRecognitionDataset()`` → the step, no launch.
    ``kaldi_on_the_fly`` and ``kaldi_on_the_fly_cached``: the utterances and
    the trimmed sessions, unfeatured, → ``SimpleCutSampler(max_duration=180)``
    → ``OnTheFlyFeatures`` on the card → the step, with a resume after
    batch 3 that must be ``torch.equal``, with ``AudioCache`` off and on.
    ``kaldi_shar``: ``shar export`` of the piped utterances, ``shar
    compute-features`` (the kernel, one launch per cut, numpy), the features
    within half an LTC1 tick of ``kaldi_extract``'s archive and the first
    cuts' against the plain version, then the shards' features into the
    step. ``kaldi_roundtrip``: ``kaldi export`` → ``kaldi import``, ids,
    durations, texts and speakers equal, ``cat`` pipes still ``command``
    sources. Returns the kernel's launches per path and the largest
    kernel-vs-plain error."""
    import shutil

    from lhotse_tpu_torch.audio import Recording, RecordingSet
    from lhotse_tpu_torch.caching import set_caching_enabled
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.dataset import SimpleCutSampler
    from lhotse_tpu_torch.dataset.loader import DataLoader
    from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
    from lhotse_tpu_torch.features import Fbank, FbankConfig
    from lhotse_tpu_torch.kaldi import load_kaldi_data_dir
    from lhotse_tpu_torch.qa import fix_manifests
    from lhotse_tpu_torch.supervision import SupervisionSet
    from lhotse_tpu_torch.tracing import reset_tracing, set_tracing_enabled, tracing_report
    from lhotse_tpu_torch.utils import fix_random_seed

    try:
        import click  # noqa: F401
        click_error = None
    except ImportError as e:
        click_error = f"{type(e).__name__}: {e}"
    found = {tool: shutil.which(tool) for tool in ("cat", "gzip")}
    print(f"[{smi}] phase 20: import click works: {click_error is None}"
          f"{'' if click_error is None else f' ({click_error})'}; shutil.which finds cat "
          f"{found['cat']!r}, gzip {found['gzip']!r}")
    if click_error is not None:
        raise AssertionError("phase 20 runs the lhotse-tpu-torch CLI, and click, a dependency "
                             "of the package (pyproject.toml), does not import")
    if found["cat"] is None:
        raise AssertionError("phase 20 writes its pipes with cat, which this machine lacks")
    from lhotse_tpu_torch.bin.modes import cli

    def run(*argv):
        """The CLI command ``argv`` in this process."""
        return cli.main([str(a) for a in argv], standalone_mode=False)

    set_caching_enabled(False)
    set_tracing_enabled(True)
    trainer = _Trainer(device)
    launches, errs = {}, []
    k = workdir / "kaldi"

    # -- kaldi_import ----------------------------------------------------------------------
    t_leg = time.perf_counter()
    utts_dir, sess_dir, source_of = _write_kaldi_dirs(workdir, found["gzip"] is not None)
    write_s = time.perf_counter() - t_leg
    library = {}
    for name, d in (("utts", utts_dir), ("sessions", sess_dir)):
        recs, sups, feats = load_kaldi_data_dir(d, sampling_rate=SR)
        library[name] = fix_manifests(recs, sups)
        pair = (k / name / "recordings.jsonl.gz", k / name / "supervisions.jsonl.gz")
        run("kaldi", "import", d, SR, k / name)
        run("validate-pair", *pair)
        run("fix", *pair, k / name / "fixed")
        run("cut", "simple", "-r", k / name / "fixed" / "recordings.jsonl.gz", "-s",
            k / name / "fixed" / "supervisions.jsonl.gz", k / name / "cuts.jsonl.gz")
    # K2SpeechRecognitionDataset refuses the parts of overlapping turns that
    # start before a trimmed cut: they are discarded, as in phase 14. Such
    # cuts take uuid4 ids, so both sides are seeded.
    run("-s", 0, "cut", "trim-to-supervisions", "--discard-overlapping",
        k / "sessions" / "cuts.jsonl.gz", k / "sessions" / "trimmed.jsonl.gz")
    proc = subprocess.run(
        [sys.executable, "-m", "lhotse_tpu_torch.bin.lhotse_tpu_torch", "validate-pair",
         k / "utts" / "recordings.jsonl.gz", k / "utts" / "supervisions.jsonl.gz"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0 or proc.stdout.strip():
        raise AssertionError(f"kaldi_import: the console entry failed: {proc.stdout} {proc.stderr}")
    equal = {}  # manifest: equal to the library calls'
    for name, (recs, sups) in library.items():
        fixed = k / name / "fixed"
        equal[f"{name}.recordings"] = [r.to_dict() for r in recs] == [
            r.to_dict() for r in RecordingSet.from_file(fixed / "recordings.jsonl.gz")]
        equal[f"{name}.supervisions"] = [s.to_dict() for s in sups] == [
            s.to_dict() for s in SupervisionSet.from_file(fixed / "supervisions.jsonl.gz")]
    fix_random_seed(0)
    lib_cuts = [c.to_dict() for c in CutSet.from_manifests(*library["sessions"]).trim_to_supervisions(
        keep_overlapping=False)]
    equal["sessions.trimmed"] = lib_cuts == [
        c.to_dict() for c in CutSet.from_file(k / "sessions" / "trimmed.jsonl.gz")]
    manifests_equal = all(equal.values())
    reset_tracing()
    t0 = time.perf_counter()
    kinds, audio_equal, audio_s = {}, True, 0.0
    for name, (recs, _) in library.items():
        for rec in recs:
            kind = rec.sources[0].source.split()[0] if rec.sources[0].type == "command" else "file"
            kinds[kind] = kinds.get(kind, 0) + 1
            audio = rec.load_audio()
            audio_s += audio.shape[1] / SR
            audio_equal &= np.array_equal(audio, Recording.from_file(source_of[rec.id]).load_audio())
    read_s = time.perf_counter() - t0
    report = tracing_report()
    trimmed_n = sum(1 for _ in CutSet.from_file(k / "sessions" / "trimmed.jsonl.gz"))
    print(f"[{smi}] kaldi_import: Kaldi dirs written in {write_s!r} s; CLI "
          f"kaldi import, validate-pair, fix, cut simple and trim-to-supervisions: "
          f"{len(library['utts'][0])} utterance recordings, {len(library['sessions'][0])} sessions, "
          f"{trimmed_n} trimmed cuts; manifests equal to the library calls': {equal}; "
          f"python3 -m lhotse_tpu_torch.bin.lhotse_tpu_torch validate-pair: exit 0, no complaint; sources by kind "
          f"{kinds}; every recording's audio np.array_equal to its source file's: {audio_equal} "
          f"({audio_s!r} audio-s read in {read_s!r} s: {audio_s / read_s!r} audio-s/s; audio.decode "
          f"{report.get('audio.decode', {}).get('total_s', 0.0)!r} s, of it audio.pipe "
          f"{report.get('audio.pipe', {}).get('total_s', 0.0)!r} s in "
          f"{report.get('audio.pipe', {}).get('calls', 0)} runs); leg took "
          f"{time.perf_counter() - t_leg!r} s")
    want = {"cat": 80 + len(library["sessions"][0]), "file": 80 - (found["gzip"] is not None)}
    if found["gzip"] is not None:
        want["gzip"] = 1
    if not manifests_equal or not audio_equal or kinds != want:
        raise AssertionError(f"kaldi_import: manifests or audio are off: {kinds}")
    if trimmed_n != LONG_SESSIONS * LONG_SEGMENTS:
        raise AssertionError(f"kaldi_import: {trimmed_n} trimmed cuts")

    # -- kaldi_extract -----------------------------------------------------------------------
    t_leg = time.perf_counter()
    sources = {"sessions": k / "sessions" / "trimmed.jsonl.gz", "utts": k / "utts" / "cuts.jsonl.gz"}
    extract_s = sum(c.duration for p in sources.values() for c in CutSet.from_file(p))

    def extract_all():
        for name, path in sources.items():
            out = (k / name / "feats_cuts.jsonl.gz", k / name / "feats")
            run("feat", "extract-cuts-batch", "-j", 4, "-b", 600, path, *out)

    reset_tracing()
    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    with _RecordFirstCall(Fbank) as recorder:
        wall_ms, busy_ms, _ = _device_busy(extract_all)
    launches["kaldi_extract"] = fbank_cuda.LAUNCHES
    report = tracing_report()
    extractor, items, kernel_out = recorder.first
    extract_err = max(float(np.abs(a - b).max())
                      for a, b in zip(kernel_out, _plain_extract(extractor, items)))
    errs.append(extract_err)
    stored = {c.id: c for name in sources for c in CutSet.from_file(k / name / "feats_cuts.jsonl.gz")}
    n_batches = launches["kaldi_extract"]
    print(f"[{smi}] kaldi_extract: feat extract-cuts-batch of {trimmed_n} trimmed session cuts and "
          f"{len(library['utts'][0])} utterances, {extract_s!r} audio-s in {wall_ms!r} ms under "
          f"torch.profiler: {extract_s / wall_ms * 1e3!r} audio-s/s; fbank kernel launches "
          f"{launches['kaldi_extract']} ({extractor.config.device} extractor built by the command); "
          f"device busy {busy_ms / wall_ms!r} of the wall; {_span_line(report, n_batches)}; first "
          f"batch kernel vs plain {extract_err!r} (tol {KERNEL_TOL}); leg took "
          f"{time.perf_counter() - t_leg!r} s")
    if not launches["kaldi_extract"] > 0 or not extract_err <= KERNEL_TOL:
        raise AssertionError("kaldi_extract: no launch, or the kernel disagrees")
    if len(stored) != trimmed_n + len(library["utts"][0]) or not all(c.has_features for c in stored.values()):
        raise AssertionError(f"kaldi_extract: {len(stored)} featured cuts")

    # -- kaldi_precomputed -----------------------------------------------------------------
    t_leg = time.perf_counter()
    featured = CutSet.from_cuts(stored.values())
    loader = DataLoader(SimpleCutSampler(featured, max_duration=FLY_MAX_DURATION, shuffle=True, seed=0),
                        K2SpeechRecognitionDataset(return_cuts=True), prefetch_batches=3)
    reset_tracing()
    fbank_cuda.LAUNCHES = 0
    runs = {}
    wall_ms, busy_ms, _ = _device_busy(lambda: runs.update(run=_train_epoch(loader, trainer, device)))
    launches["kaldi_precomputed"] = fbank_cuda.LAUNCHES
    pre = runs["run"]
    n = len(pre["losses"])
    print(f"[{smi}] kaldi_precomputed: {len(stored)} cuts of stored features, {n} batches, "
          f"{pre['audio_s']!r} audio-s in {pre['elapsed_s']!r} s: {pre['audio_s'] / pre['elapsed_s']!r} "
          f"audio-s/s; fbank kernel launches {launches['kaldi_precomputed']}; device busy "
          f"{busy_ms / wall_ms!r} of the wall; {_span_line(tracing_report(), n)}; losses "
          f"{pre['losses'][0]!r} -> {pre['losses'][-1]!r}; leg took {time.perf_counter() - t_leg!r} s")
    if sorted(pre["ids"]) != sorted(stored) or not all(map(math.isfinite, pre["losses"])):
        raise AssertionError("kaldi_precomputed: coverage or the loss is off")
    if launches["kaldi_precomputed"] != 0:
        raise AssertionError("kaldi_precomputed: stored features launched the kernel")

    # -- kaldi_on_the_fly, with AudioCache off and on ------------------------------------------
    fly_path = k / "fly_cuts.jsonl.gz"
    CutSet.from_cuts(list(CutSet.from_file(sources["utts"])) + list(
        CutSet.from_file(sources["sessions"]))).to_file(fly_path)
    for name, caching in (("kaldi_on_the_fly", False), ("kaldi_on_the_fly_cached", True)):
        t_leg = time.perf_counter()
        set_caching_enabled(caching)
        spans = {}
        launches[name], fly_err = _fly_with_resume(
            name, fly_path, trainer, device, fbank_cuda, smi, spans=spans)
        set_caching_enabled(False)
        errs.append(fly_err)
        print(f"[{smi}] {name} (AudioCache {'on' if caching else 'off'}): first epoch "
              f"{_span_line(spans['report'], spans['batches'])}; leg took "
              f"{time.perf_counter() - t_leg!r} s")

    # -- kaldi_shar ----------------------------------------------------------------------------
    t_leg = time.perf_counter()
    shar_dir = k / "shar"

    run("shar", "export", "-a", "flac", "-s", KALDI_SHAR_SHARD_SIZE, sources["utts"], shar_dir)
    reset_tracing()
    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    wall_ms, busy_ms, _ = _device_busy(lambda: run("shar", "compute-features", shar_dir))
    launches["kaldi_shar"] = fbank_cuda.LAUNCHES
    report = tracing_report()
    shards = sorted(shar_dir.glob("cuts.*.jsonl.gz"))
    fields = {"cuts": shards, "recording": [p.with_name(p.name.replace("cuts", "recording").replace(
        ".jsonl.gz", ".tar")) for p in shards],
        "features": [p.with_name(p.name.replace("cuts", "features").replace(".jsonl.gz", ".tar"))
                     for p in shards]}
    shar_cuts = list(CutSet.from_shar(fields=fields))
    shar_feats = {c.id: c.load_features() for c in shar_cuts}
    archive_err = max(float(np.abs(shar_feats[c.id] - stored[c.id].load_features()).max())
                      for c in shar_cuts)
    fly = Fbank(FbankConfig(device=device))
    head = shar_cuts[:8]
    shar_err = max(float(np.abs(shar_feats[c.id] - p).max())
                   for c, p in zip(head, _plain_extract(fly, [c.load_audio()[0] for c in head])))
    errs.append(shar_err)
    audio_equal = all(np.array_equal(c.load_audio(), Recording.from_file(
        source_of[c.recording_id]).load_audio()) for c in head)
    shar_epoch = _train_epoch(DataLoader(
        SimpleCutSampler(CutSet.from_cuts(shar_cuts), max_duration=FLY_MAX_DURATION),
        K2SpeechRecognitionDataset(return_cuts=True), prefetch_batches=3), trainer, device)
    shar_s = sum(c.duration for c in shar_cuts)
    print(f"[{smi}] kaldi_shar: shar export -a flac of the {len(shar_cuts)} utterances into "
          f"{len(shards)} shards, shar compute-features: {shar_s!r} audio-s in {wall_ms!r} ms under "
          f"torch.profiler: {shar_s / wall_ms * 1e3!r} audio-s/s; fbank kernel launches "
          f"{launches['kaldi_shar']} (one per cut); device busy {busy_ms / wall_ms!r} of the wall; "
          f"{_span_line(report, len(shar_cuts), 'cut')}; "
          f"features vs kaldi_extract's archive max_abs {archive_err!r} (tol "
          f"{LTC1_TICK / 2 + KERNEL_TOL!r}); first {len(head)} cuts kernel vs plain {shar_err!r} "
          f"(tol {KERNEL_TOL}), audio equal to the sources: {audio_equal}; the shards' features "
          f"through {len(shar_epoch['losses'])} AdamW steps, losses finite: "
          f"{all(map(math.isfinite, shar_epoch['losses']))}; leg took {time.perf_counter() - t_leg!r} s")
    if launches["kaldi_shar"] != len(shar_cuts) or len(shar_cuts) != len(library["utts"][0]):
        raise AssertionError(f"kaldi_shar: {len(shar_cuts)} cuts, {launches['kaldi_shar']} launches")
    if not archive_err <= LTC1_TICK / 2 + KERNEL_TOL or not shar_err <= KERNEL_TOL or not audio_equal:
        raise AssertionError("kaldi_shar: the features or the audio are off")
    if sorted(shar_epoch["ids"]) != sorted(shar_feats) or not all(map(math.isfinite, shar_epoch["losses"])):
        raise AssertionError("kaldi_shar: the shards' epoch is off")

    # -- kaldi_roundtrip ---------------------------------------------------------------------
    t_leg = time.perf_counter()
    same, commands = True, {}  # name: (command sources before, command sources after)
    for name, (recs, sups) in library.items():
        fixed, out, back = k / name / "fixed", k / name / "exported", k / name / "reimported"
        run("kaldi", "export", fixed / "recordings.jsonl.gz", fixed / "supervisions.jsonl.gz", out)
        run("kaldi", "import", out, SR, back)
        recs2 = {r.id: r for r in RecordingSet.from_file(back / "recordings.jsonl.gz")}
        sups2 = {s.id: s for s in SupervisionSet.from_file(back / "supervisions.jsonl.gz")}
        same &= sorted(recs2) == sorted(r.id for r in recs)
        same &= all(recs2[r.id].duration == r.duration for r in recs)
        same &= sorted(sups2) == sorted(s.id for s in sups)
        same &= all((sups2[s.id].text, sups2[s.id].speaker, sups2[s.id].recording_id)
                    == (s.text, s.speaker, s.recording_id)
                    and abs(sups2[s.id].duration - s.duration) <= 1e-6 for s in sups)
        piped_ids = [r.id for r in recs if r.sources[0].type == "command"]
        commands[name] = (len(piped_ids), sum(recs2[i].sources[0].type == "command" for i in piped_ids))
        piped = next(r for r in recs2.values() if r.sources[0].type == "command")
        same &= np.array_equal(piped.load_audio(), Recording.from_file(source_of[piped.id]).load_audio())
    print(f"[{smi}] kaldi_roundtrip: kaldi export then kaldi import of both dirs: ids, durations, "
          f"texts and speakers equal: {same}; pipes still command sources {commands}; leg took "
          f"{time.perf_counter() - t_leg!r} s")
    want = {"utts": (80 + (found["gzip"] is not None),) * 2, "sessions": (LONG_SESSIONS,) * 2}
    if not same or commands != want:
        raise AssertionError(f"kaldi_roundtrip: the round trip is off: {commands}")
    set_tracing_enabled(False)
    return launches, max(errs)


SIM_SEED = 17  # the simulations' seed (the MeetingSampler's, and numpy's for the conversational draws)
SIM_SPEAKERS = [2, 3, 4]  # speakers per simulated meeting, drawn uniformly
SIM_RESUME_AFTER = 3
SHARDS = 8  # the 160 utterances in 8 JSONL shards of 20
WDS_SHARD_SIZE = 40  # cuts per WebDataset tar: 160 utterances -> 4 tars
SHARD_SPANS = ("sampler.next", "dataset.assemble", "collation.read_audio", "audio.decode",
               "audio.transforms")


def _host_spans(report: dict, n: int, unit: str = "batch") -> str:
    """Host ms per ``unit`` of each of ``SHARD_SPANS`` that ran."""
    parts = [f"{name} {report[name]['total_s'] * 1e3 / n!r}" for name in SHARD_SPANS
             if name in report]
    return f"host ms per {unit} by span: {', '.join(parts)}"


def _write_rir_groups(workdir: Path) -> list:
    """One group of mono RIRs per speaker count of ``SIM_SPEAKERS`` (2 + 3 +
    4 WAVs), each numpy-seeded decaying noise with a unit tap in its first
    millisecond, as phase 15 writes its RIR. Returns the groups as
    ``RecordingSet``s."""
    from lhotse_tpu_torch.audio import Recording, RecordingSet
    from lhotse_tpu_torch.audio.wavio import write_wav

    rng = np.random.default_rng(5680)
    taps = np.arange(SR // 2)
    (workdir / "rirs").mkdir()
    groups = []
    for n in SIM_SPEAKERS:
        recordings = []
        for k in range(n):
            rir = np.exp(-taps / 1600.0) * rng.standard_normal(SR // 2) * 0.05
            rir[rng.integers(0, 17)] = 1.0
            path = workdir / "rirs" / f"rir{n}-{k}.wav"
            write_wav(str(path), rir.astype(np.float32), SR, subtype="float32")
            recordings.append(Recording.from_file(path))
        groups.append(RecordingSet.from_recordings(recordings))
    return groups


def _rir_ids(node) -> set:
    """The ids of the RIR recordings a cut's dict reverberates with."""
    if isinstance(node, dict):
        found = ({node["kwargs"]["rir"]["id"]}
                 if node.get("name") == "ReverbWithImpulseResponse" and node["kwargs"].get("rir")
                 else set())
        return found.union(*(_rir_ids(v) for v in node.values()))
    if isinstance(node, list):
        return set().union(*(_rir_ids(v) for v in node))
    return set()


def _simulation_invariants(one, two) -> dict:
    """What ``simulate(num_jobs=2)`` must keep of the one-job run, whose
    meetings its spawned workers build in no fixed order: as many meetings,
    the same utterances in each, one speaker per track, no NaN offset."""
    def utterances(meetings):
        return sorted(sorted(s.id for s in m.supervisions) for m in meetings)

    tracks = [t for m in two for t in m.tracks]
    return {"meetings": len(two) == len(one), "utterances": utterances(two) == utterances(one),
            "one_speaker_per_track": all(len({s.speaker for s in t.cut.supervisions}) == 1
                                         for t in tracks),
            "finite_offsets": all(math.isfinite(t.offset) for t in tracks)}


def _phase_simulated_meetings(workdir: Path, device, fbank_cuda, smi: str) -> tuple:
    """21. Meeting simulation into SURT training, on phase 14's corpora (the
    160 LibriSpeech-layout utterances of 8 speakers, and the sessions' RTTM
    turns), each batch into an AdamW step of ``Encoder(EncoderConfig())``.
    ``meeting_simulate``: ``ConversationalMeetingSimulator`` fitted to the
    sessions' supervisions simulates meetings of 2, 3 or 4 speakers from the
    utterances (``num_repeats=1``, seed ``SIM_SEED``, one job), and
    ``workflows simulate-meetings`` (run in this process) writes the same
    manifest; the same with ``SpeakerIndependentMeetingSimulator`` at its
    defaults; each once more with ``num_jobs=2`` (spawned workers), held to
    the invariants of ``_simulation_invariants``; then half the
    conversational meetings are reverberated with RIR groups (one per
    speaker count, see ``_write_rir_groups``) and half with the fast random
    RIRs. ``meeting_sim_surt``: the reverberated meetings →
    ``cut_into_windows(SURT_MAX_GROUP, keep_excessive_supervisions=False)``
    (``K2SurtDataset`` refuses supervisions that run past a window; windows
    left with none are dropped) → ``SimpleCutSampler(max_duration=180)`` →
    ``K2SurtDataset(OnTheFlyFeatures(Fbank()))`` on the card → the step, one
    launch per batch, the first batch against the kernel's plain version,
    and a resume after batch 3 whose batches must be ``torch.equal`` to the
    first run's. Returns the kernel's launches per path and the largest
    kernel-vs-plain error."""
    from lhotse_tpu_torch.bin.modes import cli
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.dataset import K2SurtDataset, SimpleCutSampler
    from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
    from lhotse_tpu_torch.dataset.loader import DataLoader
    from lhotse_tpu_torch.features import Fbank, FbankConfig
    from lhotse_tpu_torch.supervision import SupervisionSet
    from lhotse_tpu_torch.tracing import set_tracing_enabled
    from lhotse_tpu_torch.utils import fix_random_seed
    from lhotse_tpu_torch.workflows import (
        ConversationalMeetingSimulator, SpeakerIndependentMeetingSimulator)

    set_tracing_enabled(True)
    launches, errs = {}, []
    utts_path = workdir / "recipe_cuts.jsonl.gz"
    turns_path = workdir / "long_supervisions.jsonl.gz"
    out = workdir / "simulated"
    out.mkdir()

    # -- meeting_simulate --------------------------------------------------------------------
    t_leg = time.perf_counter()
    utterances = CutSet.from_file(utts_path).to_eager()
    kw = dict(num_repeats=1, num_speakers_per_meeting=SIM_SPEAKERS, seed=SIM_SEED)
    simulated, lines = {}, []
    for method, make in (("conversational", ConversationalMeetingSimulator),
                         ("independent", SpeakerIndependentMeetingSimulator)):
        simulator = make()
        fit = ["-f", turns_path] if method == "conversational" else []
        if fit:
            simulator.fit(SupervisionSet.from_file(turns_path))
        fix_random_seed(SIM_SEED)
        t0 = time.perf_counter()
        meetings = simulator.simulate(utterances, num_jobs=1, **kw)
        sim_s = time.perf_counter() - t0
        meetings.to_file(out / f"{method}.jsonl.gz")
        cli.main([str(a) for a in (
            "-s", SIM_SEED, "workflows", "simulate-meetings", "-m", method, *fit, "-r", 1, "-s",
            ",".join(map(str, SIM_SPEAKERS)), "--seed", SIM_SEED, utts_path,
            out / f"{method}_cli.jsonl.gz")], standalone_mode=False)
        cli_equal = [m.to_dict() for m in CutSet.from_file(out / f"{method}_cli.jsonl.gz")] == [
            m.to_dict() for m in CutSet.from_file(out / f"{method}.jsonl.gz")]
        t0 = time.perf_counter()
        two = simulator.simulate(utterances, num_jobs=2, **kw)
        two_s = time.perf_counter() - t0
        invariants = _simulation_invariants(meetings, two)
        audio_s = float(sum(m.duration for m in meetings))
        tracks = [len(m.tracks) for m in meetings]
        by_tracks = {k: tracks.count(k) for k in sorted(set(tracks))}
        fitted = f" (fitted to the sessions: {simulator!r})" if fit else ""
        lines.append(
            f"{method}{fitted}: {len(meetings)} meetings (by track count {by_tracks}), "
            f"{audio_s!r} simulated audio-s in {sim_s!r} s: {len(meetings) / sim_s!r} "
            f"meetings/s, {audio_s / sim_s!r} simulated audio-s/s (one job); the CLI's manifest "
            f"equal to the library call's: {cli_equal}; num_jobs=2 (spawned) in {two_s!r} s, "
            f"invariants {invariants}")
        if not cli_equal or not all(invariants.values()) or len(meetings) < 10:
            raise AssertionError(f"meeting_simulate: {lines[-1]}")
        simulated[method] = meetings
    conversational = list(simulated["conversational"])
    half = len(conversational) // 2
    groups = _write_rir_groups(workdir)
    simulator = ConversationalMeetingSimulator()
    fix_random_seed(SIM_SEED)
    reverberated = list(simulator.reverberate(CutSet.from_cuts(conversational[:half]), *groups))
    reverberated += list(simulator.reverberate(CutSet.from_cuts(conversational[half:])))
    group_ids = {len(g): sorted(r.id for r in g) for g in groups}
    with_groups = [m for m in reverberated[:half] if len(m.tracks) in group_ids]
    rirs_right = all(
        sorted(_rir_ids(t.cut.to_dict()).pop() for t in m.tracks) == group_ids[len(m.tracks)]
        and all(len(_rir_ids(t.cut.to_dict())) == 1 for t in m.tracks) for m in with_groups)
    fast = all(not _rir_ids(m.to_dict()) for m in reverberated[half:])
    print(f"[{smi}] meeting_simulate: {len(utterances)} utterances of "
          f"{len(utterances.speakers)} speakers; " + "; ".join(lines) + f"; reverberated "
          f"{half} conversational meetings with the RIR groups ({len(with_groups)} with a group "
          f"of their track count, one RIR of it per track: {rirs_right}) and "
          f"{len(reverberated) - half} with the fast random RIRs ({fast}); leg took "
          f"{time.perf_counter() - t_leg!r} s")
    if not rirs_right or not fast or not with_groups:
        raise AssertionError("meeting_simulate: the reverberation is off")

    # -- meeting_sim_surt --------------------------------------------------------------------
    t_leg = time.perf_counter()
    windows = CutSet.from_cuts(
        w for w in CutSet.from_cuts(reverberated).cut_into_windows(
            SURT_MAX_GROUP, keep_excessive_supervisions=False) if w.supervisions)

    def surt_loader():
        extractor = Fbank(FbankConfig(device=device))
        return DataLoader(
            SimpleCutSampler(windows, max_duration=TASK_MAX_DURATION, shuffle=True, seed=0),
            K2SurtDataset(return_cuts=True, input_strategy=OnTheFlyFeatures(extractor)),
            prefetch_batches=3), extractor

    loader, extractor = surt_loader()
    recorder = _RecordFirstBatch(extractor)
    state = {}

    def keep(i, batch):
        if i == SIM_RESUME_AFTER - 1:
            state["ckpt"] = loader.state_dict()

    def unpack(b):
        return b["inputs"], b["input_lens"], sum(c.duration for c in b["cuts"])

    trainer = _Trainer(device)
    run = _leg("meeting_sim_surt", loader, trainer, device, fbank_cuda, unpack, smi,
               on_batch=keep)
    launches["meeting_sim_surt"] = run["launches"]
    err = _first_batch_err(recorder, extractor)
    errs.append(err)
    n = len(run["batches"])
    ids = [c.id for b in run["batches"] for c in b["cuts"]]
    resumed_loader, _ = surt_loader()
    resumed_loader.load_state_dict(state["ckpt"])
    fbank_cuda.LAUNCHES = 0
    resumed = [([c.id for c in b["cuts"]], b["inputs"]) for b in resumed_loader]
    launches_resumed = fbank_cuda.LAUNCHES
    resume_equal = len(resumed) == n - SIM_RESUME_AFTER and all(
        a_ids == [c.id for c in b["cuts"]]
        and torch.equal(torch.from_numpy(a), torch.from_numpy(b["inputs"]))
        for (a_ids, a), b in zip(resumed, run["batches"][SIM_RESUME_AFTER:]))
    overlapped = sum(1 for b in run["batches"] for cut in b["supervisions"] if cut[1])
    kept_sups = sum(len(w.supervisions) for w in windows)
    print(f"[{smi}] meeting_sim_surt: {len(reverberated)} meetings -> {len(windows)} windows of "
          f"<= {SURT_MAX_GROUP} s with supervisions ({sum(w.duration for w in windows)!r} s), "
          f"keeping {kept_sups} of the meetings' {sum(len(m.supervisions) for m in reverberated)} "
          f"supervisions (those inside a window), "
          f"{n} batches, {len(ids)} windows in the epoch, {overlapped} with a supervision on "
          f"channel 1; fbank kernel launches {run['launches']}; first batch kernel vs plain "
          f"{err!r} (tol {KERNEL_TOL}); resumed after batch {SIM_RESUME_AFTER}: {len(resumed)} "
          f"batches torch.equal to the uninterrupted run's: {resume_equal}, launches "
          f"{launches_resumed}; leg took {time.perf_counter() - t_leg!r} s")
    if sorted(ids) != sorted(w.id for w in windows) or run["launches"] != n:
        raise AssertionError("meeting_sim_surt: the epoch's windows or launches are off")
    if not err <= KERNEL_TOL or not resume_equal or launches_resumed != n - SIM_RESUME_AFTER:
        raise AssertionError("meeting_sim_surt: the features or the resume are off")
    if not overlapped:
        raise AssertionError("meeting_sim_surt: no window holds overlapping speech")
    set_tracing_enabled(False)
    return launches, max(errs)


def _phase_sharded(workdir: Path, device, fbank_cuda, smi: str) -> tuple:
    """22. Sharded manifests into training, on phase 14's 160 utterances
    split into ``SHARDS`` uncompressed JSONL shards whose ``.idx`` files
    ``index jsonl`` writes (the CLI in this process). Each leg:
    ``SimpleCutSampler(max_duration=180)`` →
    ``K2SpeechRecognitionDataset(OnTheFlyFeatures(Fbank()))`` on the card →
    an AdamW step of ``Encoder(EncoderConfig())`` per batch, with a resume
    after batch 3 that must be ``torch.equal`` (``_fly_with_resume``).
    ``from_files_on_the_fly``: ``CutSet.from_files(shards,
    shuffle_iters=True, seed=0)``, whose item-level Feistel order visits
    every cut once. ``idxpack_on_the_fly``: ``write_index_pack`` over the
    sidecars, ``index verify-pack``, then ``LazyPackedManifestIterator(pack,
    key, shuffle_shards=True, seed=0)``. ``webdataset_on_the_fly``: ``cut
    export-to-webdataset --shard-size 40`` (FLAC), then
    ``CutSet.from_webdataset`` over ``pipe:cat <tar>`` identifiers with
    ``shuffle_shards=True``; the audio ``np.array_equal`` to the source
    utterances'. Returns the kernel's launches per path and the largest
    kernel-vs-plain error."""
    import contextlib
    import io

    from lhotse_tpu_torch.bin.modes import cli
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.index_pack import IndexPackCollectionSpec, write_index_pack
    from lhotse_tpu_torch.lazy import LazyIndexedManifestIterator
    from lhotse_tpu_torch.packed_lazy import LazyPackedManifestIterator
    from lhotse_tpu_torch.tracing import set_tracing_enabled

    def run(*argv) -> str:
        """The CLI command ``argv`` in this process; returns what it printed."""
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            cli.main([str(a) for a in argv], standalone_mode=False)
        return printed.getvalue()

    set_tracing_enabled(True)
    trainer = _Trainer(device)
    launches, errs = {}, []
    utts_path = workdir / "recipe_cuts.jsonl.gz"
    source = {c.id: c for c in CutSet.from_file(utts_path)}
    all_ids = sorted(source)
    root = workdir / "sharded"
    root.mkdir()
    t0 = time.perf_counter()
    cuts = list(source.values())
    per = len(cuts) // SHARDS
    shards = []
    for k in range(SHARDS):
        shards.append(root / f"cuts-{k:03d}.jsonl")
        CutSet.from_cuts(cuts[k * per:(k + 1) * per]).to_file(shards[-1])
        run("index", "jsonl", shards[-1])
    print(f"[{smi}] phase 22: {len(cuts)} utterances in {SHARDS} JSONL shards with index jsonl "
          f"sidecars in {time.perf_counter() - t0!r} s")

    def fly(name, make_cuts):
        spans = {}
        launches[name], err = _fly_with_resume(name, make_cuts, trainer, device, fbank_cuda, smi,
                                               spans=spans)
        errs.append(err)
        return _host_spans(spans["report"], spans["batches"])

    # -- from_files_on_the_fly -------------------------------------------------------------
    t_leg = time.perf_counter()

    def from_files():
        return CutSet.from_files(shards, shuffle_iters=True, seed=0)

    chained = from_files()
    order = [c.id for c in chained]
    indexed = all(isinstance(leaf, LazyIndexedManifestIterator) for leaf in chained.data.sources)
    shard_of = {c.id: k // per for k, c in enumerate(cuts)}
    once = sorted(order) == all_ids and len(set(order)) == len(order)
    interleaved = len({shard_of[i] for i in order[:per]}) > 1
    spans = fly("from_files_on_the_fly", from_files)
    print(f"[{smi}] from_files_on_the_fly: {SHARDS} shards, every leaf indexed: {indexed}; the "
          f"Feistel order visits every cut once: {once}, interleaves the shards: {interleaved}; "
          f"first epoch {spans}; leg took {time.perf_counter() - t_leg!r} s")
    if not indexed or not once or not interleaved:
        raise AssertionError("from_files_on_the_fly: the order is off")

    # -- idxpack_on_the_fly ----------------------------------------------------------------
    t_leg = time.perf_counter()
    spec = IndexPackCollectionSpec(role="records", kind="json-lines",
                                   source_spec=f"cuts-{{000..{SHARDS - 1:03d}}}.jsonl",
                                   paths=tuple(shards))
    t0 = time.perf_counter()
    pack = write_index_pack(root / "cuts.idxpack", [spec])
    pack_s = time.perf_counter() - t0
    verified = run("index", "verify-pack", pack).strip()

    def packed():
        return CutSet(LazyPackedManifestIterator(pack, spec.key, shuffle_shards=True, seed=0))

    packed_order = [c.id for c in packed()]
    spans = fly("idxpack_on_the_fly", packed)
    print(f"[{smi}] idxpack_on_the_fly: write_index_pack of {SHARDS} sidecars into "
          f"{pack.stat().st_size} bytes in {pack_s!r} s; index verify-pack: {verified!r}; the "
          f"shuffled pack visits every cut once: {sorted(packed_order) == all_ids}; first epoch "
          f"{spans}; leg took {time.perf_counter() - t_leg!r} s")
    if verified != f"OK ({SHARDS} segments)" or sorted(packed_order) != all_ids:
        raise AssertionError("idxpack_on_the_fly: the pack is off")

    # -- webdataset_on_the_fly -------------------------------------------------------------
    t_leg = time.perf_counter()
    t0 = time.perf_counter()
    run("cut", "export-to-webdataset", "--shard-size", WDS_SHARD_SIZE, utts_path,
        root / "wds-%06d.tar")
    export_s = time.perf_counter() - t0
    tars = sorted(root.glob("wds-*.tar"))
    urls = [f"pipe:cat {t}" for t in tars]

    def webdataset():
        return CutSet.from_webdataset(urls, shuffle_shards=True)

    back = list(webdataset())
    audio_equal = sorted(c.id for c in back) == all_ids and all(
        np.array_equal(c.load_audio(), source[c.id].load_audio()) for c in back)
    origins = sorted({c.shard_origin for c in back}) == sorted(urls)
    spans = fly("webdataset_on_the_fly", webdataset)
    print(f"[{smi}] webdataset_on_the_fly: cut export-to-webdataset --shard-size {WDS_SHARD_SIZE} "
          f"(FLAC) into {len(tars)} tars of {sum(t.stat().st_size for t in tars)} bytes in "
          f"{export_s!r} s; read back through pipe:cat: every cut's audio np.array_equal to its "
          f"source's: {audio_equal}, shard_origin the pipe: {origins}; first epoch {spans}; leg "
          f"took {time.perf_counter() - t_leg!r} s")
    if len(tars) != len(cuts) // WDS_SHARD_SIZE or not audio_equal or not origins:
        raise AssertionError("webdataset_on_the_fly: the tars or their audio are off")
    set_tracing_enabled(False)
    return launches, max(errs)


# -- 23. the noise, RIR and far-field meeting recipes -------------------------------------
# MUSAN (openslr/17) and "RIRs and Noises" (openslr/28) in their published
# layout and format, 16 kHz mono WAV, with fewer files: 32 noise files of
# 5-30 s (MUSAN has 930), 8 music and 8 speech files; 8 point-source noises,
# 16 real RIRs of 0.3-1.0 s and 4 isotropic noises, 4 simulated RIRs per room
# size. The meeting corpora: one session of each of about 30 s, at the
# corpus's own channel count and file names (with the short sessions a
# recipe needs to fill its other splits).
NOISE_SEED = 2323  # numpy seed of phase 23's corpora
MUSAN_NOISE = (("free-sound", 16), ("sound-bible", 16))
MUSAN_NOISE_SECONDS = (5.0, 30.0)
POOL_SECONDS = 16.0  # each MUSAN noise recording tiled or cut to this length in the pool
RIR_SECONDS = (0.3, 1.0)
RIR_SEED = 23  # the seeded choice of the device chain's real RIR
MIX_SEED, REVERB_SEED, WHAM_SEED = 29, 31, 37
NOISE_RESUME_AFTER = 3
MEETING_SECONDS = 30.0
MEETING_SHORT_SECONDS = 6.0  # the sessions that only fill a recipe's other splits
MEETING_TURN_SECONDS = (2.0, 5.0)
MEETING_GAP_SECONDS = (0.5, 3.0)
MEETING_SPEAKERS = 4


def _wav_file(path: Path, x: np.ndarray) -> None:
    from lhotse_tpu_torch.audio.wavio import write_wav

    path.parent.mkdir(parents=True, exist_ok=True)
    write_wav(str(path), np.atleast_2d(x).astype(np.float32), SR)


def _decaying_rir(rng, seconds: float) -> np.ndarray:
    """Exponentially decaying noise with its direct path at 1 after 2 ms."""
    n = int(seconds * SR)
    rir = rng.standard_normal(n) * np.exp(-np.arange(n) / (n / 6.0)) * 0.3
    rir[int(0.002 * SR)] = 1.0
    return rir.astype(np.float32)


def _white(rng, seconds: float, level: float = 0.1) -> np.ndarray:
    return (level * rng.standard_normal(int(seconds * SR))).astype(np.float32)


def _write_noise_corpora(root: Path, rng) -> dict:
    """MUSAN, RIRS_NOISES, the BUT Reverb DB and WHAM! layouts; MUSAN's music
    and speech as tone bursts (numpy seed ``NOISE_SEED``), the rest noise."""
    bursts = np.random.RandomState(NOISE_SEED)
    musan = root / "musan"
    for sub, count in MUSAN_NOISE:
        for i in range(count):
            _wav_file(musan / "noise" / sub / f"noise-{sub}-{i:04d}.wav",
                      _white(rng, float(rng.uniform(*MUSAN_NOISE_SECONDS)), 0.05))
    annotations = []
    for i in range(8):
        name = f"music-fma-{i:04d}"
        _wav_file(musan / "music" / "fma" / f"{name}.wav", _tone_burst(bursts, 5.0 + i))
        annotations.append(f"{name} {'rock,pop' if i % 2 else 'classical'} {'YN'[i % 2]} "
                           f"artist{i}")
    (musan / "music" / "fma" / "ANNOTATIONS").write_text("\n".join(annotations) + "\n")
    for i in range(8):
        _wav_file(musan / "speech" / "librivox" / f"speech-librivox-{i:04d}.wav",
                  _tone_burst(bursts, 3.0 + 0.5 * i))
    rirs = root / "RIRS_NOISES"
    for i in range(8):
        _wav_file(rirs / "pointsource_noises" / f"noise-free-sound-{i:04d}.wav",
                  _white(rng, float(rng.uniform(1.0, 3.0)), 0.05))
    real = rirs / "real_rirs_isotropic_noises"
    for i in range(16):
        prefix = ("RWCP_type1_rir_circle_ane_imp", "RWCP_type2_rir_cirline_e1a_imp",
                  "RVB2014_type1_rir_largeroom1_near_angla", "RVB2014_type2_rir_mediumroom1")[i % 4]
        _wav_file(real / f"{prefix}_{i:02d}.wav",
                  _decaying_rir(rng, float(rng.uniform(*RIR_SECONDS))))
    for i in range(4):
        _wav_file(real / f"RVB2014_type1_noise_largeroom1_{i + 1}.wav", _white(rng, 2.0 + i, 0.05))
    for room in ("small", "medium", "large"):
        for i in range(4):
            _wav_file(rirs / "simulated_rirs" / f"{room}room" / "Room001" / f"Room001-{i + 1:05d}.wav",
                      _decaying_rir(rng, float(rng.uniform(*RIR_SECONDS))))
    but = root / "BUT_ReverbDB"
    for room in ("Q301", "L207"):
        for mic in ("MicID01", "MicID02"):
            base = but / room / mic / "SpkID01" / "01"
            _wav_file(base / "RIR" / "IR_sweep.v00.wav",
                      _decaying_rir(rng, float(rng.uniform(*RIR_SECONDS))))
            _wav_file(base / "silence" / "sil.v00.wav", _white(rng, 2.0, 0.01))
    wham = root / "wham_noise"
    for split, count in (("tr", 4), ("cv", 2), ("tt", 2)):
        for i in range(count):
            _wav_file(wham / split / f"{split}_noise_{i:02d}.wav",
                      _white(rng, float(rng.uniform(5.0, 10.0)), 0.05))
    return {"musan": musan, "rir_noise": rirs, "but_reverb_db": but, "wham": wham}


def _same_written(a: Path, b: Path, name: str) -> list:
    """The ``.jsonl.gz`` and ``.jsonl`` manifests two runs wrote (those of the
    directories below where none lies at the top), equal (the first once
    decompressed: a gzip header carries its write time) with each file's own
    directory swapped out (a recipe that writes audio names it there).
    Returns their names."""
    import gzip

    def read(p: Path) -> bytes:
        data = gzip.decompress(p.read_bytes()) if p.suffix == ".gz" else p.read_bytes()
        return data.replace(str(p.parent).encode(), b"<out>")

    def listed(d: Path, glob) -> list:
        return sorted(str(p.relative_to(d)) for pattern in ("*.jsonl.gz", "*.jsonl")
                      for p in glob(d, pattern))

    names = listed(a, Path.glob) or listed(a, Path.rglob)  # mTEDx writes a directory per language
    if not names or names != (listed(b, Path.glob) or listed(b, Path.rglob)) or any(
            read(a / n) != read(b / n) for n in names):
        raise AssertionError(f"{name}: the CLI's manifests differ from the function's")
    return names


def _prepare_twice(manifests: Path, name: str, function, argv: list, seed=None) -> tuple:
    """A recipe as a function and through the CLI's ``prepare`` command (in
    this process), into ``manifests / name / "function"`` and ``.../"cli"``;
    the manifests they write must be equal. With ``seed``, each run starts
    from ``fix_random_seed(seed)`` (the CLI's ``-s``): for a recipe that
    names cuts with ``uuid4``. Returns what the function made, the manifests'
    names and the seconds of each run."""
    from lhotse_tpu_torch.bin.modes import cli
    from lhotse_tpu_torch.utils import fix_random_seed

    out = manifests / name
    t = time.perf_counter()
    if seed is not None:
        fix_random_seed(seed)
    made = function(out / "function")
    function_s = time.perf_counter() - t
    t = time.perf_counter()
    cli.main(([] if seed is None else ["-s", str(seed)]) + ["prepare"] + [str(a) for a in argv]
             + [str(out / "cli")], standalone_mode=False)
    cli_s = time.perf_counter() - t
    return made, _same_written(out / "function", out / "cli", name), function_s, cli_s


def _noise_pool_and_rir(workdir: Path) -> tuple:
    """Phase 23's MUSAN noise recordings tiled or cut to ``POOL_SECONDS``
    (the augmenter's noise pool) and its seeded choice of a real RIR, read
    from the manifests phase 23 wrote. Returns the pool, the RIR, the noise
    recordings and the RIR's recording."""
    import random

    from lhotse_tpu_torch.audio import RecordingSet

    noise_dir = workdir / "noise_meetings" / "manifests"
    noise = RecordingSet.from_file(
        noise_dir / "musan" / "function" / "musan_recordings_noise.jsonl.gz")
    real_rirs = sorted(RecordingSet.from_file(
        noise_dir / "rir_noise" / "function" / "real-rir_recordings_all.jsonl.gz"),
        key=lambda r: r.id)
    pool_n = int(POOL_SECONDS * SR)
    pool = np.stack([np.resize(r.load_audio()[0], pool_n) for r in noise]).astype(np.float32)
    rir_rec = random.Random(RIR_SEED).choice(real_rirs)
    return pool, rir_rec.load_audio()[0].astype(np.float32), noise, rir_rec


def _device_chain(name: str, batches: list, pool, rir, device, fbank_cuda, smi: str) -> tuple:
    """``batches`` of (audio, lens) at the 15 s x 256 bucket → the int16 wire →
    ``OnDeviceAugmenter`` with the noise pool and RIR, speed 1.1, gain, SNR
    (10, 20) and SpecAugment: stage and compute timed apiece; the kernel
    against its plain version on the first batch it got, the features'
    shape and frame counts, and the first batch's features against the same
    chain with the plain version; then the first batch once more, after the
    launches are read, under ``torch.profiler`` for the device's busy share
    of the wall. Returns the kernel's launches, the kernel-vs-plain error
    and the chain's error."""
    from lhotse_tpu_torch.dataset.device_augment import OnDeviceAugmenter
    from lhotse_tpu_torch.dataset.signal_transforms import SpecAugment

    sec, bsz = BUCKET
    n = int(sec * SR)
    frames = (math.ceil(n * 10 / 11) + 80) // 160
    aug = OnDeviceAugmenter(
        buckets=[BUCKET], wire_format="int16", speed_factor=SPEED, gain_range=(0.9, 1.1),
        noise_pool=pool, snr=(10, 20), mix_prob=0.5, rir=rir, specaugment=SpecAugment(seed=0),
        device=device)
    aug.precompile()
    # The first launch's input and output, to hold the kernel against its
    # plain version on the very batch the path gave it.
    captured = []
    launch = fbank_cuda.fbank_logmel

    def capture(audio, Mc, Ms, mel_fb, **kw):
        out = launch(audio, Mc, Ms, mel_fb, **kw)
        if not captured:
            captured.append((audio.clone(), Mc, Ms, mel_fb, out.clone()))
        return out

    staged, outs, stage_ms, compute_ms = [], [], [], []
    fbank_cuda.fbank_logmel = capture
    try:
        torch.cuda.synchronize()
        fbank_cuda.LAUNCHES = 0
        for audio, lens in batches:
            t = time.perf_counter()
            staged.append(aug.stage(audio, lens))
            torch.cuda.synchronize()
            stage_ms.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            outs.append(aug.compute(staged[-1]))
            torch.cuda.synchronize()
            compute_ms.append((time.perf_counter() - t) * 1e3)
        launches = fbank_cuda.LAUNCHES
    finally:
        fbank_cuda.fbank_logmel = launch
    audio_k, Mc, Ms, mel_fb, out_k = captured[0]
    plain = fbank_cuda.reference_fbank(audio_k, *fbank_cuda._squeeze_nyquist(
        *(fbank_cuda._as_f32(m, audio_k.device) for m in (Mc, Ms, mel_fb))))
    kernel_err = (out_k - plain).abs().max().item()
    for (feats, feat_lens), (_, lens) in zip(outs, batches):
        if tuple(feats.shape) != (bsz, frames, 80) or not torch.isfinite(feats).all():
            raise AssertionError(f"{name}: features {tuple(feats.shape)} wrong or not finite")
        if not np.array_equal(feat_lens.cpu().numpy(), _expected_feat_lens(lens)):
            raise AssertionError(f"{name}: feat_lens differ from the hop rule")
    chain_err = _check_chain(staged[0], *outs[0], "int16", rir, device, fbank_cuda, path=name)
    wall_ms, busy_ms, _ = _device_busy(lambda: aug.compute(aug.stage(*batches[0])))
    mixed_rows = [int(torch.as_tensor(s.kwargs["mix_mask"]).sum()) for s in staged]
    audio_s = sum(int(lens.sum()) for _, lens in batches) / SR
    print(f"[{smi}] {name}: {len(batches)} batches of {bsz} x {sec:g} s, {audio_s!r} audio-s in "
          f"{sum(stage_ms) + sum(compute_ms)!r} ms (stage + compute): "
          f"{audio_s / (sum(stage_ms) + sum(compute_ms)) * 1e3!r} audio-s/s; stage ms {stage_ms}, "
          f"compute ms {compute_ms}; rows mixed with MUSAN noise {mixed_rows}; fbank kernel "
          f"launches {launches}; kernel vs plain on its first batch {kernel_err!r} (tol "
          f"{KERNEL_TOL}); features vs the plain chain {chain_err!r} (tol {CHAIN_TOL}); the first "
          f"batch again under torch.profiler: wall {wall_ms!r} ms, device busy {busy_ms!r} ms "
          f"({busy_ms / wall_ms!r} of the wall)")
    if launches != len(batches) or not kernel_err <= KERNEL_TOL:
        raise AssertionError(f"{name}: launches or the kernel's result are off")
    if not all(0 < m < bsz for m in mixed_rows):
        raise AssertionError(f"{name}: the mix mask is off: {mixed_rows}")
    return launches, kernel_err, chain_err


def _meeting_turns(rng, seconds: float, speakers: int = MEETING_SPEAKERS) -> list:
    """(speaker, start, end, words) turns of 2-5 s with 0.5-3 s gaps."""
    turns, t, spk = [], 0.5, 0
    while True:
        span = round(float(rng.uniform(*MEETING_TURN_SECONDS)), 2)
        if t + span > seconds - 0.3:
            return turns
        words = [RECIPE_WORDS[i] for i in rng.integers(0, len(RECIPE_WORDS), int(rng.integers(3, 9)))]
        turns.append((spk, round(t, 2), round(t + span, 2), words))
        t = round(t + span + float(rng.uniform(*MEETING_GAP_SECONDS)), 2)
        spk = (spk + int(rng.integers(1, speakers))) % speakers


def _meeting_audio(rng, seconds: float, turns: list, channels: int,
                   speakers: int = MEETING_SPEAKERS, headsets: bool = False) -> np.ndarray:
    """(channels, n) audio of the turns as tone bursts (four harmonics of an
    80-220 Hz f0 per speaker): a far-field channel hears every speaker with
    its own gain and a delay of up to 1 ms; headset ``k`` hears speaker ``k``
    and, at 0.05, the others. Every channel has its own 0.01 noise floor."""
    n = int(seconds * SR)
    f0 = rng.uniform(80, 220, speakers)
    dry = np.zeros((speakers, n), np.float32)
    for s, start, end, _ in turns:
        lo, hi = int(start * SR), int(end * SR)
        tt = np.arange(hi - lo) / SR
        dry[s, lo:hi] += 0.2 * sum(np.sin(2 * np.pi * f0[s] * (h + 1) * tt) / (h + 1)
                                   for h in range(4))
    out = (0.01 * rng.standard_normal((channels, n))).astype(np.float32)
    total = dry.sum(axis=0)
    for c in range(channels):
        if headsets:
            out[c] += dry[c % speakers] + 0.05 * (total - dry[c % speakers])
            continue
        for k, (gain, delay) in enumerate(zip(rng.uniform(0.3, 0.8, speakers),
                                              rng.integers(0, 17, speakers))):
            out[c, delay:] += gain * dry[k, : n - delay]
    return out


def _textgrid(tiers: dict, xmax: float) -> str:
    """A long-format Praat TextGrid of interval tiers {name: [(start, end, text)]}."""
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "", "xmin = 0",
             f"xmax = {xmax}", "tiers? <exists>", f"size = {len(tiers)}", "item []:"]
    for k, (name, intervals) in enumerate(tiers.items(), 1):
        lines += [f"    item [{k}]:", '        class = "IntervalTier"', f'        name = "{name}"',
                  "        xmin = 0", f"        xmax = {xmax}",
                  f"        intervals: size = {len(intervals)}"]
        for j, (start, end, text) in enumerate(intervals, 1):
            lines += [f"        intervals [{j}]:", f"            xmin = {start}",
                      f"            xmax = {end}", f'            text = "{text}"']
    return "\n".join(lines) + "\n"


def _hms(seconds: float, digits: int = 3) -> str:
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    return f"{int(h):02d}:{int(m):02d}:{s:0{3 + digits}.{digits}f}"


def _write_aishell4(root: Path, rng) -> Path:
    """train_L/wav/<session>.flac (8 channels) and its TextGrid, a tier per speaker."""
    from lhotse_tpu_torch.audio.flacio import write_flac

    session = "L_R003S01C02"
    turns = _meeting_turns(rng, MEETING_SECONDS)
    (root / "train_L" / "wav").mkdir(parents=True)
    write_flac(str(root / "train_L" / "wav" / f"{session}.flac"),
               _meeting_audio(rng, MEETING_SECONDS, turns, 8), SR)
    (root / "train_L" / "TextGrid").mkdir()
    (root / "train_L" / "TextGrid" / f"{session}.TextGrid").write_text(_textgrid(
        {str(k + 1): [(s, e, "".join(w).lower()) for spk, s, e, w in turns if spk == k]
         for k in range(MEETING_SPEAKERS)}, MEETING_SECONDS))
    return root


def _write_ali_meeting(root: Path, rng) -> Path:
    """Train_Ali_far (the 8-channel array, a TextGrid with a tier per
    speaker) and Train_Ali_near (a headset file and TextGrid per speaker)."""
    turns = _meeting_turns(rng, MEETING_SECONDS)
    genders = "FMFM"
    far = root / "Train_Ali_far"
    _wav_file(far / "audio_dir" / "R0001_M0001_MS001.wav",
              _meeting_audio(rng, MEETING_SECONDS, turns, 8))
    (far / "textgrid_dir").mkdir(parents=True)
    (far / "textgrid_dir" / "R0001_M0001.TextGrid").write_text(_textgrid(
        {f"R0001_M0001_{genders[k]}_SPK{k + 1:04d}": [
            (s, e, " ".join(w)) for spk, s, e, w in turns if spk == k]
         for k in range(MEETING_SPEAKERS)}, MEETING_SECONDS))
    near = root / "Train_Ali_near"
    headsets = _meeting_audio(rng, MEETING_SECONDS, turns, MEETING_SPEAKERS, headsets=True)
    (near / "textgrid_dir").mkdir(parents=True)
    for k in range(MEETING_SPEAKERS):
        stem = f"R0001_M0001_{genders[k]}_SPK{k + 1:04d}"
        _wav_file(near / "audio_dir" / f"{stem}.wav", headsets[k])
        (near / "textgrid_dir" / f"{stem}.TextGrid").write_text(_textgrid(
            {f"SPK{k + 1:04d}": [(s, e, " ".join(w)) for spk, s, e, w in turns if spk == k]},
            MEETING_SECONDS))
    return root


ICSI_SESSIONS = (("Bdb001", MEETING_SECONDS), ("Bmr021", MEETING_SHORT_SECONDS),
                 ("Bmr013", MEETING_SHORT_SECONDS))  # one meeting per partition
ICSI_CHANNELS = ("chan0", "chan1", "chan2", "chan3", "chanE", "chanF", "chan6", "chan7")


def _write_icsi(root: Path, rng) -> Path:
    """speech/<meeting>/chan<X>.sph (headsets chan0-3, distant chanE/F/6/7,
    SPHERE pcm16) and transcripts/ (preambles.mrt, the per-speaker Segments
    and Words XML)."""
    from lhotse_tpu_torch.audio.sphio import write_sph

    trans = root / "transcripts"
    (trans / "Segments").mkdir(parents=True)
    (trans / "Words").mkdir()
    preambles = ['<?xml version="1.0"?>', "<Meetings>"]
    for mi, (meet, seconds) in enumerate(ICSI_SESSIONS):
        turns = _meeting_turns(rng, seconds)
        near = _meeting_audio(rng, seconds, turns, MEETING_SPEAKERS, headsets=True)
        far = _meeting_audio(rng, seconds, turns, 4)
        (root / "speech" / meet).mkdir(parents=True)
        for ch, x in zip(ICSI_CHANNELS, list(near) + list(far)):
            write_sph(root / "speech" / meet / f"{ch}.sph", x[None], SR)
        names = [f"{'mf'[k % 2]}e0{mi}{k}" for k in range(MEETING_SPEAKERS)]
        preambles += [f'  <Meeting Session="{meet}">', "    <Preamble>", "      <Channels>"]
        preambles += [f'        <Channel Name="{c}"/>' for c in ICSI_CHANNELS]
        preambles += ["      </Channels>", "      <Participants>"]
        preambles += [f'        <Participant Name="{names[k]}" Channel="chan{k}"/>'
                      for k in range(MEETING_SPEAKERS)]
        preambles += ["      </Participants>", "    </Preamble>", "  </Meeting>"]
        for k in range(MEETING_SPEAKERS):
            segs, words = [], []
            for spk, start, end, text in turns:
                if spk != k:
                    continue
                segs.append(f'  <segment participant="{names[k]}" starttime="{start}" '
                            f'endtime="{end}"/>')
                step = (end - start) / len(text)
                words += [f'  <w starttime="{round(start + j * step, 3)}" '
                          f'endtime="{round(start + (j + 1) * step - 0.05, 3)}">{w.lower()}</w>'
                          for j, w in enumerate(text)]
            agent = "ABCD"[k]
            (trans / "Segments" / f"{meet}.{agent}.segs.xml").write_text(
                '<?xml version="1.0"?>\n<segments>\n' + "\n".join(segs) + "\n</segments>")
            (trans / "Words" / f"{meet}.{agent}.words.xml").write_text(
                '<?xml version="1.0"?>\n<words>\n' + "\n".join(words) + "\n</words>")
    preambles.append("</Meetings>")
    (trans / "preambles.mrt").write_text("\n".join(preambles))
    return root


NOTSOFAR_MEETING = "MTG_30830"
NOTSOFAR_PART, NOTSOFAR_VERSION = "train_set", "240825.1_train"


def _write_notsofar1(root: Path, rng) -> Path:
    """benchmark-datasets/<part>/<version>/MTG/<meeting>/: a single-channel
    device, a 7-channel device (ch0-ch6.wav), a close-talk file per speaker,
    gt_transcription.json with word timings and gt_meeting_metadata.json."""
    turns = _meeting_turns(rng, MEETING_SECONDS)
    mtg = (root / "benchmark-datasets" / NOTSOFAR_PART / NOTSOFAR_VERSION / "MTG"
           / NOTSOFAR_MEETING)
    _wav_file(mtg / "sc_plaza_0" / "ch0.wav", _meeting_audio(rng, MEETING_SECONDS, turns, 1)[0])
    for ch, x in enumerate(_meeting_audio(rng, MEETING_SECONDS, turns, 7)):
        _wav_file(mtg / "mc_plaza_0" / f"ch{ch}.wav", x)
    speakers = ["Alice", "Bob", "Carol", "Dave"]
    for k, x in enumerate(_meeting_audio(rng, MEETING_SECONDS, turns, MEETING_SPEAKERS,
                                         headsets=True)):
        _wav_file(mtg / "close_talk" / f"CT_{21 + k}.wav", x)
    transcript = []
    for spk, start, end, words in turns:
        step = (end - start) / len(words)
        timing = [[w.lower(), round(start + j * step, 2), round(start + (j + 1) * step, 2)]
                  for j, w in enumerate(words)]
        transcript.append({"speaker_id": speakers[spk], "start_time": start, "end_time": end,
                           "text": " ".join(w.lower() for w in words),
                           "word_timing": timing[:1] + [["<ah>", timing[0][2], timing[0][2]]]
                           + timing[1:]})
    (mtg / "gt_transcription.json").write_text(json.dumps(transcript))
    (mtg / "gt_meeting_metadata.json").write_text(json.dumps(
        {"ParticipantAliasToCtDevice": {s: f"CT_{21 + k}" for k, s in enumerate(speakers)}}))
    return root


LIBRICSS_OVERLAPS = ("0L", "0S", "OV10", "OV20", "OV30", "OV40")
LIBRICSS_SESSION = "overlap_ratio_20.0_sil0.1_1.0_session0_actual20.8"


def _write_libricss(root: Path, rng) -> Path:
    """for_release/OV20/<session>/: record/raw_recording.wav (7 channels),
    clean/mix.wav, clean/each_spk.wav (8 channels) and
    transcription/meeting_info.txt; the other overlap directories empty."""
    corpus = root / "for_release"
    for ov in LIBRICSS_OVERLAPS:
        (corpus / ov).mkdir(parents=True)
    turns = _meeting_turns(rng, MEETING_SECONDS)
    session = corpus / "OV20" / LIBRICSS_SESSION
    _wav_file(session / "record" / "raw_recording.wav",
              _meeting_audio(rng, MEETING_SECONDS, turns, 7))
    _wav_file(session / "clean" / "mix.wav", _meeting_audio(rng, MEETING_SECONDS, turns, 1)[0])
    _wav_file(session / "clean" / "each_spk.wav",
              _meeting_audio(rng, MEETING_SECONDS, turns, 8, headsets=True))
    speakers = ["1089", "121", "1284", "4507"]
    rows = ["start_time\tend_time\tspeaker\tutterance_id\ttranscription"] + [
        f"{start}\t{end}\t{speakers[spk]}\t{speakers[spk]}-{i:04d}\t{' '.join(w)}"
        for i, (spk, start, end, w) in enumerate(turns)]
    (session / "transcription").mkdir()
    (session / "transcription" / "meeting_info.txt").write_text("\n".join(rows) + "\n")
    return root


CHIME6_SESSIONS = (("S02", MEETING_SECONDS), ("S09", MEETING_SHORT_SECONDS))  # the dev split


def _write_chime6(root: Path, rng) -> Path:
    """audio/dev/<session>_U0<k>.CH<c>.wav (six 4-channel arrays, one file per
    channel), <session>_P<nn>.wav (binaural headsets) and
    transcriptions/dev/<session>.json, already synchronised."""
    for si, (session, seconds) in enumerate(CHIME6_SESSIONS):
        turns = _meeting_turns(rng, seconds)
        arrays = _meeting_audio(rng, seconds, turns, 24)
        for u in range(6):
            for c in range(4):
                _wav_file(root / "audio" / "dev" / f"{session}_U0{u + 1}.CH{c + 1}.wav",
                          arrays[4 * u + c])
        speakers = [f"P{5 + 4 * si + k:02d}" for k in range(MEETING_SPEAKERS)]
        heads = _meeting_audio(rng, seconds, turns, MEETING_SPEAKERS, headsets=True)
        for k, spk in enumerate(speakers):
            _wav_file(root / "audio" / "dev" / f"{session}_{spk}.wav",
                      np.stack([heads[k], heads[k]]))
        (root / "transcriptions" / "dev").mkdir(parents=True, exist_ok=True)
        (root / "transcriptions" / "dev" / f"{session}.json").write_text(json.dumps([
            {"end_time": _hms(end), "start_time": _hms(start), "words": " ".join(w).lower(),
             "speaker": speakers[spk], "ref": f"U0{1 + spk % 6}", "location": "kitchen",
             "session_id": session} for spk, start, end, w in turns]))
    return root


def _write_dipco(root: Path, rng) -> Path:
    """audio/<part>/<session>_U0<k>.CH<c>.wav (five 7-channel arrays) and
    <session>_P<nn>.wav (close-talk) for S02, the dev session of about 30 s,
    and the arrays of the other nine sessions at a few seconds each;
    transcriptions/<part>/<session>.json with HH:MM:SS.ff times per device."""
    from lhotse_tpu_torch.recipes.dipco import SESSIONS

    for part, sessions in SESSIONS.items():
        for session in sessions:
            seconds = MEETING_SECONDS if session == "S02" else MEETING_SHORT_SECONDS
            turns = _meeting_turns(rng, seconds)
            arrays = _meeting_audio(rng, seconds, turns, 35)
            for u in range(5):
                for c in range(7):
                    _wav_file(root / "audio" / part / f"{session}_U0{u + 1}.CH{c + 1}.wav",
                              arrays[7 * u + c])
            if session == "S02":
                for k, x in enumerate(_meeting_audio(rng, seconds, turns, MEETING_SPEAKERS,
                                                     headsets=True)):
                    _wav_file(root / "audio" / part / f"{session}_P0{k + 1}.wav", x)
            (root / "transcriptions" / part).mkdir(parents=True, exist_ok=True)
            (root / "transcriptions" / part / f"{session}.json").write_text(json.dumps([
                {"speaker_id": f"P0{spk + 1}", "session_id": session,
                 "start_time": {"close-talk": _hms(start, 2), "U01": _hms(start, 2)},
                 "end_time": {"close-talk": _hms(end, 2), "U01": _hms(end, 2)},
                 "ref": "U01", "gender": "female" if spk % 2 else "male",
                 "nativeness": "native", "mother_tongue": "English",
                 "words": " ".join(w).lower()} for spk, start, end, w in turns]))
    return root


def _meeting_specs(root: Path, rng) -> dict:
    """Per corpus, in the order the legs run: its layout written under
    ``root``, the recipe's call and the CLI's command for an output
    directory, and the pick of the array recordings and supervisions the
    recipe made (its main split's). Also returns the AliMeeting layout, for
    the ``save_mono`` leg."""
    from lhotse_tpu_torch import recipes as R

    aishell4 = _write_aishell4(root / "aishell4", rng)
    ali = _write_ali_meeting(root / "AliMeeting", rng)
    icsi = _write_icsi(root / "icsi", rng)
    notsofar = _write_notsofar1(root / "notsofar1", rng)
    libricss = _write_libricss(root / "libricss", rng)
    chime6 = _write_chime6(root / "CHiME6", rng)
    dipco = _write_dipco(root / "DiPCo", rng)
    return {
        "aishell4": (lambda o: R.prepare_aishell4(aishell4, output_dir=o),
                     ["aishell4", aishell4], lambda m: m["train_L"]),
        "ali_meeting": (lambda o: R.prepare_ali_meeting(ali, output_dir=o, mic="far"),
                        ["ali-meeting", "--mic", "far", ali], lambda m: m["train"]),
        "icsi": (lambda o: R.prepare_icsi(icsi / "speech", transcripts_dir=icsi / "transcripts",
                                          output_dir=o, mic="mdm"),
                 ["icsi", "--transcripts-dir", icsi / "transcripts", "--mic", "mdm",
                  icsi / "speech"], lambda m: m["train"]),
        "notsofar1": (lambda o: R.prepare_notsofar1(notsofar, output_dir=o),
                      ["notsofar1", notsofar],
                      lambda m: m[NOTSOFAR_PART][NOTSOFAR_VERSION]["multi_channel"]),
        "libricss": (lambda o: R.prepare_libricss(libricss, output_dir=o, type="mdm"),
                     ["libricss", "--type", "mdm", libricss], lambda m: m),
        "chime6": (lambda o: R.prepare_chime6(chime6, output_dir=o, dataset_parts=["dev"],
                                              mic="mdm"),
                   ["chime6", "-p", "dev", "--mic", "mdm", chime6], lambda m: m["dev"]),
        "dipco": (lambda o: R.prepare_dipco(dipco, output_dir=o, mic="mdm"),
                  ["dipco", "--mic", "mdm", dipco], lambda m: m["dev"]),
    }, ali


def _phase_noise_meetings(workdir: Path, device, fbank_cuda, smi: str) -> tuple:
    """23. The noise, RIR and far-field meeting recipes, in phase 14's
    directory. ``musan_rir_device_chain``: MUSAN and RIRS_NOISES layouts
    through ``prepare_musan`` and ``prepare_rir_noise`` (as functions and
    through the CLI's ``prepare musan`` and ``prepare rir-noise``, which
    must write the same manifests), the MUSAN noise recordings tiled or cut
    to 16 s as ``OnDeviceAugmenter``'s noise pool and a seeded choice of the
    ``real_rir`` recordings as its RIR, at the 15 s x 256 bucket with the
    int16 wire, speed 1.1, SNR (10, 20) and SpecAugment (phase 3's chain):
    the kernel against its plain version on the batch it got, the features
    against the same chain with the plain version. ``musan_rir_on_the_fly``:
    phase 14's 160 LibriSpeech utterances through ``CutMix`` over the MUSAN
    noise cuts (p=0.5) and ``ReverbWithImpulseResponse`` over the
    ``real_rir`` and BUT Reverb DB ``rir`` recordings (p=0.5, a seeded
    ``random.Random``) → ``K2SpeechRecognitionDataset`` with
    ``OnTheFlyFeatures`` on the kernel → ``DataLoader`` with both transforms
    as checkpoint objects → an AdamW step per batch, then a resume after
    batch 3 that must be ``torch.equal``; and one batch mixed with the WHAM!
    noise ``prepare_wham`` made. ``meeting_<corpus>``: per corpus, its
    layout → ``prepare_*`` (function and CLI, equal manifests) →
    ``CutSet.from_manifests`` on the array recordings →
    ``trim_to_supervisions(keep_overlapping=False, keep_all_channels=True)``
    → ``to_mono()`` → ``OnTheFlyFeatures`` on the kernel → an AdamW step
    per batch; ``meeting_aishell4_extract``: the whole 8-channel AISHELL-4
    session on the kernel into ``lilcom_chunky``, each segment's features
    equal to their slice of the session's. Before the legs, a line saying
    whether ``sox`` is found: AliMeeting's ``save_mono`` runs it, and where
    it is missing that leg alone is left out and named. Returns the kernel's
    launches per path and the largest kernel-vs-plain error."""
    import random
    import shutil

    from lhotse_tpu_torch.caching import set_caching_enabled
    from lhotse_tpu_torch.cut import CutSet, MixedCut, MonoCut, MultiCut
    from lhotse_tpu_torch.dataset import SimpleCutSampler
    from lhotse_tpu_torch.dataset.cut_transforms import CutMix, ReverbWithImpulseResponse
    from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
    from lhotse_tpu_torch.dataset.loader import DataLoader
    from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
    from lhotse_tpu_torch.features import Fbank, FbankConfig
    from lhotse_tpu_torch.features.io import LilcomChunkyWriter
    from lhotse_tpu_torch.recipes import (
        prepare_ali_meeting, prepare_but_reverb_db, prepare_musan, prepare_rir_noise, prepare_wham)
    from lhotse_tpu_torch.tracing import set_tracing_enabled
    from lhotse_tpu_torch.utils import compute_num_frames

    set_caching_enabled(False)
    set_tracing_enabled(True)
    sox = shutil.which("sox")
    print(f"[{smi}] phase 23: sox found: {sox is not None}"
          + ("" if sox else " (AliMeeting's save_mono leg runs sox: it is left out)"))
    rng = np.random.default_rng(NOISE_SEED)
    root = workdir / "noise_meetings"
    t0 = time.perf_counter()
    noise_dirs = _write_noise_corpora(root, rng)
    print(f"noise corpora (MUSAN, RIRS_NOISES, BUT Reverb DB, WHAM!) written in "
          f"{time.perf_counter() - t0!r} s")
    launches, errs = {}, []

    # -- musan_rir_device_chain ------------------------------------------------------
    musan, musan_files, musan_s, musan_cli_s = _prepare_twice(root / "manifests", 
        "musan", lambda o: prepare_musan(noise_dirs["musan"], output_dir=o),
        ["musan", noise_dirs["musan"]])
    rirs, rir_files, rir_s, rir_cli_s = _prepare_twice(root / "manifests", 
        "rir_noise", lambda o: prepare_rir_noise(noise_dirs["rir_noise"], output_dir=o),
        ["rir-noise", noise_dirs["rir_noise"]])
    noise_recs = musan["noise"]["recordings"]
    real_rirs = sorted(rirs["real_rir"]["recordings"], key=lambda r: r.id)
    counts = {part: len(m["recordings"]) for part, m in rirs.items()}
    if len(noise_recs) != sum(n for _, n in MUSAN_NOISE) or counts != {
            "point_noise": 8, "iso_noise": 4, "real_rir": 16, "sim_rir": 12}:
        raise AssertionError(f"musan_rir_device_chain: the prepared parts are off: {counts}")
    if len(musan["music"]["supervisions"]) != 8 or len(musan["speech"]["recordings"]) != 8:
        raise AssertionError("musan_rir_device_chain: MUSAN's music or speech part is off")
    pool_n = int(POOL_SECONDS * SR)
    pool = np.stack([np.resize(r.load_audio()[0], pool_n) for r in noise_recs]).astype(np.float32)
    rir_rec = random.Random(RIR_SEED).choice(real_rirs)
    rir = rir_rec.load_audio()[0].astype(np.float32)
    print(f"[{smi}] musan_rir_device_chain: prepare_musan {musan_s!r} s (CLI {musan_cli_s!r} s), "
          f"prepare_rir_noise {rir_s!r} s (CLI {rir_cli_s!r} s), the CLI's {len(musan_files)} + "
          f"{len(rir_files)} manifests equal to the functions'; parts {counts}; noise pool "
          f"{pool.shape} from {len(noise_recs)} MUSAN noise recordings of "
          f"{sum(r.duration for r in noise_recs)!r} s; RIR {rir_rec.id} ({rir.shape[0]} taps)")
    sec, bsz = BUCKET
    n = int(sec * SR)
    batches = []
    for _ in range(2):  # phase 3's batches: 8-15 s at the full bucket
        lens = rng.integers(n * 8 // 15, n + 1, size=bsz)
        lens[0] = n
        batches.append(((rng.standard_normal((bsz, n), np.float32) * 0.1), lens))
    launches["musan_rir_device_chain"], kernel_err, chain_err = _device_chain(
        "musan_rir_device_chain", batches, pool, rir, device, fbank_cuda, smi)
    errs += [kernel_err, chain_err]

    # -- musan_rir_on_the_fly ----------------------------------------------------------
    but, but_files, _, _ = _prepare_twice(root / "manifests", 
        "but_reverb_db", lambda o: prepare_but_reverb_db(noise_dirs["but_reverb_db"], output_dir=o),
        ["but-reverb-db", noise_dirs["but_reverb_db"]])
    wham, wham_files, _, _ = _prepare_twice(root / "manifests", 
        "wham", lambda o: prepare_wham(noise_dirs["wham"], output_dir=o),
        ["wham", noise_dirs["wham"]])
    noise_cuts = CutSet.from_manifests(recordings=noise_recs).to_eager()
    rir_pool = real_rirs + sorted(but["rir"]["recordings"], key=lambda r: r.id)
    utterances = CutSet.from_file(workdir / "recipe_cuts.jsonl.gz").to_eager()
    sup_ids = sorted(s.id for c in utterances for s in c.supervisions)

    def fly_loader():
        extractor = Fbank(FbankConfig(device=device))
        transforms = [CutMix(noise_cuts, snr=(10, 20), p=0.5, seed=MIX_SEED),
                      ReverbWithImpulseResponse(rir_pool, p=0.5,
                                                randgen=random.Random(REVERB_SEED))]
        sampler = SimpleCutSampler(utterances, max_duration=FLY_MAX_DURATION, shuffle=True, seed=0)
        dataset = K2SpeechRecognitionDataset(
            return_cuts=True, cut_transforms=transforms, input_strategy=OnTheFlyFeatures(extractor))
        return DataLoader(sampler, dataset, prefetch_batches=3,
                          checkpoint_objects=transforms), extractor

    loader, extractor = fly_loader()
    recorder = _RecordFirstBatch(extractor)
    state = {}

    def checkpoint(i, batch):
        if i == NOISE_RESUME_AFTER - 1:
            state["ckpt"] = loader.state_dict()

    run = _leg("musan_rir_on_the_fly", loader, _Trainer(device), device, fbank_cuda, _rows_of, smi,
               on_batch=checkpoint)
    err = _first_batch_err(recorder, extractor)
    resumed_loader, _ = fly_loader()
    resumed_loader.load_state_dict(state["ckpt"])
    resumed = list(resumed_loader)
    want = run["batches"][NOISE_RESUME_AFTER:]
    resume_equal = len(resumed) == len(want) and all(
        torch.equal(torch.from_numpy(a["inputs"]), torch.from_numpy(b["inputs"]))
        and a["supervisions"]["text"] == b["supervisions"]["text"]
        for a, b in zip(resumed, want))
    cuts = [c for b in run["batches"] for c in b["supervisions"]["cut"]]
    covered = sorted(s.id.removesuffix("_rvb") for c in cuts for s in c.supervisions)
    mixed = sum(isinstance(c, MixedCut) for c in cuts)
    reverberated = sum(c.id.endswith("_rvb") for c in cuts)
    # One batch of the same utterances under WHAM! noise.
    wham_cuts = CutSet.from_manifests(recordings=[
        r for split in ("tr", "cv", "tt") for r in wham[split]["recordings"]]).to_eager()
    wham_extractor = Fbank(FbankConfig(device=device))
    wham_recorder = _RecordFirstBatch(wham_extractor)
    wham_set = K2SpeechRecognitionDataset(
        return_cuts=True, cut_transforms=[CutMix(wham_cuts, snr=(10, 20), p=1.0, seed=WHAM_SEED)],
        input_strategy=OnTheFlyFeatures(wham_extractor))
    first = CutSet.from_cuts(next(iter(SimpleCutSampler(
        utterances, max_duration=FLY_MAX_DURATION, shuffle=True, seed=0))))
    fbank_cuda.LAUNCHES = 0
    wham_batch = wham_set[first]
    wham_launches = fbank_cuda.LAUNCHES
    wham_err = _first_batch_err(wham_recorder, wham_extractor)
    wham_mixed = all(isinstance(c, MixedCut) and any(
        "noise" in getattr(t.cut, "recording_id", "") for t in c.tracks[1:])
        for c in wham_batch["supervisions"]["cut"])
    launches["musan_rir_on_the_fly"] = run["launches"] + wham_launches
    print(f"[{smi}] musan_rir_on_the_fly: BUT Reverb DB and WHAM! prepared (the CLI's "
          f"{len(but_files)} + {len(wham_files)} manifests equal to the functions'); "
          f"{len(utterances)} utterances, {mixed} mixed with MUSAN noise and {reverberated} "
          f"reverberated by one of {len(rir_pool)} RIRs; every supervision once: "
          f"{covered == sup_ids}; first batch kernel vs plain {err!r} (tol {KERNEL_TOL}); resumed "
          f"after batch {NOISE_RESUME_AFTER} through a fresh loader: {len(resumed)} batches "
          f"torch.equal to the uninterrupted run's: {resume_equal}; a batch of {len(first)} "
          f"utterances mixed with WHAM! noise ({len(wham_cuts)} recordings): all mixed "
          f"{wham_mixed}, {wham_launches} launch, kernel vs plain {wham_err!r}")
    if run["launches"] != len(run["batches"]) or len(run["batches"]) <= NOISE_RESUME_AFTER:
        raise AssertionError("musan_rir_on_the_fly: launches or the batch count are off")
    if covered != sup_ids or not mixed or not reverberated or not resume_equal:
        raise AssertionError("musan_rir_on_the_fly: coverage, the transforms or the resume are off")
    if not err <= KERNEL_TOL or not wham_err <= KERNEL_TOL or wham_launches != 1 or not wham_mixed:
        raise AssertionError("musan_rir_on_the_fly: the kernel or the WHAM! batch is off")
    errs += [err, wham_err]

    # -- meeting_<corpus> ----------------------------------------------------------------
    t0 = time.perf_counter()
    specs, ali_dir = _meeting_specs(root / "meetings", rng)
    print(f"meeting corpora ({', '.join(specs)}) written in {time.perf_counter() - t0!r} s")
    trainer = _Trainer(device)
    summary = {}
    for name, (function, argv, pick) in specs.items():
        made, files, prepare_s, cli_s = _prepare_twice(root / "manifests", name, function, argv)
        recordings, supervisions = pick(made)["recordings"], pick(made)["supervisions"]
        sessions = CutSet.from_manifests(recordings=recordings, supervisions=supervisions).to_eager()
        trimmed = sessions.trim_to_supervisions(
            keep_overlapping=False, keep_all_channels=True).to_eager()
        monos = CutSet.from_cuts(m for c in trimmed for m in c.to_mono())
        channels = sorted({c.num_channels for c in sessions})
        fly = Fbank(FbankConfig(device=device))
        recorder = _RecordFirstBatch(fly)
        loader = DataLoader(
            SimpleCutSampler(monos, max_duration=FLY_MAX_DURATION, shuffle=True, seed=0),
            K2SpeechRecognitionDataset(return_cuts=True, input_strategy=OnTheFlyFeatures(fly)),
            prefetch_batches=3)
        run = _leg(f"meeting_{name}", loader, trainer, device, fbank_cuda, _rows_of, smi,
                   unit="channel")
        launches[f"meeting_{name}"] = run["launches"]
        err = _first_batch_err(recorder, fly)
        rows = sum(b["inputs"].shape[0] for b in run["batches"])
        summary[name] = {"supervisions made": len(supervisions), "kept": len(trimmed),
                         "channels": channels,
                         "channel-s/s": run["audio_s"] / run["wall_ms"] * 1e3}
        print(f"[{smi}] meeting_{name}: prepare {prepare_s!r} s, CLI {cli_s!r} s, its "
              f"{len(files)} manifests equal; {len(sessions)} sessions of {channels} channels; "
              f"supervisions made {len(supervisions)}, kept {len(trimmed)} -> {len(monos)} "
              f"MonoCuts ({rows} rows); first batch kernel vs plain {err!r} (tol {KERNEL_TOL})")
        if not all(isinstance(c, MultiCut) for c in sessions) or {
                type(c) for c in monos} != {MonoCut}:
            raise AssertionError(f"meeting_{name}: the sessions are not multi-channel MultiCuts")
        if len(trimmed) != len(supervisions) or len(monos) != sum(c.num_channels for c in trimmed):
            raise AssertionError(f"meeting_{name}: trimming lost or split supervisions")
        if run["launches"] != len(run["batches"]) or rows != len(monos) or not err <= KERNEL_TOL:
            raise AssertionError(f"meeting_{name}: launches, coverage or the kernel are off")
        errs.append(err)
        if name == "aishell4":
            aishell4_sessions = sessions

    # -- meeting_aishell4_extract ----------------------------------------------------------
    (session,) = aishell4_sessions
    extractor = Fbank(FbankConfig(device=device))
    calls = _RecordExtract(extractor)
    featured = {}

    def extract():
        with LilcomChunkyWriter(root / "aishell4_feats") as storage:
            featured["cut"] = session.compute_and_store_features(extractor, storage)

    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    wall_ms, busy_ms, _ = _device_busy(extract)
    launches["meeting_aishell4_extract"] = fbank_cuda.LAUNCHES
    matrix = featured["cut"].load_features()
    extract_err = _extract_errors(extractor, calls.calls)
    archive_err = float(np.abs(matrix - calls.calls[0][1]).max())
    segments = featured["cut"].trim_to_supervisions(
        keep_overlapping=False, keep_all_channels=True).to_eager()
    slices_equal = all(np.array_equal(c.load_features(), matrix[
        :, compute_num_frames(c.start, 0.01, SR):][:, : c.num_frames]) for c in segments)
    channel_s = session.duration * session.num_channels
    print(f"[{smi}] meeting_aishell4_extract: the {session.num_channels}-channel session, "
          f"{channel_s!r} channel-s, extracted and stored in {wall_ms!r} ms: "
          f"{channel_s / wall_ms * 1e3!r} channel-s/s, device busy {busy_ms / wall_ms!r}; stored "
          f"{matrix.shape}; fbank kernel launches {launches['meeting_aishell4_extract']}; kernel "
          f"vs plain {extract_err!r} (tol {KERNEL_TOL}), archive vs the kernel's output "
          f"{archive_err!r} (tol {LTC1_TICK / 2 + 1e-6!r}); {len(segments)} segments' features "
          f"equal to their session slices: {slices_equal}")
    if launches["meeting_aishell4_extract"] != 1 or not slices_equal:
        raise AssertionError("meeting_aishell4_extract: launches or the segment slices are off")
    if not extract_err <= KERNEL_TOL or not archive_err <= LTC1_TICK / 2 + 1e-6:
        raise AssertionError("meeting_aishell4_extract: the kernel or the archive disagrees")
    errs.append(extract_err)

    # -- AliMeeting's save_mono (sox) ------------------------------------------------------
    if sox is None:
        print(f"[{smi}] ali_meeting_save_mono: left out, sox is not found")
    else:
        mono = prepare_ali_meeting(ali_dir, output_dir=root / "ali_sdm", mic="sdm",
                                   save_mono=True)["train"]["recordings"]
        far = {r.id: r for r in specs["ali_meeting"][2](
            prepare_ali_meeting(ali_dir, mic="far"))["recordings"]}
        ok = all(r.num_channels == 1 and r.num_samples == far[r.id].num_samples for r in mono)
        print(f"[{smi}] ali_meeting_save_mono: {len(mono)} sessions written mono by sox: {ok}")
        if not ok:
            raise AssertionError("ali_meeting_save_mono: the mono recordings are off")
    print(f"[{smi}] phase 23 meetings: {summary}")
    return launches, max(errs)


# -- 24. the single-stream ASR, TTS and speaker corpora ------------------------------------
# Each corpus in its published layout and format (sampling rate, channel
# count, codec, directory tree, file names, transcript files), cut in depth
# only: CORPUS_FILES audio files each (TED-LIUM 2: 16 talks; Libri-Light: 16
# files; MLS: 24), AISHELL at the main path's bucket (as many utterances of
# 2 s up to the bucket's length as it has rows) and three TED-LIUM 3 talks
# of 3-5 minutes. Tone bursts from numpy seed SINGLE_SEED.
SINGLE_SEED = 2424
CORPUS_FILES = 32
AISHELL_MIN_SECONDS = 2.0
TEDLIUM_TALKS = ("AaronHuey_2010X", "BillGates_2010", "JaneMcGonigal_2010")
TEDLIUM_TALK_SECONDS = (180.0, 300.0)
TEDLIUM_SEGMENT_SECONDS = (3.0, 15.0)
TEDLIUM_RESUME_AFTER = 2
ENGLISH = ("the", "world", "we", "have", "to", "think", "about", "energy", "climate", "people",
           "it 's", "they 're", "change", "so", "{NOISE}", "<unk>")
MANDARIN = ("甚至", "出现", "交易", "几乎", "停滞", "的", "情况", "一二线", "城市", "虽然",
            "已经", "放开", "ＡＴＭ", "好'的")
TIMIT_PHONES = ("sh", "iy", "hh", "ae", "d", "y", "er", "aa", "r", "k", "s", "uw", "t", "ix",
                "axr", "dcl", "kcl", "tcl", "q", "pau", "epi", "ux", "el", "en")
NUMBERS = ("zero", "one", "two", "three", "four", "five", "six", "seven", "eight", "nine")


def _write_audio(path: Path, x: np.ndarray, sr: int) -> None:
    """``x`` at ``sr`` Hz as FLAC (``.flac``), NIST SPHERE (``.sph``) or RIFF
    WAV (any other suffix, TIMIT's ``.WAV`` too)."""
    from lhotse_tpu_torch.audio.flacio import write_flac
    from lhotse_tpu_torch.audio.sphio import write_sph
    from lhotse_tpu_torch.audio.wavio import write_wav

    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix == ".flac":
        write_flac(str(path), np.atleast_2d(x), sr)
    elif path.suffix == ".sph":
        write_sph(str(path), x, sr)
    else:
        write_wav(str(path), np.atleast_2d(x).astype(np.float32), sr)


def _words(rng, vocabulary, lo: int = 3, hi: int = 12, sep: str = " ") -> str:
    return sep.join(vocabulary[i] for i in rng.randint(0, len(vocabulary), rng.randint(lo, hi)))


def _stm(rng, talk: str, seconds: float) -> str:
    """A talk's STM lines: segments of 3-15 s after pauses of 0.2-1.5 s,
    every 7th ``ignore_time_segment_in_scoring``."""
    lines, start = [], round(float(rng.uniform(0.5, 2.0)), 2)
    while True:
        end = round(start + float(rng.uniform(*TEDLIUM_SEGMENT_SECONDS)), 2)
        if end > seconds - 0.1:
            return "\n".join(lines) + "\n"
        words = "ignore_time_segment_in_scoring" if len(lines) % 7 == 6 else _words(rng, ENGLISH)
        lines.append(f"{talk} 1 {talk} {start:.2f} {end:.2f} <o,f0,male> {words}")
        start = round(end + float(rng.uniform(0.2, 1.5)), 2)


def _write_aishell(root: Path, rng, n: int, max_seconds: float) -> Path:
    """AISHELL-1 (openslr/33): ``data_aishell/wav/<split>/<speaker>/<utt>.wav``,
    16 kHz, and one transcript file for every split; ``n`` utterances of
    2 s to ``max_seconds``, 6 in 8 in train, speakers of up to 64."""
    corpus = root / "aishell"
    data = corpus / "data_aishell"
    lines = []
    for i in range(n):
        split = ("train", "train", "train", "train", "train", "train", "dev", "test")[i % 8]
        first = {"train": 2, "dev": 724, "test": 764}[split]
        spk = f"S{first + i // 64:04d}"
        utt = f"BAC009{spk}W{i:04d}"
        seconds = float(rng.uniform(AISHELL_MIN_SECONDS, max_seconds))
        _write_audio(data / "wav" / split / spk / f"{utt}.wav", _tone_burst(rng, seconds), SR)
        lines.append(f"{utt} {_words(rng, MANDARIN, 4, 12)}")
    (data / "transcript").mkdir(parents=True)
    (data / "transcript" / "aishell_transcript_v0.8.txt").write_text(
        "\n".join(lines) + "\n", encoding="utf-8")
    return corpus


def _write_tedlium(root: Path, rng) -> Path:
    """TED-LIUM release 3 (openslr/51), the legacy repartition: three talks
    of 3-5 minutes as 16 kHz SPHERE under ``legacy/train/sph`` and their STM
    files under ``legacy/train/stm``."""
    corpus = root / "TEDLIUM_release-3"
    stm_dir = corpus / "legacy" / "train" / "stm"
    stm_dir.mkdir(parents=True)
    for talk in TEDLIUM_TALKS:
        seconds = float(rng.uniform(*TEDLIUM_TALK_SECONDS))
        _write_audio(corpus / "legacy" / "train" / "sph" / f"{talk}.sph",
                     _tone_burst(rng, seconds), SR)
        (stm_dir / f"{talk}.stm").write_text(_stm(rng, talk, seconds))
    return corpus


def _write_yesno(root: Path, rng) -> Path:
    """YesNo (openslr/1): ``waves_yesno/<8 bits>.wav``, 8 kHz, 5-7 s."""
    corpus = root / "waves_yesno"
    for code in rng.choice(256, CORPUS_FILES, replace=False):
        name = "_".join(str((int(code) >> k) & 1) for k in range(8))
        _write_audio(corpus / f"{name}.wav", _tone_burst(rng, float(rng.uniform(5.0, 7.0)), 8000),
                     8000)
    return corpus


def _write_aishell2(root: Path, rng) -> Path:
    """AISHELL-2, iOS: ``AISHELL-2/iOS/{data,dev,test}/wav/<speaker>/<utt>.wav``,
    16 kHz, and a ``trans.txt`` per split; 24 + 4 + 4 utterances of 2-6 s."""
    ios = root / "AISHELL-2" / "iOS"
    for split, count, first in (("data", 24, 1), ("dev", 4, 2001), ("test", 4, 2101)):
        lines = []
        for u in range(count):
            spk = f"C{first + u // 8:04d}"
            utt = f"I{spk}W{u:04d}"
            _write_audio(ios / split / "wav" / spk / f"{utt}.wav",
                         _tone_burst(rng, float(rng.uniform(2.0, 6.0))), SR)
            lines.append(f"{utt}\t{_words(rng, MANDARIN, 3, 9, sep='')}")
        (ios / split / "trans.txt").write_text("\n".join(lines) + "\n", encoding="utf-8")
    return root


def _write_tedlium2(root: Path, rng) -> Path:
    """TED-LIUM release 2 (openslr/19): ``{train,dev,test}/{sph,stm}``, 16 kHz
    SPHERE talks of 20-40 s: 12 train, 2 dev, 2 test."""
    corpus = root / "TEDLIUM_release2"
    for split, count in (("train", 12), ("dev", 2), ("test", 2)):
        (corpus / split / "stm").mkdir(parents=True)
        for t in range(count):
            talk, seconds = f"Speaker{split.capitalize()}{t:02d}_2009", float(rng.uniform(20, 40))
            _write_audio(corpus / split / "sph" / f"{talk}.sph", _tone_burst(rng, seconds), SR)
            (corpus / split / "stm" / f"{talk}.stm").write_text(_stm(rng, talk, seconds))
    return corpus


def _write_librilight(root: Path, rng) -> Path:
    """Libri-Light ``small``: ``small/<speaker>/<book>/<file>.flac``, 16 kHz,
    with the sibling JSON of speaker, book and voice activity; 16 files of
    20-40 s, voice-activity intervals of 2-10 s."""
    corpus = root / "librilight"
    for f in range(16):
        spk, book = str(100 + f // 4), f"book_{f % 4:02d}"
        seconds = float(rng.uniform(20.0, 40.0))
        flac = corpus / "small" / spk / book / f"chapter_{f:02d}_64kb.flac"
        _write_audio(flac, _tone_burst(rng, seconds), SR)
        vad, start = [], float(rng.uniform(0.1, 1.0))
        while True:
            end = start + float(rng.uniform(2.0, 10.0))
            if end > seconds - 0.1:
                break
            vad.append([round(start, 3), round(end, 3)])
            start = end + float(rng.uniform(0.3, 2.0))
        flac.with_suffix(".json").write_text(json.dumps(
            {"speaker": spk, "book_meta": {"id": book}, "snr": float(rng.uniform(5, 30)),
             "voice_activity": vad}))
    return corpus


def _write_mls(root: Path, rng) -> Path:
    """MLS Polish (openslr/94): ``mls_polish/{train,dev,test}/audio/<speaker>/
    <book>/<speaker>_<book>_<utt>.flac``, 16 kHz, a ``transcripts.txt`` per
    split and ``metainfo.txt``; 16 + 4 + 4 utterances of 10-20 s."""
    corpus = root / "mls"
    lang = corpus / "mls_polish"
    meta = ["SPEAKER   |   GENDER   | PARTITION  |  MINUTES   |  BOOK ID   |       TITLE"]
    for split, count, first in (("train", 16, 6892), ("dev", 4, 2364), ("test", 4, 8758)):
        lines = []
        for u in range(count):
            spk, book = str(first + u // 8), str(10000 + u // 4)
            utt = f"{spk}_{book}_{u:06d}"
            _write_audio(lang / split / "audio" / spk / book / f"{utt}.flac",
                         _tone_burst(rng, float(rng.uniform(10.0, 20.0))), SR)
            lines.append(f"{utt}\t{_words(rng, ENGLISH).replace('{NOISE} ', '')}")
            if u % 8 == 0:
                meta.append(f"{spk} | {'FM'[u % 2]} | {split} | 30.00 | {book} | Title {book}")
        (lang / split / "transcripts.txt").write_text("\n".join(lines) + "\n")
    (lang / "metainfo.txt").write_text("\n".join(meta) + "\n")
    return corpus


def _write_peoples_speech(root: Path, rng) -> Path:
    """The People's Speech: ``train/clean.json`` and ``validation/
    validation.json`` (JSON lines of an ``identifier`` and ``training_data``
    of parallel ``duration_ms``, ``label`` and ``name`` lists) over 16 kHz
    FLAC under ``train/clean/`` and ``validation/validation/``; 24 + 8
    utterances of 3-15 s."""
    corpus = root / "peoples_speech"
    for part, sessions in (("train/clean", 4), ("validation/validation", 1)):
        items = []
        for s in range(sessions):
            ident = f"{part.split('/')[1]}_session_{s:03d}"
            data = {"duration_ms": [], "label": [], "name": []}
            for k in range(6 if part == "train/clean" else 8):
                seconds = float(rng.uniform(3.0, 15.0))
                name = f"{ident}/{ident}_{k:05d}.flac"
                _write_audio(corpus / part / name, _tone_burst(rng, seconds), SR)
                data["duration_ms"].append(int(seconds * 1000))
                data["label"].append(_words(rng, ENGLISH[:14]))
                data["name"].append(name)
            items.append(json.dumps({"identifier": ident, "training_data": data}))
        (corpus / f"{part}.json").write_text("\n".join(items) + "\n")
    return corpus


def _write_spgispeech(root: Path, rng) -> Path:
    """SPGISpeech: ``{train,val}/<call hash>/<n>.wav``, 16 kHz, with
    ``train.csv`` and ``val.csv`` (``wav_filename|wav_filesize|transcript``);
    24 + 8 utterances of 3-15 s, punctuated and cased."""
    corpus = root / "spgispeech"
    for split, calls in (("train", 4), ("val", 1)):
        rows = ["wav_filename|wav_filesize|transcript"]
        for c in range(calls):
            call = rng.bytes(16).hex()
            for k in range(6 if split == "train" else 8):
                path = corpus / split / call / f"{k + 1}.wav"
                _write_audio(path, _tone_burst(rng, float(rng.uniform(3.0, 15.0))), SR)
                text = _words(rng, ENGLISH[:14]).capitalize()
                rows.append(f"{call}/{k + 1}.wav|{path.stat().st_size}|{text}, Q{c + 1} is up "
                            f"{k + 2}%.")
        (corpus / f"{split}.csv").write_text("\n".join(rows) + "\n")
    return corpus


def _write_timit(root: Path, rng) -> Path:
    """TIMIT: ``data/{TRAIN,TEST}/<dialect>/<speaker>/<utt>.WAV``, 16 kHz, with
    ``.TXT``, ``.WRD`` and ``.PHN`` in samples; 4 train speakers and 2 each
    of Kaldi's dev and test core lists, SA1, SA2, an SI and an SX sentence
    of 2-4 s each."""
    corpus = root / "timit"
    for part, dr, spk in (("TRAIN", "DR1", "fcjf0"), ("TRAIN", "DR1", "mcpm0"),
                          ("TRAIN", "DR2", "fdaw0"), ("TRAIN", "DR2", "mdac0"),
                          ("TEST", "DR1", "fadg0"), ("TEST", "DR1", "faks0"),
                          ("TEST", "DR2", "fdhc0"), ("TEST", "DR2", "felc0")):
        for name in ("SA1", "SA2", f"SI{rng.randint(500, 2300)}", f"SX{rng.randint(10, 450)}"):
            d = corpus / "data" / part / dr / spk
            x = _tone_burst(rng, float(rng.uniform(2.0, 4.0)))
            n = x.size
            _write_audio(d / f"{name}.WAV", x, SR)
            words = _words(rng, ENGLISH[:14], 3, 8).split()
            cuts = np.linspace(0, n, len(words) + 1).astype(int)
            (d / f"{name}.TXT").write_text(f"0 {n} {' '.join(words)}.\n")
            (d / f"{name}.WRD").write_text("".join(
                f"{a} {b} {w}\n" for a, b, w in zip(cuts[:-1], cuts[1:], words)))
            phones = ["h#"] + [TIMIT_PHONES[i] for i in rng.randint(0, len(TIMIT_PHONES), 12)]
            cuts = np.linspace(0, n, len(phones) + 2).astype(int)
            (d / f"{name}.PHN").write_text("".join(
                f"{a} {b} {p}\n" for a, b, p in zip(cuts[:-1], cuts[1:], phones + ["h#"])))
    return corpus


def _write_libritts(root: Path, rng, name: str = "LibriTTS") -> Path:
    """LibriTTS (openslr/60) or LibriTTS-R (openslr/141): ``<part>/<speaker>/
    <chapter>/<speaker>_<chapter>_<paragraph>_<sentence>.wav``, 24 kHz, with
    ``.trans.tsv`` (id, original text, normalized text) and ``.book.tsv``
    per chapter and ``SPEAKERS.txt``; dev-clean and test-clean of 2 speakers
    x 2 chapters x 4 sentences of 1-8 s."""
    corpus = root / name
    speakers = [";ID  |SEX| SUBSET           |MINUTES| NAME"]
    for part, first in (("dev-clean", 84), ("test-clean", 1089)):
        for s in range(2):
            spk = str(first + s)
            speakers.append(f"{spk}  | {'FM'[s]} | {part}        | 25.00 | Reader {spk}")
            for c in range(2):
                chapter = str(121123 + 100 * s + c)
                where = corpus / part / spk / chapter
                trans, book = [], []
                for u in range(4):
                    utt = f"{spk}_{chapter}_{u:06d}_000000"
                    _write_audio(where / f"{utt}.wav",
                                 _tone_burst(rng, float(rng.uniform(1.0, 8.0)), 24000), 24000)
                    words, k = _words(rng, ENGLISH[:14]).capitalize(), int(rng.randint(0, 10))
                    trans.append(f"{utt}\t\"{words}, {k}!\"\t\"{words}, {NUMBERS[k]}!\"")
                    book.append(f"{utt}\t{words}\t{rng.uniform(5.0, 40.0):.4f}")
                (where / f"{spk}_{chapter}.trans.tsv").write_text("\n".join(trans) + "\n")
                (where / f"{spk}_{chapter}.book.tsv").write_text("\n".join(book) + "\n")
    (corpus / "SPEAKERS.txt").write_text("\n".join(speakers) + "\n")
    return corpus


def _write_ljspeech(root: Path, rng) -> Path:
    """LJ Speech 1.1: ``wavs/LJ<chapter>-<n>.wav``, 22,050 Hz, and
    ``metadata.csv`` (``id|text|normalized text``); 32 clips of 1-10 s."""
    corpus = root / "LJSpeech-1.1"
    rows = []
    for i in range(CORPUS_FILES):
        rid = f"LJ{1 + i // 16:03d}-{1 + i % 16:04d}"
        _write_audio(corpus / "wavs" / f"{rid}.wav",
                     _tone_burst(rng, float(rng.uniform(1.0, 10.0)), 22050), 22050)
        words, k = _words(rng, ENGLISH[:14]).capitalize(), int(rng.randint(0, 10))
        rows.append(f"{rid}|{words}, in {1470 + k};|{words}, in fourteen seventy-{NUMBERS[k]};")
    (corpus / "metadata.csv").write_text("\n".join(rows) + "\n")
    return corpus


def _write_vctk(root: Path, rng) -> Path:
    """VCTK 0.92: ``wav48_silence_trimmed/<speaker>/<speaker>_<n>_mic{1,2}.flac``,
    48 kHz, ``txt/<speaker>/<speaker>_<n>.txt`` and ``speaker-info.txt``; 4
    speakers x 4 sentences of 1-4 s x 2 microphones."""
    corpus = root / "VCTK-Corpus-0.92"
    info = ["ID  AGE  GENDER  ACCENTS  REGION COMMENTS "]
    for spk, age, gender, accent, region in (
            ("p225", 23, "F", "English", "Southern England"),
            ("p226", 22, "M", "English", "Surrey"), ("p227", 38, "M", "English", "Cumbria"),
            ("p228", 22, "F", "English", "Southern England")):
        info.append(f"{spk}  {age}  {gender}    {accent}    {region}")
        for u in range(1, 5):
            utt = f"{spk}_{u:03d}"
            (corpus / "txt" / spk).mkdir(parents=True, exist_ok=True)
            (corpus / "txt" / spk / f"{utt}.txt").write_text(
                _words(rng, ENGLISH[:14]).capitalize() + ".\n")
            x = _tone_burst(rng, float(rng.uniform(1.0, 4.0)), 48000)
            for mic, gain in (("mic1", 1.0), ("mic2", 0.7)):
                _write_audio(corpus / "wav48_silence_trimmed" / spk / f"{utt}_{mic}.flac",
                             x * gain, 48000)
    (corpus / "speaker-info.txt").write_text("\n".join(info) + "\n")
    return corpus


def _write_voxceleb1(root: Path, rng) -> tuple:
    """VoxCeleb1: ``wav/<speaker>/<video>/<n>.wav``, 16 kHz, ``vox1_meta.csv``
    and a trials list as openslr/49's; 4 dev and 4 test speakers x 2 videos x
    2 utterances of 4-8 s; 12 target and 12 non-target trials among the test
    files and one of a dev file (which the recipe skips)."""
    corpus = root / "voxceleb1"
    meta, test_files = ["VoxCeleb1 ID\tVGGFace1 ID\tGender\tNationality\tSet"], []
    for k, spk in enumerate(("id10001", "id10002", "id10003", "id10004",
                             "id10270", "id10271", "id10272", "id10273")):
        split = "dev" if k < 4 else "test"
        meta.append(f"{spk}\tCeleb_{k}\t{'mf'[k % 2]}\t{('USA', 'UK', 'India')[k % 3]}\t{split}")
        for v in range(2):
            video = rng.bytes(8).hex()[:11]
            for u in (1, 2):
                rel = f"{spk}/{video}/{u:05d}.wav"
                _write_audio(corpus / "wav" / rel, _tone_burst(rng, float(rng.uniform(4, 8))), SR)
                if split == "test":
                    test_files.append(rel)
    trials = []
    while len(trials) < 24:
        a, b = (test_files[i] for i in rng.choice(len(test_files), 2, replace=False))
        target = int(a.split("/")[0] == b.split("/")[0])
        if sum(t.startswith(str(target)) for t in trials) < 12:
            trials.append(f"{target} {a} {b}")
    trials.append(f"0 {test_files[0]} id10001/unknown/00001.wav")
    (corpus / "vox1_meta.csv").write_text("\n".join(meta) + "\n")
    (corpus / "trials.txt").write_text("\n".join(trials) + "\n")
    return corpus, corpus / "trials.txt"


def _manifest_pairs(made) -> list:
    """The (recordings, supervisions) pairs a recipe made, at any depth of its
    result (MLS nests languages, VoxCeleb adds trial pairs beside them); a
    part without supervisions is left out."""
    if isinstance(made, dict):
        if "recordings" in made:  # BVCC's test parts hold no supervisions
            return [(made["recordings"], made["supervisions"])] if "supervisions" in made else []
        return [p for v in made.values() for p in _manifest_pairs(v)]
    return []


def _single_stream_specs(root: Path, rng) -> dict:
    """Per corpus of leg 3, in the order the legs run: the recipe's call for
    an output directory, the CLI's command, and the training path ("asr",
    "tts" or "pairs")."""
    from lhotse_tpu_torch import recipes as R

    yesno, aishell2 = _write_yesno(root, rng), _write_aishell2(root, rng)
    tedlium2, librilight = _write_tedlium2(root, rng), _write_librilight(root, rng)
    mls, peoples = _write_mls(root, rng), _write_peoples_speech(root, rng)
    spgi, timit = _write_spgispeech(root, rng), _write_timit(root, rng)
    libritts, librittsr = _write_libritts(root, rng), _write_libritts(root, rng, "LibriTTS_R")
    ljspeech, vctk = _write_ljspeech(root, rng), _write_vctk(root, rng)
    vox, trials = _write_voxceleb1(root, rng)
    tts_parts = ("dev-clean", "test-clean")
    specs = {
        "yesno": (lambda o: R.prepare_yesno(yesno, output_dir=o), ["yesno", yesno], "asr"),
        "aishell2": (lambda o: R.prepare_aishell2(aishell2, output_dir=o),
                     ["aishell2", aishell2], "asr"),
        "tedlium2": (lambda o: R.prepare_tedlium2(tedlium2, output_dir=o),
                     ["tedlium2", tedlium2], "asr"),
        "librilight": (lambda o: R.prepare_librilight(librilight, output_dir=o),
                       ["librilight", librilight], "asr"),
        "mls": (lambda o: R.prepare_mls(mls, output_dir=o, opus=False), ["mls", "--flac", mls],
                "asr"),
        "peoples_speech": (lambda o: R.prepare_peoples_speech(peoples, output_dir=o),
                           ["peoples-speech", peoples], "asr"),
        "spgispeech": (lambda o: R.prepare_spgispeech(spgi, o), ["spgispeech", spgi], "asr"),
        "timit": (lambda o: R.prepare_timit(timit, output_dir=o), ["timit", timit], "asr"),
        "libritts": (lambda o: R.prepare_libritts(libritts, dataset_parts=tts_parts, output_dir=o),
                     ["libritts", "-p", tts_parts[0], "-p", tts_parts[1], libritts], "tts"),
        "librittsr": (lambda o: R.prepare_librittsr(librittsr, dataset_parts=tts_parts,
                                                    output_dir=o),
                      ["librittsr", "-p", tts_parts[0], "-p", tts_parts[1], librittsr], "tts"),
        "ljspeech": (lambda o: R.prepare_ljspeech(ljspeech, output_dir=o),
                     ["ljspeech", ljspeech], "tts"),
        "vctk": (lambda o: R.prepare_vctk(vctk, output_dir=o, use_edinburgh_vctk_url=True),
                 ["vctk", "--use-edinburgh-vctk-url", vctk], "tts"),
        "voxceleb1": (lambda o: R.prepare_voxceleb(voxceleb1_root=vox, trials_path=trials,
                                                   output_dir=o),
                      ["voxceleb", "--voxceleb1", vox, "--trials-path", trials], "pairs"),
    }
    return specs


def _corpus_legs(manifests: Path, specs: dict, device, fbank_cuda, smi: str) -> tuple:
    """The ``corpus_<name>`` legs of phases 24, 26, 27 and 29: each corpus of
    ``specs`` (its recipe's call for an output directory, the CLI's command
    and the training path, "asr", "tts", "mos" or "pairs") →
    ``_prepare_twice`` → ``CutSet.from_manifests`` (or the ``CutSet`` the
    recipe made) → ``resample(16000)`` where the corpus is not at 16 kHz;
    the ASR corpora trimmed to their supervisions →
    ``SimpleCutSampler(max_duration=180)`` → ``K2SpeechRecognitionDataset``
    with ``OnTheFlyFeatures`` on the kernel → an AdamW step per batch; the
    TTS corpora → ``SpeechSynthesisDataset`` with ``OnTheFlyFeatures`` and a
    ``TokenCollater``; the MOS corpora's whole rated utterances →
    ``_WindowFeatures``; trial pairs → ``CutPairsSampler``, both sides on the
    kernel. Returns the kernel's launches per leg, the kernel-vs-plain
    errors and a summary per corpus."""
    from lhotse_tpu_torch.audio import RecordingSet
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.dataset import CutPairsSampler, SimpleCutSampler
    from lhotse_tpu_torch.dataset.collation import TokenCollater
    from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
    from lhotse_tpu_torch.dataset.loader import DataLoader
    from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
    from lhotse_tpu_torch.dataset.speech_synthesis import SpeechSynthesisDataset
    from lhotse_tpu_torch.features import Fbank, FbankConfig
    from lhotse_tpu_torch.supervision import SupervisionSet

    launches, errs = {}, []
    trainer, summary = _Trainer(device), {}
    for name, (function, argv, kind) in specs.items():
        made, files, function_s, cli_s = _prepare_twice(manifests, name, function, argv)
        if isinstance(made, CutSet):  # Emilia makes its cuts itself
            cuts = made
            made_ids = sorted(s.id for c in cuts for s in c.supervisions)
        else:
            pairs = _manifest_pairs(made)
            made_ids = sorted(s.id for _, sups in pairs for s in sups)
            cuts = CutSet.from_cuts(c for recs, sups in pairs for c in CutSet.from_manifests(
                recordings=RecordingSet.from_recordings(recs),
                supervisions=SupervisionSet.from_segments(sups)))
        rates = sorted({c.sampling_rate for c in cuts})
        fly = Fbank(FbankConfig(device=device))
        recorder = _RecordFirstBatch(fly)
        torch.cuda.synchronize()
        fbank_cuda.LAUNCHES = 0
        if kind == "pairs":
            sides = [CutSet.from_cuts([*made["pos_trials"][k], *made["neg_trials"][k]])
                     for k in (0, 1)]
            target_fly = Fbank(FbankConfig(device=device))
            target_recorder = _RecordFirstBatch(target_fly)
            datasets = [K2SpeechRecognitionDataset(return_cuts=True,
                                                   input_strategy=OnTheFlyFeatures(f))
                        for f in (fly, target_fly)]
            sampler = CutPairsSampler(*sides, max_source_duration=FLY_MAX_DURATION,
                                      max_target_duration=FLY_MAX_DURATION, shuffle=True, seed=0)
            run = _task_epoch(({"source": datasets[0][s], "target": datasets[1][t]}
                               for s, t in sampler), trainer, device,
                              lambda b: _rows_of(b["source"]))
            pos_ids = {c.id for c in made["pos_trials"][0]}
            ok, kept = True, []
            for b in run["batches"]:
                # The dataset orders each side by duration: pair the sides by id.
                target = {c.id: c for c in b["target"]["supervisions"]["cut"]}
                source = b["source"]["supervisions"]["cut"]
                ok &= sorted(target) == sorted(c.id for c in source) and all(
                    (c.supervisions[0].speaker == target[c.id].supervisions[0].speaker)
                    == (c.id in pos_ids) for c in source)
                kept += [c.id for c in source]
            ok &= sorted(kept) == sorted(c.id for c in sides[0])
            err = max(_first_batch_err(recorder, fly),
                      _first_batch_err(target_recorder, target_fly))
            want_launches = 2 * len(run["batches"])
            detail = (f"{len(sides[0])} trial pairs ({len(made['pos_trials'][0])} target), ids "
                      f"aligned and speakers as the trials say: {ok}")
        else:
            if rates != [SR]:
                cuts = cuts.resample(SR)
            if kind == "asr":
                cuts = cuts.trim_to_supervisions(keep_overlapping=False)
                dataset = K2SpeechRecognitionDataset(return_cuts=True,
                                                     input_strategy=OnTheFlyFeatures(fly))
                unpack, cuts_of = _rows_of, (lambda b: b["supervisions"]["cut"])
            elif kind == "mos":  # whole rated utterances, no transcript
                dataset = _WindowFeatures(OnTheFlyFeatures(fly))
                unpack = (lambda b: (b["inputs"], b["supervisions"]["num_frames"],
                                     sum(c.duration for c in b["supervisions"]["cut"])))
                cuts_of = (lambda b: b["supervisions"]["cut"])
            else:
                collater = TokenCollater(cuts)
                dataset = SpeechSynthesisDataset(feature_input_strategy=OnTheFlyFeatures(fly),
                                                 return_cuts=True, return_spk_ids=True)
                unpack = (lambda b: (b["features"], b["features_lens"],
                                     float(np.sum(b["audio_lens"])) / SR))
                cuts_of = (lambda b: b["cut"])
            cuts = cuts.to_eager()
            run = _task_epoch(DataLoader(
                SimpleCutSampler(cuts, max_duration=FLY_MAX_DURATION, shuffle=True, seed=0),
                dataset, prefetch_batches=3), trainer, device, unpack)
            kept = sorted(s.id for b in run["batches"] for c in cuts_of(b) for s in c.supervisions)
            ok = kept == made_ids and all(c.sampling_rate == SR for b in run["batches"]
                                          for c in cuts_of(b))
            if kind == "tts":
                ok = ok and all(collater.inverse(*collater(CutSet.from_cuts(b["cut"]))) == [
                    c.supervisions[0].text for c in b["cut"]] for b in run["batches"])
            if kind == "mos":
                ok = ok and all(c.supervisions[0].custom["MOS"] and all(
                    1 <= m <= 5 for m in c.supervisions[0].custom["MOS"].values())
                    for b in run["batches"] for c in cuts_of(b))
            err = _first_batch_err(recorder, fly)
            want_launches = len(run["batches"])
            detail = ("every supervision once at 16 kHz" + (
                ", TokenCollater.inverse() gives back every text" if kind == "tts" else "")
                      + (", each with its listeners' MOS ratings" if kind == "mos" else "")
                      + f": {ok}")
        launches[f"corpus_{name}"] = fbank_cuda.LAUNCHES
        rate = run["audio_s"] / run["elapsed_s"]
        summary[name] = {"made": len(made_ids), "kept": len(kept), "prepare_s": function_s,
                         "cli_s": cli_s, "audio-s/s": rate}
        print(f"[{smi}] corpus_{name}: {kind}, {rates} Hz; prepare {function_s!r} s, CLI "
              f"{cli_s!r} s, its {len(files)} manifests equal; supervisions made {len(made_ids)}, "
              f"kept {len(kept)}; {len(run['batches'])} batches, {run['audio_s']!r} audio-s in "
              f"{run['elapsed_s']!r} s (AdamW steps included): {rate!r} audio-s/s; {detail}; "
              f"fbank kernel launches {launches[f'corpus_{name}']}; first batch kernel vs plain "
              f"{err!r} (tol {KERNEL_TOL})")
        if launches[f"corpus_{name}"] != want_launches or not ok or not err <= KERNEL_TOL:
            raise AssertionError(f"corpus_{name}: launches, coverage or the kernel are off")
        errs.append(err)
    return launches, errs, summary


def _phase_single_stream(workdir: Path, device, fbank_cuda, smi: str) -> tuple:
    """24. The single-stream ASR, TTS and speaker corpora, in phase 14's
    directory after phase 23 (whose MUSAN noise and RIRS_NOISES manifests it
    reads). Every recipe runs as a function and through the CLI's
    ``prepare`` command, and their manifests must be equal.
    ``aishell_device_chain``: an AISHELL layout of as many utterances as the
    15 s x 256 bucket has rows → ``prepare_aishell`` → the bucket's int16
    batch → ``OnDeviceAugmenter`` with phase 23's MUSAN noise pool and real
    RIR, speed 1.1, SNR (10, 20) and SpecAugment (twice); the kernel against
    its plain version on the batch it got, the features against the same
    chain with the plain version. ``tedlium_long_form``: three TED-LIUM 3
    talks of 3-5 minutes → ``prepare_tedlium`` → the lazy
    ``CutSet.from_manifests`` → ``trim_to_supervisions()`` →
    ``DynamicBucketingSampler(max_duration=180)`` →
    ``K2SpeechRecognitionDataset`` with ``OnTheFlyFeatures`` on the kernel
    → ``DataLoader`` → an AdamW step of ``Encoder(EncoderConfig())`` per
    batch, then a resume after batch 2 whose batches must be ``torch.equal``.
    ``corpus_<name>``: each other corpus → ``prepare_*`` →
    ``CutSet.from_manifests`` → ``resample(16000)`` where the corpus is not
    at 16 kHz; the ASR corpora trimmed to their supervisions →
    ``SimpleCutSampler(max_duration=180)`` → ``K2SpeechRecognitionDataset``
    with ``OnTheFlyFeatures`` on the kernel → an AdamW step per batch; the
    TTS corpora → ``SpeechSynthesisDataset`` with ``OnTheFlyFeatures`` and a
    ``TokenCollater``; VoxCeleb1's trial pairs → ``CutPairsSampler``, both
    sides on the kernel. MLS's Opus route is held to the JAX package on the
    CPU only, and named as left out. Returns the kernel's launches per path
    and the largest kernel-vs-plain error."""
    from lhotse_tpu_torch.audio import RecordingSet
    from lhotse_tpu_torch.audio.syscodecs import opus_available
    from lhotse_tpu_torch.caching import set_caching_enabled
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
    from lhotse_tpu_torch.dataset.loader import DataLoader
    from lhotse_tpu_torch.dataset.sampling.dynamic_bucketing import DynamicBucketingSampler
    from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
    from lhotse_tpu_torch.features import Fbank, FbankConfig
    from lhotse_tpu_torch.recipes import prepare_aishell, prepare_tedlium
    from lhotse_tpu_torch.supervision import SupervisionSet
    from lhotse_tpu_torch.tracing import set_tracing_enabled

    set_caching_enabled(False)
    set_tracing_enabled(True)
    print(f"[{smi}] phase 24: corpus_mls_opus, MLS's opus=True route, is left out (the Opus and "
          f"Ogg libraries load here: {opus_available()}; the route is held to the JAX package on "
          "the CPU)")
    rng = np.random.RandomState(SINGLE_SEED)
    root = workdir / "single_stream"
    launches, errs = {}, []

    # -- aishell_device_chain --------------------------------------------------------------
    sec, bsz = BUCKET
    n = int(sec * SR)
    t0 = time.perf_counter()
    aishell_dir = _write_aishell(root, rng, bsz, sec)
    write_s = time.perf_counter() - t0
    made, files, function_s, cli_s = _prepare_twice(
        root / "manifests", "aishell",
        lambda o: prepare_aishell(aishell_dir, output_dir=o), ["aishell", aishell_dir])
    recordings = sorted((r for part in made.values() for r in part["recordings"]),
                        key=lambda r: r.id)
    made_sups = sum(len(part["supervisions"]) for part in made.values())
    audio, lens = np.zeros((bsz, n), np.float32), np.zeros(bsz, np.int64)
    for k, rec in enumerate(recordings):
        x = rec.load_audio()[0]
        audio[k, : x.size], lens[k] = x, x.size
    pool, rir, noise, rir_rec = _noise_pool_and_rir(workdir)
    print(f"[{smi}] aishell_device_chain: AISHELL layout of {len(recordings)} utterances "
          f"({float(lens.sum()) / SR!r} s) written in {write_s!r} s; prepare_aishell "
          f"{function_s!r} s (CLI {cli_s!r} s), the CLI's {len(files)} manifests equal to the function's; "
          f"supervisions made {made_sups}; noise pool {pool.shape} from phase 23's "
          f"{len(noise)} MUSAN noise recordings, RIR {rir_rec.id} ({rir.size} taps)")
    if len(recordings) != bsz or made_sups != bsz or lens.max() > n:
        raise AssertionError("aishell_device_chain: the prepared corpus does not fill the bucket")
    launches["aishell_device_chain"], kernel_err, chain_err = _device_chain(
        "aishell_device_chain", [(audio, lens)] * 2, pool, rir, device, fbank_cuda, smi)
    errs += [kernel_err, chain_err]

    # -- tedlium_long_form ----------------------------------------------------------------
    t0 = time.perf_counter()
    tedlium_dir = _write_tedlium(root, rng)
    write_s = time.perf_counter() - t0
    out = root / "manifests" / "tedlium" / "function"
    made, files, function_s, cli_s = _prepare_twice(
        root / "manifests", "tedlium",
        lambda o: prepare_tedlium(tedlium_dir, output_dir=o, dataset_parts="train"),
        ["tedlium", "-p", "train", tedlium_dir])
    made_ids = sorted(s.id for s in made["train"]["supervisions"])
    ignored = sum(line.endswith("ignore_time_segment_in_scoring")
                  for p in tedlium_dir.rglob("*.stm") for line in p.read_text().splitlines())
    talk_s = sum(r.duration for r in made["train"]["recordings"])

    def tedlium_loader():
        cuts = CutSet.from_manifests(
            RecordingSet.from_file(out / "tedlium_recordings_train.jsonl.gz"),
            SupervisionSet.from_file(out / "tedlium_supervisions_train.jsonl.gz"),
            lazy=True, output_path=root / "tedlium_cuts.jsonl.gz").trim_to_supervisions()
        fly = Fbank(FbankConfig(device=device))
        sampler = DynamicBucketingSampler(cuts, max_duration=FLY_MAX_DURATION, shuffle=True, seed=0)
        return DataLoader(sampler, K2SpeechRecognitionDataset(
            return_cuts=True, input_strategy=OnTheFlyFeatures(fly)), prefetch_batches=3), fly

    loader, fly = tedlium_loader()
    recorder = _RecordFirstBatch(fly)
    state = {}

    def checkpoint(i, batch):
        if i == TEDLIUM_RESUME_AFTER - 1:
            state["ckpt"] = loader.state_dict()

    run = _leg("tedlium_long_form", loader, _Trainer(device), device, fbank_cuda, _rows_of, smi,
               on_batch=checkpoint)
    launches["tedlium_long_form"] = run["launches"]
    err = _first_batch_err(recorder, fly)
    resumed_loader, _ = tedlium_loader()
    resumed_loader.load_state_dict(state["ckpt"])
    resumed = list(resumed_loader)
    want = run["batches"][TEDLIUM_RESUME_AFTER:]
    resume_equal = len(resumed) == len(want) and all(
        torch.equal(torch.from_numpy(a["inputs"]), torch.from_numpy(b["inputs"]))
        and a["supervisions"]["text"] == b["supervisions"]["text"] for a, b in zip(resumed, want))
    covered = sorted(s.id for b in run["batches"] for c in b["supervisions"]["cut"]
                     for s in c.supervisions)
    print(f"[{smi}] tedlium_long_form: {len(TEDLIUM_TALKS)} SPHERE talks of {talk_s!r} s written "
          f"in {write_s!r} s; prepare_tedlium {function_s!r} s (CLI {cli_s!r} s), the CLI's "
          f"{len(files)} manifests equal to the function's; STM segments made {len(made_ids)} "
          f"({ignored} ignore_time_segment_in_scoring lines dropped), kept {len(covered)}, every "
          f"one once: {covered == made_ids}; first batch kernel vs plain {err!r} (tol "
          f"{KERNEL_TOL}); resumed after batch {TEDLIUM_RESUME_AFTER} through a fresh loader: "
          f"{len(resumed)} batches torch.equal to the uninterrupted run's: {resume_equal}")
    if run["launches"] != len(run["batches"]) or len(run["batches"]) <= TEDLIUM_RESUME_AFTER:
        raise AssertionError("tedlium_long_form: launches or the batch count are off")
    if covered != made_ids or not ignored or not resume_equal or not err <= KERNEL_TOL:
        raise AssertionError("tedlium_long_form: coverage, the resume or the kernel are off")
    errs.append(err)

    # -- corpus_<name> ----------------------------------------------------------------------
    t0 = time.perf_counter()
    specs = _single_stream_specs(root / "corpora", rng)
    print(f"[{smi}] corpora ({', '.join(specs)}) written in {time.perf_counter() - t0!r} s")
    corpus_launches, corpus_errs, summary = _corpus_legs(root / "manifests", specs, device,
                                                         fbank_cuda, smi)
    launches.update(corpus_launches)
    errs += corpus_errs
    print(f"[{smi}] phase 24 corpora: {summary}")
    set_tracing_enabled(False)
    return launches, max(errs)


MUX_SEED = 2525
MUX_WEIGHTS = [1, 1]
MUX_MVN_CUTS = 64  # cuts of the muxed stream that GlobalMVN's statistics are computed over
MUX_RESUME_AFTER = 3
INFINITE_BATCHES = 6  # batches of infinite_mux_shar before its checkpoint
INFINITE_RESUMED = 2  # batches after it, uninterrupted and resumed
SMOOTHING_CUTS = 32


def _batches_of(cuts, n: int):
    """Batches of ``n`` cuts taken straight off an endless CutSet: a sampler
    with no ``state_dict``."""
    from lhotse_tpu_torch.cut import CutSet

    it = iter(cuts)
    while True:
        yield CutSet.from_cuts([next(it) for _ in range(n)])


def _phase_muxed(workdir: Path, shar_dir: Path, device, fbank_cuda, smi: str) -> tuple:
    """25. Two corpora muxed into training, in phase 14's directory after
    phase 24, and phase 13's Shar shards. ``mux_on_the_fly``: phase 14's
    LibriSpeech cuts and phase 24's AISHELL cuts (both 16 kHz) →
    ``CutSet.mux(weights=[1, 1], seed=2525)`` over their lazy manifests →
    ``DynamicBucketingSampler(max_duration=180)`` →
    ``K2SpeechRecognitionDataset`` with ``OnTheFlyFeatures`` on the kernel
    and ``input_transforms=[GlobalMVN.from_cuts(...), SpecAugment(...)]``
    (the statistics from the kernel's features of the stream's first 64
    cuts) → ``DataLoader(checkpoint_objects=[specaugment])`` → an AdamW step
    of ``Encoder(EncoderConfig())`` per batch, one epoch; after batch 3 a
    ``DataloaderCheckpoint`` of the loader's state (the sampler's and
    SpecAugment's) written to JSON, read back into a fresh loader, whose
    batches must be ``torch.equal`` to the uninterrupted run's. Then
    ``GlobalMVN`` on the card's features against its numpy apply, and
    ``RandomizedSmoothing`` on a card batch of 32 cuts' audio against the
    same transform's CPU result moved to the card (``torch.equal``).
    ``infinite_mux_shar``: ``CutSet.infinite_mux`` over the 8 Shar shards
    (one source per shard, at most 2 open) → ``DynamicCutSampler`` →
    ``OnTheFlyFeatures`` on the kernel → the step, for 6 + 2 batches. As in
    the JAX package, the sampler keeps no graph state over the mux and
    ``loader.state_dict()`` falls back to replaying its batches: a
    checkpoint after batch 6 resumes the next 2 batches ``torch.equal``; a
    loader whose batches come straight off the mux (a sampler with no
    state) iterates and refuses ``state_dict()``. Returns the kernel's
    launches per path and the largest kernel-vs-plain error."""
    import itertools

    from lhotse_tpu_torch import CutSet, RecordingSet, SupervisionSet
    from lhotse_tpu_torch.caching import set_caching_enabled
    from lhotse_tpu_torch.checkpoint import DataloaderCheckpoint
    from lhotse_tpu_torch.dataset import (
        DataLoader, DynamicBucketingSampler, DynamicCutSampler, GlobalMVN,
        K2SpeechRecognitionDataset, OnTheFlyFeatures, RandomizedSmoothing, SpecAugment)
    from lhotse_tpu_torch.features import Fbank, FbankConfig
    from lhotse_tpu_torch.tracing import set_tracing_enabled

    set_caching_enabled(False)
    set_tracing_enabled(True)
    launches, errs = {}, []
    trainer = _Trainer(device)

    # -- mux_on_the_fly --------------------------------------------------------------------
    libri_path = workdir / "recipe_cuts.jsonl.gz"
    made = workdir / "single_stream" / "manifests" / "aishell" / "function"
    aishell_path = workdir / "mux_aishell_cuts.jsonl.gz"
    CutSet.from_cuts(c for part in ("train", "dev", "test") for c in CutSet.from_manifests(
        RecordingSet.from_file(made / f"aishell_recordings_{part}.jsonl.gz"),
        SupervisionSet.from_file(made / f"aishell_supervisions_{part}.jsonl.gz"))).to_file(
        aishell_path)
    corpora = {"librispeech": libri_path, "aishell": aishell_path}
    ids = {name: {c.id for c in CutSet.from_jsonl_lazy(p)} for name, p in corpora.items()}
    rates = {c.sampling_rate for p in corpora.values() for c in CutSet.from_jsonl_lazy(p)}

    def muxed():
        return CutSet.mux(*(CutSet.from_jsonl_lazy(p) for p in corpora.values()),
                          weights=MUX_WEIGHTS, seed=MUX_SEED)

    t0 = time.perf_counter()
    mvn = GlobalMVN.from_cuts(muxed(), max_cuts=MUX_MVN_CUTS,
                              extractor=Fbank(FbankConfig(device=device)))
    mvn_s = time.perf_counter() - t0

    def mux_loader(seed):
        fly = Fbank(FbankConfig(device=device))
        specaug = SpecAugment(seed=seed)
        dataset = K2SpeechRecognitionDataset(
            return_cuts=True, input_strategy=OnTheFlyFeatures(fly),
            input_transforms=[mvn, specaug])
        sampler = DynamicBucketingSampler(muxed(), max_duration=FLY_MAX_DURATION, shuffle=True,
                                          seed=0)
        return DataLoader(sampler, dataset, prefetch_batches=3,
                          checkpoint_objects=[specaug]), fly

    loader, fly = mux_loader(MUX_SEED)
    recorder = _RecordFirstBatch(fly)
    ckpt_path = workdir / "mux_checkpoint.json"

    def checkpoint(i, batch):
        if i == MUX_RESUME_AFTER - 1:
            DataloaderCheckpoint(num_workers=0, world_size=1, rank=0,
                                 sampler_state=loader.state_dict()).save(ckpt_path)

    run = _leg("mux_on_the_fly", loader, trainer, device, fbank_cuda, _rows_of, smi,
               on_batch=checkpoint)
    launches["mux_on_the_fly"] = run["launches"]
    err = _first_batch_err(recorder, fly)
    ckpt = DataloaderCheckpoint.load(ckpt_path)
    ckpt.validate(num_workers=0, world_size=1, rank=0)
    resumed_loader, _ = mux_loader(seed=0)  # SpecAugment's state comes from the file
    resumed_loader.load_state_dict(ckpt.sampler_state)
    resumed = list(resumed_loader)
    want = run["batches"][MUX_RESUME_AFTER:]
    resume_equal = len(resumed) == len(want) and all(
        [c.id for c in a["supervisions"]["cut"]] == [c.id for c in b["supervisions"]["cut"]]
        and torch.equal(torch.from_numpy(a["inputs"]), torch.from_numpy(b["inputs"]))
        for a, b in zip(resumed, want))
    seen = [c.id for b in run["batches"] for c in b["supervisions"]["cut"]]
    first = [c.id for c in run["batches"][0]["supervisions"]["cut"]]
    mixed_batches = sum(
        len({name for c in b["supervisions"]["cut"] for name, s in ids.items() if c.id in s}) == 2
        for b in run["batches"])
    items, kernel_out = recorder.first
    mvn_err = max(float((mvn(torch.from_numpy(f).to(device)).cpu()
                         - torch.from_numpy(mvn(f))).abs().max()) for f in kernel_out)
    print(f"[{smi}] mux_on_the_fly: {len(ids['librispeech'])} LibriSpeech and "
          f"{len(ids['aishell'])} AISHELL cuts at {sorted(rates)} Hz muxed with weights "
          f"{MUX_WEIGHTS}, seed {MUX_SEED}; GlobalMVN statistics over {MUX_MVN_CUTS} cuts on the "
          f"kernel in {mvn_s!r} s; {len(run['batches'])} batches, {mixed_batches} of them holding "
          f"both corpora; every cut once: {sorted(seen) == sorted(set().union(*ids.values()))}; "
          f"first batch kernel vs plain {err!r} (tol {KERNEL_TOL}); GlobalMVN on the card's "
          f"features in their dtype vs its numpy apply {mvn_err!r}; DataloaderCheckpoint after "
          f"batch {MUX_RESUME_AFTER} ({ckpt_path.stat().st_size} bytes of JSON) read into a fresh "
          f"loader: {len(resumed)} batches torch.equal to the uninterrupted run's: {resume_equal}")
    if run["launches"] != len(run["batches"]) or len(run["batches"]) <= MUX_RESUME_AFTER:
        raise AssertionError("mux_on_the_fly: launches or the batch count are off")
    if sorted(seen) != sorted(set().union(*ids.values())) or not mixed_batches:
        raise AssertionError("mux_on_the_fly: the muxed epoch does not cover both corpora once")
    if not resume_equal or not err <= KERNEL_TOL or not mvn_err <= 1e-6 or rates != {SR}:
        raise AssertionError("mux_on_the_fly: the resume, the kernel or GlobalMVN are off")
    errs.append(err)

    audio, _ = CutSet.from_jsonl_lazy(aishell_path).subset(first=SMOOTHING_CUTS).to_eager() \
        .load_audio(collate=True)
    audio = torch.from_numpy(audio)
    smoothed = RandomizedSmoothing(sigma=0.1, p=0.5, seed=MUX_SEED)(audio.to(device))
    on_cpu = RandomizedSmoothing(sigma=0.1, p=0.5, seed=MUX_SEED)(audio)
    smoothing_equal = (smoothed.device.type == torch.device(device).type
                       and torch.equal(smoothed, on_cpu.to(device)))
    print(f"[{smi}] RandomizedSmoothing on a card batch {tuple(audio.shape)} of {SMOOTHING_CUTS} "
          f"AISHELL cuts: torch.equal to the CPU result moved to the card: {smoothing_equal}; "
          f"rows changed {int((smoothed != audio.to(device)).any(dim=1).sum())}")
    if not smoothing_equal:
        raise AssertionError("RandomizedSmoothing on the card differs from the CPU")

    # -- infinite_mux_shar -------------------------------------------------------------------
    shards = sorted(shar_dir.glob("cuts.*.jsonl"))
    tars = sorted(shar_dir.glob("recording.*.tar"))
    shar_ids = {c.id for p in shards for c in CutSet.from_jsonl_lazy(p)}

    def infinite():
        sources = [CutSet.from_shar(fields={"cuts": [str(c)], "recording": [str(r)]})
                   for c, r in zip(shards, tars)]
        return CutSet.infinite_mux(*sources, seed=MUX_SEED, max_open_streams=2)

    def shar_loader():
        fly = Fbank(FbankConfig(device=device))
        dataset = K2SpeechRecognitionDataset(return_cuts=True,
                                             input_strategy=OnTheFlyFeatures(fly))
        return DataLoader(DynamicCutSampler(infinite(), max_duration=FLY_MAX_DURATION), dataset,
                          prefetch_batches=3), fly, dataset

    loader, fly, dataset = shar_loader()
    recorder = _RecordFirstBatch(fly)
    state = {}

    def keep_state(i, batch):
        if i == INFINITE_BATCHES - 1:
            state["ckpt"] = loader.state_dict()

    threads_before = set(threading.enumerate())
    it = iter(loader)
    run = _leg("infinite_mux_shar", itertools.islice(it, INFINITE_BATCHES + INFINITE_RESUMED),
               trainer, device, fbank_cuda, _rows_of, smi, on_batch=keep_state)
    _close_and_join(it, threads_before)
    launches["infinite_mux_shar"] = run["launches"]
    err = _first_batch_err(recorder, fly)
    DataloaderCheckpoint(num_workers=0, world_size=1, rank=0,
                         sampler_state=state["ckpt"]).save(workdir / "infinite_checkpoint.json")
    replay = "cuts_state" not in state["ckpt"]["sampler"]
    resumed_loader, _, _ = shar_loader()
    resumed_loader.load_state_dict(
        DataloaderCheckpoint.load(workdir / "infinite_checkpoint.json").sampler_state)
    threads_before = set(threading.enumerate())
    it = iter(resumed_loader)
    resumed = list(itertools.islice(it, INFINITE_RESUMED))
    _close_and_join(it, threads_before)
    want = run["batches"][INFINITE_BATCHES:]
    resume_equal = len(resumed) == len(want) == INFINITE_RESUMED and all(
        [c.id for c in a["supervisions"]["cut"]] == [c.id for c in b["supervisions"]["cut"]]
        and torch.equal(torch.from_numpy(a["inputs"]), torch.from_numpy(b["inputs"]))
        for a, b in zip(resumed, want))
    drawn = [c.id for b in run["batches"] for c in b["supervisions"]["cut"]]
    stateless = DataLoader(_batches_of(infinite(), 4), dataset, prefetch_batches=1)
    threads_before = set(threading.enumerate())
    it = iter(stateless)
    next(it)
    try:
        stateless.state_dict()
        refused = "nothing"
    except AttributeError as e:
        refused = f"AttributeError: {e}"
    _close_and_join(it, threads_before)
    print(f"[{smi}] infinite_mux_shar: {len(shards)} Shar shards of {len(shar_ids)} cuts, one "
          f"source each, at most 2 open; {len(run['batches'])} batches of {len(drawn)} cuts "
          f"({len(set(drawn))} distinct, all from the shards: {set(drawn) <= shar_ids}), "
          f"{run['launches']} launches with the producer's prefetched batches; first "
          f"batch kernel vs plain {err!r} (tol {KERNEL_TOL}); loader.state_dict() after batch "
          f"{INFINITE_BATCHES} keeps no graph state (replay, as the JAX package's): {replay}; "
          f"resumed from its JSON file: {len(resumed)} batches torch.equal to the uninterrupted "
          f"run's: {resume_equal}; a loader over batches straight off the mux refuses "
          f"state_dict(): {refused}")
    # The loader's producer assembles up to its prefetch depth (and one in hand) past the
    # batches taken before the iterator is closed.
    if not len(drawn) or not set(drawn) <= shar_ids or not (
            len(run["batches"]) <= run["launches"] <= len(run["batches"]) + 3 + 1):
        raise AssertionError("infinite_mux_shar: launches or the drawn cuts are off")
    if not replay or not resume_equal or refused == "nothing" or not err <= KERNEL_TOL:
        raise AssertionError("infinite_mux_shar: the checkpoint, the resume or the kernel are off")
    errs.append(err)
    set_tracing_enabled(False)
    return launches, max(errs)


ZH_SEED = 2626
ZH_FILES = 32  # utterances of each multi_zh-hans corpus: 8 x 32 fill the 15 s x 256 bucket
ZH_SECONDS = (2.0, 15.0)
ZH_CORPUS_FILES = 16  # files of each corpus_<name> leg of phase 26
ZH_CORPUS_SECONDS = (2.0, 8.0)
ZH_TTS_SECONDS = (2.0, 6.0)
ZH_WEIGHTS = [1] * 8
KESPEECH_PARTS = ("train_phase1", "dev_phase1", "test")
KESPEECH_SUBDIALECTS = ("Mandarin", "Beijing", "Southwestern", "Zhongyuan", "Northeastern",
                        "Lan-Yin", "Jiang-Huai", "Ji-Lu", "Jiao-Liao")
CODE_SWITCH = MANDARIN[:11] + ("hello", "world", "Ａpp", "ＨＩ", "email")
TIBETAN = ("བཀྲ་ཤིས་", "བདེ་ལེགས།", "ང་", "ཁྱེད་རང་", "ལ་", "དགའ་པོ་", "ཡོད།", "སློབ་གྲྭ་")
CANTONESE = ("佢", "哋", "喺", "度", "食", "緊", "嘢", "我", "唔", "係", "好", "鍾意")
HANZI_PINYIN = (("你", "ni3"), ("好", "hao3"), ("世", "shi4"), ("界", "jie4"), ("早", "zao3"),
                ("上", "shang4"), ("学", "xue2"), ("生", "sheng1"), ("老", "lao3"), ("师", "shi1"))


def _zh_split(i: int, n: int = 0, names=("train", "dev", "test")) -> str:
    """Three in four of ``n`` (``ZH_FILES`` if 0) files in the first split,
    one in eight in each other."""
    n = n or ZH_FILES
    return names[0] if i < n * 3 // 4 else names[1] if i < n * 7 // 8 else names[2]


def _zh_burst(rng, seconds=ZH_SECONDS, sr: int = SR) -> np.ndarray:
    return _tone_burst(rng, float(rng.uniform(*seconds)), sr)


def _write_thchs_30(root: Path, rng) -> Path:
    """THCHS-30 (openslr/18): ``data_thchs30/data/<speaker>_<n>.wav``, 16 kHz,
    each with a ``.wav.trn`` of three lines (characters, pinyin, phones), and
    the splits ``data_thchs30/{train,dev,test}`` of symbolic links into
    ``data``; 24 + 4 + 4 utterances of 2-15 s."""
    corpus = root / "thchs_30"
    data = corpus / "data_thchs30" / "data"
    for i in range(ZH_FILES):
        utt = f"{'ABCD'[i % 4]}{(2, 11, 12, 32)[i // 8]}_{100 + i}"
        _write_audio(data / f"{utt}.wav", _zh_burst(rng), SR)
        (data / f"{utt}.wav.trn").write_text(
            f"{_words(rng, MANDARIN, 4, 12)} l =\nlv4 shi4 yang2 chun1\nl v4 sh ix4\n",
            encoding="utf-8")
        link = corpus / "data_thchs30" / _zh_split(i) / f"{utt}.wav"
        link.parent.mkdir(parents=True, exist_ok=True)
        link.symlink_to(Path("..") / "data" / f"{utt}.wav")
    return corpus


def _write_stcmds(root: Path, rng) -> Path:
    """ST-CMDS (openslr/38): ``ST-CMDS-20170001_1-OS/20170001P<speaker><n>.wav``,
    16 kHz, a ``.txt`` transcript beside each; 32 utterances of 2-15 s by 4
    speakers."""
    corpus = root / "stcmds"
    base = corpus / "ST-CMDS-20170001_1-OS"
    for i in range(ZH_FILES):
        utt = f"20170001P{241 + i % 4:05d}{'AI'[i % 2]}{i // 4 + 1:04d}"
        _write_audio(base / f"{utt}.wav", _zh_burst(rng), SR)
        (base / f"{utt}.txt").write_text(_words(rng, MANDARIN, 2, 8, sep="，"), encoding="utf-8")
    return corpus


def _write_primewords(root: Path, rng) -> Path:
    """Primewords (openslr/47): ``primewords_md_2018_set1/audio_files/<h>/<hh>/
    <md5>.wav``, 16 kHz, and ``set1_transcript.json`` (id, text, length,
    file, user_id); 32 utterances of 2-15 s by 6 speakers."""
    import hashlib

    corpus = root / "primewords"
    base = corpus / "primewords_md_2018_set1"
    table = []
    for i in range(ZH_FILES):
        name = hashlib.md5(f"primewords-{i}".encode()).hexdigest()
        _write_audio(base / "audio_files" / name[0] / name[:2] / f"{name}.wav", _zh_burst(rng), SR)
        text = _words(rng, MANDARIN, 3, 10)
        table.append({"id": str(i), "text": text, "length": len(text.split()),
                      "file": f"{name}.wav", "user_id": str(1000 + i % 6)})
    (base / "set1_transcript.json").write_text(json.dumps(table, ensure_ascii=False),
                                               encoding="utf-8")
    return corpus


def _write_magicdata(root: Path, rng) -> Path:
    """MagicData (openslr/68): ``{train,dev,test}/<speaker>/<utt>.wav``, 16 kHz,
    and a tab-separated ``TRANS.txt`` per split (UtteranceID, SpeakerID,
    Transcription); 24 + 4 + 4 utterances of 2-15 s."""
    corpus = root / "magicdata"
    rows = {}
    for i in range(ZH_FILES):
        split = _zh_split(i)
        spk = f"{dict(train=38, dev=5, test=9)[split]}_{5700 + i % 4}"
        utt = f"{spk}_{20170915093000 + i}"
        _write_audio(corpus / split / spk / f"{utt}.wav", _zh_burst(rng), SR)
        rows.setdefault(split, ["UtteranceID\tSpeakerID\tTranscription"]).append(
            f"{utt}.wav\t{spk}\t{_words(rng, MANDARIN, 3, 10, sep='')}！[FIL]")
    for split, lines in rows.items():
        (corpus / split / "TRANS.txt").write_text("\n".join(lines) + "\n", encoding="utf-8")
    return corpus


def _write_aidatatang(root: Path, rng) -> Path:
    """aidatatang_200zh (openslr/62): ``aidatatang_200zh/corpus/{train,dev,test}/
    <speaker>/T0055<speaker>S<n>.wav``, 16 kHz, and one transcript file;
    24 + 4 + 4 utterances of 2-15 s, 4 per speaker."""
    corpus = root / "aidatatang"
    d = corpus / "aidatatang_200zh"
    lines = []
    for i in range(ZH_FILES):
        spk = f"G{13 + i // 4:04d}"
        utt = f"T0055{spk}S{i % 4 + 1:04d}"
        _write_audio(d / "corpus" / _zh_split(i) / spk / f"{utt}.wav", _zh_burst(rng), SR)
        lines.append(f"{utt} {_words(rng, MANDARIN, 3, 10)}")
    (d / "transcript").mkdir(parents=True)
    (d / "transcript" / "aidatatang_200_zh_transcript.txt").write_text(
        "\n".join(lines) + "\n", encoding="utf-8")
    return corpus


def _write_kespeech(root: Path, rng) -> Path:
    """KeSpeech: ``Audio/<speaker>/phase1/<utt>.wav``, 16 kHz, and the
    Kaldi-style ``Tasks/ASR/<part>/{wav.scp,text,utt2subdialect,utt2spk}``;
    24 utterances in train_phase1, 4 in dev_phase1 and 4 in test, of
    2-15 s, over the subdialects."""
    corpus = root / "KeSpeech"
    rows = {}
    for i in range(ZH_FILES):
        part = _zh_split(i, names=KESPEECH_PARTS)
        spk = str(1000142 + i % 5)
        utt = f"{spk}_{0x5a0e8f5d + i:08x}"
        rel = f"Audio/{spk}/phase1/{utt}.wav"
        _write_audio(corpus / rel, _zh_burst(rng), SR)
        rows.setdefault(part, []).append(
            (utt, rel, f"<SPOKEN_NOISE>{_words(rng, MANDARIN, 3, 10, sep='')}",
             KESPEECH_SUBDIALECTS[i % len(KESPEECH_SUBDIALECTS)], spk))
    for part, entries in rows.items():
        task = corpus / "Tasks" / "ASR" / part
        task.mkdir(parents=True)
        entries.sort()
        for name, k in (("wav.scp", 1), ("text", 2), ("utt2subdialect", 3), ("utt2spk", 4)):
            (task / name).write_text("".join(f"{e[0]} {e[k]}\n" for e in entries),
                                     encoding="utf-8")
    return corpus


def _zh_multi_specs(root: Path, rng) -> dict:
    """The members of icefall's multi_zh-hans mix that the port prepares, in
    its order (WenetSpeech, AISHELL-4 and AliMeeting left out): the recipe's
    call for an output directory and the CLI's command."""
    from lhotse_tpu_torch import recipes as R

    thchs, stcmds = _write_thchs_30(root, rng), _write_stcmds(root, rng)
    primewords, magicdata = _write_primewords(root, rng), _write_magicdata(root, rng)
    aidatatang, kespeech = _write_aidatatang(root, rng), _write_kespeech(root, rng)
    aishell = _write_aishell(root, rng, ZH_FILES, ZH_SECONDS[1])
    aishell2 = _write_aishell2(root / "aishell2", rng)
    ke_argv = [a for part in KESPEECH_PARTS for a in ("-p", part)]
    return {
        "thchs_30": (lambda o: R.prepare_thchs_30(thchs, output_dir=o), ["thchs-30", thchs]),
        "stcmds": (lambda o: R.prepare_stcmds(stcmds, output_dir=o), ["stcmds", stcmds]),
        "primewords": (lambda o: R.prepare_primewords(primewords, output_dir=o),
                       ["primewords", primewords]),
        "magicdata": (lambda o: R.prepare_magicdata(magicdata, output_dir=o),
                      ["magicdata", magicdata]),
        "aidatatang_200zh": (lambda o: R.prepare_aidatatang_200zh(aidatatang, output_dir=o),
                             ["aidatatang-200zh", aidatatang]),
        "kespeech": (lambda o: R.prepare_kespeech(kespeech, output_dir=o,
                                                  dataset_parts=list(KESPEECH_PARTS)),
                     ["kespeech", *ke_argv, kespeech]),
        "aishell": (lambda o: R.prepare_aishell(aishell, output_dir=o), ["aishell", aishell]),
        "aishell2": (lambda o: R.prepare_aishell2(aishell2, output_dir=o),
                     ["aishell2", aishell2]),
    }


def _write_tal_asr(root: Path, rng) -> Path:
    """TAL-ASR: ``aisolution_data/wav/{train,dev,test}/<speaker>/<utt>.wav``,
    16 kHz, and ``aisolution_data/transcript/transcript.txt``; 12 + 2 + 2
    utterances of 2-8 s."""
    corpus = root / "tal_asr"
    base = corpus / "aisolution_data"
    lines = []
    for i in range(ZH_CORPUS_FILES):
        spk = f"T{i // 4:03d}"
        utt = f"{spk}_{i:05d}"
        _write_audio(base / "wav" / _zh_split(i, ZH_CORPUS_FILES) / spk / f"{utt}.wav",
                     _zh_burst(rng, ZH_CORPUS_SECONDS), SR)
        lines.append(f"{utt} {_words(rng, MANDARIN, 3, 10, sep='，')}。")
    (base / "transcript").mkdir(parents=True)
    (base / "transcript" / "transcript.txt").write_text("\n".join(lines) + "\n", encoding="utf-8")
    return corpus


def _write_tal_csasr(root: Path, rng) -> Path:
    """TAL-CSASR: ``TALCS_corpus/{train_set,dev_set,test_set}/wav/<utt>.wav``,
    16 kHz, and a ``label.txt`` per split of Mandarin-English text; 12 + 2 +
    2 utterances of 2-8 s."""
    corpus = root / "tal_csasr"
    rows = {}
    for i in range(ZH_CORPUS_FILES):
        split = _zh_split(i, ZH_CORPUS_FILES, ("train_set", "dev_set", "test_set"))
        utt = f"{split[:2]}_{i:06d}"
        _write_audio(corpus / "TALCS_corpus" / split / "wav" / f"{utt}.wav",
                     _zh_burst(rng, ZH_CORPUS_SECONDS), SR)
        rows.setdefault(split, []).append(f"{utt} {_words(rng, CODE_SWITCH, 3, 10)}！")
    for split, lines in rows.items():
        (corpus / "TALCS_corpus" / split / "label.txt").write_text(
            "\n".join(lines) + "\n", encoding="utf-8")
    return corpus


def _write_cdsd(root: Path, rng) -> Path:
    """CDSD: ``after_catting/{1h,10h}/Audio/<speaker>/<utt>.wav``, 16 kHz, and
    a transcript shard per speaker under ``Text/``; 8 utterances of 2-8 s by
    4 speakers in 1h, 8 by one speaker in 10h."""
    corpus = root / "cdsd"
    for part, speakers in (("1h", ("S01", "S02", "S03", "S04")), ("10h", ("S05",))):
        shards = {}
        for k in range(ZH_CORPUS_FILES // 2):
            spk = speakers[k % len(speakers)]
            utt = f"{spk}_{part}_{k:04d}"
            _write_audio(corpus / "after_catting" / part / "Audio" / spk / f"{utt}.wav",
                         _zh_burst(rng, ZH_CORPUS_SECONDS), SR)
            shards.setdefault(spk, []).append(f"{utt} {_words(rng, MANDARIN, 3, 10)}")
        (corpus / "after_catting" / part / "Text").mkdir(parents=True)
        for spk, lines in shards.items():
            (corpus / "after_catting" / part / "Text" / f"{spk}.txt").write_text(
                "\n".join(lines) + "\n", encoding="utf-8")
    return corpus


def _write_speechio(root: Path, rng) -> Path:
    """SpeechIO: ``SPEECHIO_ASR_ZH000NN/wav/<id>.wav``, 16 kHz, with a
    ``metadata.tsv`` of ID/AUDIO/DURATION/TEXT columns; two test sets of 8
    utterances of 2-8 s."""
    corpus = root / "speechio"
    for s, part in enumerate(("SPEECHIO_ASR_ZH00000", "SPEECHIO_ASR_ZH00001")):
        rows = ["ID\tAUDIO\tDURATION\tTEXT"]
        for k in range(ZH_CORPUS_FILES // 2):
            uid = f"S{s}SPK{k % 3}_{k:04d}"
            x = _zh_burst(rng, ZH_CORPUS_SECONDS)
            _write_audio(corpus / part / "wav" / f"{uid}.wav", x, SR)
            text = _words(rng, MANDARIN, 3, 10, sep="")
            rows.append(f"{uid}\twav/{uid}.wav\t{x.size / SR:.3f}\t{text}")
        (corpus / part / "metadata.tsv").write_text("\n".join(rows) + "\n", encoding="utf-8")
    return corpus


def _write_xbmu_amdo31(root: Path, rng) -> Path:
    """XBMU-AMDO31: ``data/wav/{train,dev,test}/<speaker>/<speaker>-<utt>.wav``,
    16 kHz, and ``data/transcript/transcript_clean.txt`` in Tibetan; 12 + 2
    + 2 utterances of 2-8 s."""
    corpus = root / "xbmu_amdo31"
    lines = []
    for i in range(ZH_CORPUS_FILES):
        spk, utt = f"A{i // 4:02d}", f"U{i:05d}"
        _write_audio(corpus / "data" / "wav" / _zh_split(i, ZH_CORPUS_FILES) / spk
                     / f"{spk}-{utt}.wav", _zh_burst(rng, ZH_CORPUS_SECONDS), SR)
        lines.append(f"{utt} {_words(rng, TIBETAN, 2, 8)}")
    (corpus / "data" / "transcript").mkdir(parents=True)
    (corpus / "data" / "transcript" / "transcript_clean.txt").write_text(
        "\n".join(lines) + "\n", encoding="utf-8")
    return corpus


def _write_mdcc(root: Path, rng) -> Path:
    """MDCC: ``dataset/audio/<name>.wav``, 16 kHz, ``transcription/<name>.txt``
    in Cantonese and ``cnt_asr_{train,valid,test}_metadata.csv``
    (audio_path,text_path,gender,duration); 12 + 2 + 2 utterances of 2-8 s."""
    corpus = root / "mdcc" / "dataset"
    rows = {}
    for i in range(ZH_CORPUS_FILES):
        name = f"447_{1711162210 + i}_{i:05d}"
        x = _zh_burst(rng, ZH_CORPUS_SECONDS)
        _write_audio(corpus / "audio" / f"{name}.wav", x, SR)
        (corpus / "transcription").mkdir(exist_ok=True)
        (corpus / "transcription" / f"{name}.txt").write_text(
            _words(rng, CANTONESE, 3, 10, sep=""), encoding="utf-8")
        rows.setdefault(_zh_split(i, ZH_CORPUS_FILES, ("train", "valid", "test")), []).append(
            f"./audio/{name}.wav,./transcription/{name}.txt,{'MF'[i % 2]},{x.size / SR:.2f}")
    for part, lines in rows.items():
        (corpus / f"cnt_asr_{part}_metadata.csv").write_text(
            "audio_path,text_path,gender,duration\n" + "\n".join(lines) + "\n")
    return corpus


def _write_aishell3(root: Path, rng) -> Path:
    """AISHELL-3 (openslr/93): ``{train,test}/wav/<speaker>/<utt>.wav`` at
    44.1 kHz, ``content.txt`` per split (hanzi and pinyin interleaved),
    ``train/label_train-set.txt`` tone labels and ``spk-info.txt``; 12 + 4
    utterances of 2-6 s by 4 speakers."""
    corpus = root / "aishell3"
    speakers = ("SSB0005", "SSB0009", "SSB0011", "SSB0016")
    info = ["# AISHELL-3 speaker info", "# speaker\tage group\tgender\taccent"]
    info += [f"{spk}\tB\t{'female' if k % 3 else 'male'}\tnorth" for k, spk in enumerate(speakers)]
    (corpus / "train").mkdir(parents=True)
    (corpus / "spk-info.txt").write_text("\n".join(info) + "\n")
    content, labels = {}, ["# AISHELL-3 tone labels"]
    for i in range(ZH_CORPUS_FILES):
        split = "train" if i < 12 else "test"
        spk = speakers[i % 4]
        utt = f"{spk}{i:04d}"
        _write_audio(corpus / split / "wav" / spk / f"{utt}.wav",
                     _zh_burst(rng, ZH_TTS_SECONDS, 44100), 44100)
        pairs = [HANZI_PINYIN[k] for k in rng.randint(0, len(HANZI_PINYIN), rng.randint(3, 9))]
        content.setdefault(split, []).append(
            f"{utt}.wav\t{' '.join(f'{h} {p}' for h, p in pairs)}")
        if split == "train":
            labels.append(f"{utt}|{' '.join(p for _, p in pairs)}|{''.join(h for h, _ in pairs)}")
    (corpus / "train" / "label_train-set.txt").write_text("\n".join(labels) + "\n")
    for split, lines in content.items():
        (corpus / split / "content.txt").write_text("\n".join(lines) + "\n")
    return corpus


def _write_baker_zh(root: Path, rng) -> Path:
    """Baker (BZNSYP): ``Wave/<6 digits>.wav`` at 48 kHz and
    ``ProsodyLabeling/000001-010000.txt``, whose lines alternate the id and
    the text with prosody marks ``#1``-``#4``, then the pinyin; 16
    utterances of 2-6 s."""
    corpus = root / "BZNSYP"
    lines = []
    for i in range(ZH_CORPUS_FILES):
        rid = f"{i + 1:06d}"
        _write_audio(corpus / "Wave" / f"{rid}.wav", _zh_burst(rng, ZH_TTS_SECONDS, 48000), 48000)
        pairs = [HANZI_PINYIN[k] for k in rng.randint(0, len(HANZI_PINYIN), rng.randint(4, 10))]
        text = "".join(h + (f"#{rng.randint(1, 4)}" if rng.rand() < 0.3 else "")
                       for h, _ in pairs)
        lines += [f"{rid}\t{text}#4。", f"\t{' '.join(p for _, p in pairs)}"]
    (corpus / "ProsodyLabeling").mkdir(parents=True)
    (corpus / "ProsodyLabeling" / "000001-010000.txt").write_text(
        "\n".join(lines) + "\n", encoding="utf-8")
    return corpus


def _write_wenetspeech4tts(root: Path, rng) -> Path:
    """WenetSpeech4TTS: ``<tier>/WenetSpeech4TTS_<tier>_<n>/{wavs,txts}/``,
    16 kHz, ``filelists/Basic_filelist.lst`` of ``../`` paths and a DNSMOS
    score list per tier; 4 Premium, 6 Standard and 6 Basic-only files of
    2-6 s."""
    corpus = root / "wenetspeech4tts"
    listed, scores = [], {}
    for i in range(ZH_CORPUS_FILES):
        tier = "Premium" if i < 4 else "Standard" if i < 10 else "Basic"
        pack = f"{tier}/WenetSpeech4TTS_{tier}_{1 + i % 2}"
        name = f"Y{i:04d}_S{i % 3:05d}"
        x = _zh_burst(rng, ZH_TTS_SECONDS)
        _write_audio(corpus / pack / "wavs" / f"{name}.wav", x, SR)
        (corpus / pack / "txts").mkdir(parents=True, exist_ok=True)
        (corpus / pack / "txts" / f"{name}.txt").write_text(
            f"{name}\t{_words(rng, MANDARIN, 3, 10, sep='')}\n[0.0,{x.size / SR:.2f}]\n",
            encoding="utf-8")
        listed.append(f"{name} ../{pack}/wavs/{name}.wav")
        for t in ("Basic", "Standard", "Premium")[:3 if tier == "Premium" else
                                                   2 if tier == "Standard" else 1]:
            scores.setdefault(t, []).append(f"{name} {rng.uniform(3.0, 4.5):.4f}")
    (corpus / "filelists").mkdir(parents=True)
    (corpus / "filelists" / "Basic_filelist.lst").write_text("\n".join(listed) + "\n")
    (corpus / "DNSMOS_P808Scores").mkdir()
    for tier, lines in scores.items():
        (corpus / "DNSMOS_P808Scores" / f"{tier}_DNSMOS.lst").write_text("\n".join(lines) + "\n")
    return corpus


def _zh_corpus_specs(root: Path, rng) -> dict:
    """Per corpus of phase 26's ``corpus_<name>`` legs, in the order they
    run: the recipe's call for an output directory, the CLI's command, and
    the training path ("asr" or "tts")."""
    from lhotse_tpu_torch import recipes as R

    tal, talcs = _write_tal_asr(root, rng), _write_tal_csasr(root, rng)
    cdsd = _write_cdsd(root, rng)
    speechio, xbmu, mdcc = (_write_speechio(root, rng), _write_xbmu_amdo31(root, rng),
                            _write_mdcc(root, rng))
    aishell3, baker = _write_aishell3(root, rng), _write_baker_zh(root, rng)
    wenet4tts = _write_wenetspeech4tts(root, rng)
    return {
        "tal_asr": (lambda o: R.prepare_tal_asr(tal, output_dir=o), ["tal-asr", tal], "asr"),
        "tal_csasr": (lambda o: R.prepare_tal_csasr(talcs, output_dir=o), ["tal-csasr", talcs],
                      "asr"),
        "cdsd": (lambda o: R.prepare_cdsd(cdsd, output_dir=o), ["cdsd", cdsd], "asr"),
        "speechio": (lambda o: R.prepare_speechio(speechio, output_dir=o),
                     ["speechio", speechio], "asr"),
        "xbmu_amdo31": (lambda o: R.prepare_xbmu_amdo31(xbmu, output_dir=o),
                        ["xbmu-amdo31", xbmu], "asr"),
        "mdcc": (lambda o: R.prepare_mdcc(mdcc, output_dir=o), ["mdcc", mdcc], "asr"),
        "aishell3": (lambda o: R.prepare_aishell3(aishell3, output_dir=o),
                     ["aishell3", aishell3], "tts"),
        "baker_zh": (lambda o: R.prepare_baker_zh(baker, output_dir=o), ["baker-zh", baker],
                     "tts"),
        "wenetspeech4tts": (lambda o: R.prepare_wenetspeech4tts(wenet4tts, output_dir=o),
                            ["wenetspeech4tts", wenet4tts], "tts"),
    }


def _phase_zh_corpora(workdir: Path, device, fbank_cuda, smi: str) -> tuple:
    """26. The Chinese corpus recipes, in phase 14's directory after phase 25
    (phase 23's MUSAN noise and RIRS_NOISES manifests feed the augmenter).
    Every recipe runs as a function and through the CLI's ``prepare``
    command, and their manifests must be equal. ``zh_multi_device_chain``:
    the members of icefall's multi_zh-hans mix that the port prepares
    (THCHS-30, ST-CMDS, Primewords, MagicData, aidatatang_200zh, KeSpeech,
    AISHELL and AISHELL-2), 32 utterances of each at 16 kHz in its
    published layout → ``prepare_*`` → ``CutSet.from_manifests`` → one
    lazy manifest per corpus → ``CutSet.mux(weights=[1] * 8, seed=2626)``
    → the 256 cuts in mux order as the 15 s x 256 bucket's int16 batch →
    ``OnDeviceAugmenter`` with phase 23's MUSAN noise pool and real RIR,
    speed 1.1, SNR (10, 20) and SpecAugment (twice); the kernel against its
    plain version on the batch it got, the features against the same chain
    with the plain version. ``zh_multi_on_the_fly``: the same mux →
    ``DynamicBucketingSampler(max_duration=180)`` →
    ``K2SpeechRecognitionDataset`` with ``OnTheFlyFeatures`` on the kernel
    → ``DataLoader`` → an AdamW step of ``Encoder(EncoderConfig())`` per
    batch, one epoch under ``torch.profiler``: every cut once, most
    batches holding several corpora. ``corpus_<name>``: TAL-ASR,
    TAL-CSASR, CDSD, SpeechIO, XBMU-AMDO31 and MDCC into the step, and
    AISHELL-3 (44.1 kHz), Baker (48 kHz) and WenetSpeech4TTS into
    ``SpeechSynthesisDataset`` with host resampling to 16 kHz, as phase
    24's ``corpus_<name>`` legs. Returns the kernel's launches per path and
    the largest kernel-vs-plain error."""
    from lhotse_tpu_torch import CutSet, RecordingSet, SupervisionSet
    from lhotse_tpu_torch.caching import set_caching_enabled
    from lhotse_tpu_torch.dataset import (
        DataLoader, DynamicBucketingSampler, K2SpeechRecognitionDataset, OnTheFlyFeatures)
    from lhotse_tpu_torch.features import Fbank, FbankConfig
    from lhotse_tpu_torch.tracing import set_tracing_enabled

    set_caching_enabled(False)
    set_tracing_enabled(True)
    rng = np.random.RandomState(ZH_SEED)
    root = workdir / "zh_corpora"
    launches, errs = {}, []

    # -- zh_multi_device_chain ---------------------------------------------------------------
    t0 = time.perf_counter()
    specs = _zh_multi_specs(root / "corpora", rng)
    write_s = time.perf_counter() - t0
    cut_paths, corpus_of, prepared = {}, {}, {}
    for name, (function, argv) in specs.items():
        made, files, function_s, cli_s = _prepare_twice(root / "manifests", name, function, argv)
        cuts = CutSet.from_cuts(c for recs, sups in _manifest_pairs(made)
                                for c in CutSet.from_manifests(
                                    recordings=RecordingSet.from_recordings(recs),
                                    supervisions=SupervisionSet.from_segments(sups)))
        cut_paths[name] = root / f"{name}_cuts.jsonl.gz"
        cuts.to_file(cut_paths[name])
        corpus_of.update((c.id, name) for c in cuts)
        prepared[name] = {"cuts": len(cuts), "manifests": len(files), "prepare_s": function_s,
                          "cli_s": cli_s}

    def muxed():
        return CutSet.mux(*(CutSet.from_jsonl_lazy(p) for p in cut_paths.values()),
                          weights=ZH_WEIGHTS, seed=ZH_SEED)

    sec, bsz = BUCKET
    n = int(sec * SR)
    order = list(muxed())
    t0 = time.perf_counter()
    audio, lens = np.zeros((bsz, n), np.float32), np.zeros(bsz, np.int64)
    for k, cut in enumerate(order[:bsz]):
        x = cut.load_audio()[0]
        audio[k, : x.size], lens[k] = x, x.size
    load_s = time.perf_counter() - t0
    blocks = [len({corpus_of[c.id] for c in order[i:i + 32]}) for i in range(0, len(order), 32)]
    pool, rir, noise, rir_rec = _noise_pool_and_rir(workdir)
    print(f"[{smi}] zh_multi_device_chain: {len(specs)} corpora of icefall's multi_zh-hans mix "
          f"written in {write_s!r} s, each prepared as function and CLI with equal manifests: "
          f"{prepared}; CutSet.mux(weights={ZH_WEIGHTS}, seed={ZH_SEED}) gives {len(order)} cuts "
          f"({float(lens.sum()) / SR!r} s, loaded in {load_s!r} s), corpora per block of 32 in mux "
          f"order {blocks}; noise pool {pool.shape} from phase 23's {len(noise)} MUSAN noise "
          f"recordings, RIR {rir_rec.id} ({rir.size} taps)")
    if (len(order) != bsz or sorted(c.id for c in order) != sorted(corpus_of)
            or lens.max() > n or lens.min() < 2 * SR or min(blocks) < 4):
        raise AssertionError("zh_multi_device_chain: the muxed corpora do not fill the bucket")
    launches["zh_multi_device_chain"], kernel_err, chain_err = _device_chain(
        "zh_multi_device_chain", [(audio, lens)] * 2, pool, rir, device, fbank_cuda, smi)
    errs += [kernel_err, chain_err]

    # -- zh_multi_on_the_fly -----------------------------------------------------------------
    fly = Fbank(FbankConfig(device=device))
    recorder = _RecordFirstBatch(fly)
    loader = DataLoader(
        DynamicBucketingSampler(muxed(), max_duration=FLY_MAX_DURATION, shuffle=True, seed=0),
        K2SpeechRecognitionDataset(return_cuts=True, input_strategy=OnTheFlyFeatures(fly)),
        prefetch_batches=3)
    run = _leg("zh_multi_on_the_fly", loader, _Trainer(device), device, fbank_cuda, _rows_of, smi)
    launches["zh_multi_on_the_fly"] = run["launches"]
    err = _first_batch_err(recorder, fly)
    seen = sorted(c.id for b in run["batches"] for c in b["supervisions"]["cut"])
    per_batch = [len({corpus_of[c.id] for c in b["supervisions"]["cut"]}) for b in run["batches"]]
    several = sum(k > 1 for k in per_batch)
    print(f"[{smi}] zh_multi_on_the_fly: corpora per batch {per_batch} ({several} of "
          f"{len(per_batch)} batches hold several); every cut once: {seen == sorted(corpus_of)}; "
          f"launches per batch {run['launches'] / len(run['batches'])!r}; first batch kernel vs "
          f"plain {err!r} (tol {KERNEL_TOL})")
    if run["launches"] != len(run["batches"]) or seen != sorted(corpus_of):
        raise AssertionError("zh_multi_on_the_fly: launches or coverage are off")
    if not 2 * several > len(per_batch) or not err <= KERNEL_TOL:
        raise AssertionError("zh_multi_on_the_fly: few batches mix corpora, or the kernel is off")
    errs.append(err)

    # -- corpus_<name> -----------------------------------------------------------------------
    t0 = time.perf_counter()
    corpus_specs = _zh_corpus_specs(root / "corpora", rng)
    print(f"[{smi}] corpora ({', '.join(corpus_specs)}) written in {time.perf_counter() - t0!r} s")
    corpus_launches, corpus_errs, summary = _corpus_legs(root / "manifests", corpus_specs, device,
                                                         fbank_cuda, smi)
    launches.update(corpus_launches)
    errs += corpus_errs
    print(f"[{smi}] phase 26 corpora: {summary}")
    set_tracing_enabled(False)
    return launches, max(errs)


TEL_SEED = 2727
TEL_SR = 8000  # the LDC telephone corpora: two-channel 8 kHz mu-law SPHERE
SWBD_CONVERSATIONS = 8
SWBD_SECONDS = 300.0  # about the length of a Switchboard-1 conversation
FISHER_CALLS = 8
FISHER_SECONDS = 300.0  # half a Fisher call of 10 minutes
TEL_TURN_SECONDS = (2.0, 15.0)
TEL_GAP_SECONDS = (-1.0, 1.5)  # a negative gap overlaps the other side's turn
TEL_WEIGHTS = [1, 1]
TEL_CORPUS_FILES = 16  # files of each corpus_<name> leg of phase 27
TEL_CORPUS_SECONDS = 40.0  # each conversation or programme of those legs
TEL_CORPUS_TURNS = (2.0, 8.0)
TEL_ARABIC = ("مرحبا", "بكم", "في", "نشرة", "الأخبار", "اليوم", "من", "الدوحة", "الطقس",
              "العالم", "الرئيس", "قال")
TEL_ROMAN = ("%ah", "Tayyib", "kalam", "ya", "$ukran", "il", "bEd", "da", "mi$", "Hilw", "ana")
SPANISH = ("hola", "buenos", "dias", "que", "tal", "bueno", "pues", "si", "claro", "mira", "vale")
BUCKWALTER = ("mrHbA", "bkm", "fy", "n$rp", "Al>xbAr", "Alywm", "mn", "AldwHp", "AlTqs")
GALE_DEV = ("CCTV2_NEWS1_CMN_20080401_180000", "VOA_FOCUS_CMN_20080402_210000")


def _ldc_sphere(path: Path, x: np.ndarray, sr: int, coding: str, **fields) -> None:
    """``x`` (channels, frames) as SPHERE in ``coding`` ("ulaw" or "pcm16"),
    the LDC release's own header fields (``fields``: name -> str or int)
    added to the port's writer's."""
    import io

    from lhotse_tpu_torch.audio.sphio import write_sph

    buf = io.BytesIO()
    write_sph(buf, x, sr, coding=coding)
    data = buf.getvalue()
    lines = [f"{k} -i {v}" if isinstance(v, int) else f"{k} -s{len(v)} {v}"
             for k, v in fields.items()]
    head = data[:1024].rstrip(b"\0").replace(
        b"end_head", "\n".join(lines + ["end_head"]).encode())
    if len(head) > 1024:
        raise AssertionError(f"{path}: the SPHERE header outgrows its 1024 bytes")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(head + b"\0" * (1024 - len(head)) + data[1024:])


def _conversation(rng, seconds: float, turns=TEL_TURN_SECONDS, sr: int = TEL_SR,
                  channels: int = 2) -> tuple:
    """A conversation of ``seconds`` at ``sr`` Hz: turns of ``turns`` seconds
    that alternate between the sides (with gaps and overlaps of
    ``TEL_GAP_SECONDS``), each a tone burst on its own side's channel over
    a quiet noise floor. With ``channels`` 1 every turn is on the one
    channel. Returns the (channels, frames) audio and the (side, start,
    end) turns, rounded to 10 ms."""
    n = int(seconds * sr)
    audio = (rng.randn(channels, n) * 0.003).astype(np.float32)
    out, t, side = [], float(rng.uniform(0.2, 1.0)), 0
    while True:
        length = float(rng.uniform(*turns))
        start, end = round(t, 2), round(t + length, 2)
        if end > seconds - 0.2:
            break
        i0, i1 = int(start * sr), int(end * sr)
        audio[side % channels, i0:i1] += _tone_burst(rng, (i1 - i0 + 1) / sr, sr)[: i1 - i0]
        out.append((side, start, end))
        side = 1 - side
        t = end + float(rng.uniform(*TEL_GAP_SECONDS))
    return np.clip(audio, -1, 1), out


def _write_switchboard(root: Path, rng, n: int = SWBD_CONVERSATIONS,
                       seconds: float = SWBD_SECONDS) -> tuple:
    """Switchboard-1 (LDC97S62): two-channel 8 kHz mu-law SPHERE
    conversations under ``swb1_d1/data``, and the MS-State transcripts
    (``swb_ms98_transcriptions/<2 digits>/<conversation>/sw<NNNN><side>-ms98-a-trans.text``,
    one per side, the other side's turns and the gaps as ``[silence]`` rows,
    times to 6 decimals). Returns the audio and transcript directories and
    the number of speech rows."""
    audio_dir, trans = root / "LDC97S62" / "swb1_d1" / "data", root / "swb_ms98_transcriptions"
    rows = 0
    for k in range(n):
        conv = f"{2001 + 7 * k}"
        x, turns = _conversation(rng, seconds)
        _ldc_sphere(audio_dir / f"sw0{conv}.sph", x, TEL_SR, "ulaw",
                    database_id="SWITCHBOARD", database_version="1.0",
                    conversation_id=conv, channels_interleaved="TRUE")
        for s, side in enumerate("AB"):
            lines, t, i = [], 0.0, 0
            for who, start, end in turns:
                if who != s:
                    continue
                if start > t:
                    i += 1
                    lines.append(f"sw{conv}{side}-ms98-a-{i:04d} {t:.6f} {start:.6f} [silence]")
                words = _words(rng, ENGLISH, 3, 14)
                if rng.rand() < 0.2:
                    words = "[noise] " + words
                i += 1
                lines.append(f"sw{conv}{side}-ms98-a-{i:04d} {start:.6f} {end:.6f} {words}")
                rows += 1
                t = end
            i += 1
            lines.append(f"sw{conv}{side}-ms98-a-{i:04d} {t:.6f} {seconds:.6f} [silence]")
            d = trans / conv[:2] / conv
            d.mkdir(parents=True, exist_ok=True)
            (d / f"sw{conv}{side}-ms98-a-trans.text").write_text("\n".join(lines) + "\n")
    return audio_dir.parent.parent, trans, rows


def _write_fisher_english(root: Path, rng, n: int = FISHER_CALLS,
                          seconds: float = FISHER_SECONDS) -> tuple:
    """Fisher English part 1 (LDC2004S13 audio, LDC2004T19 transcripts):
    two-channel 8 kHz mu-law SPHERE calls under
    ``LDC2004S13/fe_03_p1_sph1/audio/<3 digits>``, one transcript per call
    under ``LDC2004T19/data/trans/<3 digits>`` (a 3-line header, then
    ``<start> <end> <A|B>: <words>`` rows between blank lines), and the
    ``doc/fe_03_p1_calldata.tbl`` table of each call's A and B PINs. Returns
    the corpus directory and the number of rows."""
    rows = 0
    table = ["CALL_ID,DATE_TIME,TOPICID,SIG_GRADE,CNV_GRADE,APIN,ASX.DL,APHNUM,APHSET,APHTYP,"
             "BPIN,BSX.DL,BPHNUM,BPHSET,BPHTYP"]
    for k in range(n):
        call = f"{1 + 13 * k:05d}"
        x, turns = _conversation(rng, seconds)
        _ldc_sphere(root / "LDC2004S13" / "fe_03_p1_sph1" / "audio" / call[:3] / f"fe_03_{call}.sph",
                    x, TEL_SR, "ulaw", database_id="FISHER_ENGLISH", database_version="1.0",
                    recording_site="LDC", channels_interleaved="TRUE")
        lines = [f"# fe_03_{call}.sph", "# Transcribed at the LDC", ""]
        for who, start, end in turns:
            lines += [f"{start:.2f} {end:.2f} {'AB'[who]}: {_words(rng, ENGLISH, 3, 14)}", ""]
            rows += 1
        d = root / "LDC2004T19" / "data" / "trans" / call[:3]
        d.mkdir(parents=True, exist_ok=True)
        (d / f"fe_03_{call}.txt").write_text("\n".join(lines))
        table.append(f"{call},2004120{k % 9 + 1}_1{k:02d}000,ENG{k % 40 + 1:02d},2.5,2.7,"
                     f"{10000 + 2 * k},F.a,{5550000 + k},x,x,{10001 + 2 * k},M.a,{5560000 + k},x,x")
    doc = root / "LDC2004T19" / "doc"
    doc.mkdir(parents=True)
    (doc / "fe_03_p1_calldata.tbl").write_text("\n".join(table) + "\n")
    (doc / "fe_03_readme.txt").write_text("Fisher English Training Part 1 Transcripts\n")
    return root, rows


def _tel_rows(rng, turns, vocabulary, fmt) -> list:
    return [fmt(who, start, end, _words(rng, vocabulary, 2, 10)) for who, start, end in turns]


def _write_eval2000(root: Path, rng) -> Path:
    """Eval2000 (LDC2002S09 audio under ``hub5e_00/english``, LDC2002T43
    references under ``reference/english``): Switchboard (``sw_``) and
    CALLHOME (``en_``) conversations of two-channel 8 kHz mu-law SPHERE,
    ``#`` header lines and ``<start> <end> <side>: <words>`` rows."""
    for k in range(TEL_CORPUS_FILES):
        conv = f"{'sw' if k % 2 else 'en'}_{4156 + 11 * k}"
        x, turns = _conversation(rng, TEL_CORPUS_SECONDS, TEL_CORPUS_TURNS)
        _ldc_sphere(root / "LDC2002S09" / "hub5e_00" / "english" / f"{conv}.sph", x, TEL_SR,
                    "ulaw", database_id="HUB5E_00", conversation_id=conv)
        d = root / "LDC2002T43" / "reference" / "english"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{conv}.txt").write_text("\n".join(
            [f"# {conv}", "# Hub5 2000 English evaluation reference", ""] + _tel_rows(
                rng, turns, ENGLISH, lambda w, s, e, t: f"{s:.2f} {e:.2f} {'AB'[w]}: {t}")) + "\n")
    return root


def _callhome_split(k: int) -> str:
    return _zh_split(k, TEL_CORPUS_FILES, ("train", "devtest", "evaltest"))


def _write_callhome_english(root: Path, rng) -> tuple:
    """CALLHOME American English (LDC97S42 audio under
    ``data/{train,devtest,evltest}``, the LDC's spelling, and LDC97T14
    transcripts under ``transcrpt/{train,devtest,evaltest}``): two-channel
    8 kHz mu-law SPHERE, rows ``<start> <end> <A|B>: <text>`` some of which
    wrap onto a second line."""
    audio, trans = root / "LDC97S42", root / "LDC97T14"
    for k in range(TEL_CORPUS_FILES):
        split, conv = _callhome_split(k), f"en_{4065 + 31 * k}"
        x, turns = _conversation(rng, TEL_CORPUS_SECONDS, TEL_CORPUS_TURNS)
        _ldc_sphere(audio / "data" / split.replace("evaltest", "evltest") / f"{conv}.sph", x,
                    TEL_SR, "ulaw", database_id="CALLHOME_ENGLISH", conversation_id=conv)
        rows = []
        for who, start, end in turns:
            words = _words(rng, ENGLISH, 2, 16).split()
            rows.append(f"{start:.2f} {end:.2f} {'AB'[who]}: {' '.join(words[:8])}")
            if len(words) > 8:
                rows.append(" ".join(words[8:]))
        d = trans / "transcrpt" / split
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{conv}.txt").write_text("\n".join([f"# {conv}", ""] + rows) + "\n")
    return audio, trans


def _write_callhome_egyptian(root: Path, rng) -> tuple:
    """CALLHOME Egyptian Arabic (LDC97S45 audio under
    ``callhome/arabic/{train,devtest,evltest}``, LDC97T19 romanized
    transcripts under ``callhome_arabic_trans_970711/transcrp/<split>/roman``):
    two-channel 8 kHz mu-law SPHERE."""
    audio, trans = root / "LDC97S45", root / "LDC97T19"
    for k in range(TEL_CORPUS_FILES):
        split, conv = _callhome_split(k), f"ar_{4170 + 29 * k}"
        x, turns = _conversation(rng, TEL_CORPUS_SECONDS, TEL_CORPUS_TURNS)
        _ldc_sphere(audio / "callhome" / "arabic" / split.replace("evaltest", "evltest")
                    / f"{conv}.sph", x, TEL_SR, "ulaw", database_id="CALLHOME_ARABIC",
                    conversation_id=conv)
        d = trans / "callhome_arabic_trans_970711" / "transcrp" / split / "roman"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{conv}.txt").write_text("\n".join(_tel_rows(
            rng, turns, TEL_ROMAN, lambda w, s, e, t: f"{s:.2f} {e:.2f} {'AB'[w]}: {t}")) + "\n")
    return audio, trans


TDF_HEADER = ("file;unicode\tchannel;int\tstart;float\tend;float\tspeaker;unicode\t"
              "speakerType;unicode\tspeakerDialect;unicode\ttranscript;unicode\tsection;int\t"
              "turn;int\tsegment;int\tsectionType;unicode\tsuType;unicode\n"
              ";;MM sectionTypes\t[u'report', u'conversational']\n"
              ";;MM sectionBoundaries\t[0.0, 9999.0]\n")


def _tdf_rows(rng, file: str, turns, vocabulary, channel_of, speaker_of, sep=" ") -> str:
    return "".join(
        f"{file}\t{channel_of(w)}\t{s}\t{e}\t{speaker_of(w)}\t{('male', 'female')[w]}\tnative\t"
        f"{_words(rng, vocabulary, 2, 10, sep)}\t0\t{i}\t{i}\treport\tstatement\n"
        for i, (w, s, e) in enumerate(turns))


def _write_fisher_spanish(root: Path, rng) -> tuple:
    """Fisher Spanish (LDC2010S01 audio under ``fisher_spa/data/speech``,
    LDC2010T04 TDF transcripts under ``fisher_spa_tr/data/transcripts`` and
    the ``*_call.tbl`` sessions table): two-channel 8 kHz mu-law SPHERE,
    each side's speaker from the table."""
    audio = root / "LDC2010S01" / "fisher_spa" / "data" / "speech"
    trans = root / "LDC2010T04" / "fisher_spa_tr"
    table = ["CALL_ID,DATE,A_SPKR,A_SEX,A_AGE,A_DIALECT,A_EDU,A_PHONE,B_SPKR,B_SEX,B_AGE"]
    for k in range(TEL_CORPUS_FILES):
        call = 100 + 7 * k
        stem = f"2005{k % 9 + 1:02d}15_1{k:02d}000_{call}_fsp"
        x, turns = _conversation(rng, TEL_CORPUS_SECONDS, TEL_CORPUS_TURNS)
        _ldc_sphere(audio / f"{stem}.sph", x, TEL_SR, "ulaw", database_id="FISHER_SPANISH",
                    conversation_id=str(call))
        d = trans / "data" / "transcripts"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{stem}.tdf").write_text(TDF_HEADER + _tdf_rows(
            rng, f"{stem}.sph", turns, SPANISH, lambda w: w, lambda w: f"{stem}_{'AB'[w]}"),
            encoding="utf-8")
        table.append(f"{call},2005,{stem}_A,f,30,caribe,x,x,{stem}_B,m,40")
    (trans / "doc").mkdir(parents=True)
    (trans / "doc" / "fsp_call.tbl").write_text("\n".join(table) + "\n")
    return audio, trans


def _write_gale(root: Path, rng, names: tuple, programmes: tuple, vocabulary, sep) -> tuple:
    """GALE speech and transcript corpora in matched pairs (the first pair's
    audio 16 kHz WAV, the second's FLAC, ``TEL_CORPUS_FILES // 2`` broadcasts
    each) with one TDF file per broadcast, its speakers marked ``*`` as in
    the releases. Returns the speech and transcript directories and the
    recording ids."""
    audio_dirs, trans_dirs, ids = [], [], []
    for (s_name, t_name), fmt in zip(names, ("wav", "flac")):
        a, t = root / s_name / "data", root / t_name / "data" / "tdf"
        t.mkdir(parents=True)
        for k in range(TEL_CORPUS_FILES // 2):
            rid = programmes[len(ids)]
            x, turns = _conversation(rng, TEL_CORPUS_SECONDS, TEL_CORPUS_TURNS, sr=SR, channels=1)
            _write_audio(a / f"{rid}.{fmt}", x[0], SR)
            (t / f"{rid}.tdf").write_text(TDF_HEADER + _tdf_rows(
                rng, f"{rid}.sph", turns, vocabulary, lambda w: 0,
                lambda w: f"{rid[:4]}spk*{w}", sep), encoding="utf-8")
            ids.append(rid)
        audio_dirs.append(root / s_name)
        trans_dirs.append(root / t_name)
    return audio_dirs, trans_dirs, ids


def _write_mgb2(root: Path, rng) -> Path:
    """MGB-2: 16 kHz WAV; ``train`` as ``wav/`` and one XML file per
    programme under ``xml/utf8`` (segments with their WMER, speaker and
    words), ``dev`` and ``test`` as Kaldi directories
    (``wav.scp`` with ``wav/`` paths, ``segments.non_overlap_speech`` and
    BuckWalter ``text.non_overlap_speech``)."""
    for k in range(TEL_CORPUS_FILES):
        part = "train" if k < 12 else "dev" if k < 14 else "test"
        prog = "-".join(f"{int(v):X}" for v in rng.randint(0x1000, 0xFFFF, 4)) + f"-{k:04X}"
        x, turns = _conversation(rng, TEL_CORPUS_SECONDS, TEL_CORPUS_TURNS, sr=SR, channels=1)
        _write_audio(root / part / "wav" / f"{prog}.wav", x[0], SR)
        if part == "train":
            segs = "".join(
                f'<segment id="{prog}_utt_{i}" starttime="{s:.2f}" endtime="{e:.2f}" '
                f'AWD="0.3" PMER="{rng.uniform(0, 40):.2f}" WMER="{(5.0, 95.0)[i % 7 == 3]}" '
                f'who="transcript_speaker{w + 1}_align">'
                + "".join(f'<element type="word" starttime="{s:.2f}" dur="0.30" '
                          f'score="1">{word}</element>'
                          for word in _words(rng, TEL_ARABIC, 2, 10).split() + ["،"])
                + "</segment>" for i, (w, s, e) in enumerate(turns))
            xml = root / "train" / "xml" / "utf8" / f"{prog}.xml"
            xml.parent.mkdir(parents=True, exist_ok=True)
            xml.write_text('<?xml version="1.0" encoding="utf-8"?>\n<transcript>'
                           f'<head><recording filename="{prog}"/></head><body>'
                           f'<segments annotation_id="transcript_align">{segs}</segments>'
                           "</body></transcript>\n", encoding="utf-8")
            continue
        d = root / part
        with open(d / "wav.scp", "a") as f:
            f.write(f"{prog} wav/{prog}.wav\n")
        with open(d / "segments.non_overlap_speech", "a") as f:
            f.writelines(f"{prog}_{i:04d} {prog} {s:.2f} {e:.2f}\n"
                         for i, (_, s, e) in enumerate(turns))
        with open(d / "text.non_overlap_speech", "a", encoding="utf-8") as f:
            f.writelines(f"{prog}_{i:04d} {_words(rng, BUCKWALTER, 2, 10)}\n"
                         for i in range(len(turns)))
    return root


def _write_broadcast_news(root: Path, rng) -> tuple:
    """1997 English Broadcast News (LDC98S71 audio, LDC98T28 transcripts):
    16 kHz 16-bit PCM SPHERE programmes and their Hub-4 SGML (``episode``,
    ``section``, ``turn`` and ``time`` marks; a filler section; the
    ``startTime``/``endTime`` attributes of the release)."""
    audio, trans = root / "LDC98S71" / "hub4e97" / "data", root / "LDC98T28" / "hub4e97_trans"
    trans.mkdir(parents=True)
    for k in range(TEL_CORPUS_FILES):
        stem = f"h4e_97_{k + 1:02d}"
        x, turns = _conversation(rng, TEL_CORPUS_SECONDS, (4.0, 12.0), sr=SR, channels=1)
        _ldc_sphere(audio / f"{stem}.sph", x, SR, "pcm16", database_id="HUB4_1997",
                    recording_site="LDC")
        sgml = [f'<episode filename={stem} program="CNN Headline News" language=english '
                f"version=1 version_date=980220>",
                f"<section type=filler startTime=0.000 endTime={turns[0][1]:.3f}>", "</section>",
                f"<section type=report startTime={turns[0][1]:.3f} "
                f'endTime={turns[-1][2]:.3f} topic="news">']
        for i, (w, s, e) in enumerate(turns):
            sgml.append(f"<turn speaker=Speaker_{i % 3 + 1} spkrtype={('male', 'female')[w]} "
                        f"startTime={s:.3f} endTime={e:.3f}>")
            mid = round((s + e) / 2, 3)
            sgml += [f"<time sec={s:.3f}>", _words(rng, ENGLISH, 3, 10), f"<time sec={mid:.3f}>",
                     _words(rng, ENGLISH, 3, 10), "</turn>"]
        sgml += ["</section>", "</episode>"]
        (trans / f"{stem}.sgml").write_text("\n".join(sgml) + "\n")
    return audio, trans


def _tel_corpus_specs(root: Path, rng, segment_words: bool) -> dict:
    """Per corpus of phase 27's ``corpus_<name>`` legs, in the order they
    run: the recipe's call for an output directory, the CLI's command, and
    the training path ("asr"). GALE Mandarin splits its words with ``jieba``
    where ``segment_words``."""
    from lhotse_tpu_torch import recipes as R
    from lhotse_tpu_torch.recipes.gale_arabic import TEST

    e2k = _write_eval2000(root / "eval2000", rng)
    che_audio, che_trans = _write_callhome_english(root / "callhome_english", rng)
    chg_audio, chg_trans = _write_callhome_egyptian(root / "callhome_egyptian", rng)
    fsp_audio, fsp_trans = _write_fisher_spanish(root / "fisher_spanish", rng)
    ar_audio, ar_trans, _ = _write_gale(
        root / "gale_arabic", rng, (("LDC2013S02", "LDC2013T17"), ("LDC2013S07", "LDC2013T04")),
        tuple(TEST[:4]) + tuple(f"ALJZ_PROG{k:02d}_ARB_2007{k + 1:02d}05_205800" for k in range(12)),
        TEL_ARABIC, " ")
    zh_audio, zh_trans, _ = _write_gale(
        root / "gale_mandarin", rng, (("LDC2013S08", "LDC2013T20"), ("LDC2015S06", "LDC2015T09")),
        GALE_DEV + tuple(f"PHOENIX_PROG{k:02d}_CMN_2008{k % 9 + 1:02d}10_143000"
                         for k in range(14)), MANDARIN, "")
    mgb2, bn = _write_mgb2(root / "mgb2", rng), _write_broadcast_news(root / "broadcast_news", rng)
    bn_audio, bn_trans = bn
    segment = ["--segment-words"] if segment_words else []

    def broadcast_news(o):
        made = R.prepare_broadcast_news(bn_audio, bn_trans, output_dir=o, absolute_paths=True)
        return {"recordings": made["recordings"], "supervisions": made["segments"]}

    def gale(flag, dirs):
        return [v for d in dirs for v in (flag, d)]

    return {
        "eval2000": (lambda o: R.prepare_eval2000(e2k, output_dir=o, absolute_paths=True),
                     ["eval2000", e2k, "--absolute-paths"], "asr"),
        "callhome_english": (lambda o: R.prepare_callhome_english(
            che_audio, transcript_dir=che_trans, output_dir=o, absolute_paths=True),
            ["callhome-english", che_audio, "--transcript-dir", che_trans, "--absolute-paths",
             "true"], "asr"),
        "callhome_egyptian": (lambda o: R.prepare_callhome_egyptian(
            chg_audio, chg_trans, output_dir=o, absolute_paths=True),
            ["callhome-egyptian", chg_audio, chg_trans, "--absolute-paths", "true"], "asr"),
        "fisher_spanish": (lambda o: R.prepare_fisher_spanish(
            fsp_audio, fsp_trans, output_dir=o, absolute_paths=True),
            ["fisher-spanish", fsp_audio, fsp_trans, "--absolute-paths", "true"], "asr"),
        "gale_arabic": (lambda o: R.prepare_gale_arabic(ar_audio, ar_trans, output_dir=o),
                        ["gale-arabic"] + gale("-s", ar_audio) + gale("-t", ar_trans)
                        + ["--absolute-paths", "true"], "asr"),
        "gale_mandarin": (lambda o: R.prepare_gale_mandarin(
            zh_audio, zh_trans, output_dir=o, segment_words=segment_words),
            ["gale-mandarin"] + gale("-s", zh_audio) + gale("-t", zh_trans)
            + ["--absolute-paths", "true"] + segment, "asr"),
        "mgb2": (lambda o: R.prepare_mgb2(mgb2, o), ["mgb2", mgb2], "asr"),
        "broadcast_news": (broadcast_news,
                           ["broadcast-news", bn_audio, bn_trans, "--absolute-paths", "true"],
                           "asr"),
    }


def _phase_telephone(workdir: Path, device, fbank_cuda, smi: str) -> tuple:
    """27. The LDC telephone and broadcast corpus recipes, in phase 14's
    directory after phase 26 (phase 23's MUSAN noise and RIRS_NOISES
    manifests feed the augmenter). Every recipe runs as a function and
    through the CLI's ``prepare`` command, and their manifests must be
    equal. ``swbd_fisher_device_chain``: the training set of Kaldi's
    ``fisher_swbd`` recipe, 8 Switchboard-1 conversations of 5 minutes and
    8 Fisher English calls cut to 5 minutes, two-channel 8 kHz mu-law SPHERE
    in their published layouts with MS-State and LDC transcripts →
    ``prepare_switchboard`` and ``prepare_fisher_english`` →
    ``CutSet.from_manifests`` → ``trim_to_supervisions`` (each side of a
    call its own channel) → ``resample(16000)`` → one lazy manifest per
    corpus → ``CutSet.mux(weights=[1, 1], seed=2727)`` → the first 256 cuts
    in mux order as the 15 s x 256 bucket's int16 batch →
    ``OnDeviceAugmenter`` with phase 23's MUSAN noise pool and real RIR,
    speed 1.1, SNR (10, 20) and SpecAugment (twice, then once under
    ``torch.profiler`` for the device's busy share, as every
    ``_device_chain`` leg); the kernel against its
    plain version on the batch it got, the features against the same chain
    with the plain version. ``corpus_<name>``: Eval2000, CALLHOME English
    (its ASR task), CALLHOME Egyptian and Fisher Spanish (two-channel 8 kHz
    mu-law SPHERE, resampled to 16 kHz), GALE Arabic and GALE Mandarin
    (16 kHz WAV and FLAC with TDF transcripts; GALE Mandarin's dev ids, which
    its recipe reads from the network, replaced by a local list, and its
    words split by ``jieba`` where it imports), MGB-2 (16 kHz WAV, train as
    XML, dev and test as Kaldi directories) and 1997 Broadcast News (16 kHz
    PCM SPHERE with Hub-4 SGML), 16 files each, into the step as phase 24's
    ``corpus_<name>`` legs. Returns the kernel's launches per path and the
    largest kernel-vs-plain error."""
    from lhotse_tpu_torch import CutSet, RecordingSet, SupervisionSet
    from lhotse_tpu_torch import recipes as R
    from lhotse_tpu_torch.caching import set_caching_enabled
    from lhotse_tpu_torch.recipes import gale_mandarin
    from lhotse_tpu_torch.tracing import set_tracing_enabled
    from lhotse_tpu_torch.utils import is_module_available

    set_caching_enabled(False)
    set_tracing_enabled(True)
    rng = np.random.RandomState(TEL_SEED)
    root = workdir / "telephone"
    launches, errs = {}, []

    # -- swbd_fisher_device_chain ------------------------------------------------------------
    t0 = time.perf_counter()
    swbd_audio, swbd_trans, swbd_rows = _write_switchboard(root / "corpora" / "switchboard", rng)
    fisher, fisher_rows = _write_fisher_english(root / "corpora" / "fisher_english", rng)
    write_s = time.perf_counter() - t0
    specs = {
        "switchboard": (lambda o: R.prepare_switchboard(
            swbd_audio, transcripts_dir=swbd_trans, output_dir=o, absolute_paths=True),
            ["switchboard", swbd_audio, "--transcript-dir", swbd_trans, "--absolute-paths"]),
        "fisher_english": (lambda o: R.prepare_fisher_english(
            fisher, o, audio_dirs=["LDC2004S13"], transcript_dirs=["LDC2004T19"],
            absolute_paths=True),
            ["fisher-english", fisher, "-a", "LDC2004S13", "-t", "LDC2004T19",
             "--absolute-paths", "true"]),
    }
    cut_paths, corpus_of, prepared = {}, {}, {}
    for name, (function, argv) in specs.items():
        made, files, function_s, cli_s = _prepare_twice(root / "manifests", name, function, argv)
        recs, sups = made["recordings"], made["supervisions"]
        cuts = CutSet.from_manifests(
            recordings=RecordingSet.from_recordings(recs),
            supervisions=SupervisionSet.from_segments(sups),
        ).trim_to_supervisions(keep_overlapping=False).resample(SR)
        cut_paths[name] = root / f"{name}_cuts.jsonl.gz"
        cuts.to_file(cut_paths[name])
        corpus_of.update((c.id, name) for c in cuts)
        prepared[name] = {"recordings": len(recs), "channels": sorted({r.num_channels for r in recs}),
                          "rates": sorted({r.sampling_rate for r in recs}),
                          "supervisions": len(sups), "manifests": len(files),
                          "prepare_s": function_s, "cli_s": cli_s}
    if [prepared[n]["supervisions"] for n in specs] != [swbd_rows, fisher_rows]:
        raise AssertionError(f"swbd_fisher_device_chain: supervisions {prepared} differ from the "
                             f"transcripts' rows {swbd_rows} and {fisher_rows}")

    sec, bsz = BUCKET
    n = int(sec * SR)
    order = list(CutSet.mux(*(CutSet.from_jsonl_lazy(p) for p in cut_paths.values()),
                            weights=TEL_WEIGHTS, seed=TEL_SEED))[:bsz]
    t0 = time.perf_counter()
    audio, lens = np.zeros((bsz, n), np.float32), np.zeros(bsz, np.int64)
    for k, cut in enumerate(order):
        x = cut.load_audio()[0]
        audio[k, : x.size], lens[k] = x, x.size
    load_s = time.perf_counter() - t0
    shares = {name: sum(corpus_of[c.id] == name for c in order) for name in specs}
    channels = sorted({c.channel for c in order})
    pool, rir, noise, rir_rec = _noise_pool_and_rir(workdir)
    print(f"[{smi}] swbd_fisher_device_chain: {SWBD_CONVERSATIONS} Switchboard-1 conversations of "
          f"{SWBD_SECONDS:g} s and {FISHER_CALLS} Fisher English calls of {FISHER_SECONDS:g} s "
          f"(two-channel {TEL_SR} Hz mu-law SPHERE) written in {write_s!r} s, each prepared as "
          f"function and CLI with equal manifests: {prepared}; trimmed to their supervisions, "
          f"resampled to {SR} Hz and CutSet.mux(weights={TEL_WEIGHTS}, seed={TEL_SEED}): the first "
          f"{len(order)} cuts ({float(lens.sum()) / SR!r} s, loaded in {load_s!r} s) hold {shares} "
          f"on channels {channels}; noise pool {pool.shape} from phase 23's {len(noise)} MUSAN "
          f"noise recordings, RIR {rir_rec.id} ({rir.size} taps)")
    if (len(order) != bsz or min(shares.values()) < bsz // 4 or channels != [0, 1]
            or lens.max() > n or lens.min() < 2 * SR
            or any(c.sampling_rate != SR for c in order)):
        raise AssertionError("swbd_fisher_device_chain: the muxed corpora do not fill the bucket")
    launches["swbd_fisher_device_chain"], kernel_err, chain_err = _device_chain(
        "swbd_fisher_device_chain", [(audio, lens)] * 2, pool, rir, device, fbank_cuda, smi)
    errs += [kernel_err, chain_err]

    # -- corpus_<name> -----------------------------------------------------------------------
    segment_words = is_module_available("jieba")
    print(f"[{smi}] jieba imports: {segment_words}; corpus_gale_mandarin runs "
          f"{'with' if segment_words else 'without'} segment_words")
    t0 = time.perf_counter()
    corpus_specs = _tel_corpus_specs(root / "corpora", rng, segment_words)
    print(f"[{smi}] corpora ({', '.join(corpus_specs)}) written in {time.perf_counter() - t0!r} s")
    # GALE Mandarin's recipe reads its dev ids from the network in every call: a local list
    # takes its place while the legs run.
    fetch = gale_mandarin._fetch_dev_ids
    gale_mandarin._fetch_dev_ids = lambda: list(GALE_DEV)
    try:
        corpus_launches, corpus_errs, summary = _corpus_legs(
            root / "manifests", corpus_specs, device, fbank_cuda, smi)
    finally:
        gale_mandarin._fetch_dev_ids = fetch
    launches.update(corpus_launches)
    errs += corpus_errs
    print(f"[{smi}] phase 27 corpora: {summary}")
    set_tracing_enabled(False)
    return launches, max(errs)


OVERLAP_SEED = 2828
LIBRIMIX_ROWS = 256  # Libri2Mix rows: the 15 s x 256 bucket's rows
LIBRIMIX_GAINS = ((0.5, 1.5), (0.2, 0.8))  # the sources' and the WHAM! noise's gains
SEPARATION_ROWS = 32  # rows whose sources and mixtures are extracted for separation
LSMIX_ENTRIES = 64
LSMIX_DELAY = (0.5, 3.0)  # s before the second speaker of a LibriSpeechMix entry starts
DIAR_SESSIONS = 4  # of each corpus
DIAR_SECONDS = 120.0
DIAR_SPEAKERS = (2, 6)
DIAR_DOMAINS = ("audiobooks", "broadcast_interview", "clinical", "court", "cts", "maptask",
                "meeting", "restaurant", "socio_field", "socio_lab", "webvideo")
# The dev split (S09 only completes it).
CHIME5_SESSIONS = (("S02", 60.0), ("S09", 30.0))
CHIME5_ARRAYS, CHIME5_CHANNELS = 6, 4
CHIME5_HEADSETS = {"S02": ("P05", "P06", "P07", "P08"), "S09": ("P25", "P26", "P27", "P28")}
MINI_ROWS = 16
MINI_SR = 8000  # MiniLibriMix's wav8k/min
MINI_SECONDS = (3.5, 8.0)
OVERLAP_CORPUS_FILES = 16  # files of the corpus_spatial_librispeech and corpus_earnings legs
EARNINGS_SECONDS = 120.0  # each earnings call, cut to 2 minutes
EARNINGS_WORDS = ("good", "morning", "everyone", "revenue", "grew", "percent", "year", "over",
                  "quarter", "thank", "you", "operator", "margin", "guidance")


def _write_librimix_metadata(root: Path, utterances, wham_ids: list, rng) -> Path:
    """``metadata/Libri2Mix/libri2mix_train-100.csv`` in the published
    columns: ``LIBRIMIX_ROWS`` rows, each two utterances of different
    speakers (seeded choice) at gains drawn from ``LIBRIMIX_GAINS[0]`` and a
    WHAM! train noise (plain, or its 0.8 or 1.2 speed variant) at a gain from
    ``LIBRIMIX_GAINS[1]``; and the ``_info`` file the recipe skips."""
    ids = sorted(c.recording_id for c in utterances)
    rows, seen = [], set()
    while len(rows) < LIBRIMIX_ROWS:
        a, b = (ids[i] for i in rng.choice(len(ids), 2, replace=False))
        if a.split("-")[0] == b.split("-")[0] or f"{a}_{b}" in seen:
            continue
        seen.add(f"{a}_{b}")
        noise = wham_ids[int(rng.integers(len(wham_ids)))] + ("", "sp08", "sp12")[int(rng.integers(3))]
        gains = [round(float(rng.uniform(*LIBRIMIX_GAINS[k > 1])), 6) for k in range(3)]
        rows.append(",".join([
            f"{a}_{b}", f"train-clean-100/{a.split('-')[0]}/{a.split('-')[1]}/{a}.flac",
            str(gains[0]), f"train-clean-100/{b.split('-')[0]}/{b.split('-')[1]}/{b}.flac",
            str(gains[1]), f"tr/{noise}.wav", str(gains[2])]))
    meta = root / "metadata"
    (meta / "Libri2Mix").mkdir(parents=True)
    (meta / "Libri2Mix" / "libri2mix_train-100.csv").write_text("\n".join(
        ["mixture_ID,source_1_path,source_1_gain,source_2_path,source_2_gain,noise_path,"
         "noise_gain"] + rows) + "\n")
    (meta / "Libri2Mix" / "libri2mix_train-100_info.csv").write_text("")
    return meta


def _write_librispeechmix(root: Path, utterances, rng) -> Path:
    """``list/test-clean-2mix.jsonl``: ``LSMIX_ENTRIES`` entries in the
    published format (``id``, ``wavs``, ``delays``, ``speakers``, ``texts``,
    ``durations``), two utterances of different speakers each, the second
    delayed by ``LSMIX_DELAY`` seconds."""
    by_id = {c.recording_id: c for c in utterances}
    ids = sorted(by_id)
    lines = []
    while len(lines) < LSMIX_ENTRIES:
        a, b = (ids[i] for i in rng.choice(len(ids), 2, replace=False))
        if a.split("-")[0] == b.split("-")[0]:
            continue
        lines.append(json.dumps({
            "id": f"test-clean-2mix/{len(lines):05d}",
            "wavs": [f"test-clean/{u.split('-')[0]}/{u.split('-')[1]}/{u}.flac" for u in (a, b)],
            "delays": [0.0, round(float(rng.uniform(*LSMIX_DELAY)), 3)],
            "speakers": [u.split("-")[0] for u in (a, b)],
            "texts": [by_id[u].supervisions[0].text for u in (a, b)],
            "durations": [by_id[u].duration for u in (a, b)]}))
    (root / "list").mkdir(parents=True)
    (root / "list" / "test-clean-2mix.jsonl").write_text("\n".join(lines) + "\n")
    return root / "list"


def _diarization_turns(rng, seconds: float, speakers: int) -> list:
    """``_meeting_turns`` with a negative gap now and then, so that turns
    overlap."""
    turns, t, spk = [], 0.5, 0
    while True:
        span = round(float(rng.uniform(*MEETING_TURN_SECONDS)), 2)
        if t + span > seconds - 0.3:
            return turns
        turns.append((spk, round(t, 2), round(t + span, 2), []))
        t = round(t + span + float(rng.uniform(-1.0, 1.5)), 2)
        spk = (spk + int(rng.integers(1, speakers))) % speakers


def _write_diarization_corpora(root: Path, rng) -> tuple:
    """DIHARD III's dev layout (``data/flac``, ``data/rttm``, ``data/uem``
    and ``docs/recordings.tbl``) and VoxConverse's (``dev/*.wav`` with the
    annotation repository's ``dev/*.rttm`` beside them), ``DIAR_SESSIONS``
    sessions of ``DIAR_SECONDS`` each with 2-6 speakers in overlapping
    turns. Returns both roots and the turns written."""
    dihard, vox = root / "LDC2020E12_DIHARD_III_dev", root / "voxconverse"
    table = ["file_id\tin_core\tlanguage\tdomain\tsource"]
    written = 0
    for k in range(DIAR_SESSIONS):
        for corpus in ("dihard3", "voxconverse"):
            speakers = int(rng.integers(DIAR_SPEAKERS[0], DIAR_SPEAKERS[1] + 1))
            turns = _diarization_turns(rng, DIAR_SECONDS, speakers)
            audio = _meeting_audio(rng, DIAR_SECONDS, turns, 1, speakers=speakers)[0]
            written += len(turns)
            if corpus == "dihard3":
                rid = f"DH_DEV_{k + 1:04d}"
                _write_audio(dihard / "data" / "flac" / f"{rid}.flac", audio, SR)
                names = [f"speaker{s}" for s in range(speakers)]
                rttm = dihard / "data" / "rttm" / f"{rid}.rttm"
                (dihard / "data" / "uem").mkdir(parents=True, exist_ok=True)
                (dihard / "data" / "uem" / f"{rid}.uem").write_text(
                    f"{rid} 1 0.000 {DIAR_SECONDS:.3f}\n")
                table.append(f"{rid}\t{k % 2 == 0}\teng\t{DIAR_DOMAINS[k % len(DIAR_DOMAINS)]}"
                             "\tLDC")
            else:
                rid = "".join(chr(97 + int(c)) for c in rng.integers(0, 26, 5))
                _wav_file(vox / "dev" / f"{rid}.wav", audio)
                names = [f"spk{s:02d}" for s in range(speakers)]
                rttm = vox / "dev" / f"{rid}.rttm"
            rttm.parent.mkdir(parents=True, exist_ok=True)
            rttm.write_text("".join(
                f"SPEAKER {rid} 1 {start:.3f} {end - start:.3f} <NA> <NA> {names[s]} <NA> <NA>\n"
                for s, start, end, _ in turns))
    (dihard / "docs").mkdir(parents=True)
    (dihard / "docs" / "recordings.tbl").write_text("\n".join(table) + "\n")
    (vox / "test").mkdir(parents=True)
    return dihard, vox, written


def _fit(x: np.ndarray, n: int) -> np.ndarray:
    """``x`` cut or zero-padded to ``n`` samples along its last axis."""
    out = np.zeros(x.shape[:-1] + (n,), x.dtype)
    out[..., : min(n, x.shape[-1])] = x[..., :n]
    return out


def _write_chime5(root: Path, rng) -> tuple:
    """A raw CHiME-5 dev split in the published layout: per session six
    4-channel Kinect arrays (``audio/dev/S02_U0k.CHn.wav``), four binaural
    headsets (``S02_P05.wav``...) and ``transcriptions/dev/S02.json`` with
    per-device ``original`` times, ``ref`` and ``location``; every device a
    few hundred samples off the session's length. And the
    ``chime6_audio_edits.json`` shape that makes them agree: per array,
    frame-drop triplets (a dropped and an inserted span), ``speed`` (1.0 for
    U01, a drift of a few 1e-4 for the others) and ``padding``; per headset,
    ``speed`` and ``padding``. Returns the corpus root, the edits and the
    count of transcribed turns."""
    edits, n_turns = {}, 0
    for session, seconds in CHIME5_SESSIONS:
        target = int(seconds * SR)
        headsets = CHIME5_HEADSETS[session]
        turns = _meeting_turns(rng, seconds)
        n_turns += len(turns)
        arrays = _meeting_audio(rng, seconds, turns, CHIME5_ARRAYS * CHIME5_CHANNELS)
        heads = _meeting_audio(rng, seconds, turns, len(headsets), headsets=True)
        fits = {}
        for u in range(CHIME5_ARRAYS):
            raw = target + int(rng.integers(-400, 400))
            drop, gap, a = 60 + 10 * u, 30, raw // 3
            x = _fit(arrays[CHIME5_CHANNELS * u: CHIME5_CHANNELS * (u + 1)], raw)
            for c in range(CHIME5_CHANNELS):
                _wav_file(root / "audio" / "dev" / f"{session}_U0{u + 1}.CH{c + 1}.wav", x[c])
            speed = 1.0 if u == 0 else float(rng.choice([0.9997, 0.9998, 1.0002, 1.0003]))
            length = raw - drop + gap
            fits[f"U0{u + 1}"] = {
                "edits": [[1, a, 1], [a + 1 + drop, 2 * a, a + 1],
                          [2 * a + 1, raw, 2 * a + 1 - drop + gap]],
                "speed": speed, "padding": target - int(length / speed)}
        for k, p in enumerate(headsets):
            raw = target + int(rng.integers(-300, 300))
            _wav_file(root / "audio" / "dev" / f"{session}_{p}.wav",
                      _fit(np.stack([heads[k], heads[k]]), raw))
            speed = float(rng.choice([0.9996, 1.0, 1.0004]))
            fits[p] = {"speed": speed, "padding": target - int(raw / speed)}
        edits[session] = fits
        entries = []
        for spk, start, end, words in turns:
            devices = ["original"] + [f"U0{u + 1}" for u in range(CHIME5_ARRAYS)] + list(headsets)
            entries.append({
                "end_time": {d: _hms(end + 0.001 * i) for i, d in enumerate(devices)},
                "start_time": {d: _hms(start + 0.001 * i) for i, d in enumerate(devices)},
                "words": " ".join(words).lower(), "speaker": headsets[spk],
                "ref": f"U0{1 + spk % CHIME5_ARRAYS}", "location": "kitchen",
                "session_id": session})
        (root / "transcriptions" / "dev").mkdir(parents=True, exist_ok=True)
        (root / "transcriptions" / "dev" / f"{session}.json").write_text(json.dumps(entries))
    return root, edits, n_turns


def _write_librimix_mini(root: Path, bursts, rng) -> Path:
    """MiniLibriMix's layout: ``metadata/mixture_train_mix_both.csv`` over
    ``wav8k/min/train/{mix_both,s1,s2,noise}``, ``MINI_ROWS`` rows at 8 kHz
    (two tone-burst speakers, white noise, and their sum)."""
    base = root / "MiniLibriMix" / "wav8k" / "min" / "train"
    rows = ["mixture_ID,mixture_path,source_1_path,source_2_path,noise_path,length"]
    for i in range(MINI_ROWS):
        seconds = float(rng.uniform(*MINI_SECONDS))
        s1, s2 = (_tone_burst(bursts, seconds, MINI_SR) for _ in range(2))
        noise = (0.05 * rng.standard_normal(len(s1))).astype(np.float32)
        mid = f"{100 + i}-{5000 + i}-{i:04d}_{300 + i}-{7000 + i}-{i:04d}"
        paths = {}
        for role, x in (("mix_both", s1 + s2 + noise), ("s1", s1), ("s2", s2), ("noise", noise)):
            paths[role] = base / role / f"{mid}.wav"
            _write_audio(paths[role], x, MINI_SR)
        rows.append(f"{mid},{paths['mix_both']},{paths['s1']},{paths['s2']},{paths['noise']},"
                    f"{len(s1)}")
    csv_path = root / "MiniLibriMix" / "metadata" / "mixture_train_mix_both.csv"
    csv_path.parent.mkdir(parents=True)
    csv_path.write_text("\n".join(rows) + "\n")
    return csv_path


def _write_spatial_librispeech(root: Path, utterances, rng) -> Path:
    """Spatial LibriSpeech: ``OVERLAP_CORPUS_FILES`` utterances of phase 14
    rendered to 4-channel (first-order ambisonics) FLAC under
    ``audio_files/{train,test}`` by a seeded gain per channel, and their rows
    of ``metadata.parquet`` (needs pandas)."""
    import pandas as pd

    frame = {k: [] for k in ("split", "sample_id", "speech/librispeech_metadata/transcription",
                             "speech/librispeech_metadata/reader_sex",
                             "speech/librispeech_metadata/reader_id")}
    for i, cut in enumerate(list(utterances)[:OVERLAP_CORPUS_FILES]):
        split = "train" if i % 4 else "test"
        x = cut.load_audio()[0]
        _write_audio(root / "audio_files" / split / f"{1000 + i:06}.flac",
                     np.stack([x * float(g) for g in rng.uniform(0.3, 1.0, 4)]), SR)
        for key, value in zip(frame, (split, 1000 + i, cut.supervisions[0].text, "FM"[i % 2],
                                      cut.recording_id.split("-")[0])):
            frame[key].append(value)
    pd.DataFrame(frame).to_parquet(root / "metadata.parquet")
    return root


def _write_earnings(root: Path, rng, bursts, name: str) -> Path:
    """Earnings-21 or -22: ``OVERLAP_CORPUS_FILES`` calls of
    ``EARNINGS_SECONDS`` as MP3 (libmp3lame) under ``media/``, their
    ``transcripts/nlp_references/*.nlp`` token tables, and for Earnings-22 a
    ``metadata.csv`` with the language region."""
    from lhotse_tpu_torch.audio import syscodecs

    nlp = root / "transcripts" / "nlp_references"
    nlp.mkdir(parents=True)
    meta = ["File ID,Ticker Symbol,Country by Ticker,Un Region,Language Region,Sector,Time"]
    regions = ("African", "Asian", "English", "European", "Latin American", "Other")
    for i in range(OVERLAP_CORPUS_FILES):
        call = f"{4320211 + 97 * i}"
        (root / "media").mkdir(exist_ok=True)
        (root / "media" / f"{call}.mp3").write_bytes(syscodecs.mp3_encode(
            _tone_burst(bursts, EARNINGS_SECONDS)[None, :], SR))
        tokens = [EARNINGS_WORDS[j] for j in rng.integers(0, len(EARNINGS_WORDS), 40)]
        (nlp / f"{call}.nlp").write_text("\n".join(
            ["token|speaker|ts|endTs|punct|case|tags|wer_tags"]
            + [f"{t}|{1 + j % 3}|||{',' if j % 7 == 6 else ''}|LC|[]|[]"
               for j, t in enumerate(tokens)]) + "\n")
        meta.append(f"{call},TCK{i},Country{i},Region{i},{regions[i % len(regions)]},Sector,0:02:00")
    if name == "earnings22":
        (root / "metadata.csv").write_text("\n".join(meta) + "\n")
    return root


def _phase_overlap(workdir: Path, device, fbank_cuda, smi: str) -> tuple:
    """28. The overlapped-speech, diarization and earnings-call recipes and
    the CHiME-6 array synchroniser, in phase 14's directory after phase 27
    (phase 14's LibriSpeech manifests and phase 23's WHAM!, MUSAN and
    RIRS_NOISES manifests feed it). Every recipe runs as a function and
    through the CLI's ``prepare`` command, and their manifests must be equal.
    ``librimix_device_chain``: Libri2Mix metadata in the published columns,
    256 rows over phase 14's 160 utterances and phase 23's WHAM! noises →
    ``prepare_librimix(n_src=2)`` (the noise extended by its crossfade where
    it is shorter than the mixture) → the ``_noisy`` mixtures loaded on the
    host as the 15 s x 256 bucket's int16 batch → ``OnDeviceAugmenter`` with
    phase 23's MUSAN pool and real RIR, speed 1.1, SNR (10, 20) and
    SpecAugment, as every ``_device_chain`` leg.
    ``librimix_separation_extract``: the first 32 rows' clean sources (padded
    to their mixture) and noisy mixtures → ``compute_and_store_features_batch``
    on the kernel into ``lilcom_chunky``; ``librimix_separation``: the stored
    features → ``PreMixedSourceSeparationDataset`` → the AdamW step (no
    launch). ``librispeechmix_surt``: 64 two-speaker entries of
    ``test-clean-2mix.jsonl`` → ``prepare_librispeechmix`` →
    ``K2SurtDataset(num_channels=2)`` with ``OnTheFlyFeatures`` → the step.
    ``dihard3_diarization_extract`` / ``dihard3_diarization`` and
    ``voxconverse_diarization_extract`` / ``voxconverse_diarization``: 4
    sessions of 120 s with 2-6 speakers in overlapping turns in each corpus's
    layout → its recipe → 15 s windows → ``compute_and_store_features_batch``
    → ``DiarizationDataset`` → the step. ``chime6_array_sync``: a raw CHiME-5
    dev split (S02 of 60 s and S09 of 30 s, six 4-channel arrays and four
    binaural headsets each) and a local ``audio_edits.json`` →
    ``prepare_chime6(perform_array_sync=True, mic="mdm")``, the U01 channels
    against their edit splice sample by sample, ``verify_md5_checksums`` on
    an MD5 list of the synced files (and its refusal of a changed digest),
    then ``trim_to_supervisions(keep_all_channels=True)`` → ``to_mono()`` →
    ``OnTheFlyFeatures`` → the step. ``corpus_librimix_mini``: the
    MiniLibriMix layout at 8 kHz → ``prepare_librimix_mini(
    with_precomputed_mixtures=True, sampling_rate=8000)`` → the premixed
    mixtures resampled to 16 kHz → the step. ``corpus_spatial_librispeech``
    (where pandas imports: 16 four-channel files, a MonoCut per channel) and
    ``corpus_earnings21`` / ``corpus_earnings22`` (where the MP3 libraries
    load: 16 calls of 120 s each, in 15 s windows) into the step; otherwise a
    line names what is missing. Returns the kernel's launches per path and
    the largest kernel-vs-plain error."""
    import hashlib
    import warnings

    from lhotse_tpu_torch import recipes as R
    from lhotse_tpu_torch.audio import RecordingSet, syscodecs
    from lhotse_tpu_torch.audio.wavio import read_wav
    from lhotse_tpu_torch.caching import set_caching_enabled
    from lhotse_tpu_torch.cut import CutSet, MonoCut, MultiCut
    from lhotse_tpu_torch.dataset import (
        DiarizationDataset, K2SurtDataset, PreMixedSourceSeparationDataset, SimpleCutSampler)
    from lhotse_tpu_torch.dataset.input_strategies import AudioSamples, OnTheFlyFeatures
    from lhotse_tpu_torch.dataset.loader import DataLoader
    from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
    from lhotse_tpu_torch.features import Fbank, FbankConfig
    from lhotse_tpu_torch.features.io import LilcomChunkyWriter
    from lhotse_tpu_torch.recipes.chime6 import Chime6ArraySynchronizer, verify_md5_checksums
    from lhotse_tpu_torch.supervision import SupervisionSet
    from lhotse_tpu_torch.tracing import set_tracing_enabled, trace_span
    from lhotse_tpu_torch.utils import fastcopy, is_module_available

    set_caching_enabled(False)
    set_tracing_enabled(True)
    rng = np.random.default_rng(OVERLAP_SEED)
    bursts = np.random.RandomState(OVERLAP_SEED)
    root = workdir / "overlap"
    manifests = root / "manifests"
    launches, errs = {}, []

    def fly():
        extractor = Fbank(FbankConfig(device=device))
        return extractor, _RecordFirstBatch(extractor)

    def loader_over(cuts, dataset):
        return DataLoader(SimpleCutSampler(cuts, max_duration=FLY_MAX_DURATION, shuffle=True,
                                           seed=0), dataset, prefetch_batches=3)

    # -- librimix_device_chain ----------------------------------------------------------------
    ls_manifests = workdir / "manifests"
    utterances = CutSet.from_cuts(c for split in RECIPE_SPLITS for c in CutSet.from_manifests(
        recordings=RecordingSet.from_file(ls_manifests / f"librispeech_recordings_{split}.jsonl.gz"),
        supervisions=SupervisionSet.from_file(
            ls_manifests / f"librispeech_supervisions_{split}.jsonl.gz"))).to_eager()
    ls_root = root / "librispeech"
    ls_root.mkdir(parents=True)
    # LibriMix strips the last '-' field of each cut id to find the source; LibriSpeechMix
    # looks the cuts up by recording id.
    for part in ("train-100", "test-clean"):
        utterances.to_file(ls_root / f"librispeech_cutset_{part}.jsonl.gz")
    wham_root = workdir / "noise_meetings" / "manifests" / "wham" / "function"
    wham_ids = sorted(r.id for r in RecordingSet.from_file(wham_root / "wham_recordings_tr.jsonl.gz"))
    meta = _write_librimix_metadata(root, utterances, wham_ids, rng)
    work = root / "librimix_work"
    made, files, function_s, cli_s = _prepare_twice(
        manifests, "librimix",
        lambda o: R.prepare_librimix(ls_root, wham_root, meta, work, output_dir=o, n_src=2),
        ["librimix", ls_root, wham_root, meta, work, "--n-src", "2"])
    clean = list(made["libri2mix_train-100"]["cutset"])
    noisy = list(made["libri2mix_train-100_noisy"]["cutset"])
    extended = sorted(p.name for p in work.iterdir())
    sec, bsz = BUCKET
    n = int(sec * SR)
    t0 = time.perf_counter()
    audio, lens = np.zeros((bsz, n), np.float32), np.zeros(bsz, np.int64)
    for k, cut in enumerate(noisy):
        x = cut.load_audio()[0]
        audio[k, : x.size], lens[k] = x, x.size
    load_s = time.perf_counter() - t0
    pool, rir, noise, rir_rec = _noise_pool_and_rir(workdir)
    speeds = {s: sum(c.tracks[-1].cut.recording.id.split("_vp")[0].endswith(s) for c in noisy)
              for s in ("sp08", "sp12")}
    print(f"[{smi}] librimix_device_chain: Libri2Mix metadata of {LIBRIMIX_ROWS} rows over "
          f"{len(utterances)} LibriSpeech utterances and {len(wham_ids)} WHAM! train noises "
          f"(tripled at speeds 0.8/1.0/1.2: {speeds} rows take the 0.8 and 1.2 variants); "
          f"prepare {function_s!r} s, CLI {cli_s!r} s, its {len(files)} manifests equal; "
          f"{len(clean)} clean and {len(noisy)} noisy mixtures, {len(extended)} noises extended "
          f"into the work directory; the noisy mixtures loaded in {load_s!r} s: "
          f"{float(lens.sum()) / SR!r} audio-s, the bucket {float(lens.sum()) / (bsz * n)!r} full")
    if (len(noisy) != bsz or [c.id for c in noisy] != [c.id for c in clean] or not extended
            or lens.max() > n or lens.min() < 4 * SR):
        raise AssertionError("librimix_device_chain: the mixtures do not fill the bucket")
    launches["librimix_device_chain"], kernel_err, chain_err = _device_chain(
        "librimix_device_chain", [(audio, lens)] * 2, pool, rir, device, fbank_cuda, smi)
    errs += [kernel_err, chain_err]

    # -- librimix_separation_extract, librimix_separation --------------------------------------
    sources, mixtures = [], []
    for clean_mix, noisy_mix in zip(clean[:SEPARATION_ROWS], noisy[:SEPARATION_ROWS]):
        for k, track in enumerate(clean_mix.tracks):
            source = track.cut
            if source.duration < clean_mix.duration:
                source = source.pad(duration=clean_mix.duration)
            sources.append(fastcopy(source, id=f"{clean_mix.id}-src{k}"))
        mixtures.append(noisy_mix)
    extractor, recorder = fly()
    stored = {}

    def extract():
        stored["cuts"] = CutSet.from_cuts(sources + mixtures).compute_and_store_features_batch(
            extractor, root / "separation_feats", manifest_path=root / "separation.jsonl",
            storage_type=LilcomChunkyWriter).to_eager()

    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    wall_ms, busy_ms, _ = _device_busy(extract)
    launches["librimix_separation_extract"] = fbank_cuda.LAUNCHES
    err = _first_batch_err(recorder, extractor)
    seconds = sum(c.duration for c in sources + mixtures)
    print(f"[{smi}] librimix_separation_extract: {len(sources)} clean sources (padded to their "
          f"mixture) and {len(mixtures)} noisy mixtures, {seconds!r} audio-s extracted and stored "
          f"in {wall_ms!r} ms under torch.profiler: {seconds / wall_ms * 1e3!r} audio-s/s; device "
          f"busy {busy_ms / wall_ms!r} of the wall; fbank kernel launches "
          f"{launches['librimix_separation_extract']}; first batch kernel vs plain {err!r} (tol "
          f"{KERNEL_TOL})")
    if not launches["librimix_separation_extract"] >= 1 or not err <= KERNEL_TOL:
        raise AssertionError("librimix_separation_extract: launches or the kernel are off")
    errs.append(err)

    def premixed(featured):
        by_id = {c.id: c for c in featured}
        relabelled = [fastcopy(by_id[s.id], recording=None, features=fastcopy(
            by_id[s.id].features, recording_id=s.id.rsplit("-src", 1)[0])) for s in sources]
        return PreMixedSourceSeparationDataset(
            CutSet.from_cuts(relabelled), CutSet.from_cuts(by_id[m.id] for m in mixtures))

    def sep_batches(dataset):
        for lo in range(0, len(dataset), SEP_BATCH):
            with trace_span("dataset.assemble"):
                items = [dataset[i] for i in range(lo, min(lo + SEP_BATCH, len(dataset)))]
            yield items

    def sep_rows(items):
        feats, feat_lens = _padded([it["mixture"] for it in items])
        return feats, feat_lens, sum(feat_lens) * 0.01

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "not yet updated to use the new sampling mechanism"
        dataset = premixed(stored["cuts"])
        cpu = premixed(CutSet.from_file(root / "separation.jsonl").to_eager())
    run = _leg("librimix_separation", sep_batches(dataset), _Trainer(device), device, fbank_cuda,
               sep_rows, smi, unit="mixture")
    launches["librimix_separation"] = run["launches"]
    items = [it for b in run["batches"] for it in b]
    mask_err = 0.0
    for it in items:
        power = np.exp(it["sources"]).sum(0)
        mask_err = max(mask_err, float(np.abs(it["real_mask"].sum(0) - power / (power + 1e-10)).max()))
    masks_equal = len(items) == len(cpu) == SEPARATION_ROWS and all(
        np.array_equal(it["real_mask"], cpu[i]["real_mask"])
        and np.array_equal(it["binary_mask"], cpu[i]["binary_mask"]) for i, it in enumerate(items))
    print(f"[{smi}] librimix_separation: {len(items)} mixtures of "
          f"{items[0]['sources'].shape[0]} sources; real_mask sums over the sources to "
          f"P / (P + EPSILON) within {mask_err!r} (tol 1e-6); masks equal to the dataset on the "
          f"manifest read back: {masks_equal}")
    if run["launches"] != 0 or not mask_err <= 1e-6 or not masks_equal:
        raise AssertionError("librimix_separation: a launch, or the masks are off")

    # -- librispeechmix_surt ------------------------------------------------------------------
    lists = _write_librispeechmix(root / "LibriSpeechMix", utterances, rng)
    made, files, function_s, cli_s = _prepare_twice(
        manifests, "librispeechmix",
        lambda o: R.prepare_librispeechmix(ls_root, lists, output_dir=o),
        ["librispeechmix", ls_root, lists], seed=OVERLAP_SEED)
    mixed = made["test-clean-2mix"]["cutset"].to_eager()
    extractor, recorder = fly()
    loader = loader_over(mixed, K2SurtDataset(
        num_channels=2, return_cuts=True, input_strategy=OnTheFlyFeatures(extractor)))
    run = _leg("librispeechmix_surt", loader, _Trainer(device), device, fbank_cuda,
               lambda b: (b["inputs"], b["input_lens"], sum(c.duration for c in b["cuts"])), smi)
    launches["librispeechmix_surt"] = run["launches"]
    err = _first_batch_err(recorder, extractor)
    cpu = K2SurtDataset(num_channels=2, return_cuts=True, input_strategy=AudioSamples())

    def sups(batch):
        return [[[s.to_dict() for s in ch] for ch in cut] for cut in batch["supervisions"]]

    same = all(b["text"] == want["text"] and sups(b) == sups(want)
               for b, want in ((b, cpu[b["cuts"]]) for b in run["batches"]))
    seen = sorted(c.id for b in run["batches"] for c in b["cuts"])
    overlapped = sum(1 for b in run["batches"] for cut in b["supervisions"] if cut[1])
    print(f"[{smi}] librispeechmix_surt: prepare {function_s!r} s, CLI {cli_s!r} s, its "
          f"{len(files)} manifests equal; {len(mixed)} two-speaker mixtures, every one once: "
          f"{seen == sorted(c.id for c in mixed)}, {overlapped} with a supervision on channel 1; "
          f"supervisions and text equal to the CPU port's dataset on the same cuts: {same}; "
          f"first batch kernel vs plain {err!r} (tol {KERNEL_TOL})")
    if run["launches"] != len(run["batches"]) or seen != sorted(c.id for c in mixed):
        raise AssertionError("librispeechmix_surt: launches or the epoch's cuts are off")
    if len(mixed) != LSMIX_ENTRIES or not same or not overlapped or not err <= KERNEL_TOL:
        raise AssertionError("librispeechmix_surt: the supervisions, text or features are off")
    errs.append(err)

    # -- dihard3_diarization(_extract), voxconverse_diarization(_extract) -----------------------
    t0 = time.perf_counter()
    dihard, vox, n_turns = _write_diarization_corpora(root / "diarization", rng)
    print(f"[{smi}] DIHARD III and VoxConverse layouts ({DIAR_SESSIONS} sessions of "
          f"{DIAR_SECONDS:g} s each, {n_turns} turns) written in {time.perf_counter() - t0!r} s")
    diarization = {
        "dihard3": (lambda o: R.prepare_dihard3(dev_audio_dir=dihard, output_dir=o),
                    ["dihard3", "--dev", dihard]),
        "voxconverse": (lambda o: R.prepare_voxconverse(vox, output_dir=o), ["voxconverse", vox]),
    }
    for name, (function, argv) in diarization.items():
        made, files, function_s, cli_s = _prepare_twice(manifests, name, function, argv)
        sessions = CutSet.from_manifests(recordings=made["dev"]["recordings"],
                                         supervisions=made["dev"]["supervisions"])
        windows = sessions.cut_into_windows(VAD_WINDOW).to_eager()
        extractor, recorder = fly()
        stored = {}

        def extract():
            stored["cuts"] = windows.compute_and_store_features_batch(
                extractor, root / f"{name}_feats", storage_type=LilcomChunkyWriter).to_eager()

        torch.cuda.synchronize()
        fbank_cuda.LAUNCHES = 0
        wall_ms, busy_ms, _ = _device_busy(extract)
        launches[f"{name}_diarization_extract"] = fbank_cuda.LAUNCHES
        err = _first_batch_err(recorder, extractor)
        featured = stored["cuts"]
        seconds = sum(c.duration for c in featured)
        print(f"[{smi}] {name}_diarization_extract: prepare {function_s!r} s, CLI {cli_s!r} s, "
              f"its {len(files)} manifests equal; {len(made['dev']['supervisions'])} turns of "
              f"{len(made['dev']['recordings'])} sessions; {len(featured)} windows of "
              f"{VAD_WINDOW:g} s, {seconds!r} audio-s extracted and stored in {wall_ms!r} ms "
              f"under torch.profiler: {seconds / wall_ms * 1e3!r} audio-s/s; device busy "
              f"{busy_ms / wall_ms!r} of the wall; fbank kernel launches "
              f"{launches[f'{name}_diarization_extract']}; first batch kernel vs plain {err!r} "
              f"(tol {KERNEL_TOL})")
        if (not launches[f"{name}_diarization_extract"] >= 1 or not err <= KERNEL_TOL
                or len(featured) != DIAR_SESSIONS * int(DIAR_SECONDS // VAD_WINDOW)):
            raise AssertionError(f"{name}_diarization_extract: launches, windows or the kernel "
                                 "are off")
        errs.append(err)
        dataset = _KeepCuts(DiarizationDataset(featured, global_speaker_ids=True,
                                               min_speaker_dim=4))
        run = _leg(f"{name}_diarization", loader_over(featured, dataset), _Trainer(device),
                   device, fbank_cuda, lambda b: (b["features"], b["features_lens"],
                                                  float(np.sum(b["features_lens"])) * 0.01), smi)
        launches[f"{name}_diarization"] = run["launches"]
        speakers = dataset.dataset.speakers
        activity_equal = all(
            np.array_equal(b["speaker_activity"], _activity_reference(cuts, speakers))
            for cuts, b in zip(dataset.cuts, run["batches"]))
        overlap = float(np.mean([(b["speaker_activity"].clip(0).sum(1) > 1).mean()
                                 for b in run["batches"]]))
        print(f"[{smi}] {name}_diarization: {len(speakers)} speakers; speaker_activity equal to "
              f"the raster of the supervisions: {activity_equal}; share of frames with two or "
              f"more speakers {overlap!r}")
        if run["launches"] != 0 or not activity_equal or not overlap > 0:
            raise AssertionError(f"{name}_diarization: launches or the speaker activity are off")

    # -- chime6_array_sync --------------------------------------------------------------------
    t0 = time.perf_counter()
    chime5, edits, n_turns = _write_chime5(root / "CHiME5", rng)
    print(f"[{smi}] raw CHiME-5 dev split ({', '.join(f'{s} of {t:g} s' for s, t in CHIME5_SESSIONS)}"
          f", {CHIME5_ARRAYS} x {CHIME5_CHANNELS}-channel arrays and 4 binaural headsets each) "
          f"written in {time.perf_counter() - t0!r} s")
    for where in ("function", "cli"):
        (manifests / "chime6" / where / "CHiME6").mkdir(parents=True)
        (manifests / "chime6" / where / "CHiME6" / "audio_edits.json").write_text(json.dumps(edits))
    made, files, function_s, cli_s = _prepare_twice(
        manifests, "chime6",
        lambda o: R.prepare_chime6(chime5, output_dir=o, dataset_parts="dev", mic="mdm",
                                   perform_array_sync=True),
        ["chime6", chime5, "-p", "dev", "--mic", "mdm", "--perform-array-sync"])
    synced = manifests / "chime6" / "function" / "CHiME6"
    channel_s = sum(seconds * (CHIME5_ARRAYS * CHIME5_CHANNELS + 2 * len(CHIME5_HEADSETS[s]))
                    for s, seconds in CHIME5_SESSIONS)
    splice_equal = True
    for session, _ in CHIME5_SESSIONS:
        fit = edits[session]["U01"]
        for c in range(CHIME5_CHANNELS):
            name = f"{session}_U01.CH{c + 1}.wav"
            x, _ = read_wav(chime5 / "audio" / "dev" / name)
            want = Chime6ArraySynchronizer._apply_edits(x, fit["edits"])
            pad = fit["padding"]
            want = np.pad(want, ((0, 0), (pad, 0))) if pad > 0 else want[:, -pad:]
            got, _ = read_wav(synced / "audio" / "dev" / name)
            splice_equal &= fit["speed"] == 1.0 and np.array_equal(got, want)
    wavs = sorted(synced.rglob("*.wav"))
    sums = root / "audio_md5sums.txt"
    sums.write_text("".join(f"{hashlib.md5(w.read_bytes()).hexdigest()} {w.name}\n" for w in wavs))
    verified = verify_md5_checksums(synced, num_workers=4, checksum_file=sums)
    changed = root / "audio_md5sums_changed.txt"
    lines = sums.read_text().splitlines()
    lines[len(lines) // 2] = "0" * 32 + lines[len(lines) // 2][32:]
    changed.write_text("\n".join(lines) + "\n")
    refused = not verify_md5_checksums(synced, num_workers=4, checksum_file=changed)
    recs, sups = made["dev"]["recordings"], made["dev"]["supervisions"]
    sessions = CutSet.from_manifests(recordings=recs, supervisions=sups).to_eager()
    trimmed = sessions.trim_to_supervisions(keep_overlapping=False, keep_all_channels=True).to_eager()
    monos = CutSet.from_cuts(m for c in trimmed for m in c.to_mono())
    extractor, recorder = fly()
    loader = loader_over(monos, K2SpeechRecognitionDataset(
        return_cuts=True, input_strategy=OnTheFlyFeatures(extractor)))
    run = _leg("chime6_array_sync", loader, _Trainer(device), device, fbank_cuda, _rows_of, smi,
               unit="channel")
    launches["chime6_array_sync"] = run["launches"]
    err = _first_batch_err(recorder, extractor)
    rows = sum(b["inputs"].shape[0] for b in run["batches"])
    print(f"[{smi}] chime6_array_sync: prepare_chime6(perform_array_sync=True, mic='mdm') "
          f"{function_s!r} s, the CLI's --perform-array-sync {cli_s!r} s, its {len(files)} "
          f"manifests equal; the synchroniser and the recipe took {function_s / channel_s!r} s "
          f"per channel-second ({channel_s:g} channel-s); {len(wavs)} synced files, every U01 "
          f"channel (speed 1.0) equal to its edit splice sample by sample: {splice_equal}; "
          f"verify_md5_checksums on their MD5 list: {verified}, with one digest changed: "
          f"{not refused}; {len(sups)} supervisions of {len(recs)} sessions of "
          f"{sorted({r.num_channels for r in recs})} channels -> {len(trimmed)} trimmed -> "
          f"{len(monos)} MonoCuts ({rows} rows); first batch kernel vs plain {err!r} (tol "
          f"{KERNEL_TOL})")
    if not splice_equal or not verified or not refused or len(recs) != len(CHIME5_SESSIONS):
        raise AssertionError("chime6_array_sync: the splice or the checksums are off")
    if len(sups) != n_turns or not all(isinstance(c, MultiCut) for c in sessions) or {
            type(c) for c in monos} != {MonoCut}:
        raise AssertionError("chime6_array_sync: the sessions or supervisions are off")
    if run["launches"] != len(run["batches"]) or rows != len(monos) or not err <= KERNEL_TOL:
        raise AssertionError("chime6_array_sync: launches, coverage or the kernel are off")
    errs.append(err)

    # -- corpus_librimix_mini -----------------------------------------------------------------
    csv_path = _write_librimix_mini(root / "corpora", bursts, rng)
    made, files, function_s, cli_s = _prepare_twice(
        manifests, "librimix_mini",
        lambda o: R.prepare_librimix_mini(csv_path, output_dir=o, with_precomputed_mixtures=True,
                                          sampling_rate=MINI_SR),
        ["librimix-mini", csv_path, "--with-precomputed-mixtures", "--sampling-rate", MINI_SR])
    premixed_cuts = CutSet.from_manifests(
        recordings=made["premixed"]["recordings"],
        supervisions=made["premixed"]["supervisions"]).resample(SR).to_eager()
    extractor, recorder = fly()
    run = _leg("corpus_librimix_mini", loader_over(premixed_cuts, K2SpeechRecognitionDataset(
        return_cuts=True, input_strategy=OnTheFlyFeatures(extractor))), _Trainer(device), device,
        fbank_cuda, _rows_of, smi)
    launches["corpus_librimix_mini"] = run["launches"]
    err = _first_batch_err(recorder, extractor)
    kept = sorted(c.id for b in run["batches"] for c in b["supervisions"]["cut"])
    print(f"[{smi}] corpus_librimix_mini: prepare {function_s!r} s, CLI {cli_s!r} s, its "
          f"{len(files)} manifests equal ({sorted(made)}); {len(premixed_cuts)} premixed "
          f"mixtures at {MINI_SR} Hz resampled to {SR} Hz, every one once: "
          f"{kept == sorted(c.id for c in premixed_cuts)}; first batch kernel vs plain {err!r} "
          f"(tol {KERNEL_TOL})")
    if (kept != sorted(c.id for c in premixed_cuts) or len(kept) != MINI_ROWS
            or sorted(made) != ["noise", "premixed", "sources"]
            or any(c.sampling_rate != SR for b in run["batches"] for c in b["supervisions"]["cut"])):
        raise AssertionError("corpus_librimix_mini: coverage or the rate is off")
    if run["launches"] != len(run["batches"]) or not err <= KERNEL_TOL:
        raise AssertionError("corpus_librimix_mini: launches or the kernel are off")
    errs.append(err)

    # -- corpus_spatial_librispeech, corpus_earnings21, corpus_earnings22 ----------------------
    specs = {}
    if is_module_available("pandas"):
        spatial = _write_spatial_librispeech(root / "corpora" / "Spatial-LibriSpeech", utterances,
                                             rng)
        specs["spatial_librispeech"] = (
            lambda o: R.prepare_spatial_librispeech(spatial, output_dir=o),
            ["spatial-librispeech", spatial], "multi")
    else:
        print(f"[{smi}] corpus_spatial_librispeech left out: pandas does not import here, and the "
              "recipe reads metadata.parquet through it (ROADMAP.md A3)")
    if syscodecs.mp3_available() and syscodecs.mp3_encode_available():
        for name in ("earnings21", "earnings22"):
            where = _write_earnings(root / "corpora" / name, rng, bursts, name)
            specs[name] = ((lambda o, w=where, n=name: getattr(R, f"prepare_{n}")(w, output_dir=o)),
                           [name, where], "long")
    else:
        print(f"[{smi}] corpus_earnings21 and corpus_earnings22 left out: the MP3 libraries "
              f"(libmpg123, libmp3lame) do not load here: {syscodecs.loaded_sonames()} "
              "(ROADMAP.md A3)")
    for name, (function, argv, kind) in specs.items():
        made, files, function_s, cli_s = _prepare_twice(manifests, name, function, argv)
        pairs = _manifest_pairs(made) or [made]  # Earnings returns one (recordings, supervisions)
        cuts = CutSet.from_cuts(c for recs, sups in pairs for c in CutSet.from_manifests(
            recordings=recs, supervisions=sups))
        extractor, recorder = fly()
        if kind == "multi":  # 4-channel ambisonics: a MonoCut per channel
            cuts = CutSet.from_cuts(m for c in cuts.trim_to_supervisions(
                keep_all_channels=True) for m in c.to_mono())
            dataset = K2SpeechRecognitionDataset(return_cuts=True,
                                                 input_strategy=OnTheFlyFeatures(extractor))
            unpack = _rows_of
        else:  # whole calls, longer than the encoder's positions: windows of 15 s
            cuts = cuts.cut_into_windows(VAD_WINDOW).to_eager()
            dataset = _WindowFeatures(OnTheFlyFeatures(extractor))
            unpack = (lambda b: (b["inputs"], b["supervisions"]["num_frames"],
                                 sum(c.duration for c in b["supervisions"]["cut"])))
        run = _leg(f"corpus_{name}", loader_over(cuts, dataset), _Trainer(device), device,
                   fbank_cuda, unpack, smi)
        launches[f"corpus_{name}"] = run["launches"]
        err = _first_batch_err(recorder, extractor)
        kept = sorted(c.id for b in run["batches"] for c in b["supervisions"]["cut"])
        print(f"[{smi}] corpus_{name}: prepare {function_s!r} s, CLI {cli_s!r} s, its "
              f"{len(files)} manifests equal; {len(cuts)} cuts, every one once: "
              f"{kept == sorted(c.id for c in cuts)}; first batch kernel vs plain {err!r} (tol "
              f"{KERNEL_TOL})")
        if kept != sorted(c.id for c in cuts) or run["launches"] != len(run["batches"]):
            raise AssertionError(f"corpus_{name}: coverage or launches are off")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"corpus_{name}: the kernel disagrees with its plain version")
        errs.append(err)
    set_tracing_enabled(False)
    return launches, max(errs)


TRANSLATION_SEED = 2929
MUSTC_TALKS = 8  # train talks of the MuST-C en-de layout
MUSTC_TALK_SECONDS = 300.0
MUSTC_SEGMENTS = 32  # segments of each train talk: 8 x 32 fill the 15 s x 256 bucket
MUSTC_SEGMENT_SECONDS = (2.0, 15.0)
MUSTC_GAP_SECONDS = (0.05, 0.5)
MUSTC_EVAL_SECONDS = 60.0  # the one talk of each of dev, tst-COMMON and tst-HE
IWSLT_CONVERSATIONS = 8
IWSLT_SECONDS = 120.0
IWSLT_SR = 8000  # LDC2022E01: 8 kHz telephone conversations
IWSLT_RESUME_AFTER = 2
GIGAST_FILES = 16
GIGAST_SECONDS = 40.0
TRANSLATION_CORPUS_FILES = 16  # files of each corpus_<name> leg of phase 29
TRANSLATION_CORPUS_SECONDS = 30.0
GERMAN = ("wir", "müssen", "über", "Energie", "nachdenken", "und", "das", "Klima", "ändert",
          "sich", "schön", "Straße", "Menschen", "die", "Welt")
TRANSLATION_ENGLISH = ("we", "have", "to", "think", "about", "energy", "and", "the", "climate",
                       "is", "changing", "people", "world", "today", "good")
TUNISIAN = ("كلام", "تونسي", "باهي", "برشا", "اليوم", "شنوة", "أحوالك", "إنشاء", "آمين", "مرحبا",
            "يعيشك", "توة")
VTT_SPANISH = ("hola", "mundo", "buenos", "días", "energía", "niño", "señor", "qué", "tal",
               "clima", "personas")
THAI = ("สวัสดี", "ครับ", "ขอบคุณ", "มาก", "วันนี้", "อากาศ", "ดี", "เรา", "ต้อง", "คิด")
# (surface, pronunciation, part of speech) of CSJ's SDB words, some with disfluency tags.
CSJ_WORDS = (("それ", "ソレ", "代名詞"), ("は", "ワ", "助詞"), ("です", "デス", "助動詞"),
             ("日本", "ニッポン", "名詞"), ("語", "ゴ", "接尾辞"), ("話し", "ハナシ", "動詞"),
             ("ます", "マス", "助動詞"), ("研究", "ケンキュー", "名詞"), ("(F えー)", "(F エー)", "感動詞"),
             ("(D ど)", "(D ド)", "言いよどみ"), ("(W アタシ;ワタシ)", "(W アタシ;ワタシ)", "代名詞"),
             ("(? はい)", "(? ハイ)", "感動詞"))


def _speech_track(rng, seconds: float, segments: list, sr: int = SR) -> np.ndarray:
    """(1, n) audio of ``seconds``: a quiet noise floor with a tone burst
    under each (start, end) of ``segments``."""
    n = int(seconds * sr)
    audio = (rng.randn(1, n) * 0.003).astype(np.float32)
    for start, end in segments:
        i0, i1 = int(start * sr), int(end * sr)
        audio[0, i0:i1] += _tone_burst(rng, (i1 - i0 + 1) / sr, sr)[: i1 - i0]
    return np.clip(audio, -1, 1)


def _segments_within(rng, seconds: float, count: int, lengths=MUSTC_SEGMENT_SECONDS,
                     gaps=MUSTC_GAP_SECONDS) -> list:
    """``count`` (start, end) segments of ``lengths`` seconds after gaps of
    ``gaps``, drawn until they fit in ``seconds``; 6 decimals."""
    while True:
        out, t = [], float(rng.uniform(*gaps))
        for _ in range(count):
            length = float(rng.uniform(*lengths))
            out.append((round(t, 6), round(t + length, 6)))
            t += length + float(rng.uniform(*gaps))
        if out[-1][1] < seconds - 0.05:
            return out


def _write_must_c(root: Path, rng) -> tuple:
    """MuST-C release 1.0 ``en-de`` (fairseq's S2T example): ``en-de/data/
    {train,dev,tst-COMMON,tst-HE}/wav/ted_<n>.wav`` (16 kHz talks) with
    ``txt/<split>.yaml`` (a row per segment: duration, offset, speaker_id,
    wav) and ``txt/<split>.de`` (the German target of each row, in order).
    Train holds ``MUSTC_TALKS`` talks of ``MUSTC_TALK_SECONDS`` with
    ``MUSTC_SEGMENTS`` segments of 2-15 s each; the other splits one talk of
    ``MUSTC_EVAL_SECONDS``. Returns the corpus directory and the train
    split's rows."""
    talk = 767
    for split in ("train", "dev", "tst-COMMON", "tst-HE"):
        data = root / "en-de" / "data" / split
        (data / "txt").mkdir(parents=True, exist_ok=True)
        rows, texts = [], []
        for _ in range(MUSTC_TALKS if split == "train" else 1):
            seconds = MUSTC_TALK_SECONDS if split == "train" else MUSTC_EVAL_SECONDS
            count = MUSTC_SEGMENTS if split == "train" else 6
            segments = _segments_within(rng, seconds, count)
            _write_audio(data / "wav" / f"ted_{talk}.wav", _speech_track(rng, seconds, segments),
                         SR)
            for start, end in segments:
                rows.append(f"- {{duration: {round(end - start, 6)}, offset: {start}, "
                            f"speaker_id: spk.{talk}, wav: ted_{talk}.wav}}")
                texts.append(_words(rng, GERMAN).capitalize() + ".")
            talk += 1
        (data / "txt" / f"{split}.yaml").write_text("\n".join(rows) + "\n")
        (data / "txt" / f"{split}.de").write_text("\n".join(texts) + "\n")
        if split == "train":
            train_rows = len(rows)
    return root, train_rows


def _write_iwslt22_ta(root: Path, rng) -> tuple:
    """IWSLT 2022's dialect task (LDC2022E01 with the split lists of
    github.com/kevinduh/iwslt22-dialect): ``data/audio/ta/<file>.sph`` (8 kHz
    PCM SPHERE, one side of a call), ``data/transcripts/ta/<file>.ta.tsv``
    and ``data/translations/ta/<file>.eng.tsv`` (start, end, speaker, text
    per turn), ``splits/{train,dev,test1}.file_id.txt`` and
    ``splits/exclude-utterance.txt``. The Tunisian turns carry the corpus's
    noise markers and punctuation; each English translation is a capitalised
    sentence. Returns the corpus and splits directories and each kept
    supervision's expected translation, keyed by supervision id."""
    corpus, splits = root / "ldc", root / "splits"
    for d in ("audio", "transcripts", "translations"):
        (corpus / "data" / d / "ta").mkdir(parents=True, exist_ok=True)
    splits.mkdir(parents=True, exist_ok=True)
    names = [f"2017{k + 1:02d}15_1{k}3000_{20000 + 17 * k}_{'AB'[k % 2]}"
             for k in range(IWSLT_CONVERSATIONS)]
    expected, excluded = {}, []
    for k, name in enumerate(names):
        audio, turns = _conversation(rng, IWSLT_SECONDS, sr=IWSLT_SR, channels=1)
        _write_audio(corpus / "data" / "audio" / "ta" / f"{name}.sph", audio[0], IWSLT_SR)
        src, tgt = [], []
        for i, (_, start, end) in enumerate(turns):
            text = _words(rng, TUNISIAN)
            text = f"O/ {text}؟" if i % 3 == 0 else f"{text}، ٣ M/" if i % 3 == 1 else text + "!"
            english = _words(rng, TRANSLATION_ENGLISH)
            spk = f"spk{k}{'AB'[i % 2]}"
            src.append(f"{start:.2f}\t{end:.2f}\t{spk}\t{text}")
            tgt.append(f"{start:.2f}\t{end:.2f}\t{spk}\t{english.capitalize()}.")
            if i == 4:
                excluded.append(f"{name} {start:.2f} {end:.2f}")
            else:
                expected[f"{spk}_ta_eng_{name}_{int(100 * start):06}"] = english
        (corpus / "data" / "transcripts" / "ta" / f"{name}.ta.tsv").write_text("\n".join(src) + "\n")
        (corpus / "data" / "translations" / "ta" / f"{name}.eng.tsv").write_text(
            "\n".join(tgt) + "\n")
    (splits / "train.file_id.txt").write_text("\n".join(names[:6]) + "\n")
    (splits / "dev.file_id.txt").write_text(names[6] + "\n")
    (splits / "test1.file_id.txt").write_text(names[7] + "\n")
    (splits / "exclude-utterance.txt").write_text("\n".join(excluded) + "\n")
    return corpus, splits, expected


def _write_gigast(root: Path, rng) -> tuple:
    """GigaSpeech's manifests for ``GIGAST_FILES`` podcasts of
    ``GIGAST_SECONDS`` (16 kHz WAV here; 12 in XL, 4 in TEST; segments of
    2-8 s named ``<audio>_S<n>``), as GigaSpeech's own recipe writes them,
    and ``GigaST.de.json`` with a German translation of every segment (XL's
    with an ``extra`` field) in the audios' order. The GigaST reader runs on
    from XL into TEST and drops the line after XL's last match, so a filler
    line separates the parts. Returns the corpus and manifest directories
    and each segment's translation."""
    from lhotse_tpu_torch.audio import Recording, RecordingSet
    from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet

    manifests = root / "gigaspeech_manifests"
    manifests.mkdir(parents=True, exist_ok=True)
    translations, audios = {}, []
    parts = {"XL": [], "TEST": []}
    for k in range(GIGAST_FILES):
        part = "XL" if k < GIGAST_FILES * 3 // 4 else "TEST"
        aid = f"{'POD' if part == 'XL' else 'YOU'}{1000000000 + k}"
        segments = _segments_within(rng, GIGAST_SECONDS, 5, lengths=(2.0, 8.0))
        path = root / "audio" / f"{aid}.wav"
        _write_audio(path, _speech_track(rng, GIGAST_SECONDS, segments), SR)
        rec = Recording.from_file(path, recording_id=aid)
        sups = []
        for i, (start, end) in enumerate(segments):
            sid = f"{aid}_S{i:07d}"
            sups.append(SupervisionSegment(id=sid, recording_id=aid, start=start,
                                           duration=round(end - start, 6), channel=0,
                                           text=_words(rng, TRANSLATION_ENGLISH).upper()))
            translations[sid] = _words(rng, GERMAN)
        parts[part].append((rec, sups))
        rows = [{"sid": s.id, "text_raw": translations[s.id]} for s in sups]
        if part == "XL":
            rows = [dict(r, extra={"confidence": round(float(rng.uniform(0.5, 1.0)), 3)})
                    for r in rows]
        audios.append({"aid": aid, "segments": rows})
        if k == GIGAST_FILES * 3 // 4 - 1:
            audios.append({"aid": "FILLER", "segments": [{"sid": "FILLER", "text_raw": ""}]})
    for part, pairs in parts.items():
        RecordingSet.from_recordings(r for r, _ in pairs).to_file(
            manifests / f"gigaspeech_recordings_{part}.jsonl.gz")
        SupervisionSet.from_segments(s for _, sups in pairs for s in sups).to_file(
            manifests / f"gigaspeech_supervisions_{part}.jsonl.gz")
    (root / "GigaST.de.json").write_text(json.dumps({"audios": audios}, ensure_ascii=False),
                                         encoding="utf-8")
    return root, manifests, translations


def _write_mtedx(root: Path, rng) -> Path:
    """mTEDx's ``es-es`` package (openslr/100): ``es-es/data/{train,valid,test}/
    wav/<talk>.flac`` (16 kHz) and ``vtt/<talk>.es.vtt`` subtitles, numbered
    cues of 2-6 s, a laughter cue that the recipe drops; 12 train, 2 valid
    and 2 test talks of ``TRANSLATION_CORPUS_SECONDS``."""
    for k in range(TRANSLATION_CORPUS_FILES):
        split = _zh_split(k, TRANSLATION_CORPUS_FILES, ("train", "valid", "test"))
        talk = f"{'abcdefgh'[k % 8]}TalkId{k:03d}"
        segments = _segments_within(rng, TRANSLATION_CORPUS_SECONDS, 5, lengths=(2.0, 5.0),
                                    gaps=(0.2, 0.8))
        base = root / "es-es" / "data" / split
        _write_audio(base / "wav" / f"{talk}.flac",
                     _speech_track(rng, TRANSLATION_CORPUS_SECONDS, segments)[0], SR)
        cues = ["WEBVTT", ""]
        for i, (start, end) in enumerate(segments):
            text = "(Risas)" if i == 2 else _words(rng, VTT_SPANISH).capitalize() + "."
            cues += [str(i + 1), f"{_hms(start)} --> {_hms(end)}", text, ""]
        (base / "vtt").mkdir(parents=True, exist_ok=True)
        (base / "vtt" / f"{talk}.es.vtt").write_text("\n".join(cues))
    return root


def _write_gigaspeech2(root: Path, rng) -> Path:
    """GigaSpeech 2's Thai set: ``data/th/{train_raw,dev,test}.tsv`` (segment
    id TAB text) over ``data/th/{train,dev,test}/<a>/<b>/<a>-<b>-<c>.wav``
    (16 kHz segments of 2-8 s); 12 train, 2 dev and 2 test segments."""
    lines = {"train_raw": [], "dev": [], "test": []}
    for k in range(TRANSLATION_CORPUS_FILES):
        part = _zh_split(k, TRANSLATION_CORPUS_FILES, ("train_raw", "dev", "test"))
        sid = f"{k % 3}-{1000 + k}-{k}"
        tree = part.replace("_raw", "")
        _write_audio(root / "data" / "th" / tree / str(k % 3) / str(1000 + k) / f"{sid}.wav",
                     _zh_burst(rng, (2.0, 8.0)), SR)
        lines[part].append(f"{sid}\t{_words(rng, THAI)}")
    for part, rows in lines.items():
        (root / "data" / "th" / f"{part}.tsv").write_text("\n".join(rows) + "\n")
    return root


def _csj_sdb_rows(rng, session: str, segments: list, side: str = "L") -> list:
    """One (start, row) per word of an SDB: 17 tab-separated columns, the
    segment id and the word's times in the fourth (``<sgid> <start>-<end>
    <side>:``), the surface in the sixth, the pronunciation in the eleventh
    and the part of speech in the twelfth."""
    rows = []
    for s, (start, end) in enumerate(segments):
        sgid = f"{s + 1 + (500 if side == 'R' else 0):04d}"
        n = max(2, int((end - start) / 0.4))
        bounds = np.linspace(start, end, n + 1)
        for w in range(n):
            surface, pron, pos = CSJ_WORDS[rng.randint(len(CSJ_WORDS))]
            cols = [""] * 17
            cols[0], cols[1], cols[2] = f"{len(rows) + 1:05d}", "1", session
            cols[3] = f"{sgid} {bounds[w]:.3f}-{bounds[w + 1]:.3f} {side}:{s}"
            cols[5], cols[10], cols[11], cols[14] = surface, pron, pos, "一般"
            rows.append((float(bounds[w]), "\t".join(cols)))
    return rows


def _write_csj(root: Path, rng) -> Path:
    """CSJ's layout: ``MORPH/SDB/core/<session>.sdb`` (Shift-JIS word tables)
    and ``WAV/core/<session>.wav`` (16 kHz): 14 lectures (``A``/``S``/``R``
    sessions) and one dialogue (``D``) whose SDB holds both sides and whose
    audio is ``<session>-L.wav`` and ``-R.wav``; segments of 2-6 s."""
    sessions = [f"{'ASR'[k % 3]}{k:02d}{'MF'[k % 2]}{1000 + k:04d}" for k in range(14)]
    for session in sessions + ["D05F1001"]:
        segments = _segments_within(rng, TRANSLATION_CORPUS_SECONDS, 5, lengths=(2.0, 6.0),
                                    gaps=(0.3, 1.0))
        sdb = root / "MORPH" / "SDB" / "core" / f"{session}.sdb"
        sdb.parent.mkdir(parents=True, exist_ok=True)
        if session[0] == "D":
            right = _segments_within(rng, TRANSLATION_CORPUS_SECONDS, 4, lengths=(2.0, 6.0),
                                     gaps=(0.3, 1.0))
            rows = sorted(_csj_sdb_rows(rng, session, segments, "L")
                          + _csj_sdb_rows(rng, session, right, "R"))
            for side, segs in (("L", segments), ("R", right)):
                _write_audio(root / "WAV" / "core" / f"{session}-{side}.wav",
                             _speech_track(rng, TRANSLATION_CORPUS_SECONDS, segs), SR)
        else:
            rows = _csj_sdb_rows(rng, session, segments)
            _write_audio(root / "WAV" / "core" / f"{session}.wav",
                         _speech_track(rng, TRANSLATION_CORPUS_SECONDS, segments), SR)
        sdb.write_text("\n".join(r for _, r in rows) + "\n", encoding="shift_jis")
    return root


def _write_emilia(root: Path, rng) -> Path:
    """Emilia's English set: ``raw/EN/EN_B<n>.jsonl`` rows (id, wav, text,
    duration, speaker, language, dnsmos) over clips of 2-8 s written as WAV
    behind the corpus's ``.mp3`` names, as the JAX package's test writes
    them; 16 clips in two metadata files."""
    data = root / "raw" / "EN"
    for b in range(2):
        rows = []
        for i in range(TRANSLATION_CORPUS_FILES // 2):
            utt = f"EN_B0000{b}_S0000{i % 4}_W{i:06d}"
            rel = f"EN_B0000{b}/EN_B0000{b}_S0000{i % 4}/mp3/{utt}.mp3"
            clip = _zh_burst(rng, (2.0, 8.0))
            _write_audio(data / rel, clip, SR)
            rows.append(json.dumps({
                "id": utt, "wav": rel, "text": " " + _words(rng, TRANSLATION_ENGLISH).capitalize(),
                "duration": round(clip.size / SR, 3), "speaker": f"EN_B0000{b}_S0000{i % 4}",
                "language": "en", "dnsmos": round(float(rng.uniform(3.0, 3.6)), 4)}))
        (data / f"EN_B0000{b}.jsonl").write_text("\n".join(rows) + "\n")
    return root


def _write_bvcc(root: Path, rng) -> Path:
    """BVCC's ``phase1-main`` and ``phase1-ood`` tracks: ``DATA/wav/<sys>-
    <utt>.wav`` (16 kHz) and ``DATA/sets/{TRAINSET,DEVSET}`` rating rows
    (system, utterance, rating, ignored, listener info), ``test.scp`` and
    the OOD track's ``unlabeled_mos_list.txt``; 8 rated utterances per track
    (6 train, 2 dev), each rated by 3 listeners, and an unrated test one."""
    for track in ("main", "ood"):
        data = root / f"phase1-{track}" / "DATA"
        (data / "sets").mkdir(parents=True, exist_ok=True)
        rows = {"TRAINSET": [], "DEVSET": []}
        for u in range(TRANSLATION_CORPUS_FILES // 2):
            name = f"sys{u % 4:02d}-utt{rng.randint(16 ** 6):06x}"
            _write_audio(data / "wav" / f"{name}.wav", _zh_burst(rng, (2.0, 6.0)), SR)
            for k in range(3):
                if track == "main":
                    info = (f"{rng.randint(10 ** 6)}_{('18-29', '30-39', '40-49')[k]}_L{u}{k:03d}_"
                            f"{('Male', 'Female', 'Others')[(u + k) % 3]}_x_x_"
                            f"{('No', 'Yes')[(u * k) % 2]}")
                else:
                    info = f"{rng.randint(10 ** 6)}_na_L{u}{k:03d}_na_na_na_{('EE', 'EP', 'ER')[k]}"
                rows["DEVSET" if u >= 6 else "TRAINSET"].append(
                    f"sys{u % 4:02d},{name}.wav,{rng.randint(1, 6)},0,{info}")
        for part, lines in rows.items():
            (data / "sets" / part).write_text("\n".join(lines[::-1]) + "\n")
        _write_audio(data / "wav" / f"test-{track}.wav", _zh_burst(rng, (2.0, 4.0)), SR)
        (data / "sets" / "test.scp").write_text(f"test-{track}.wav\n")
        if track == "ood":
            (data / "sets" / "unlabeled_mos_list.txt").write_text(f"test-{track}.wav\n")
    return root


def _write_voxpopuli(root: Path, rng, syscodecs) -> tuple:
    """VoxPopuli's ASR subset: ``raw_audios/en/<year>/<session>_en.ogg``
    (16 kHz mono Ogg Vorbis sessions, cut to ``TRANSLATION_CORPUS_SECONDS``)
    and the annotation table ``asr_en.tsv.gz`` (id, session, start, end,
    speaker, gender, normalised and original text, split) that the recipe
    reads from its output directory; 16 sessions, 12 train, 2 dev, 2 test.
    Returns the corpus directory and the table's bytes."""
    import gzip

    rows = ["id|session_id|start_time|end_time|speaker_id|gender|normed_text|original_text|split"]
    for k in range(TRANSLATION_CORPUS_FILES):
        session = f"20{19 + k % 2}{k % 12 + 1:02d}{k + 1:02d}-0900-PLENARY-{k}"
        segments = _segments_within(rng, TRANSLATION_CORPUS_SECONDS, 4, lengths=(2.0, 6.0),
                                    gaps=(0.2, 1.0))
        path = root / "raw_audios" / "en" / f"20{19 + k % 2}" / f"{session}_en.ogg"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(syscodecs.vorbis_encode(
            _speech_track(rng, TRANSLATION_CORPUS_SECONDS, segments), SR))
        split = _zh_split(k, TRANSLATION_CORPUS_FILES)
        for i, (start, end) in enumerate(segments):
            words = _words(rng, TRANSLATION_ENGLISH)
            rows.append(f"{session}_{i}|{session}|{start}|{end}|{1000 + k % 5}|"
                        f"{('female', 'male')[k % 2]}|{words}|{words.capitalize()}.|{split}")
    return root, gzip.compress(("\n".join(rows) + "\n").encode())


def _translation_specs(root: Path, rng, syscodecs, manifests: Path, smi: str) -> dict:
    """Per corpus of phase 29's ``corpus_<name>`` legs, in the order they
    run: the recipe's call for an output directory, the CLI's command and
    the training path. VoxPopuli's only where the Vorbis libraries load
    (its annotation table is written into both output directories first)."""
    from lhotse_tpu_torch import recipes as R

    mtedx, gs2 = _write_mtedx(root / "mtedx", rng), _write_gigaspeech2(root / "gigaspeech2", rng)
    csj = _write_csj(root / "csj", rng)
    emilia, bvcc = _write_emilia(root / "emilia", rng), _write_bvcc(root / "bvcc", rng)
    trans = root / "csj_transcripts"
    specs = {
        "mtedx": (lambda o: R.prepare_mtedx(mtedx, o, languages="es"),
                  ["mtedx", mtedx, "-l", "es"], "asr"),
        "gigaspeech2": (lambda o: R.prepare_gigaspeech2(gs2, output_dir=o, languages="th"),
                        ["gigaspeech2", gs2, "-l", "th"], "asr"),
        "csj": (lambda o: R.prepare_csj(csj, transcript_dir=trans, manifest_dir=o,
                                        dataset_parts=["core"]),
                ["csj", csj, "-t", trans, "-p", "core"], "asr"),
        "emilia": (lambda o: R.prepare_emilia(emilia, lang="en", output_dir=o),
                   ["emilia", emilia, "--lang", "en"], "tts"),
        "bvcc": (lambda o: R.prepare_bvcc(bvcc, output_dir=o), ["bvcc", bvcc], "mos"),
    }
    if syscodecs.vorbis_available() and syscodecs.vorbis_encode_available():
        vox, table = _write_voxpopuli(root / "voxpopuli", rng, syscodecs)
        for run in ("function", "cli"):
            (manifests / "voxpopuli" / run).mkdir(parents=True, exist_ok=True)
            (manifests / "voxpopuli" / run / "asr_en.tsv.gz").write_bytes(table)
        specs["voxpopuli"] = (lambda o: R.prepare_voxpopuli(vox, output_dir=o, lang="en"),
                              ["voxpopuli", vox, "--lang", "en"], "asr")
    else:
        print(f"[{smi}] corpus_voxpopuli left out: the Vorbis libraries (libvorbisfile, "
              f"libvorbisenc, libogg) do not load here, and VoxPopuli ships Ogg Vorbis: "
              f"{syscodecs.loaded_sonames()} (ROADMAP.md A3)")
    return specs


def _translation_epoch(name, cuts, tgt_of, device, fbank_cuda, smi, resume_after=None) -> tuple:
    """``cuts`` → ``SimpleCutSampler(max_duration=FLY_MAX_DURATION)`` →
    ``K2Speech2TextTranslationDataset`` with ``OnTheFlyFeatures`` on the card
    → ``DataLoader`` → an AdamW step per batch (``_leg``, under
    ``torch.profiler``). Every batch's ``tgt_text`` must be ``tgt_of`` of its
    supervisions, and the epoch must bring each cut once. With
    ``resume_after``, a fresh loader resumed from the state after that many
    batches gives the rest of the epoch ``torch.equal`` to the first run's.
    Returns the launches and the first batch's kernel-vs-plain error."""
    from lhotse_tpu_torch.dataset import SimpleCutSampler
    from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
    from lhotse_tpu_torch.dataset.loader import DataLoader
    from lhotse_tpu_torch.dataset.speech_translation import K2Speech2TextTranslationDataset
    from lhotse_tpu_torch.features import Fbank, FbankConfig

    def loader_and_extractor():
        extractor = Fbank(FbankConfig(device=device))
        dataset = K2Speech2TextTranslationDataset(
            return_cuts=True, input_strategy=OnTheFlyFeatures(extractor))
        sampler = SimpleCutSampler(cuts, max_duration=FLY_MAX_DURATION, shuffle=True, seed=0)
        return DataLoader(sampler, dataset, prefetch_batches=3), extractor

    loader, extractor = loader_and_extractor()
    recorder = _RecordFirstBatch(extractor)
    state = {}

    def keep(i, batch):
        if resume_after is not None and i == resume_after - 1:
            state["ckpt"] = loader.state_dict()

    run = _leg(name, loader, _Trainer(device), device, fbank_cuda, _rows_of, smi, on_batch=keep)
    err = _first_batch_err(recorder, extractor)
    batches = run["batches"]
    # Each trimmed cut holds one supervision, listed once in the batch.
    tgt_ok = all(b["supervisions"]["tgt_text"]
                 == [tgt_of(c.supervisions[0]) for c in b["supervisions"]["cut"]]
                 == [c.supervisions[0].custom["translated_text"] for c in b["supervisions"]["cut"]]
                 for b in batches)
    seen = sorted(c.id for b in batches for c in b["supervisions"]["cut"])
    coverage = seen == sorted(c.id for c in cuts)
    detail = ""
    if resume_after is not None:
        resumed_loader, _ = loader_and_extractor()
        resumed_loader.load_state_dict(state["ckpt"])
        fbank_cuda.LAUNCHES = 0
        resumed = list(resumed_loader)
        resumed_launches = fbank_cuda.LAUNCHES
        want = batches[resume_after:]
        resume_ok = len(resumed) == len(want) > 0 and resumed_launches == len(want) and all(
            [c.id for c in a["supervisions"]["cut"]] == [c.id for c in b["supervisions"]["cut"]]
            and torch.equal(torch.from_numpy(a["inputs"]), torch.from_numpy(b["inputs"]))
            and a["supervisions"]["tgt_text"] == b["supervisions"]["tgt_text"]
            for a, b in zip(resumed, want))
        detail = (f"; resumed after batch {resume_after}: {len(resumed)} batches torch.equal to "
                  f"the uninterrupted run's (ids, inputs and tgt_text): {resume_ok}, launches "
                  f"{resumed_launches}")
        if not resume_ok:
            raise AssertionError(f"{name}: the resumed batches differ from the first run's")
    print(f"[{smi}] {name}: tgt_text of every batch the translations of its supervisions: "
          f"{tgt_ok}; every cut once: {coverage}; first batch kernel vs plain {err!r} (tol "
          f"{KERNEL_TOL}){detail}")
    if not (tgt_ok and coverage) or run["launches"] != len(batches) or not err <= KERNEL_TOL:
        raise AssertionError(f"{name}: tgt_text, coverage, launches or the kernel are off")
    return run["launches"], err


def _phase_translation(workdir: Path, device, fbank_cuda, smi: str) -> tuple:
    """29. The speech-translation and multilingual corpus recipes, in phase
    14's directory after phase 28 (phase 23's MUSAN noise and RIRS_NOISES
    manifests feed the augmenter). Every recipe runs as a function and
    through the CLI's ``prepare`` command, and their manifests must be
    equal. ``must_c_device_chain``: the input chain of fairseq's S2T MuST-C
    example (80-dim log-mel fbank), on MuST-C ``en-de`` in its published
    layout, 8 train talks of 300 s with 32 segments of 2-15 s each →
    ``prepare_must_c`` → ``CutSet.from_manifests`` →
    ``trim_to_supervisions`` → the 256 segments as the 15 s x 256 bucket's
    int16 batch → ``OnDeviceAugmenter`` with phase 23's MUSAN pool and real
    RIR, speed 1.1, SNR (10, 20) and SpecAugment (as every
    ``_device_chain`` leg). ``iwslt22_ta_translation``: 8 Tunisian Arabic
    calls of 120 s as 8 kHz SPHERE with transcripts, translations, split
    lists and exclusions → ``prepare_iwslt22_ta(normalize_text=True)`` →
    the train split trimmed and resampled to 16 kHz →
    ``K2Speech2TextTranslationDataset`` with ``OnTheFlyFeatures`` on the
    kernel → the AdamW step, with a resume after batch 2.
    ``gigast_translation``: GigaSpeech manifests over 16 podcasts of 40 s
    and ``GigaST.de.json`` → ``prepare_gigast`` → the translated XL and
    TEST segments, their ``text_raw`` as ``translated_text`` → the same
    dataset and step. ``corpus_<name>``: mTEDx (``es-es``, FLAC and VTT),
    GigaSpeech 2 (Thai), CSJ (14 lectures and a dialogue, Shift-JIS SDBs
    through a transcript directory), Emilia (English, into
    ``SpeechSynthesisDataset`` with a ``TokenCollater``), BVCC (the main and
    OOD tracks, whole utterances with their MOS ratings) and VoxPopuli (Ogg
    Vorbis, where the Vorbis libraries load), 16 files each, into the step
    through ``_corpus_legs``. Returns the kernel's launches per path and the
    largest kernel-vs-plain error."""
    from lhotse_tpu_torch import CutSet
    from lhotse_tpu_torch import recipes as R
    from lhotse_tpu_torch.audio import RecordingSet, syscodecs
    from lhotse_tpu_torch.caching import set_caching_enabled
    from lhotse_tpu_torch.supervision import SupervisionSet
    from lhotse_tpu_torch.tracing import set_tracing_enabled
    from lhotse_tpu_torch.utils import fastcopy

    set_caching_enabled(False)
    set_tracing_enabled(True)
    rng = np.random.RandomState(TRANSLATION_SEED)
    root = workdir / "translation"
    manifests = root / "manifests"
    launches, errs = {}, []

    # -- must_c_device_chain -----------------------------------------------------------------
    t0 = time.perf_counter()
    must_c, train_rows = _write_must_c(root / "corpora" / "must_c", rng)
    write_s = time.perf_counter() - t0
    made, files, function_s, cli_s = _prepare_twice(
        manifests, "must_c", lambda o: R.prepare_must_c(must_c, o, tgt_lang="de"),
        ["must-c", must_c, "--tgt-lang", "de"])
    train = made["train"]
    cuts = CutSet.from_manifests(recordings=train["recordings"],
                                 supervisions=train["supervisions"]).trim_to_supervisions(
        keep_overlapping=False).to_eager()
    sec, bsz = BUCKET
    n = int(sec * SR)
    order = list(cuts)[:bsz]
    t0 = time.perf_counter()
    audio, lens = np.zeros((bsz, n), np.float32), np.zeros(bsz, np.int64)
    for k, cut in enumerate(order):
        x = cut.load_audio()[0]
        audio[k, : x.size], lens[k] = x, x.size
    load_s = time.perf_counter() - t0
    targets = sum(bool(c.supervisions[0].text) and c.supervisions[0].language == "de"
                  for c in order)
    pool, rir, noise, rir_rec = _noise_pool_and_rir(workdir)
    print(f"[{smi}] must_c_device_chain: MuST-C en-de with {MUSTC_TALKS} train talks of "
          f"{MUSTC_TALK_SECONDS:g} s ({train_rows} segments of {MUSTC_SEGMENT_SECONDS} s) written "
          f"in {write_s!r} s; prepare {function_s!r} s, CLI {cli_s!r} s, its {len(files)} "
          f"manifests equal; splits {sorted(made)}; {len(cuts)} train segments trimmed, the first "
          f"{len(order)} loaded in {load_s!r} s: {float(lens.sum()) / SR!r} audio-s, the bucket "
          f"{float(lens.sum()) / (bsz * n)!r} full, {targets} with a German target; noise pool "
          f"{pool.shape} from phase 23's {len(noise)} MUSAN noise recordings, RIR {rir_rec.id}")
    if (len(cuts) != train_rows or len(order) != bsz or targets != bsz or lens.max() > n
            or lens.min() < MUSTC_SEGMENT_SECONDS[0] * SR - 1
            or sorted(made) != ["dev", "train", "tst-COMMON", "tst-HE"]):
        raise AssertionError("must_c_device_chain: the segments do not fill the bucket")
    launches["must_c_device_chain"], kernel_err, chain_err = _device_chain(
        "must_c_device_chain", [(audio, lens)] * 2, pool, rir, device, fbank_cuda, smi)
    errs += [kernel_err, chain_err]

    # -- iwslt22_ta_translation --------------------------------------------------------------
    t0 = time.perf_counter()
    corpus, splits, expected = _write_iwslt22_ta(root / "corpora" / "iwslt22_ta", rng)
    write_s = time.perf_counter() - t0
    made, files, function_s, cli_s = _prepare_twice(
        manifests, "iwslt22_ta",
        lambda o: R.prepare_iwslt22_ta(corpus, splits, output_dir=o, normalize_text=True),
        ["iwslt22-ta", corpus, splits, "--normalize-text"])
    train = made["train"]
    cuts = CutSet.from_manifests(recordings=train["recordings"],
                                 supervisions=train["supervisions"]).trim_to_supervisions(
        keep_overlapping=False).resample(SR).to_eager()
    rates = sorted({r.sampling_rate for r in train["recordings"]})
    print(f"[{smi}] iwslt22_ta_translation: {IWSLT_CONVERSATIONS} calls of {IWSLT_SECONDS:g} s "
          f"({IWSLT_SR} Hz SPHERE) written in {write_s!r} s; prepare {function_s!r} s, CLI "
          f"{cli_s!r} s, its {len(files)} manifests equal; supervisions per split "
          f"{ {k: len(v['supervisions']) for k, v in made.items()} }; {len(cuts)} train cuts at "
          f"{rates} Hz resampled to {SR} Hz")
    if rates != [IWSLT_SR] or not len(cuts) or any(s.id not in expected for c in cuts
                                                   for s in c.supervisions):
        raise AssertionError("iwslt22_ta_translation: the rate or the supervisions are off")
    launches["iwslt22_ta_translation"], err = _translation_epoch(
        "iwslt22_ta_translation", cuts, lambda s: {"eng": expected[s.id]}, device, fbank_cuda,
        smi, resume_after=IWSLT_RESUME_AFTER)
    errs.append(err)

    # -- gigast_translation ------------------------------------------------------------------
    t0 = time.perf_counter()
    gigast, gs_manifests, translations = _write_gigast(root / "corpora" / "gigast", rng)
    write_s = time.perf_counter() - t0
    made, files, function_s, cli_s = _prepare_twice(
        manifests, "gigast", lambda o: R.prepare_gigast(gigast, gs_manifests, o, languages="de"),
        ["gigast", gigast, gs_manifests, "-l", "de"])
    recordings = RecordingSet.from_recordings(
        r for part in ("XL", "TEST")
        for r in RecordingSet.from_file(gs_manifests / f"gigaspeech_recordings_{part}.jsonl.gz"))
    sups = SupervisionSet.from_segments(
        fastcopy(s, custom=dict(s.custom, translated_text={"de": s.custom["text_raw"]}))
        for part in ("XL", "TEST") for s in made[f"de-{part}"]["supervisions"])
    cuts = CutSet.from_manifests(recordings=recordings, supervisions=sups).trim_to_supervisions(
        keep_overlapping=False).to_eager()
    extra = sum("extra" in s.custom for s in made["de-XL"]["supervisions"])
    print(f"[{smi}] gigast_translation: {GIGAST_FILES} podcasts of {GIGAST_SECONDS:g} s written in "
          f"{write_s!r} s; prepare {function_s!r} s, CLI {cli_s!r} s, its {len(files)} manifests "
          f"equal; translated segments XL {len(made['de-XL']['supervisions'])} ({extra} with "
          f"extra), TEST {len(made['de-TEST']['supervisions'])}, of {len(translations)}")
    if len(cuts) != len(translations) or extra != len(made["de-XL"]["supervisions"]):
        raise AssertionError("gigast_translation: a segment was not translated")
    launches["gigast_translation"], err = _translation_epoch(
        "gigast_translation", cuts, lambda s: {"de": translations[s.id]}, device, fbank_cuda, smi)
    errs.append(err)

    # -- corpus_<name> -----------------------------------------------------------------------
    t0 = time.perf_counter()
    specs = _translation_specs(root / "corpora", rng, syscodecs, manifests, smi)
    print(f"[{smi}] corpora ({', '.join(specs)}) written in {time.perf_counter() - t0!r} s")
    corpus_launches, corpus_errs, summary = _corpus_legs(manifests, specs, device, fbank_cuda, smi)
    launches.update(corpus_launches)
    errs += corpus_errs
    print(f"[{smi}] phase 29 corpora: {summary}")
    set_tracing_enabled(False)
    return launches, max(errs)


# -- 30. the large ASR training corpora ---------------------------------------------------
# Each corpus in its published layout and format (sampling rate, codec,
# directory tree, file names, transcript tables, TextGrids, zips), cut in
# depth only: KsponSpeech's 256 train utterances of 2-15 s fill the 15 s x
# 256 bucket (the release has 620,000), every other corpus holds minutes of
# audio. Tone bursts from numpy seed ASR_SEED.
ASR_SEED = 3030
KSPON_TRAIN = 256  # train rows of the KsponSpeech layout: the 15 s x 256 bucket
KSPON_OTHER = 8  # rows of each of dev, eval_clean and eval_other
KSPON_SECONDS = (2.0, 15.0)
NSC_CONVERSATIONS = 4  # PART3_SameCloseMic conversations
NSC_SECONDS = 60.0
NSC_SPEAKERS = 2  # PART1_CHANNEL0 speaker zips, each of NSC_SESSIONS sessions
NSC_SESSIONS = 2
NSC_UTTERANCES = 8  # read utterances of each session
BABEL_CALLS = 4  # training calls of the Cantonese package, two sides each: 8 conversations
BABEL_SECONDS = 60.0
BABEL_SR = 8000
HEROICO_FILES = 8  # of each of the answers, recitations and USMA
ICMC_SECTIONS = (("train", "S0001"), ("train", "S0002"), ("dev", "S0101"))
ICMC_SECONDS = 60.0
REAZON_ROWS = 1116  # dev 1,000, test 100, train 16
REAZON_SECONDS = (1.0, 2.0)
BENGALI_FILES = 16
BENGALI_SR = 32000
KOREAN = ("안녕", "하세요", "오늘", "날씨", "정말", "좋네요", "그래서", "우리", "같이", "밥", "먹자",
          "진짜", "그러니까", "아니", "근데", "내일", "학교", "가요")
# (the spelling side, the pronunciation side) of KsponSpeech's dual transcripts
KSPON_DUALS = (("3프로", "삼 프로"), ("10시", "열 시"), ("2개", "두 개"), ("TV", "티비"),
               ("5분", "오 분"))
KSPON_NOISE = ("b/", "l/", "o/", "n/", "u/")
NSC_ENGLISH = ("okay", "can", "lah", "we", "go", "makan", "first", "then", "see", "how", "leh",
               "the", "hawker", "centre", "open", "already")
BABEL_TAGS = ("<breath>", "<hes>", "(())", "<click>", "<lipsmack>", "<foreign>")
CANTONESE_WORDS = ("佢", "哋", "喺", "度", "食", "緊", "嘢", "我", "唔", "係", "好", "鍾意")
HEROICO_SPANISH = ("hola", "amigo", "buenos", "días", "cómo", "estás", "señor", "niño", "qué",
                   "tal", "mañana", "canción")
ICMC_MANDARIN = ("你好", "打开", "空调", "导航", "到", "公司", "播放", "音乐", "关闭", "车窗", "调高",
                 "温度")
REAZON_JAPANESE = ("こんにちは", "今日は", "いい", "天気", "ですね", "１２３", "、", "。", "ＡＢＣ",
                   "3.5", "ニュース", "です")
BENGALI_WORDS = ("বাংলা", "বাক্য", "আমি", "তুমি", "ভালো", "আছি", "আজ", "কাল", "বই", "পড়ি")


def _write_ksponspeech(root: Path, rng) -> tuple:
    """KsponSpeech as AI-Hub ships it (and icefall's ``egs/ksponspeech``
    reads it): headerless 16 kHz int16 ``.pcm`` files under
    ``KsponSpeech_01/KsponSpeech_0001/`` (train), ``KsponSpeech_05/
    KsponSpeech_0621/`` (dev) and ``eval_clean/``/``eval_other/``, with the
    tables ``train.trn``, ``dev.trn``, ``eval_clean.trn`` and
    ``eval_other.trn`` of ``path :: text`` rows (the eval rows under the
    ``KsponSpeech_eval/`` prefix). Each text is Korean words with noise
    labels, dual transcripts and ``*``/``+``/``/`` marks. Returns the corpus
    and, per recording id, its samples and the text ``normalize`` should
    make."""
    expected, n = {}, 0
    for part, count in (("train", KSPON_TRAIN), ("dev", KSPON_OTHER),
                        ("eval_clean", KSPON_OTHER), ("eval_other", KSPON_OTHER)):
        rows = []
        for _ in range(count):
            n += 1
            name = f"KsponSpeech_{n:06d}" if part in ("train", "dev") else f"KsponSpeech_E{n:05d}"
            rel = {"train": f"KsponSpeech_01/KsponSpeech_{(n - 1) // 1000 + 1:04d}/{name}.pcm",
                   "dev": f"KsponSpeech_05/KsponSpeech_0621/{name}.pcm"}.get(
                part, f"{part}/{name}.pcm")
            x = _tone_burst(rng, float(rng.uniform(*KSPON_SECONDS)))
            pcm = np.round(x * 32767).astype("<i2")
            (root / rel).parent.mkdir(parents=True, exist_ok=True)
            pcm.tofile(root / rel)
            tokens, clean = [], []
            for _ in range(rng.randint(3, 10)):
                if rng.rand() < 0.25:
                    tokens.append(KSPON_NOISE[rng.randint(len(KSPON_NOISE))])
                if rng.rand() < 0.2:
                    spelling, pronunciation = KSPON_DUALS[rng.randint(len(KSPON_DUALS))]
                    word, text = f"({spelling})/({pronunciation})", spelling
                else:
                    word = text = KOREAN[rng.randint(len(KOREAN))]
                tokens.append(word + ("*", "+", "/", "", "", "")[rng.randint(6)])
                clean.append(text)
            prefix = "" if part in ("train", "dev") else "KsponSpeech_eval/"
            rows.append(f"{prefix}{rel} :: {' '.join(tokens)}")
            expected[name] = (pcm, " ".join(clean))
        (root / f"{part}.trn").write_text("\n".join(rows) + "\n", encoding="utf-8")
    return root, expected


def _nsc_part3(root: Path, rng) -> None:
    """NSC ``PART3_SameCloseMic``: ``NSC_CONVERSATIONS`` conversations of
    ``NSC_SECONDS`` at 16 kHz under ``PART3/Audio Same CloseMic/``, each with
    a TextGrid in ``PART3/Scripts Same/`` whose one tier (named after the
    file) has a text interval per turn and ``<S>``/``<Z>`` between them."""
    from lhotse_tpu_torch.recipes.nsc import get_part_handler_map

    dirs = get_part_handler_map(root)["PART3_SameCloseMic"].script_audio
    for k in range(NSC_CONVERSATIONS):
        stem = f"conf_{2500 + k}_{2500 + k}"
        segments = _segments_within(rng, NSC_SECONDS, 12, lengths=(1.5, 6.0), gaps=(0.2, 1.2))
        _write_audio(Path(dirs.audio_dir) / f"{stem}.wav", _speech_track(rng, NSC_SECONDS,
                                                                        segments), SR)
        intervals, t = [], 0.0
        for start, end in segments:
            intervals.append((t, start, ("<S>", "<Z>")[rng.randint(2)]))
            intervals.append((start, end, _words(rng, NSC_ENGLISH, 2, 9)))
            t = end
        intervals.append((t, NSC_SECONDS, "<S>"))
        Path(dirs.script_dir).mkdir(parents=True, exist_ok=True)
        (Path(dirs.script_dir) / f"{stem}.TextGrid").write_text(
            _textgrid({stem: intervals}, NSC_SECONDS))


def _nsc_part1(root: Path, rng) -> int:
    """NSC ``PART1_CHANNEL0``: ``WAVE/SPEAKER000k.zip`` per speaker, holding
    ``SPEAKER000k/SESSION{s}/<id>.WAV`` (16 kHz read utterances of 2-5 s),
    and a ``SCRIPT/0000ks.TXT`` per session that pairs each id row with its
    text and then the normalised text. Returns the utterance count."""
    import io
    import zipfile

    from lhotse_tpu_torch.audio.wavio import write_wav
    from lhotse_tpu_torch.recipes.nsc import get_part_handler_map

    dirs = get_part_handler_map(root)["PART1_CHANNEL0"].script_audio
    audio_dir, script_dir = Path(dirs.audio_dir), Path(dirs.script_dir)
    audio_dir.mkdir(parents=True, exist_ok=True)
    script_dir.mkdir(parents=True, exist_ok=True)
    for s in range(NSC_SPEAKERS):
        spk = f"{s + 1:04d}"
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w") as zf:
            for session in range(NSC_SESSIONS):
                rows = []
                for utt in range(NSC_UTTERANCES):
                    audio_id = f"0{spk}{session}{utt:03d}"
                    wav = io.BytesIO()
                    write_wav(wav, _tone_burst(rng, float(rng.uniform(2.0, 5.0)))[None], SR)
                    zf.writestr(f"SPEAKER{spk}/SESSION{session}/{audio_id}.WAV", wav.getvalue())
                    text = _words(rng, NSC_ENGLISH, 3, 10)
                    rows += [f"{audio_id}\t{text.capitalize()}.", f"\t{text}"]
                (script_dir / f"0{spk}{session}.TXT").write_text(
                    "\ufeff" + "\n".join(rows) + "\n", encoding="utf-8")
        (audio_dir / f"SPEAKER{spk}.zip").write_bytes(buf.getvalue())
    return NSC_SPEAKERS * NSC_SESSIONS * NSC_UTTERANCES


def _write_babel(root: Path, rng) -> Path:
    """One IARPA BABEL package, Cantonese (101): ``conversational/{training,
    dev,eval}/audio/BABEL_BP_101_<speaker>_<date>_<hour>_{inLine,outLine}.sph``
    (8 kHz mu-law SPHERE, one side of a call each, ``BABEL_SECONDS`` long)
    and ``transcription/<same>.txt`` of ``[seconds]`` stamps alternating with
    text lines (``<no-speech>`` between turns, noise tags within them);
    ``BABEL_CALLS`` training calls, one dev call, and one eval call whose
    transcripts are withheld."""
    package = root / "IARPA_BABEL_BP_101"
    speaker = 10033
    for split, calls in (("training", BABEL_CALLS), ("dev", 1), ("eval", 1)):
        conv = package / "conversational" / split
        (conv / "transcription").mkdir(parents=True, exist_ok=True)
        for c in range(calls):
            speaker += 1
            for side in ("inLine", "outLine"):
                stem = f"BABEL_BP_101_{speaker}_2011102{c}_20{c}740_{side}"
                segments = _segments_within(rng, BABEL_SECONDS, 10, lengths=(1.5, 5.0),
                                            gaps=(0.3, 1.5))
                _ldc_sphere(conv / "audio" / f"{stem}.sph",
                            _speech_track(rng, BABEL_SECONDS, segments, BABEL_SR), BABEL_SR,
                            "ulaw")
                if split == "eval":
                    continue
                lines = ["[0.000]"]
                for start, end in segments:
                    tag = BABEL_TAGS[rng.randint(len(BABEL_TAGS))] + " " if rng.rand() < 0.3 else ""
                    lines += ["<no-speech>", f"[{start:.3f}]",
                              tag + _words(rng, CANTONESE_WORDS, 2, 8), f"[{end:.3f}]"]
                lines += ["<no-speech>", f"[{BABEL_SECONDS:.3f}]"]
                (conv / "transcription" / f"{stem}.txt").write_text("\n".join(lines) + "\n")
    return package


def _write_heroico(root: Path, rng) -> tuple:
    """LDC2006S37 as OpenSLR 39 unpacks it: ``speech/heroico/Answers_Spanish/
    <spk>/<prompt>.wav``, ``speech/heroico/Recordings_Spanish/<spk>/<id>.wav``
    (ids on both sides of the 355-561 repeats) and ``speech/usma/
    {native,nonnative}-[fm]-<name>/s<id>.wav``, ``HEROICO_FILES`` of each at
    16 kHz, and ``transcripts/`` with the three ISO-8859-1 prompt tables.
    Returns the speech and transcript directories."""
    speech, trans = root / "speech", root / "transcripts"
    trans.mkdir(parents=True, exist_ok=True)
    answers, recitations = [], []
    for k in range(HEROICO_FILES):
        spk, pid = str(k % 3 + 1), k + 1
        _write_audio(speech / "heroico" / "Answers_Spanish" / spk / f"{pid}.wav",
                     _tone_burst(rng, float(rng.uniform(1.0, 4.0))), SR)
        answers.append(f"{spk}/{pid}\t{_words(rng, HEROICO_SPANISH, 2, 8)}")
        rid = (100, 354, 355, 400, 450, 561, 562, 700)[k]
        _write_audio(speech / "heroico" / "Recordings_Spanish" / str(k % 2 + 4) / f"{rid}.wav",
                     _tone_burst(rng, float(rng.uniform(1.0, 4.0))), SR)
        recitations.append(f"{rid}\t{_words(rng, HEROICO_SPANISH, 2, 8)}")
        usma = ("native-f-ana", "native-m-jose", "nonnative-f-kim", "nonnative-m-lee")[k % 4]
        _write_audio(speech / "usma" / usma / f"s{k // 4 + 1}.wav",
                     _tone_burst(rng, float(rng.uniform(1.0, 4.0))), SR)
    prompts = [f"s{i}\t{_words(rng, HEROICO_SPANISH, 2, 8)}" for i in (1, 2)]
    for name, rows in (("heroico-answers.txt", answers), ("heroico-recordings.txt", recitations),
                       ("usma-prompts.txt", prompts)):
        (trans / name).write_text("\n".join(rows) + "\n", encoding="iso-8859-1")
    return speech, trans


def _write_icmcasr(root: Path, rng) -> Path:
    """ICMC-ASR's layout: ``{train,dev}/<section>/DA0{1-4}.wav`` (each seat's
    headset), ``DX0{1-4}C01.wav`` (the four far-field mics, every seat at its
    own gain) and ``DA0{1-4}.TextGrid`` (one tier per seat, a Mandarin text
    interval per turn and empty ones between), ``ICMC_SECONDS`` per section
    at 16 kHz; ``eval_track1/`` without sections."""
    for part, section in ICMC_SECTIONS:
        d = root / part / section
        n = int(ICMC_SECONDS * SR)
        heads, far = [], np.zeros((4, n), np.float32)
        for seat in range(4):
            segments = _segments_within(rng, ICMC_SECONDS, 6, lengths=(1.0, 4.0), gaps=(1.0, 5.0))
            x = _speech_track(rng, ICMC_SECONDS, segments)[0]
            heads.append(x)
            far += rng.uniform(0.2, 0.6, size=(4, 1)).astype(np.float32) * x
            intervals, t = [], 0.0
            for start, end in segments:
                intervals += [(t, start, ""), (start, end, _words(rng, ICMC_MANDARIN, 2, 6, ""))]
                t = end
            intervals.append((t, ICMC_SECONDS, ""))
            d.mkdir(parents=True, exist_ok=True)
            (d / f"DA0{seat + 1}.TextGrid").write_text(
                _textgrid({f"{section}_spk{seat + 1}": intervals}, ICMC_SECONDS))
            _write_audio(d / f"DA0{seat + 1}.wav", x, SR)
        for k in range(4):
            _write_audio(d / f"DX0{k + 1}C01.wav", np.clip(far[k], -1, 1), SR)
    (root / "eval_track1").mkdir(parents=True, exist_ok=True)
    return root


def _write_reazonspeech(root: Path, rng) -> Path:
    """ReazonSpeech as its download leaves it: ``audio/<id>.flac`` clips of
    1-2 s (16 kHz) and ``dataset.json`` rows of id, path, normalised
    Japanese text and duration, ``REAZON_ROWS`` of them."""
    from lhotse_tpu_torch.recipes.reazonspeech import normalize

    rows = []
    for i in range(REAZON_ROWS):
        path = root / "audio" / f"{i:06d}.flac"
        x = _tone_burst(rng, float(rng.uniform(*REAZON_SECONDS)))
        _write_audio(path, x, SR)
        rows.append({"id": f"{i:06d}", "audio_filepath": str(path), "duration": x.size / SR,
                     "text": normalize(_words(rng, REAZON_JAPANESE, 2, 8, ""))})
    (root / "dataset.json").write_text(json.dumps(rows, ensure_ascii=False), encoding="utf-8")
    return root


def _write_bengaliai(root: Path, rng, syscodecs) -> Path:
    """The Kaggle competition's layout: ``train_mp3s/<id>.mp3`` (32 kHz MP3,
    2-6 s; three quarters train and a quarter valid in ``train.csv``) and
    ``test_mp3s/<id>.mp3`` (no text), ``BENGALI_FILES`` clips in all."""
    rows = ["id,sentence,split"]
    for k in range(BENGALI_FILES):
        part = "test_mp3s" if k >= BENGALI_FILES * 3 // 4 else "train_mp3s"
        audio_id = f"{k:012x}"
        x = _tone_burst(rng, float(rng.uniform(2.0, 6.0)), BENGALI_SR)
        (root / part).mkdir(parents=True, exist_ok=True)
        (root / part / f"{audio_id}.mp3").write_bytes(syscodecs.mp3_encode(x[None], BENGALI_SR))
        if part == "train_mp3s":
            rows.append(f"{audio_id},{_words(rng, BENGALI_WORDS, 2, 8)},"
                        f"{'valid' if k % 4 == 3 else 'train'}")
    (root / "train.csv").write_text("\n".join(rows) + "\n", encoding="utf-8")
    return root


def _asr_corpus_specs(root: Path, rng, syscodecs, smi: str) -> tuple:
    """Per corpus of phase 30's ``corpus_<name>`` legs, in the order they
    run: the recipe's call for an output directory, the CLI's command and
    the training path. Bengali.AI Speech's only where the MP3 libraries
    load (its test split has no text, so its train and valid splits are
    trained on). Returns the specs and the ICMC-ASR corpus."""
    from lhotse_tpu_torch import recipes as R

    nsc = root / "nsc"
    _nsc_part3(nsc, rng)
    _nsc_part1(nsc, rng)
    babel = _write_babel(root / "babel", rng)
    speech, trans = _write_heroico(root / "heroico", rng)
    icmc = _write_icmcasr(root / "icmcasr", rng)
    reazon = _write_reazonspeech(root / "reazonspeech", rng)
    specs = {
        "nsc_part3": (lambda o: R.prepare_nsc(nsc, dataset_part="PART3_SameCloseMic",
                                              output_dir=o),
                      ["nsc", nsc, "-p", "PART3_SameCloseMic"], "asr"),
        "nsc_part1": (lambda o: R.prepare_nsc(nsc, dataset_part="PART1_CHANNEL0", output_dir=o),
                      ["nsc", nsc, "-p", "PART1_CHANNEL0"], "asr"),
        "babel": (lambda o: R.prepare_single_babel_language(babel, output_dir=o),
                  ["babel", babel], "asr"),
        "heroico": (lambda o: R.prepare_heroico(speech, trans, output_dir=o),
                    ["heroico", speech, trans], "asr"),
        "icmcasr_ihm": (lambda o: R.prepare_icmcasr(icmc, output_dir=o, mic="ihm"),
                        ["icmcasr", icmc, "--mic", "ihm"], "asr"),
        "icmcasr_sdm": (lambda o: R.prepare_icmcasr(icmc, output_dir=o, mic="sdm"),
                        ["icmcasr", icmc, "--mic", "sdm"], "asr"),
        "reazonspeech": (lambda o: R.prepare_reazonspeech(reazon, output_dir=o),
                         ["reazonspeech", reazon], "asr"),
    }
    if syscodecs.mp3_available() and syscodecs.mp3_encode_available():
        bengali = _write_bengaliai(root / "bengaliai_speech", rng, syscodecs)
        specs["bengaliai_speech"] = (
            lambda o: {part: m for part, m in R.prepare_bengaliai_speech(
                bengali, output_dir=o).items() if part != "test"},
            ["bengaliai-speech", bengali], "asr")
    else:
        print(f"[{smi}] corpus_bengaliai_speech left out: the MP3 libraries (libmpg123, "
              f"libmp3lame) do not load here, and Bengali.AI Speech ships MP3: "
              f"{syscodecs.loaded_sonames()} (ROADMAP.md A3)")
    return specs, icmc


def _phase_asr_corpora(workdir: Path, device, fbank_cuda, smi: str) -> tuple:
    """30. The large ASR training corpus recipes, in phase 14's directory
    after phase 29 (phase 23's MUSAN noise and RIRS_NOISES manifests feed
    the augmenter). Every recipe runs as a function and through the CLI's
    ``prepare`` command, and their manifests must be equal.
    ``ksponspeech_device_chain``: the input chain of icefall's KsponSpeech
    recipe (80-dim log-mel fbank, MUSAN noise, speed perturbation,
    SpecAugment) on KsponSpeech in its published layout, 256 train
    utterances of 2-15 s as headerless int16 PCM and 8 of each other part →
    ``prepare_ksponspeech`` (PCM to FLAC beside each file, the texts
    normalised) → ``CutSet.from_manifests`` → the first 256 train cuts as
    the 15 s x 256 bucket's int16 batch → ``OnDeviceAugmenter`` with phase
    23's MUSAN pool and real RIR, speed 1.1, SNR (10, 20) and SpecAugment
    (as every ``_device_chain`` leg); every recording's samples must equal
    its PCM / 32768 and every text its expected normalisation.
    ``corpus_<name>``: NSC ``PART3_SameCloseMic`` (TextGrids) and
    ``PART1_CHANNEL0`` (speaker zips), BABEL Cantonese (8 kHz mu-law SPHERE,
    eval transcripts withheld), Heroico (three folds), ICMC-ASR ``ihm`` and
    ``sdm``, ReazonSpeech (1,116 rows, all three splits) and, where the MP3
    libraries load, Bengali.AI Speech, into the step through
    ``_corpus_legs``. ``icmcasr_mdm``: ``prepare_icmcasr(mic="mdm")`` on the
    same sections, each recording's (4, T) audio against the four DX files
    stacked, then one batch of its segments trimmed with every channel kept
    → ``to_mono()`` → ``OnTheFlyFeatures`` on the kernel → the step (phase
    23's multi-channel route). Returns the kernel's launches per path and the
    largest kernel-vs-plain error."""
    from lhotse_tpu_torch import CutSet
    from lhotse_tpu_torch import recipes as R
    from lhotse_tpu_torch.audio import Recording, syscodecs
    from lhotse_tpu_torch.caching import set_caching_enabled
    from lhotse_tpu_torch.cut import MonoCut, MultiCut
    from lhotse_tpu_torch.dataset import SimpleCutSampler
    from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
    from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
    from lhotse_tpu_torch.features import Fbank, FbankConfig
    from lhotse_tpu_torch.tracing import set_tracing_enabled

    set_caching_enabled(False)
    set_tracing_enabled(True)
    rng = np.random.RandomState(ASR_SEED)
    root = workdir / "asr_corpora"
    manifests = root / "manifests"
    launches, errs = {}, []

    # -- ksponspeech_device_chain ------------------------------------------------------------
    t0 = time.perf_counter()
    kspon, expected = _write_ksponspeech(root / "corpora" / "ksponspeech", rng)
    write_s = time.perf_counter() - t0
    made, files, function_s, cli_s = _prepare_twice(
        manifests, "ksponspeech", lambda o: R.prepare_ksponspeech(kspon, output_dir=o),
        ["ksponspeech", kspon])
    train = made["train"]
    cuts = CutSet.from_manifests(recordings=train["recordings"],
                                 supervisions=train["supervisions"]).to_eager()
    sec, bsz = BUCKET
    n = int(sec * SR)
    order = list(cuts)[:bsz]
    t0 = time.perf_counter()
    audio, lens = np.zeros((bsz, n), np.float32), np.zeros(bsz, np.int64)
    loaded = {}
    for k, cut in enumerate(order):
        loaded[cut.recording_id] = x = cut.load_audio()[0]
        audio[k, : x.size], lens[k] = x, x.size
    load_s = time.perf_counter() - t0
    # Every recording's samples (the bucket's as loaded, the rest read here)
    # against its PCM / 32768, and every text against its normalisation.
    t0 = time.perf_counter()
    samples_equal = texts_equal = True
    for part in made.values():
        for rec in part["recordings"]:
            x = loaded[rec.id] if rec.id in loaded else rec.load_audio()[0]
            samples_equal &= np.array_equal(x, expected[rec.id][0].astype(np.float32) / 32768.0)
        texts_equal &= all(s.text == expected[s.id][1] and s.language == "Korean"
                           for s in part["supervisions"])
    check_s = time.perf_counter() - t0
    pool, rir, noise, rir_rec = _noise_pool_and_rir(workdir)
    counts = {part: len(m["supervisions"]) for part, m in made.items()}
    print(f"[{smi}] ksponspeech_device_chain: KsponSpeech with {KSPON_TRAIN} train utterances "
          f"of {KSPON_SECONDS} s and {KSPON_OTHER} of each other part written in {write_s!r} s; "
          f"prepare {function_s!r} s (PCM to FLAC included), CLI {cli_s!r} s (the FLACs reused), "
          f"its {len(files)} manifests equal; supervisions per part {counts}; every recording "
          f"equal to its PCM / 32768: {samples_equal}, every text its expected normalisation: "
          f"{texts_equal} (checked in {check_s!r} s; e.g. {order[0].supervisions[0].text!r}); "
          f"the first {len(order)} train cuts loaded in {load_s!r} s: "
          f"{float(lens.sum()) / SR!r} audio-s, the bucket {float(lens.sum()) / (bsz * n)!r} "
          f"full; noise pool {pool.shape} from phase 23's {len(noise)} MUSAN noise recordings, "
          f"RIR {rir_rec.id}")
    if (counts != {"train": KSPON_TRAIN, "dev": KSPON_OTHER, "eval_clean": KSPON_OTHER,
                   "eval_other": KSPON_OTHER} or not samples_equal or not texts_equal
            or len(order) != bsz or lens.max() > n or lens.min() < KSPON_SECONDS[0] * SR - 1):
        raise AssertionError("ksponspeech_device_chain: the parts, samples, texts or the bucket "
                             "are off")
    launches["ksponspeech_device_chain"], kernel_err, chain_err = _device_chain(
        "ksponspeech_device_chain", [(audio, lens)] * 2, pool, rir, device, fbank_cuda, smi)
    errs += [kernel_err, chain_err]

    # -- corpus_<name> -----------------------------------------------------------------------
    t0 = time.perf_counter()
    specs, icmc = _asr_corpus_specs(root / "corpora", rng, syscodecs, smi)
    print(f"[{smi}] corpora ({', '.join(specs)}) written in {time.perf_counter() - t0!r} s")
    corpus_launches, corpus_errs, summary = _corpus_legs(manifests, specs, device, fbank_cuda, smi)
    launches.update(corpus_launches)
    errs += corpus_errs
    print(f"[{smi}] phase 30 corpora: {summary}")

    # -- icmcasr_mdm -------------------------------------------------------------------------
    made, files, function_s, cli_s = _prepare_twice(
        manifests, "icmcasr_mdm", lambda o: R.prepare_icmcasr(icmc, output_dir=o, mic="mdm"),
        ["icmcasr", icmc, "--mic", "mdm"])
    stacked, shapes_ok = {}, True
    for part in made.values():
        for rec in part["recordings"]:
            section = Path(rec.sources[0].source).parent
            if section not in stacked:
                stacked[section] = np.concatenate([
                    Recording.from_file(section / f"DX0{k}C01.wav").load_audio()
                    for k in range(1, 5)])
            x = rec.load_audio()
            shapes_ok &= x.shape == (4, rec.num_samples) and np.array_equal(x, stacked[section])
    sessions = CutSet.from_manifests(recordings=made["train"]["recordings"],
                                     supervisions=made["train"]["supervisions"]).to_eager()
    trimmed = sessions.trim_to_supervisions(keep_overlapping=False,
                                            keep_all_channels=True).to_eager()
    monos = CutSet.from_cuts(m for c in trimmed for m in c.to_mono())
    batch_cuts = CutSet.from_cuts(next(iter(SimpleCutSampler(
        monos, max_duration=FLY_MAX_DURATION, shuffle=True, seed=0))))
    fly = Fbank(FbankConfig(device=device))
    recorder = _RecordFirstBatch(fly)
    dataset = K2SpeechRecognitionDataset(return_cuts=True, input_strategy=OnTheFlyFeatures(fly))
    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    run = _task_epoch([dataset[batch_cuts]], _Trainer(device), device, _rows_of)
    batch_s = time.perf_counter() - t0
    launches["icmcasr_mdm"] = fbank_cuda.LAUNCHES
    err = _first_batch_err(recorder, fly)
    rows = run["batches"][0]["inputs"].shape[0]
    print(f"[{smi}] icmcasr_mdm: prepare {function_s!r} s, CLI {cli_s!r} s, its {len(files)} "
          f"manifests equal; {sum(len(p['recordings']) for p in made.values())} four-source "
          f"recordings over {len(stacked)} sections, each load_audio() (4, T) and equal to the "
          f"four DX files stacked: {shapes_ok}; {len(sessions)} train sessions "
          f"({sorted({c.num_channels for c in sessions})} channels), "
          f"{len(trimmed)} segments -> {len(monos)} MonoCuts; one batch of {rows} rows "
          f"({run['audio_s']!r} channel-s) through OnTheFlyFeatures and the step in {batch_s!r} s; "
          f"fbank kernel launches {launches['icmcasr_mdm']}; kernel vs plain {err!r} (tol "
          f"{KERNEL_TOL})")
    if not shapes_ok or not all(isinstance(c, MultiCut) and c.num_channels == 4
                                for c in sessions) or {type(c) for c in monos} != {MonoCut}:
        raise AssertionError("icmcasr_mdm: the four-channel recordings are off")
    if len(monos) != 4 * len(trimmed) or len(trimmed) != len(made["train"]["supervisions"]):
        raise AssertionError("icmcasr_mdm: trimming lost or split segments")
    if launches["icmcasr_mdm"] != 1 or rows != len(batch_cuts) or not err <= KERNEL_TOL:
        raise AssertionError("icmcasr_mdm: launches, the batch or the kernel are off")
    errs.append(err)
    set_tracing_enabled(False)
    return launches, max(errs)


# -- 31. the TTS, accented-speech and children's corpora ---------------------------------
# Each corpus in its published layout and format (sampling rate, codec,
# directory tree, file names, tables and JSON metadata), cut in depth only:
# CMU Kids' 256 utterances of 2-15 s fill the 15 s x 256 bucket (the release
# has 5,180), every other corpus holds a few minutes of audio. Tone bursts
# from numpy seed KIDS_SEED.
KIDS_SEED = 3131
KIDS_SPEAKERS = 16  # 8 girls and 8 boys
KIDS_READS = 16  # prompts each speaker reads: 16 x 16 fill the 15 s x 256 bucket
KIDS_PROMPTS = 48  # rows of sentence.tbl
KIDS_SECONDS = (2.0, 15.0)
TTS_SECONDS = (2.0, 6.0)  # each clip of the TTS corpora
L2_SUITCASE_SECONDS = (20.0, 30.0)  # each spontaneous suitcase-corpus recording
CSLU_STORY_SECONDS = (8.0, 15.0)  # each spontaneous CSLU Kids story
GRID_SR = 25000  # the rate of the GRID release's audio_25k copies
GRID_VIDEOS = 8  # of each of two speakers, 3 s each as in the release
OTO_SESSIONS = 2  # FLAC sessions in each of the two tar shards
OTO_SECONDS = 60.0
OTO_SR = 48000
TTS_ENGLISH = ("author", "of", "the", "danger", "trail", "philip", "steels", "we", "have", "to",
               "think", "about", "people", "please", "call", "stella", "ask", "her", "bring",
               "these", "things", "with", "from", "store")
HIFITTS_QUALITY = {"92": "clean", "6097": "other", "9017": "clean", "6670": "other",
                   "6671": "clean", "8051": "other", "9136": "clean", "11614": "other",
                   "11697": "clean", "12787": "other"}
KIDS_TAGS = ("[noise]", "[breath]", "/h#/", "[begin_noise]")
CSLU_TAGS = ("<bn>", "<ln>", "<sil>", "<br>")
BENGALI_TTS = ("বাংলা", "বাক্য", "আমি", "তুমি", "ভালো", "আছি", "আজ", "কাল")
TELUGU_TTS = ("తెలుగు", "వాక్యం", "నేను", "మీరు", "బాగున్నాను", "ఈరోజు")


def _write_cmu_kids(root: Path, rng) -> tuple:
    """CMU Kids (LDC97S63) as the LDC ships it: ``cmu_kids/tables/`` with
    ``sentence.tbl`` (``<utt>\\t<count>\\t<prompt>``), ``speaker.tbl`` (two
    header lines, then ``<spk>\\t<population>\\t<grade>/<age>\\t<sex>\\t<dialect>``,
    ``NA`` where a grade or age was not taken) and ``transcrp.tbl``
    (``<spk><utt><bin> <spoken transcript>``), and the audio at
    ``cmu_kids/kids/<spk>/signal/<trn-id>.sph`` as 16 kHz int16 SPHERE with
    LDC header fields. ``KIDS_SPEAKERS`` children of both sexes read
    ``KIDS_READS`` prompts each, in bin 1 (clean) or 2 (noisy, with noise
    tags in the spoken transcript). Returns the ``cmu_kids`` directory and,
    per transcription id, its samples and the fields the recipe should read
    (prompt, spoken transcript, bin, grade, age)."""
    corpus = root / "cmu_kids"
    letters = "abcdefghijklmnopqrstuvwxyz"
    prompts = {f"{letters[i // 10]}{letters[i % 10 + 10]}{1 + i % 9}":
               _words(rng, TTS_ENGLISH, 3, 10).capitalize() + "." for i in range(KIDS_PROMPTS)}
    (corpus / "tables").mkdir(parents=True, exist_ok=True)
    (corpus / "tables" / "sentence.tbl").write_text("".join(
        f"{utt}\t{1 + k % 5}\t{text}\n" for k, (utt, text) in enumerate(prompts.items())))
    speakers, rows = [], ["SPEAKER\tPOPULATION\tGRADE/AGE\tSEX\tDIALECT", "=" * 40]
    for i in range(KIDS_SPEAKERS):
        sex = "fm"[i % 2]
        spk = f"{sex}{letters[i]}{letters[(3 * i + 5) % 26]}{letters[(7 * i + 2) % 26]}"
        grade, age = str(1 + i % 5), str(6 + i % 6)
        if i in (3, 10):
            grade = "NA"
        if i in (5, 10):
            age = "NA"
        speakers.append((spk, grade, age))
        rows.append(f"{spk}\t{('SUM95', 'SUM96')[i % 2]}\t{grade}/{age}\t{sex.upper()}\t"
                    f"Pittsburgh")
    (corpus / "tables" / "speaker.tbl").write_text("\n".join(rows) + "\n")
    expected, transcripts, utts = {}, [], sorted(prompts)
    for spk, grade, age in speakers:
        for j in rng.permutation(len(utts))[:KIDS_READS]:
            utt = utts[j]
            tbin = 2 if rng.rand() < 0.25 else 1
            trn = f"{spk}{utt}{tbin}"
            spoken = prompts[utt].lower().rstrip(".")
            if tbin == 2:
                words = spoken.split()
                words.insert(int(rng.randint(len(words) + 1)), KIDS_TAGS[rng.randint(4)])
                spoken = " ".join(words)
            pcm = np.round(_tone_burst(rng, float(rng.uniform(*KIDS_SECONDS))) * 32767).astype(
                np.int16)
            _ldc_sphere(corpus / "kids" / spk / "signal" / f"{trn}.sph", pcm[None], SR, "pcm16",
                        database_id="CMU_KIDS", speaker_id=spk, utterance_id=trn)
            transcripts.append(f"{trn} {spoken}")
            expected[trn] = (pcm, prompts[utt], spoken, tbin,
                             None if grade == "NA" else grade, None if age == "NA" else int(age))
    (corpus / "tables" / "transcrp.tbl").write_text("\n".join(transcripts) + "\n")
    return corpus, expected


def _write_hifitts(root: Path, rng) -> Path:
    """Hi-Fi TTS (OpenSLR 109): ``hi_fi_tts_v0/<spk>_manifest_<quality>_<split>.json``
    jsonl rows (``audio_filepath``, ``text``, ``text_normalized``,
    ``duration``) over ``audio/<spk>_<quality>/<book>/*.flac`` at 44.1 kHz;
    the ten speakers, half ``clean`` and half ``other``, 2 clips of 2-6 s in
    each of train, dev and test."""
    corpus = root / "hi_fi_tts_v0"
    for spk, quality in HIFITTS_QUALITY.items():
        for split in ("train", "dev", "test"):
            rows = []
            for i in range(2):
                seconds = float(rng.uniform(*TTS_SECONDS))
                rel = (f"audio/{spk}_{quality}/{10000 + int(spk) % 97}/"
                       f"book_{split}_{i:02d}_f000{i}.flac")
                _write_audio(corpus / rel, _tone_burst(rng, seconds, 44100), 44100)
                text = _words(rng, TTS_ENGLISH, 4, 12)
                rows.append(json.dumps({"audio_filepath": rel, "text": text,
                                        "text_normalized": text.capitalize() + ".",
                                        "duration": round(seconds, 2)}))
            (corpus / f"{spk}_manifest_{quality}_{split}.json").write_text("\n".join(rows) + "\n")
    return corpus


def _write_ears(root: Path, rng) -> Path:
    """EARS: ``p001``-``p004`` of 4 read utterances each as 48 kHz WAV named by
    style, ``speaker_statistics.json`` (age, ethnicity, gender, height,
    native language, weight) and ``transcripts.json`` (style -> text)."""
    corpus = root / "EARS"
    styles = ("emo_adoration_sentences", "read_fast", "rainbow_01_regular",
              "sentences_01_whisper")
    meta = {}
    for k, spk in enumerate(("p001", "p002", "p003", "p004")):
        meta[spk] = {"age": ("18-25", "26-35", "36-45", "46-55")[k],
                     "ethnicity": "white or caucasian", "gender": ("female", "male")[k % 2],
                     "height": f"{160 + 5 * k} cm", "native language": "american english",
                     "weight": f"{55 + 6 * k} kg"}
        for style in styles:
            _write_audio(corpus / spk / f"{style}.wav",
                         _tone_burst(rng, float(rng.uniform(*TTS_SECONDS)), 48000), 48000)
    (corpus / "speaker_statistics.json").write_text(json.dumps(meta))
    (corpus / "transcripts.json").write_text(json.dumps(
        {style: _words(rng, TTS_ENGLISH, 4, 12).capitalize() + "." for style in styles}))
    return corpus


def _write_daily_talk(root: Path, rng) -> Path:
    """DailyTalk: ``dailytalk/data/<dialog>/<utt>_<speaker>_d<dialog>.wav`` at
    44.1 kHz and ``metadata.json`` ({dialog: {utt: index, text, speaker,
    turn, topic, emotion, act}}); 4 dialogues of 4 turns."""
    corpus, meta, index = root / "dailytalk", {}, 0
    for d in range(4):
        meta[str(d)] = {}
        for u in range(4):
            spk = u % 2
            _write_audio(corpus / "data" / str(d) / f"{u}_{spk}_d{d}.wav",
                         _tone_burst(rng, float(rng.uniform(*TTS_SECONDS)), 44100), 44100)
            meta[str(d)][str(u)] = {
                "index": index, "text": _words(rng, TTS_ENGLISH, 3, 10), "speaker": spk,
                "turn": u, "topic": ("ordinary_life", "work", "relationship", "tourism")[d],
                "emotion": ("no emotion", "happiness", "surprise", "sadness")[u],
                "act": ("inform", "question", "directive", "commissive")[u]}
            index += 1
    (corpus / "metadata.json").write_text(json.dumps(meta))
    return corpus


def _write_festvox(root: Path, rng, package: str, utts: list, vocabulary=TTS_ENGLISH) -> None:
    """A festvox voice package: ``<package>/wav/<utt>.wav`` at 16 kHz and
    ``etc/txt.done.data`` lines ``( <utt> "<prompt>" )``; ``utts`` holds
    (utterance id, vocabulary) pairs."""
    lines = []
    for utt, words in utts:
        _write_audio(root / package / "wav" / f"{utt}.wav",
                     _tone_burst(rng, float(rng.uniform(*TTS_SECONDS))), SR)
        lines.append(f'( {utt} "{_words(rng, words, 3, 10)}" )')
    (root / package / "etc").mkdir(parents=True, exist_ok=True)
    (root / package / "etc" / "txt.done.data").write_text("\n".join(lines) + "\n")


def _write_cmu_arctic(root: Path, rng) -> Path:
    """CMU ARCTIC: ``cmu_us_bdl_arctic`` and ``cmu_us_slt_arctic``, 8
    utterances each (sets a and b)."""
    corpus = root / "cmu_arctic"
    for spk in ("bdl", "slt"):
        _write_festvox(corpus, rng, f"cmu_us_{spk}_arctic", [
            (f"arctic_{'ab'[i // 4]}{i % 4 + 1:04d}", TTS_ENGLISH) for i in range(8)])
    return corpus


def _write_cmu_indic(root: Path, rng) -> Path:
    """CMU INDIC: ``cmu_indic_ben_rm`` (with ``etc/voice.feats``, the age) and
    ``cmu_indic_tel_ss``, each 6 prompts in its own script and 2 English
    arctic prompts."""
    corpus = root / "cmu_indic"
    for spk, words in (("ben_rm", BENGALI_TTS), ("tel_ss", TELUGU_TTS)):
        lang = spk.split("_")[0]
        _write_festvox(corpus, rng, f"cmu_indic_{spk}", [
            (f"{lang}_{i:04d}", words) for i in range(1, 7)] + [
            (f"arctic_a{i:04d}", TTS_ENGLISH) for i in (1, 2)])
    (corpus / "cmu_indic_ben_rm" / "etc" / "voice.feats").write_text("name ben_rm\nage 29\n")
    return corpus


def _write_adept(root: Path, rng) -> Path:
    """ADEPT: ``wav_44khz/<type>/<label>/<prompt>.wav`` at 44.1 kHz, the
    ``txt/`` mirror and ``adept_prompts.json`` (interpretations of the
    emphasis prompts only); 2 types x 2 labels x 4 prompts."""
    corpus, interpretations = root / "ADEPT", {"emphasis": {}}
    for kind, labels in (("emphasis", ("marked", "unmarked")),
                         ("propositional_attitude", ("surprise", "incredulity"))):
        for label in labels:
            for p in range(4):
                prompt = f"{p + 1:02d}_{'abcd'[p]}"
                _write_audio(corpus / "wav_44khz" / kind / label / f"{prompt}.wav",
                             _tone_burst(rng, float(rng.uniform(*TTS_SECONDS)), 44100), 44100)
                (corpus / "txt" / kind / label).mkdir(parents=True, exist_ok=True)
                (corpus / "txt" / kind / label / f"{prompt}.txt").write_text(
                    _words(rng, TTS_ENGLISH, 4, 10).capitalize() + ".\n")
                if kind == "emphasis":
                    interpretations["emphasis"].setdefault(prompt, {})[label] = (
                        f"stress on {_words(rng, TTS_ENGLISH, 1, 2)}")
    (corpus / "adept_prompts.json").write_text(json.dumps(interpretations))
    return corpus


def _write_l2_arctic(root: Path, rng) -> Path:
    """L2-ARCTIC: the speaker directories ``ABA``, ``BWC``, ``HJK`` and
    ``YKWK`` with ``wav/arctic_*.wav`` at 44.1 kHz and
    ``transcript/arctic_*.txt``, 4 utterances each, and
    ``suitcase_corpus/{wav,transcript}/<spk>.{wav,txt}`` for ``aba`` and
    ``hjk``, of 20-30 s."""
    corpus = root / "l2arctic_release_v5"
    for spk in ("ABA", "BWC", "HJK", "YKWK"):
        for i in range(4):
            utt = f"arctic_{'ab'[i // 2]}{i + 1:04d}"
            _write_audio(corpus / spk / "wav" / f"{utt}.wav",
                         _tone_burst(rng, float(rng.uniform(*TTS_SECONDS)), 44100), 44100)
            (corpus / spk / "transcript").mkdir(parents=True, exist_ok=True)
            (corpus / spk / "transcript" / f"{utt}.txt").write_text(
                _words(rng, TTS_ENGLISH, 4, 10) + "\n")
    for spk in ("aba", "hjk"):
        _write_audio(corpus / "suitcase_corpus" / "wav" / f"{spk}.wav",
                     _tone_burst(rng, float(rng.uniform(*L2_SUITCASE_SECONDS)), 44100), 44100)
        (corpus / "suitcase_corpus" / "transcript").mkdir(parents=True, exist_ok=True)
        (corpus / "suitcase_corpus" / "transcript" / f"{spk}.txt").write_text(
            _words(rng, TTS_ENGLISH, 30, 60) + "\n")
    return corpus


def _write_cslu_kids(root: Path, rng) -> Path:
    """CSLU Kids (LDC2007S18): ``speech/scripted/<prompt>/<grade>/<spk>/<utt>.wav``
    and ``speech/spontaneous/<prompt>/<grade>/<spk>/<utt>.wav`` at 16 kHz,
    ``docs/all.map`` (``<prompt> "<text>"``), ``docs/<prompt>-verified.txt``
    (``<path> <label>``) and the ``trans/spontaneous/`` mirror with noise
    tags; 4 speakers of grades 0-3, 4 scripted prompts and 1 story each."""
    corpus = root / "cslu_kids"
    scripted = [f"{i:02d}" for i in range(4)]
    (corpus / "docs").mkdir(parents=True, exist_ok=True)
    (corpus / "docs" / "all.map").write_text("".join(
        f'{p} "{_words(rng, TTS_ENGLISH, 1, 4)}"\n' for p in scripted) + '70 "tell me a story"\n')
    verified = {p: [] for p in scripted}
    for grade, spk in enumerate(("ks001", "ks101", "ks201", "ks301")):
        for k, prompt in enumerate(scripted):
            utt = f"{spk}{prompt}0"
            rel = f"speech/scripted/{prompt}/{grade}/{spk}/{utt}.wav"
            _write_audio(corpus / rel, _tone_burst(rng, float(rng.uniform(2.0, 4.0))), SR)
            if (grade + k) % 5:
                verified[prompt].append(f"{rel} {1 + (grade + k) % 4}")
        utt = f"{spk}xx0"
        _write_audio(corpus / "speech" / "spontaneous" / "70" / str(grade) / spk / f"{utt}.wav",
                     _tone_burst(rng, float(rng.uniform(*CSLU_STORY_SECONDS))), SR)
        words = _words(rng, TTS_ENGLISH, 12, 24).split()
        for _ in range(3):
            words.insert(int(rng.randint(len(words) + 1)), CSLU_TAGS[rng.randint(4)])
        trans = corpus / "trans" / "spontaneous" / "70" / str(grade) / spk
        trans.mkdir(parents=True, exist_ok=True)
        (trans / f"{utt}.txt").write_text(" ".join(words[:8]) + "\n" + " ".join(words[8:]) + "\n")
    for prompt, lines in verified.items():
        (corpus / "docs" / f"{prompt}-verified.txt").write_text("\n".join(lines) + "\n")
    return corpus


def _write_grid(root: Path, rng) -> Path:
    """GRID: 2 speakers of ``GRID_VIDEOS`` 3 s command sentences,
    ``video/<spk>/<id>.mpg`` written as the JAX package's test writes them
    (a RIFF payload under the ``.mpg`` name, here at the 25 kHz of the
    release's ``audio_25k`` copies), ``alignments/<spk>/<id>.align``
    (``<start> <end> <word>`` in 1/1000 s, ``sil`` at both ends) and an
    empty ``audio_25k/``, which the recipe requires and does not read."""
    corpus = root / "grid"
    (corpus / "audio_25k").mkdir(parents=True, exist_ok=True)
    commands = (("bin", "lay", "place", "set"), ("blue", "green", "red", "white"),
                ("at", "by", "in", "with"), tuple("abcdefghijklmnopqrstuvxyz"),
                ("zero", "one", "two", "three", "four", "five", "six", "seven", "eight", "nine"),
                ("again", "now", "please", "soon"))
    for spk in ("s1", "s2"):
        for v in range(GRID_VIDEOS):
            words = [c[rng.randint(len(c))] for c in commands]
            vid = "".join(w[0] for w in words[:4]) + words[4][0] + words[5][0]
            vid = f"{vid}{v}"
            x = _tone_burst(rng, 3.0, GRID_SR)
            _write_audio(corpus / "video" / spk / f"{vid}.mpg", x, GRID_SR)
            edges = np.sort(rng.choice(np.arange(300, 2700, 50), len(words) + 1, replace=False))
            bounds = [0, *edges.tolist(), 3000]
            items = ["sil", *words, "sil"]
            (corpus / "alignments" / spk).mkdir(parents=True, exist_ok=True)
            (corpus / "alignments" / spk / f"{vid}.align").write_text("".join(
                f"{a} {b} {w}\n" for a, b, w in zip(bounds[:-1], bounds[1:], items)))
    return corpus


def _write_oto_speech(root: Path, rng) -> Path:
    """otoSpeech: ``data/train/shard{0,1}.tar``, each of ``OTO_SESSIONS``
    FLAC sessions of ``OTO_SECONDS`` at 48 kHz under nested paths, and
    ``seglst.json``: the turns of each session (two speakers, 2-15 s, most
    with word alignments in session time), a segment of a session that is
    not on disk and one of zero length."""
    import tarfile

    corpus, stage, labels = root / "oto_speech", root / "oto_stage", []
    (corpus / "data" / "train").mkdir(parents=True, exist_ok=True)
    for shard in range(2):
        with tarfile.open(corpus / "data" / "train" / f"shard{shard}.tar", "w") as tar:
            for s in range(OTO_SESSIONS):
                session = f"oto_{shard:02d}{s:02d}_full_duplex"
                segments = _segments_within(rng, OTO_SECONDS, 8, lengths=(2.0, 7.0),
                                            gaps=(0.2, 1.0))
                src = stage / f"{session}.flac"
                _write_audio(src, _speech_track(rng, OTO_SECONDS, segments, OTO_SR), OTO_SR)
                tar.add(src, arcname=f"train/{shard:05d}/{session}.flac")
                for k, (a, b) in enumerate(segments):
                    a, b = round(a, 3), round(b, 3)
                    words = _words(rng, TTS_ENGLISH, 3, 9).split()
                    seg = {"session_id": session, "start_time": a, "end_time": b,
                           "words": " ".join(words), "speaker": f"speaker_{k % 2}"}
                    if k % 4:
                        edges = np.round(np.linspace(a, b, len(words) + 1), 3)
                        seg["word_alignment"] = [[w, float(x), float(y)] for w, x, y in
                                                 zip(words, edges[:-1], edges[1:])]
                    labels.append(seg)
    labels.insert(5, {"session_id": "oto_9999_full_duplex", "start_time": 1.0, "end_time": 4.0,
                      "words": "not on disk", "speaker": "speaker_0"})
    labels.append({"session_id": labels[0]["session_id"], "start_time": 30.0, "end_time": 30.0,
                   "words": "", "speaker": "speaker_1"})
    (corpus / "seglst.json").write_text(json.dumps(labels), encoding="utf-8")
    return corpus


def _tts_kids_specs(root: Path, rng) -> dict:
    """Per corpus of phase 31's ``corpus_<name>`` legs, in the order they
    run: the recipe's call for an output directory, the CLI's command and
    the training path. DailyTalk's recipe returns a (recordings,
    supervisions) tuple, which the spec names; L2-ARCTIC's two parts are
    two legs. Hi-Fi TTS and GRID run at one job: at two, their calls took
    13.3-18.7 s on the card's machine, most of it starting the spawned
    workers, against 0.02-0.7 s at one (the CPU tests run them at two)."""
    from lhotse_tpu_torch import recipes as R

    hifitts, ears = _write_hifitts(root, rng), _write_ears(root, rng)
    daily, arctic = _write_daily_talk(root, rng), _write_cmu_arctic(root, rng)
    indic, adept = _write_cmu_indic(root, rng), _write_adept(root, rng)
    l2, cslu = _write_l2_arctic(root, rng), _write_cslu_kids(root, rng)
    grid, oto = _write_grid(root, rng), _write_oto_speech(root, rng)
    return {
        "hifitts": (lambda o: R.prepare_hifitts(hifitts, output_dir=o), ["hifitts", hifitts],
                    "tts"),
        "ears": (lambda o: R.prepare_ears(ears, output_dir=o), ["ears", ears], "tts"),
        "daily_talk": (lambda o: dict(zip(("recordings", "supervisions"),
                                          R.prepare_daily_talk(daily, output_dir=o))),
                       ["daily-talk", daily], "tts"),
        "cmu_arctic": (lambda o: R.prepare_cmu_arctic(arctic, output_dir=o),
                       ["cmu-arctic", arctic], "tts"),
        "cmu_indic": (lambda o: R.prepare_cmu_indic(indic, output_dir=o),
                      ["cmu-indic", indic], "tts"),
        "adept": (lambda o: R.prepare_adept(adept, output_dir=o), ["adept", adept], "tts"),
        "l2_arctic_read": (lambda o: R.prepare_l2_arctic(l2, output_dir=o)["read"],
                           ["l2-arctic", l2], "asr"),
        "l2_arctic_suitcase": (lambda o: R.prepare_l2_arctic(l2, output_dir=o)["suitcase"],
                               ["l2-arctic", l2], "asr"),
        "cslu_kids": (lambda o: R.prepare_cslu_kids(cslu, output_dir=o),
                      ["cslu-kids", cslu], "asr"),
        "grid": (lambda o: R.prepare_grid(grid, output_dir=o), ["grid", grid], "asr"),
        "oto_speech": (lambda o: R.prepare_oto_speech(oto, o), ["oto-speech", oto], "asr"),
    }


def _phase_tts_kids(workdir: Path, device, fbank_cuda, smi: str) -> tuple:
    """31. The TTS, accented-speech and children's corpus recipes, in phase
    14's directory after phase 30 (phase 23's MUSAN noise and RIRS_NOISES
    manifests feed the augmenter). Every recipe runs as a function and
    through the CLI's ``prepare`` command, and their manifests must be
    equal. ``cmu_kids_device_chain``: the input chain every
    ``_device_chain`` leg runs (80-dim log-mel fbank, MUSAN noise, speed
    perturbation, SpecAugment) on CMU Kids in its LDC layout, 256
    utterances of 2-15 s as 16 kHz int16 SPHERE from 16 children →
    ``prepare_cmu_kids`` → ``CutSet.from_manifests`` → the first 256 cuts as
    the 15 s x 256 bucket's int16 batch → ``OnDeviceAugmenter`` (twice);
    every recording's samples must equal the int16 written / 32768 and
    every supervision's prompt, spoken transcript, bin, grade and age what
    was written. ``corpus_<name>``: Hi-Fi TTS, EARS, DailyTalk, CMU ARCTIC,
    CMU Indic and ADEPT into the TTS dataset, L2-ARCTIC's read and suitcase
    parts, CSLU Kids, GRID and otoSpeech into the step, through
    ``_corpus_legs``. Returns the kernel's launches per path and the
    largest kernel-vs-plain error."""
    import shutil

    from lhotse_tpu_torch import CutSet
    from lhotse_tpu_torch import recipes as R
    from lhotse_tpu_torch.caching import set_caching_enabled
    from lhotse_tpu_torch.tracing import set_tracing_enabled

    set_caching_enabled(False)
    set_tracing_enabled(True)
    rng = np.random.RandomState(KIDS_SEED)
    root = workdir / "tts_kids"
    manifests = root / "manifests"
    launches, errs = {}, []

    # -- cmu_kids_device_chain ---------------------------------------------------------------
    t0 = time.perf_counter()
    kids, expected = _write_cmu_kids(root / "corpora", rng)
    write_s = time.perf_counter() - t0
    made, files, function_s, cli_s = _prepare_twice(
        manifests, "cmu_kids", lambda o: R.prepare_cmu_kids(kids, output_dir=o),
        ["cmu-kids", kids])
    cuts = CutSet.from_manifests(recordings=made["recordings"],
                                 supervisions=made["supervisions"]).to_eager()
    sec, bsz = BUCKET
    n = int(sec * SR)
    order = list(cuts)[:bsz]
    t0 = time.perf_counter()
    audio, lens = np.zeros((bsz, n), np.float32), np.zeros(bsz, np.int64)
    loaded = {}
    for k, cut in enumerate(order):
        loaded[cut.recording_id] = x = cut.load_audio()[0]
        audio[k, : x.size], lens[k] = x, x.size
    load_s = time.perf_counter() - t0
    # Every recording's samples (the bucket's as loaded, the rest read here)
    # against the int16 written / 32768, and every supervision's fields.
    t0 = time.perf_counter()
    samples_equal = all(np.array_equal(
        loaded[r.id] if r.id in loaded else r.load_audio()[0],
        expected[r.id][0].astype(np.float32) / 32768.0) for r in made["recordings"])
    fields_equal = all(
        (s.text, s.custom["spoken_transcript"], s.custom["bin"], s.custom["speaker_grade"],
         s.custom["speaker_age"]) == expected[s.id][1:] and s.gender == (
            "Male" if s.speaker[0] == "m" else "Female") for s in made["supervisions"])
    check_s = time.perf_counter() - t0
    bins = sorted({s.custom["bin"] for s in made["supervisions"]})
    nas = sum(s.custom["speaker_grade"] is None or s.custom["speaker_age"] is None
              for s in made["supervisions"])
    pool, rir, noise, rir_rec = _noise_pool_and_rir(workdir)
    print(f"[{smi}] cmu_kids_device_chain: CMU Kids with {len(expected)} utterances of "
          f"{KIDS_SECONDS} s from {KIDS_SPEAKERS} children as 16 kHz SPHERE written in "
          f"{write_s!r} s; prepare {function_s!r} s, CLI {cli_s!r} s, its {len(files)} manifests "
          f"equal; {len(made['supervisions'])} supervisions in bins {bins}, {nas} with an NA "
          f"grade or age; every recording equal to its int16 / 32768: {samples_equal}, every "
          f"prompt, spoken transcript, bin, grade and age as written: {fields_equal} (checked in "
          f"{check_s!r} s; e.g. {order[0].supervisions[0].text!r}); the first {len(order)} cuts "
          f"loaded in {load_s!r} s: {float(lens.sum()) / SR!r} audio-s, the bucket "
          f"{float(lens.sum()) / (bsz * n)!r} full; noise pool {pool.shape} from phase 23's "
          f"{len(noise)} MUSAN noise recordings, RIR {rir_rec.id}")
    if (len(made["supervisions"]) != len(expected) or not samples_equal or not fields_equal
            or bins != [1, 2] or not nas or len(order) != bsz or lens.max() > n
            or lens.min() < KIDS_SECONDS[0] * SR - 1):
        raise AssertionError("cmu_kids_device_chain: the supervisions, samples, fields or the "
                             "bucket are off")
    launches["cmu_kids_device_chain"], kernel_err, chain_err = _device_chain(
        "cmu_kids_device_chain", [(audio, lens)] * 2, pool, rir, device, fbank_cuda, smi)
    errs += [kernel_err, chain_err]

    # -- corpus_<name> -----------------------------------------------------------------------
    t0 = time.perf_counter()
    specs = _tts_kids_specs(root / "corpora", rng)
    print(f"[{smi}] corpora ({', '.join(specs)}) written in {time.perf_counter() - t0!r} s; "
          f"corpus_grid reads its videos through the RIFF payload the JAX package's test "
          f"writes under the .mpg name: a real GRID video (MPEG) needs ffmpeg to decode "
          f"(found here: {shutil.which('ffmpeg') is not None})")
    corpus_launches, corpus_errs, summary = _corpus_legs(manifests, specs, device, fbank_cuda, smi)
    launches.update(corpus_launches)
    errs += corpus_errs
    print(f"[{smi}] phase 31 corpora: {summary}")
    set_tracing_enabled(False)
    return launches, max(errs)


DP_RANKS = 2  # data-parallel ranks of phase 16, both on the one card


def _dp_rank(rank: int, n_ranks: int, cuts_path: Path) -> list:
    """Phase 16's rank ``rank`` of ``n_ranks`` in its own spawned process,
    joined to the others by gloo (``lhotse_tpu_torch.entry.run_gloo_ranks``):
    its partition of phase 10's sampler → ``K2SpeechRecognitionDataset``
    with ``OnTheFlyFeatures`` on the card (the fbank kernel) →
    ``DataLoader`` → one AdamW step of ``Encoder(EncoderConfig())`` per
    batch, the gradients averaged over the ranks by one ``all_reduce`` of
    the card's tensors through gloo, and after every step this rank's
    parameters ``torch.equal`` to every other rank's. A rank out of batches
    takes the step with zero gradients until every rank is done. Every
    rank's report goes to rank 0, which returns the list."""
    import torch.distributed as dist

    from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
    from lhotse_tpu_torch.dataset.loader import DataLoader
    from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
    from lhotse_tpu_torch.features import Fbank, FbankConfig
    from lhotse_tpu_torch.models import encoder as enc
    from lhotse_tpu_torch.ops import fbank_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    fbank_cuda._lib()  # built by the parent before it spawned the ranks
    fly = Fbank(FbankConfig(device=device))
    recorder = _RecordFirstBatch(fly)
    sampler = _sampler_over(cuts_path, world_size=n_ranks, rank=rank)
    dataset = K2SpeechRecognitionDataset(return_cuts=True, input_strategy=OnTheFlyFeatures(fly))
    loader = DataLoader(sampler, dataset, prefetch_batches=3)
    cfg = enc.EncoderConfig()
    model = enc.Encoder(cfg, device=device)  # the same seeded weights on every rank
    params = list(model.parameters())
    init, _ = enc.make_adamw_train_step(lr=1e-3)
    opt = init(model)
    gen = torch.Generator(device=device).manual_seed(10 + rank)  # rank-keyed masks
    n_batches = torch.tensor([sum(1 for _ in sampler)])
    dist.all_reduce(n_batches, op=dist.ReduceOp.MAX)
    ids, losses, reduce_ms, audio_s, equal_after = [], [], [], 0.0, []
    torch.cuda.synchronize()
    dist.barrier()
    fbank_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    it = iter(loader)
    for _ in range(int(n_batches)):
        batch = next(it, None)
        opt.zero_grad(set_to_none=False)
        if batch is not None:
            cuts = batch["supervisions"]["cut"]
            feats = torch.from_numpy(batch["inputs"]).to(device)
            feat_lens = torch.from_numpy(
                np.asarray(batch["supervisions"]["num_frames"], np.int64)).to(device)
            mask = enc.draw_mask(feat_lens, feats.shape[1], cfg.mask_prob, gen)
            loss = enc.masked_prediction_loss(model, feats, feat_lens, mask)
            loss.backward()
            losses.append(float(loss.detach()))
            ids.append([c.id for c in cuts])
            audio_s += sum(c.duration for c in cuts)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        torch.cuda.synchronize()
        t = time.perf_counter()
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        dist.all_reduce(flat)
        flat /= n_ranks
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad.copy_(g.view_as(p))
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t) * 1e3)
        opt.step()
        mine = torch.cat([p.detach().reshape(-1) for p in params]).cpu()
        everyone = [torch.empty_like(mine) for _ in range(n_ranks)]
        dist.all_gather(everyone, mine)
        equal_after.append(all(torch.equal(mine, other) for other in everyone))
    torch.cuda.synchronize()
    elapsed_s = time.perf_counter() - t0
    launches = fbank_cuda.LAUNCHES
    items, kernel_out = recorder.first
    err = max(float(np.abs(a - b).max()) for a, b in zip(kernel_out, _plain_extract(fly, items)))
    report = {"rank": rank, "ids": ids, "losses": losses, "reduce_ms": reduce_ms,
              "audio_s": audio_s, "elapsed_s": elapsed_s, "launches": launches,
              "equal_after": equal_after, "kernel_err": err, "steps": int(n_batches)}
    reports = [None] * n_ranks
    dist.all_gather_object(reports, report)
    return reports


def _phase_data_parallel(cuts_path: Path, smi: str) -> tuple:
    """16. Two data-parallel ranks on the one card, on phase 10's corpus and
    bucket table (``_dp_rank``, one epoch). Checks that the ranks' cuts are
    disjoint and together are what the two samplers give in this process
    without a process group, that the parameters are ``torch.equal`` across
    the ranks after every step, that each rank launched the kernel once per
    batch, and the first batch of each rank against the kernel's plain
    version. Then ``dryrun_multichip(4)`` on the CPU, timed. Returns the
    launches and the kernel's worst error."""
    from lhotse_tpu_torch.entry import dryrun_multichip, run_gloo_ranks

    t0 = time.perf_counter()
    reports = run_gloo_ranks(_dp_rank, DP_RANKS, cuts_path)
    wall_s = time.perf_counter() - t0
    in_process = [{c.id for batch in _sampler_over(cuts_path, DP_RANKS, r) for c in batch}
                  for r in range(DP_RANKS)]
    per_rank = [{i for batch in rep["ids"] for i in batch} for rep in reports]
    disjoint = all(not (per_rank[a] & per_rank[b])
                   for a in range(DP_RANKS) for b in range(a + 1, DP_RANKS))
    union_equal = set().union(*per_rank) == set().union(*in_process)
    audio_s = sum(rep["audio_s"] for rep in reports)
    elapsed_s = max(rep["elapsed_s"] for rep in reports)
    launches = sum(rep["launches"] for rep in reports)
    err = max(rep["kernel_err"] for rep in reports)
    for rep in reports:
        n = len(rep["ids"])
        print(f"[{smi}] dp_on_the_fly rank {rep['rank']}/{DP_RANKS}: {n} batches "
              f"({rep['steps']} steps), {rep['audio_s']!r} audio-s in {rep['elapsed_s']!r} s; "
              f"losses {rep['losses']}; host ms per step in the gradient all_reduce (gloo, "
              f"through the host) {rep['reduce_ms']}; fbank kernel launches {rep['launches']}; "
              f"parameters torch.equal across the ranks after every step: "
              f"{all(rep['equal_after'])}; first batch kernel vs plain {rep['kernel_err']!r} "
              f"(tol {KERNEL_TOL})")
    print(f"[{smi}] dp_on_the_fly: {DP_RANKS} ranks on one card, {audio_s!r} audio-s in "
          f"{elapsed_s!r} s (the slower rank's epoch, steps included): {audio_s / elapsed_s!r} "
          f"audio-s/s of both ranks together; batches per rank {[len(r['ids']) for r in reports]}; "
          f"host ms per step in the gradient reduction, mean "
          f"{float(np.mean([m for r in reports for m in r['reduce_ms']]))!r}; ranks' cuts "
          f"disjoint: {disjoint}, union equal to the two samplers' in one process: "
          f"{union_equal}; spawn to join {wall_s!r} s")
    if not disjoint or not union_equal:
        raise AssertionError("dp_on_the_fly: the ranks' partitions are off")
    for rep in reports:
        if not all(rep["equal_after"]) or len(rep["equal_after"]) != rep["steps"]:
            raise AssertionError(f"dp_on_the_fly: rank {rep['rank']}'s parameters differ")
        if rep["launches"] != len(rep["ids"]) or not rep["kernel_err"] <= KERNEL_TOL:
            raise AssertionError(f"dp_on_the_fly: rank {rep['rank']}'s launches or kernel are off")
        if not rep["ids"] or not all(math.isfinite(x) for x in rep["losses"]):
            raise AssertionError(f"dp_on_the_fly: rank {rep['rank']} ran no batch or lost finiteness")
    t0 = time.perf_counter()
    dryrun_multichip(4)
    print(f"dryrun_multichip(4): 4 gloo ranks on the CPU, (2 data x 2 model), passed in "
          f"{time.perf_counter() - t0!r} s")
    return launches, err


class _PlainFbank:
    """The default fbank layer's computation with the kernel's plain version
    in place of the kernel, for the chain comparison."""

    frame_shift = 0.01

    def __init__(self, layer, fbank_cuda):
        self.layer = layer
        self.fbank_cuda = fbank_cuda

    def __call__(self, x):
        Mc, Ms, fb, _ = self.layer._fused_matrices()
        padded = self.fbank_cuda.edge_pad(x)
        return self.fbank_cuda.reference_fbank(padded, Mc, Ms, fb)


def main() -> None:
    start = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is False.")
    import lhotse_tpu_torch

    if Path(lhotse_tpu_torch.__file__).resolve().parent.parent != ROOT:
        sys.exit(f"lhotse_tpu_torch was imported from {lhotse_tpu_torch.__file__}, not from {ROOT}.")
    from lhotse_tpu_torch import _build
    from lhotse_tpu_torch.dataset.device_augment import OnDeviceAugmenter
    from lhotse_tpu_torch.dataset.signal_transforms import SpecAugment
    from lhotse_tpu_torch.ops import fbank as ops
    from lhotse_tpu_torch.ops import fbank_cuda

    assert "jax" not in sys.modules and "lhotse_tpu" not in sys.modules
    # The plain versions this script compares against must be IEEE fp32:
    # TF32 keeps ~3 decimal digits. Matmuls default to fp32 already; cuDNN
    # convolutions default to TF32 (the port's resampler turns it off itself).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    # -- 1. environment -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    fbank_cuda._lib()
    print(f"fbank kernel built and loaded in {time.perf_counter() - t0:.2f} s "
          f"({_build.library_path('fbank')})")
    # The host C libraries (byte-for-byte copies of the JAX package's
    # sources), built here so that no phase times a build.
    from lhotse_tpu_torch.audio import flacio
    from lhotse_tpu_torch.codecs import lilcom_codec
    from lhotse_tpu_torch.ops import host_dsp

    for name, get_lib in (("flac", flacio._get_lib), ("dsp", host_dsp._get_lib),
                          ("lilcom (LTC1)", lilcom_codec._native_lib)):
        t0 = time.perf_counter()
        get_lib()
        print(f"{name} host library built and loaded in {time.perf_counter() - t0:.2f} s")

    # -- 2. kernel vs plain version -------------------------------------------
    # The kernel gets the packed DFT operand as the layers hold it, so its
    # times are of the launch alone.
    Mc, Ms = ops.dft_analysis_matrices(400, 512)
    cases = []
    # 200 filters run in two of the kernel's 128-filter chunks; 8 x 30,000
    # frames is a 300 s, 8-channel meeting session.
    for B, T, n_mels in [(1, 100, 23), (3, 1001, 80), (3, 1001, 200), (8, 30000, 80),
                         (256, 1364, 80)]:
        Mc_d, Ms_d, fb_d = (
            torch.from_numpy(np.ascontiguousarray(m)).to(device)
            for m in fbank_cuda._squeeze_nyquist(Mc, Ms, _mel_bank(n_mels, ops)))
        dft = fbank_cuda.pack_dft(Mc_d, Ms_d)
        N = (T - 1) * 160 + 400
        x = torch.from_numpy(
            np.random.default_rng(B).standard_normal((B, N), np.float32) * 0.1).to(device)

        def kernel():
            return fbank_cuda.fbank_cuda(x, Mc_d, Ms_d, fb_d, dft=dft)

        def plain():
            return fbank_cuda.reference_fbank(x, Mc_d, Ms_d, fb_d)

        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        if out.shape != (B, T, n_mels) or not torch.isfinite(out).all():
            raise AssertionError(f"kernel output {tuple(out.shape)} wrong or not finite")
        case = {"shape": [B, T, n_mels], "max_abs_err": (out - ref).abs().max().item(),
                "ms": _median_ms(kernel), "plain_ms": _median_ms(plain),
                "device_ms": _device_ms(kernel, "fbank_logmel"), "plain_device_ms": _device_ms(plain)}
        # The two DFT products and the mel product over each filter's bins.
        flop = B * T * (400 * 256 * 4 + 2 * _mel_macs(fb_d))
        case["flop"] = flop
        # Each input read once (audio, packed DFT, mel bank), the output written once.
        nbytes = 4 * (B * N + dft.numel() + fb_d.numel() + B * T * n_mels)
        t_ops, t_bytes = flop / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
        case["bound_ms"] = max(t_ops, t_bytes) * 1e3
        case["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        print(f"fbank B={B} T={T} n_mels={n_mels}: max_abs_err {case['max_abs_err']!r} "
              f"(tol {KERNEL_TOL}); per call (CUDA events, median of {TIMING_RUNS}) kernel "
              f"{case['ms']!r} ms, plain {case['plain_ms']!r} ms; device (torch.profiler) "
              f"kernel {case['device_ms']!r} ms ({flop / case['device_ms'] / 1e9:.1f} TFLOP/s), "
              f"plain {case['plain_device_ms']!r} ms; bound {case['bound_ms']!r} ms "
              f"({case['bound_by']})")
        if not case["max_abs_err"] <= KERNEL_TOL:
            raise AssertionError(
                f"kernel disagrees with its plain version: {case['max_abs_err']} > {KERNEL_TOL}")
        cases.append(case)
    main_case = cases[-1]  # the main path's shape

    kernel_err, plain_err = _near_silent_errors(device, ops, fbank_cuda)
    print(f"near-silent 3 x 1001 x 80 against float64: kernel {kernel_err!r}, plain {plain_err!r} "
          f"(the kernel may be at most twice as far off)")
    if not kernel_err <= 2 * plain_err:
        raise AssertionError(f"kernel lost digits on a near-silent input: {kernel_err} > 2 x {plain_err}")

    # -- 3. main path ---------------------------------------------------------
    rng = np.random.default_rng(0)
    noise_pool = rng.standard_normal((16, 16 * SR), np.float32) * 0.1
    t_rir = np.arange(SR // 2, dtype=np.float32)
    rir = (rng.standard_normal(SR // 2).astype(np.float32) * np.exp(-t_rir / 1600.0)).astype(
        np.float32)
    rir[0] = 1.0
    common = dict(speed_factor=SPEED, gain_range=(0.9, 1.1), noise_pool=noise_pool,
                  snr=(10, 20), mix_prob=0.5, rir=rir, specaugment=SpecAugment(seed=0),
                  device=device)
    aug = OnDeviceAugmenter(buckets=[(15.0, 256)], wire_format="int16", **common)
    doc_buckets = [(6.0, 40), (9.0, 27), (12.0, 20)]
    aug_doc = OnDeviceAugmenter(buckets=doc_buckets, wire_format="float32", **common)
    aug.precompile()
    aug_doc.precompile()
    batches = []
    for i in range(3):
        lens = rng.integers(8 * SR, 15 * SR + 1, size=256)
        lens[0] = 15 * SR
        audio = rng.standard_normal((256, 15 * SR), np.float32) * 0.1
        batches.append((audio, lens))
    doc_batches = []
    for sec, bsz in doc_buckets:
        lens = rng.integers(int((sec - 3) * SR), int(sec * SR) + 1, size=bsz - 1)
        lens[0] = int(sec * SR)
        audio = rng.standard_normal((bsz - 1, int(lens.max())), np.float32) * 0.1
        doc_batches.append((audio, lens))

    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    staged = [aug.stage(audio, lens) for audio, lens in batches]
    outs = [aug.compute(s) for s in staged]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    doc_outs = [aug_doc(audio, lens) for audio, lens in doc_batches]
    torch.cuda.synchronize()
    launches = fbank_cuda.LAUNCHES
    print(f"main path: fbank kernel launches {launches}")
    if launches < len(batches) + len(doc_batches):
        raise AssertionError(f"the main path launched the fbank kernel {launches} times")

    audio_sec = sum(int(lens.sum()) for _, lens in batches) / SR
    print(f"15 s x 256 bucket, int16 wire: {len(batches)} batches, {audio_sec!r} audio-s in "
          f"{elapsed!r} s (stage + compute): {audio_sec / elapsed!r} audio-s/s")
    for (feats, feat_lens), (_, lens) in zip(outs, batches):
        if tuple(feats.shape) != (256, 1364, 80) or not torch.isfinite(feats).all():
            raise AssertionError(f"main-path features {tuple(feats.shape)} wrong or not finite")
        if not np.array_equal(feat_lens.cpu().numpy(), _expected_feat_lens(lens)):
            raise AssertionError("main-path feat_lens differ from the hop rule")
    for (feats, feat_lens), (sec, bsz), (_, lens) in zip(doc_outs, doc_buckets, doc_batches):
        frames = (math.ceil(int(sec * SR) * 10 / 11) + 80) // 160
        full_lens = np.zeros(bsz, np.int64)
        full_lens[: len(lens)] = lens
        if tuple(feats.shape) != (bsz, frames, 80) or not torch.isfinite(feats).all():
            raise AssertionError(f"{sec} s bucket features {tuple(feats.shape)} wrong or not finite")
        if not np.array_equal(feat_lens.cpu().numpy(), _expected_feat_lens(full_lens)):
            raise AssertionError(f"{sec} s bucket feat_lens differ from the hop rule")
        print(f"{sec} s x {bsz} bucket, float32 wire: features {tuple(feats.shape)} finite")

    _check_chain(staged[0], *outs[0], "int16", rir, device, fbank_cuda)

    # A small batch through the CPU port (plain versions throughout) as the
    # reference for the card's result.
    audio, lens = doc_batches[0][0][:4], doc_batches[0][1][:4]
    small = dict(common, device="cpu")
    cpu_feats, cpu_lens = OnDeviceAugmenter(buckets=[(6.0, 4)], **small)(audio, lens)
    gpu_feats, gpu_lens = OnDeviceAugmenter(buckets=[(6.0, 4)], **common)(audio, lens)
    cross_err = (gpu_feats.cpu() - cpu_feats).abs().max().item()
    print(f"6 s x 4 batch, card vs CPU port: max_abs_err {cross_err!r} (tol {CHAIN_TOL})")
    if not cross_err <= CHAIN_TOL or not torch.equal(gpu_lens.cpu(), cpu_lens):
        raise AssertionError("the card's result disagrees with the CPU port's")

    # -- 4. adpcm4 wire, 5. sample cache, 6. extractors -------------------------
    by_path = {"augment_int16": launches}
    by_path["augment_adpcm4"] = _phase_adpcm4(common, batches[0], rir, device, fbank_cuda, smi)
    extra = rng.integers(8 * SR, 15 * SR + 1, size=256)
    cache_batches = batches + [(rng.standard_normal((256, 15 * SR), np.float32) * 0.1, extra)]
    by_path["cached"] = _phase_cache(common, cache_batches, device, fbank_cuda)
    by_path.update(_phase_extractors(device, fbank_cuda, ops))

    # -- 7. model path, 8. entry, 9. WPE --------------------------------------
    by_path["model"] = _phase_model(common, rng, device, fbank_cuda)
    by_path["entry"] = _phase_entry(device, fbank_cuda)
    _phase_wpe(device)

    # -- 10. the host data path into the trainer step, 11. precomputed features,
    # 12. the augmented training path, 13. the Shar corpus path. One FLAC
    # corpus for the four phases.
    (ROOT / "build").mkdir(exist_ok=True)
    # Phase 13's Shar shards outlive phase 10's corpus: phase 25 muxes them.
    kept = tempfile.TemporaryDirectory(dir=ROOT / "build")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        cuts_path, noise_path = _synthesize_corpus(Path(tmp), E2E_RECORDINGS)
        print(f"e2e corpus: {E2E_RECORDINGS} FLAC recordings and a 4 x 10 s noise pool written "
              f"in {time.perf_counter() - t0!r} s")
        by_path.update(_phase_e2e(cuts_path, device, fbank_cuda, smi))
        launches_pre, pre_err = _phase_precomputed(cuts_path, Path(tmp), device, fbank_cuda, smi)
        by_path.update(launches_pre)
        t0 = time.perf_counter()
        launches_aug, aug_err = _phase_augmented(
            cuts_path, noise_path, Path(tmp) / "feats_cuts.jsonl", Path(tmp), device, fbank_cuda, smi)
        by_path.update(launches_aug)
        print(f"phase 12 took {time.perf_counter() - t0!r} s")
        t0 = time.perf_counter()
        launches_shar, shar_err = _phase_shar(
            cuts_path, Path(tmp) / "feats_cuts.jsonl", Path(tmp), device, fbank_cuda, smi)
        by_path.update(launches_shar)
        print(f"phase 13 took {time.perf_counter() - t0!r} s")
        # -- 16. two data-parallel ranks on the card, on the same corpus ----------
        t0 = time.perf_counter()
        by_path["dp_on_the_fly"], dp_err = _phase_data_parallel(cuts_path, smi)
        print(f"phase 16 took {time.perf_counter() - t0!r} s")
        shar_dir = Path(kept.name) / "shar"
        (Path(tmp) / "shar").rename(shar_dir)

    # -- 14. the recipe path, on corpora of its own --------------------------------
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        launches_recipe, recipe_err = _phase_recipe(Path(tmp), device, fbank_cuda, smi)
        by_path.update(launches_recipe)
        print(f"phase 14 took {time.perf_counter() - t0!r} s")
        # -- 18. the paired-cut, SPHERE/AIFF and remaining task-dataset path, on the
        # same corpora
        t0 = time.perf_counter()
        launches_paired, paired_err = _phase_paired(Path(tmp), device, fbank_cuda, smi)
        by_path.update(launches_paired)
        print(f"phase 18 took {time.perf_counter() - t0!r} s")
        # -- 19. the lossy-codec corpus path, on the same corpora
        t0 = time.perf_counter()
        launches_lossy, lossy_err = _phase_lossy(Path(tmp), device, fbank_cuda, smi)
        by_path.update(launches_lossy)
        print(f"phase 19 took {time.perf_counter() - t0!r} s")
        # -- 20. Kaldi data dirs with piped audio through the CLI, on the same corpora
        t0 = time.perf_counter()
        launches_kaldi, kaldi_err = _phase_kaldi(Path(tmp), device, fbank_cuda, smi)
        by_path.update(launches_kaldi)
        print(f"phase 20 took {time.perf_counter() - t0!r} s")
        # -- 21. simulated meetings into SURT training, on the same corpora
        t0 = time.perf_counter()
        launches_sim, sim_err = _phase_simulated_meetings(Path(tmp), device, fbank_cuda, smi)
        by_path.update(launches_sim)
        print(f"phase 21 took {time.perf_counter() - t0!r} s")
        # -- 22. sharded manifests: from_files, an index pack and WebDataset tars
        t0 = time.perf_counter()
        launches_sharded, sharded_err = _phase_sharded(Path(tmp), device, fbank_cuda, smi)
        by_path.update(launches_sharded)
        print(f"phase 22 took {time.perf_counter() - t0!r} s")
        # -- 23. MUSAN and RIRS_NOISES into the main path and the augmented path, and the
        # far-field meeting recipes, on the same corpora
        t0 = time.perf_counter()
        launches_noise, noise_err = _phase_noise_meetings(Path(tmp), device, fbank_cuda, smi)
        by_path.update(launches_noise)
        print(f"phase 23 took {time.perf_counter() - t0!r} s")
        # -- 24. the single-stream ASR, TTS and speaker corpora into the main path, long-form
        # training and on-the-fly features, after phase 23 (its MUSAN pool and RIRs)
        t0 = time.perf_counter()
        launches_single, single_err = _phase_single_stream(Path(tmp), device, fbank_cuda, smi)
        by_path.update(launches_single)
        print(f"phase 24 took {time.perf_counter() - t0!r} s")
        # -- 25. two corpora muxed into training with a checkpoint in JSON, and an
        # infinite mux over phase 13's Shar shards
        t0 = time.perf_counter()
        launches_muxed, muxed_err = _phase_muxed(Path(tmp), shar_dir, device, fbank_cuda, smi)
        by_path.update(launches_muxed)
        print(f"phase 25 took {time.perf_counter() - t0!r} s")
        # -- 26. the Chinese corpora: icefall's multi_zh-hans mix into the main path and into
        # on-the-fly training, and the other Chinese corpus recipes, after phase 23
        t0 = time.perf_counter()
        launches_zh, zh_err = _phase_zh_corpora(Path(tmp), device, fbank_cuda, smi)
        by_path.update(launches_zh)
        print(f"phase 26 took {time.perf_counter() - t0!r} s")
        # -- 27. the LDC telephone and broadcast corpora: Switchboard-1 and Fisher English
        # muxed into the main path, and the other LDC recipes into on-the-fly training,
        # after phase 23
        t0 = time.perf_counter()
        launches_tel, tel_err = _phase_telephone(Path(tmp), device, fbank_cuda, smi)
        by_path.update(launches_tel)
        print(f"phase 27 took {time.perf_counter() - t0!r} s")
        # -- 28. the overlapped-speech, diarization and earnings-call corpora and the CHiME-6
        # array synchroniser: LibriMix into the main path, after phases 14 and 23
        t0 = time.perf_counter()
        launches_overlap, overlap_err = _phase_overlap(Path(tmp), device, fbank_cuda, smi)
        by_path.update(launches_overlap)
        print(f"phase 28 took {time.perf_counter() - t0!r} s")
        # -- 29. the speech-translation and multilingual corpora: MuST-C into the main path,
        # IWSLT 2022 Tunisian Arabic and GigaST into translation training, after phase 23
        t0 = time.perf_counter()
        launches_translation, translation_err = _phase_translation(
            Path(tmp), device, fbank_cuda, smi)
        by_path.update(launches_translation)
        print(f"phase 29 took {time.perf_counter() - t0!r} s")
        # -- 30. the large ASR training corpora: KsponSpeech into the main path, NSC, BABEL,
        # Heroico, ICMC-ASR, ReazonSpeech and Bengali.AI Speech into training, after phase 23
        t0 = time.perf_counter()
        launches_asr, asr_err = _phase_asr_corpora(Path(tmp), device, fbank_cuda, smi)
        by_path.update(launches_asr)
        print(f"phase 30 took {time.perf_counter() - t0!r} s")
        # -- 31. the TTS, accented-speech and children's corpora: CMU Kids into the main
        # path, Hi-Fi TTS, EARS, DailyTalk, CMU ARCTIC, CMU Indic and ADEPT into TTS batches,
        # L2-ARCTIC, CSLU Kids, GRID and otoSpeech into training, after phase 23
        t0 = time.perf_counter()
        launches_tts, tts_err = _phase_tts_kids(Path(tmp), device, fbank_cuda, smi)
        by_path.update(launches_tts)
        print(f"phase 31 took {time.perf_counter() - t0!r} s")
    kept.cleanup()

    # -- 15. the multi-channel meeting path, on a corpus of its own, and 17. the
    # signal-effects and multi-source, multi-talker training path on the same corpus
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        launches_meetings, meetings_err, ami = _phase_meetings(Path(tmp), device, fbank_cuda, smi)
        by_path.update(launches_meetings)
        print(f"phase 15 took {time.perf_counter() - t0!r} s")
        t0 = time.perf_counter()
        launches_ms, ms_err = _phase_multi_source(Path(tmp), ami, device, fbank_cuda, smi)
        by_path.update(launches_ms)
        print(f"phase 17 took {time.perf_counter() - t0!r} s")
    print(f"fbank kernel launches by path: {by_path}")
    reads_stored = ("precomputed_train", "precomputed_mix", "shar_precomputed", "long_form_trimmed",
                    "ami_diarization", "separation_premixed", "separation_dynamic",
                    "kaldi_precomputed", "librimix_separation", "dihard3_diarization",
                    "voxconverse_diarization")
    if not all(n > 0 for path, n in by_path.items() if path not in reads_stored):
        raise AssertionError(f"a path did not launch the fbank kernel: {by_path}")

    record = {"kernels": [{
        "name": "fbank_logmel",
        "route": "cuda",
        "source": "lhotse_tpu_torch/csrc/fbank.cu",
        "replaces": "lhotse_tpu/ops/fbank_pallas.py:64",
        "launches": launches,
        "max_abs_err": max([c["max_abs_err"] for c in cases]
                           + [pre_err, aug_err, shar_err, recipe_err, meetings_err, dp_err,
                              ms_err, paired_err, lossy_err, kaldi_err, sim_err, sharded_err,
                              noise_err, single_err, muxed_err, zh_err, tel_err, overlap_err,
                              translation_err, asr_err, tts_err]),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the Kaldi log-mel
        "device_ms": main_case["device_ms"],
        "plain_device_ms": main_case["plain_device_ms"],
        "cases": cases,
        "near_silent_err": {"kernel": kernel_err, "plain": plain_err},
        "launches_by_path": by_path,
    }]}
    print(f"chip_smoke.py wall time {time.perf_counter() - start!r} s")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
