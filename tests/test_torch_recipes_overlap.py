"""
The port's overlapped-speech, diarization and earnings-call recipes
(lhotse_tpu_torch.recipes ``librimix``, ``librimix_mini``,
``librispeechmix``, ``spatial_librispeech``, ``dihard3``, ``voxconverse``,
``earnings21`` and ``earnings22``) against the JAX package's, on the fixture
layouts of tests/test_recipes_tranche18.py:171-305,
tests/test_recipes_tranche11.py:14, tests/test_recipes_tranche3.py:458,483,
tests/test_recipes_tranche4.py:127,263, tests/test_recipes_tranche14.py:13,
tests/test_recipes_tranche2.py:216,266,403, tests/test_recipes.py:557 and
tests/test_refdiff_recipes.py:757,912,1315,1620 (made from the same numpy
seeds), and on wider layouts of the same formats: Libri2Mix and Libri3Mix
with WHAM! noises shorter and longer than their mixtures (speed-perturbed
ones among them) at 1 and 4 jobs, two- and three-speaker LibriSpeechMix,
8 kHz MiniLibriMix, 4-channel Spatial LibriSpeech FLAC, DIHARD III dev and
eval with overlapping turns, VoxConverse re-split, and MP3 earnings calls.
Also their helpers against JAX's, their refusals of broken layouts, the
downloads they leave out, their ``prepare`` commands through both CLIs,
and the slice at a small size: LibriMix's noisy mixtures through each
package's ``OnDeviceAugmenter`` (within ``AUG_TOL`` of the JAX augmenter
with its fbank layer's kernel route in float64), and LibriSpeechMix through
``K2SurtDataset`` with ``OnTheFlyFeatures`` (within ``EXTRACTOR_TOL`` of the
JAX extractor's host chain in float64).

LibriMix and LibriSpeechMix gather their rows with ``as_completed`` in the
JAX package, whose order is not fixed; the port keeps the input's order. So
their returns and written manifests are compared as mappings keyed by cut
id. Mixtures and padding name cuts with ``uuid4``: each package is seeded
with its own ``fix_random_seed`` before it prepares.
"""
import gzip
import json

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.audio.flacio import write_flac
from lhotse_tpu.audio.wavio import write_wav
from lhotse_tpu.dataset.device_augment import OnDeviceAugmenter as JAugmenter
from lhotse_tpu.dataset.input_strategies import OnTheFlyFeatures as JOnTheFly
from lhotse_tpu.dataset.signal_transforms import SpecAugment as JSpecAugment
from lhotse_tpu.dataset.surt import K2SurtDataset as JSurt
from lhotse_tpu.features.kaldi.extractors import Fbank as JFbank
from lhotse_tpu.features.kaldi.extractors import FbankConfig as JFbankConfig
from lhotse_tpu.recipes import dihard3 as jdihard3
from lhotse_tpu.recipes import earnings21 as jearn21
from lhotse_tpu.recipes import earnings22 as jearn22
from lhotse_tpu.recipes import librimix as jlibrimix
from lhotse_tpu.recipes import librimix_mini as jmini
from lhotse_tpu.recipes import librispeechmix as jlsmix
from lhotse_tpu.recipes import musan as jmusan
from lhotse_tpu.recipes import rir_noise as jrir
from lhotse_tpu.recipes import spatial_librispeech as jspatial
from lhotse_tpu.recipes import voxconverse as jvox
from lhotse_tpu.utils import fix_random_seed as jfix
from lhotse_tpu_torch import utils as putils
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.device_augment import OnDeviceAugmenter
from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
from lhotse_tpu_torch.dataset.signal_transforms import SpecAugment
from lhotse_tpu_torch.dataset.surt import K2SurtDataset
from lhotse_tpu_torch.features import Fbank, FbankConfig
from lhotse_tpu_torch.recipes import dihard3 as pdihard3
from lhotse_tpu_torch.recipes import earnings21 as pearn21
from lhotse_tpu_torch.recipes import earnings22 as pearn22
from lhotse_tpu_torch.recipes import librimix as plibrimix
from lhotse_tpu_torch.recipes import librimix_mini as pmini
from lhotse_tpu_torch.recipes import librispeechmix as plsmix
from lhotse_tpu_torch.recipes import musan as pmusan
from lhotse_tpu_torch.recipes import rir_noise as prir
from lhotse_tpu_torch.recipes import spatial_librispeech as pspatial
from lhotse_tpu_torch.recipes import voxconverse as pvox
from lhotse_tpu_torch.utils import fix_random_seed
from test_torch_recipes_asr import _dicts
from test_torch_recipes_noise import (
    AUG_TOL, EXTRACTOR_TOL, musan_tree, noise_pool, rir_noise_tree, seeded_rir)
from test_torch_recipes_zh import _JaxKernelRoute64, _bucketed

SR = 16000
WORDS = ("good", "morning", "everyone", "revenue", "grew", "percent", "year", "over", "quarter",
         "thank", "you", "operator")

P = {"librimix": plibrimix.prepare_librimix, "librimix_mini": pmini.prepare_librimix_mini,
     "librispeechmix": plsmix.prepare_librispeechmix,
     "spatial_librispeech": pspatial.prepare_spatial_librispeech,
     "dihard3": pdihard3.prepare_dihard3, "voxconverse": pvox.prepare_voxconverse,
     "earnings21": pearn21.prepare_earnings21, "earnings22": pearn22.prepare_earnings22}
JP = {"librimix": jlibrimix.prepare_librimix, "librimix_mini": jmini.prepare_librimix_mini,
      "librispeechmix": jlsmix.prepare_librispeechmix,
      "spatial_librispeech": jspatial.prepare_spatial_librispeech,
      "dihard3": jdihard3.prepare_dihard3, "voxconverse": jvox.prepare_voxconverse,
      "earnings21": jearn21.prepare_earnings21, "earnings22": jearn22.prepare_earnings22}


def _sig(seconds, seed, channels=None, sr=SR):
    """tests/test_recipes*.py's signals: 0.1 white noise from RandomState(seed),
    (n,) or (channels, n)."""
    rng = np.random.RandomState(seed)
    shape = (int(seconds * sr),) if channels is None else (channels, int(seconds * sr))
    return (0.1 * rng.randn(*shape)).astype(np.float32)


def _wav(path, seconds=1.0, seed=0, channels=1, sr=SR):
    path.parent.mkdir(parents=True, exist_ok=True)
    write_wav(path, _sig(seconds, seed, channels, sr), sr)
    return path


def _flac(path, seconds=1.0, seed=0, channels=1, sr=SR):
    path.parent.mkdir(parents=True, exist_ok=True)
    write_flac(path, _sig(seconds, seed, channels, sr), sr)
    return path


def _words(rng, lo=2, hi=7):
    return " ".join(WORDS[i] for i in rng.randint(0, len(WORDS), rng.randint(lo, hi)))


# -- the JAX tests' layouts, and wider ones ---------------------------------------------


def _librispeech_cutset(path, recordings, texts=None):
    """The JAX package's ``CutSet.from_manifests`` over ``recordings`` (ids
    ``<utterance>-<k>``, which LibriMix strips), with one supervision per
    recording where ``texts`` is given, written to ``path``."""
    sups = None
    if texts is not None:
        sups = J.SupervisionSet.from_segments(
            J.SupervisionSegment(id=r.id, recording_id=r.id, start=0.0, duration=r.duration,
                                 channel=0, text=t, speaker=r.id.split("-")[0])
            for r, t in zip(recordings, texts))
    path.parent.mkdir(parents=True, exist_ok=True)
    J.CutSet.from_manifests(recordings=J.RecordingSet.from_recordings(recordings),
                            supervisions=sups).to_file(path)


def librimix_tree(root, layout="tranche18", n_src=2):
    """``tranche18``/``tranche18-short``: tests/test_recipes_tranche18.py:171
    (two sources of 1.0 and 0.8 s, one WHAM! noise of 2.0 or 0.4 s, one row
    of ``libri2mix_train-100.csv`` and an ``_info`` file the scan skips);
    ``wide``: 8 utterances of 1-3 s, four WHAM! noises of 0.3-4 s, ``Libri2Mix``
    and ``Libri3Mix`` each with ``train-100`` (6 rows) and ``train-360`` (3
    rows) CSVs over plain and speed-perturbed noises, an ``_info`` file and a
    ``.completed`` marker. Returns the arguments of ``prepare_librimix`` but
    ``workdir`` and ``output_dir``."""
    wav_dir = root / "wav"
    if layout.startswith("tranche18"):
        recs = [J.Recording.from_file(_wav(wav_dir / f"{name}.wav", dur, seed), recording_id=name)
                for name, dur, seed in [("1089-134686-0000", 1.0, 1), ("1188-133604-0002", 0.8, 2)]]
        _librispeech_cutset(root / "librispeech" / "librispeech_cutset_train-100.jsonl.gz", recs)
        noise = J.Recording.from_file(_wav(wav_dir / "40na010x_1.2422_01xo031b_-1.2422.wav",
                                           0.4 if layout.endswith("short") else 2.0, 9))
        noises = [noise]
        csvs = {"Libri2Mix/libri2mix_train-100.csv": [
            ("1089-134686-0000_1188-133604-0002", [
                ("train-clean-100/1089/134686/1089-134686-0000.wav", 1.2),
                ("train-clean-100/1188/133604/1188-133604-0002.wav", 0.8)],
             f"tr/{noise.id}.wav", 0.5)]}
    else:
        rng = np.random.RandomState(1818)
        names = [f"{200 + k}-{3000 + k}-{k:04d}" for k in range(8)]
        recs = [J.Recording.from_file(_wav(wav_dir / f"{n}.wav", rng.uniform(1.0, 3.0),
                                           100 + k), recording_id=n)
                for k, n in enumerate(names)]
        for part in ("train-100", "train-360"):
            _librispeech_cutset(root / "librispeech" / f"librispeech_cutset_{part}.jsonl.gz", recs)
        noises = [J.Recording.from_file(_wav(wav_dir / f"noise_{k:02d}.wav", seconds, 200 + k))
                  for k, seconds in enumerate((0.3, 1.2, 2.5, 4.0))]
        csvs = {}
        for n in (2, 3):
            for part, rows in (("train-100", 6), ("train-360", 3)):
                lines = []
                for i in range(rows):
                    picks = rng.choice(len(names), n, replace=False)
                    noise = noises[rng.randint(len(noises))].id + ("", "sp08", "sp12")[i % 3]
                    lines.append(("_".join(names[p] for p in picks), [
                        (f"train-clean-100/x/y/{names[p]}.wav", round(float(rng.uniform(0.5, 1.5)), 4))
                        for p in picks], f"tr/{noise}.wav", round(float(rng.uniform(0.2, 1.0)), 4)))
                csvs[f"Libri{n}Mix/libri{n}mix_{part}.csv"] = lines
    wham = root / "wham"
    wham.mkdir(parents=True)
    for name in ("tr", "cv", "tt"):
        J.RecordingSet.from_recordings(noises).to_file(wham / f"wham_recordings_{name}.jsonl.gz")
    meta = root / "metadata"
    for rel, rows in csvs.items():
        n = len(rows[0][1])
        header = ["mixture_ID"] + [f"source_{k}_{f}" for k in range(1, n + 1)
                                   for f in ("path", "gain")] + ["noise_path", "noise_gain"]
        lines = [",".join(header)] + [
            ",".join([mid] + [str(v) for src in sources for v in src] + [noise, str(gain)])
            for mid, sources, noise, gain in rows]
        (meta / rel).parent.mkdir(parents=True, exist_ok=True)
        (meta / rel).write_text("\n".join(lines) + "\n")
        (meta / rel).with_name(rel.split("/")[1].replace(".csv", "_info.csv")).write_text(
            "ignored\n")
    if layout == "wide":
        (meta / "Libri2Mix" / ".completed").touch()
    return (root / "librispeech", wham, meta), {"n_src": n_src}


def librispeechmix_tree(root, layout="tranche3"):
    """``tranche3``: tests/test_recipes_tranche3.py:483 (two sources, one
    ``dev-clean-2mix.jsonl`` entry with delays 0 and 0.5 s); ``wide``: 10
    utterances of 1-3 s with texts, ``test-clean-2mix.jsonl`` (12 entries)
    and ``test-clean-3mix.jsonl`` (6, some with fewer delays than sources)
    in the published format (``id``, ``wavs``, ``delays``, ``speakers``,
    ``texts``, ``durations``)."""
    ls_root, meta = root / "ls", root / "meta"
    meta.mkdir(parents=True)
    if layout == "tranche3":
        _wav(root / "a1.wav", 2.0, 44)
        _wav(root / "a2.wav", 1.0, 45)
        cuts = J.CutSet.from_cuts([
            J.MonoCut(id=f"{stem}-0", start=0, duration=dur, channel=0,
                      recording=J.Recording.from_file(root / f"{stem}.wav"))
            for stem, dur in (("a1", 2.0), ("a2", 1.0))])
        ls_root.mkdir()
        cuts.to_file(ls_root / "librispeech_cutset_dev-clean.jsonl.gz")
        (meta / "dev-clean-2mix.jsonl").write_text(
            json.dumps({"id": "x/mix1", "wavs": ["w/a1.wav", "w/a2.wav"], "delays": [0.0, 0.5]})
            + "\n")
        return (ls_root, meta), {}
    rng = np.random.RandomState(483)
    names = [f"{1000 + k}-{4000 + k}-{k:04d}" for k in range(10)]
    recs = [J.Recording.from_file(_wav(root / "wav" / f"{n}.wav", rng.uniform(1.0, 3.0), 300 + k),
                                  recording_id=n) for k, n in enumerate(names)]
    texts = [_words(rng).upper() for _ in names]
    _librispeech_cutset(ls_root / "librispeech_cutset_test-clean.jsonl.gz", recs, texts)
    for n, count in ((2, 12), (3, 6)):
        lines = []
        for i in range(count):
            picks = [int(p) for p in rng.choice(len(names), n, replace=False)]
            delays = [0.0] + [round(float(rng.uniform(0.0, 1.5)), 3) for _ in picks[1:]]
            if n == 3 and i % 2:
                delays = delays[:2]  # the third source starts at 0
            lines.append(json.dumps({
                "id": f"test-clean/{n}mix/{i:04d}",
                "wavs": [f"test-clean/{names[p].split('-')[0]}/{names[p]}.flac" for p in picks],
                "delays": delays, "speakers": [names[p].split("-")[0] for p in picks],
                "texts": [texts[p] for p in picks],
                "durations": [recs[p].duration for p in picks]}))
        (meta / f"test-clean-{n}mix.jsonl").write_text("\n".join(lines) + "\n\n")
    return (ls_root, meta), {}


def librimix_mini_tree(root, layout="tranche11"):
    """``tranche11``: tests/test_recipes_tranche11.py:14 (rows of 4, 5 and
    1 s, the last below ``min_segment_seconds``); ``tranche3``:
    tests/test_recipes_tranche3.py:458 (one mixture and a 0.5 s row);
    ``wide``: the MiniLibriMix layout, ``metadata/mixture_train_mix_both.csv``
    over ``wav8k/min/train/{mix_both,s1,s2,noise}``, 12 rows of 1-6 s at
    8 kHz; ``no-noise``: the same without a noise column. Returns the CSV's
    path and no keywords."""
    if layout == "tranche11":
        wavs = root / "wavs"
        rng = np.random.RandomState(0)
        rows = ["mixture_ID,mixture_path,source_1_path,source_2_path,noise_path,length"]
        for i, seconds in enumerate((4.0, 5.0, 1.0)):
            n = int(seconds * SR)
            paths = {}
            for role in ("mix", "s1", "s2", "noise"):
                paths[role] = wavs / f"{role}_{i}.wav"
                paths[role].parent.mkdir(parents=True, exist_ok=True)
                write_wav(str(paths[role]), (0.1 * rng.randn(n)).astype(np.float32), SR)
            rows.append(f"mix{i},{paths['mix']},{paths['s1']},{paths['s2']},{paths['noise']},{n}")
        csv_path = root / "mixture_train_mix_both.csv"
    elif layout == "tranche3":
        for sub, name, seed in (("s1", "m1_s1", 40), ("s2", "m1_s2", 41), ("mix", "m1", 42),
                                ("noise", "m1_n", 43)):
            _wav(root / sub / f"{name}.wav", 4.0, seed)
        rows = ["mixture_ID,mixture_path,source_1_path,source_2_path,noise_path,length"]
        for mid, length in (("m1", 4 * 16000), ("short", 8000)):
            rows.append(f"{mid},{root}/mix/m1.wav,{root}/s1/m1_s1.wav,{root}/s2/m1_s2.wav,"
                        f"{root}/noise/m1_n.wav,{length}")
        csv_path = root / "mixture_train_mix_both.csv"
    else:
        rng = np.random.RandomState(1111)
        base = root / "MiniLibriMix" / "wav8k" / "min" / "train"
        noise = layout == "wide"
        rows = ["mixture_ID,mixture_path,source_1_path,source_2_path"
                + (",noise_path" if noise else "") + ",length"]
        for i in range(12):
            n = int(rng.uniform(1.0, 6.0) * 8000)
            mid = f"{100 + i}-{5000 + i}-{i:04d}_{200 + i}-{6000 + i}-{i:04d}"
            paths = {}
            for role in ("mix_both", "s1", "s2") + (("noise",) if noise else ()):
                paths[role] = base / role / f"{mid}.wav"
                paths[role].parent.mkdir(parents=True, exist_ok=True)
                write_wav(paths[role], (0.1 * rng.randn(n)).astype(np.float32), 8000)
            rows.append(",".join([mid, str(paths["mix_both"]), str(paths["s1"]), str(paths["s2"])]
                                 + ([str(paths["noise"])] if noise else []) + [str(n)]))
        csv_path = root / "MiniLibriMix" / "metadata" / "mixture_train_mix_both.csv"
    csv_path.parent.mkdir(parents=True, exist_ok=True)
    csv_path.write_text("\n".join(rows) + "\n")
    return (csv_path,), {}


def spatial_librispeech_tree(root, layout="tranche4"):
    """``tranche4``: tests/test_recipes_tranche4.py:263 (one train and one
    test FLAC with their parquet rows); ``wide``: 4-channel (first-order
    ambisonics) FLAC, 6 train and 3 test samples and a parquet row each."""
    pd = pytest.importorskip("pandas")
    if layout == "tranche4":
        _flac(root / "audio_files" / "train" / "000000.flac", seed=15)
        _flac(root / "audio_files" / "test" / "000001.flac", seed=16)
        frame = {"split": ["train", "test"], "sample_id": [0, 1],
                 "speech/librispeech_metadata/transcription": ["HELLO WORLD", "BYE"],
                 "speech/librispeech_metadata/reader_sex": ["F", "M"],
                 "speech/librispeech_metadata/reader_id": ["19", "26"]}
    else:
        rng = np.random.RandomState(263)
        frame = {k: [] for k in ("split", "sample_id", "speech/librispeech_metadata/transcription",
                                 "speech/librispeech_metadata/reader_sex",
                                 "speech/librispeech_metadata/reader_id")}
        for i in range(9):
            split = "train" if i < 6 else "test"
            sample = 120 + 7 * i
            _flac(root / "audio_files" / split / f"{sample:06}.flac", rng.uniform(1.0, 3.0),
                  400 + i, channels=4)
            for key, value in zip(frame, (split, sample, _words(rng).upper(), "FM"[i % 2],
                                          str(19 + i))):
                frame[key].append(value)
    pd.DataFrame(frame).to_parquet(root / "metadata.parquet")
    return (root,), {}


def dihard3_tree(root, layout="tranche14"):
    """``tranche14``: tests/test_recipes_tranche14.py:13 (two FLACs with
    RTTMs and UEMs beside them, a space-separated ``recordings.tbl``);
    ``tranche2``: tests/test_recipes_tranche2.py:216 (``data/`` and
    ``docs/`` with a tab-separated table); ``refdiff``:
    tests/test_refdiff_recipes.py:757 (dev and eval, a 9-column table);
    ``wide``: the LDC dev/eval layout (``data/flac``, ``data/rttm``,
    ``data/uem``, ``docs/recordings.tbl``), three 8 s recordings each with
    2-4 speakers and overlapping turns. Returns no positional arguments."""
    if layout == "tranche14":
        dev = root / "dihard_dev"
        (dev / "flac").mkdir(parents=True)
        rng = np.random.RandomState(0)
        for rid in ("DH_DEV_0001", "DH_DEV_0002"):
            write_flac(str(dev / "flac" / f"{rid}.flac"),
                       (0.1 * rng.randn(3 * SR)).astype(np.float32), SR)
            (dev / "flac" / f"{rid}.rttm").write_text(
                f"SPEAKER {rid} 1 0.50 1.00 <NA> <NA> spkA <NA> <NA>\n"
                f"SPEAKER {rid} 1 1.80 0.70 <NA> <NA> spkB <NA> <NA>\n")
            (dev / "flac" / f"{rid}.uem").write_text(f"{rid} 1 0.25 2.75\n")
        (dev / "recordings.tbl").write_text(
            "recording_id in_core lang domain source\n"
            "DH_DEV_0001 True eng clinical ldc\n"
            "DH_DEV_0002 False eng broadcast ldc\n")
        return (), {"dev_audio_dir": dev}
    if layout == "tranche2":
        dev = root / "dev"
        write_flac(_dir(dev / "data") / "DH_DEV_0001.flac", _sig(2.0, 40, 1), SR)
        (dev / "docs").mkdir(parents=True)
        (dev / "docs" / "recordings.tbl").write_text(
            "id\tin_core\tlang\tdomain\tsource\n"
            "DH_DEV_0001\tTrue\teng\tbroadcast_interview\tyoutube\n")
        (dev / "data" / "DH_DEV_0001.rttm").write_text(
            "SPEAKER DH_DEV_0001 1 0.10 0.80 <NA> <NA> spkA <NA> <NA>\n")
        (dev / "data" / "DH_DEV_0001.uem").write_text("DH_DEV_0001 1 0.00 2.00\n")
        return (), {"dev_audio_dir": dev}
    if layout == "refdiff":
        rng = np.random.RandomState(0)
        dirs = {}
        for split, rids in (("dev", ("DH_DEV_0001", "DH_DEV_0002")), ("eval", ("DH_EVAL_0001",))):
            d = root / f"dihard_{split}"
            (d / "flac").mkdir(parents=True)
            rows = ["recording_id in_core lang domain source dur x y z"]
            for rid in rids:
                write_flac(str(d / "flac" / f"{rid}.flac"),
                           (0.1 * rng.randn(1, 3 * SR)).astype(np.float32), SR)
                (d / "flac" / f"{rid}.rttm").write_text(
                    f"SPEAKER {rid} 1 0.50 1.00 <NA> <NA> spkA <NA> <NA>\n"
                    f"SPEAKER {rid} 1 1.80 0.70 <NA> <NA> spkB <NA> <NA>\n")
                (d / "flac" / f"{rid}.uem").write_text(f"{rid} 1 0.25 2.75\n")
                rows.append(f"{rid} True eng clinical ldc 3.0 a b c")
            (d / "recordings.tbl").write_text("\n".join(rows) + "\n")
            dirs[f"{split}_audio_dir"] = d
        return (), dirs
    rng = np.random.RandomState(1414)
    dirs = {}
    domains = ("clinical", "broadcast_interview", "meeting", "restaurant", "webvideo", "court")
    for split, tag in (("dev", "DEV"), ("eval", "EVAL")):
        d = root / f"LDC_{split}"
        rows = ["file_id\tin_core\tlanguage\tdomain\tsource"]
        for k in range(3):
            rid = f"DH_{tag}_{k + 1:04d}"
            _flac(d / "data" / "flac" / f"{rid}.flac", 8.0, 500 + 10 * (split == "eval") + k)
            turns, t = [], 0.3
            speakers = [f"speaker{s}" for s in range(rng.randint(2, 5))]
            while t < 7.0:
                span = round(float(rng.uniform(0.5, 2.0)), 2)
                turns.append(f"SPEAKER {rid} 1 {t:.2f} {min(span, 7.9 - t):.2f} <NA> <NA> "
                             f"{speakers[rng.randint(len(speakers))]} <NA> <NA>")
                t = round(t + span + float(rng.uniform(-0.4, 0.6)), 2)  # a negative gap overlaps
            _dir(d / "data" / "rttm")
            (d / "data" / "rttm" / f"{rid}.rttm").write_text("\n".join(turns) + "\n")
            _dir(d / "data" / "uem")
            (d / "data" / "uem" / f"{rid}.uem").write_text(f"{rid} 1 0.000 8.000\n")
            rows.append(f"{rid}\t{'True' if k else 'False'}\teng\t{domains[(k + 3 * (split == 'eval'))]}"
                        "\tLDC")
        _dir(d / "docs")
        (d / "docs" / "recordings.tbl").write_text("\n".join(rows) + "\n")
        dirs[f"{split}_audio_dir"] = d
    return (), dirs


def _dir(path):
    path.mkdir(parents=True, exist_ok=True)
    return path


def voxconverse_tree(root, layout="tranche2"):
    """``tranche2``: tests/test_recipes_tranche2.py:266 and
    tests/test_refdiff_recipes.py:1315 (one dev and one test WAV with an
    RTTM each); ``wide``: 3 dev and 5 test WAVs of 6 s, the RTTMs of the
    annotation repository's ``dev/`` and ``test/`` beside them, 2-5
    speakers and overlapping turns."""
    if layout == "tranche2":
        for split, name, seed in (("dev", "abc", 50), ("test", "xyz", 51)):
            _wav(root / split / f"{name}.wav", 2.0, seed)
            (root / split / f"{name}.rttm").write_text(
                f"SPEAKER {name} 1 0.20 1.00 <NA> <NA> spk00 <NA> <NA>\n")
        return (root,), {}
    rng = np.random.RandomState(1315)
    for split, count in (("dev", 3), ("test", 5)):
        for k in range(count):
            name = "".join(chr(97 + int(c)) for c in rng.randint(0, 26, 5))
            _wav(root / split / f"{name}.wav", 6.0, 600 + 10 * (split == "test") + k)
            turns, t = [], 0.1
            while t < 5.5:
                span = round(float(rng.uniform(0.4, 1.8)), 3)
                turns.append(f"SPEAKER {name} 1 {t:.3f} {min(span, 5.9 - t):.3f} <NA> <NA> "
                             f"spk{rng.randint(0, rng.randint(2, 6)):02d} <NA> <NA>")
                t = round(t + span + float(rng.uniform(-0.3, 0.5)), 3)
            (root / split / f"{name}.rttm").write_text("\n".join(turns) + "\n")
    return (root,), {}


NLP_HEADER = "token|speaker|ts|endTs|punct|case|tags|wer_tags"


def _nlp_rows(rng, n):
    rows = []
    for i in range(n):
        word = WORDS[rng.randint(len(WORDS))]
        punct = (",", ".", "?", "")[rng.randint(4)]
        rows.append(f"{word.capitalize() if i % 5 == 0 else word}|{rng.randint(1, 4)}|||{punct}"
                    f"|LC|[]|[]")
    return rows


def _mp3_available():
    from lhotse_tpu_torch.audio import syscodecs

    return syscodecs.mp3_available() and syscodecs.mp3_encode_available()


def earnings21_tree(root, layout="tranche2"):
    """``tranche2``: tests/test_recipes_tranche2.py:403 and
    tests/test_refdiff_recipes.py:1620 (WAV bytes behind an ``.mp3`` name,
    which both packages read by their magic); ``wide``: three calls of
    2-4 s (WAV bytes behind ``.mp3`` names) with ``.nlp`` references that
    carry punctuation columns; ``mp3``: the same calls as real MP3
    (libmp3lame)."""
    nlp = root / "transcripts" / "nlp_references"
    nlp.mkdir(parents=True)
    if layout == "tranche2":
        _wav(root / "media" / "4320211.mp3", 2.0, 83)
        (nlp / "4320211.nlp").write_text("token|speaker|ts|endTs\ngood|1|0.0|0.3\nmorning|1|0.3|0.8\n")
        return (root,), {}
    rng = np.random.RandomState(1620)
    for k, call in enumerate(("4320211", "4341191", "4359971")):
        x = _sig(rng.uniform(2.0, 4.0), 700 + k)
        path = root / "media" / f"{call}.mp3"
        path.parent.mkdir(parents=True, exist_ok=True)
        if layout == "mp3":
            from lhotse_tpu_torch.audio import syscodecs

            path.write_bytes(syscodecs.mp3_encode(x[None, :], SR))
        else:
            write_wav(path, x[None, :], SR)
        (nlp / f"{call}.nlp").write_text("\n".join([NLP_HEADER] + _nlp_rows(rng, 12)) + "\n")
    return (root,), {}


def earnings22_tree(root, layout="tranche4"):
    """``tranche4``: tests/test_recipes_tranche4.py:127 and
    tests/test_refdiff_recipes.py:912 (one call, WAV bytes behind ``.mp3``,
    ``metadata.csv`` with the language region in its sixth column);
    ``wide``: four calls of 2-4 s from three regions, ``.nlp`` rows with
    punctuation; ``mp3``: the same as real MP3."""
    nlp = root / "transcripts" / "nlp_references"
    nlp.mkdir(parents=True)
    if layout == "tranche4":
        _wav(root / "media" / "4320211.mp3", 2.0, 10)
        (root / "metadata.csv").write_text("source_id,a,b,c,d,lang,end\n4320211,x,y,z,w,en-US,0\n")
        (nlp / "4320211.nlp").write_text(
            "token|speaker|ts|endTs|punct|prepunct|case|tags|wer_tags\n"
            "hello|1|||||||\n"
            "world|1|||||||\n")
        return (root,), {}
    rng = np.random.RandomState(912)
    meta = ["File ID,Ticker Symbol,Country by Ticker,Un Region,Language Region,Sector,Time"]
    for k, (call, region) in enumerate((("4420696", "African"), ("4448760", "Asian"),
                                        ("4461799", "Asian"), ("4468679", "Latin American"))):
        x = _sig(rng.uniform(2.0, 4.0), 800 + k)
        path = root / "media" / f"{call}.mp3"
        path.parent.mkdir(parents=True, exist_ok=True)
        if layout == "mp3":
            from lhotse_tpu_torch.audio import syscodecs

            path.write_bytes(syscodecs.mp3_encode(x[None, :], SR))
        else:
            write_wav(path, x[None, :], SR)
        (nlp / f"{call}.nlp").write_text("\n".join([NLP_HEADER] + _nlp_rows(rng, 10)) + "\n")
        meta.append(f"{call},TCK{k},Country{k},Region{k},{region},Sector{k},0:0{k}:00")
    (root / "metadata.csv").write_text("\n".join(meta) + "\n")
    return (root,), {}


TREES = {"librimix": librimix_tree, "librispeechmix": librispeechmix_tree,
         "librimix_mini": librimix_mini_tree, "spatial_librispeech": spatial_librispeech_tree,
         "dihard3": dihard3_tree, "voxconverse": voxconverse_tree,
         "earnings21": earnings21_tree, "earnings22": earnings22_tree}

# recipe-layout-variant: (recipe, layout, extra keywords)
CASES = {
    "librispeechmix-tranche3": ("librispeechmix", "tranche3", {}),
    "librispeechmix-wide": ("librispeechmix", "wide", {}),
    "librimix_mini-tranche11": ("librimix_mini", "tranche11",
                                {"with_precomputed_mixtures": True, "min_segment_seconds": 3.0}),
    "librimix_mini-tranche3": ("librimix_mini", "tranche3", {"with_precomputed_mixtures": True}),
    "librimix_mini-wide": ("librimix_mini", "wide", {"with_precomputed_mixtures": True,
                                                     "sampling_rate": 8000}),
    "librimix_mini-no-noise": ("librimix_mini", "no-noise", {"sampling_rate": 8000,
                                                             "min_segment_seconds": 2.0}),
    "spatial_librispeech-tranche4": ("spatial_librispeech", "tranche4",
                                     {"dataset_parts": ("train", "test")}),
    "spatial_librispeech-wide": ("spatial_librispeech", "wide", {"normalize_text": "lower"}),
    "spatial_librispeech-wide-train": ("spatial_librispeech", "wide", {"dataset_parts": "train"}),
    "dihard3-tranche14": ("dihard3", "tranche14", {}),
    "dihard3-tranche2": ("dihard3", "tranche2", {}),
    "dihard3-refdiff": ("dihard3", "refdiff", {}),
    "dihard3-wide": ("dihard3", "wide", {}),
    "dihard3-wide-no-uem": ("dihard3", "wide", {"uem_manifest": False, "num_jobs": 2}),
    "voxconverse-tranche2": ("voxconverse", "tranche2", {}),
    "voxconverse-wide": ("voxconverse", "wide", {}),
    "voxconverse-wide-split": ("voxconverse", "wide", {"split_test": True}),
    "earnings21-tranche2": ("earnings21", "tranche2", {}),
    "earnings21-wide": ("earnings21", "wide", {}),
    "earnings21-wide-normalized": ("earnings21", "wide", {"normalize_text": True}),
    "earnings22-tranche4": ("earnings22", "tranche4", {}),
    "earnings22-wide": ("earnings22", "wide", {}),
    "earnings22-wide-normalized": ("earnings22", "wide", {"normalize_text": True}),
}


def _files(directory, replace=(), keyed=False) -> dict:
    """Every file under ``directory`` by its relative path, ``.gz`` files
    decompressed (a gzip header carries its write time), with the
    directory's own path and each of ``replace`` swapped for a placeholder;
    with ``keyed``, a JSONL manifest as a mapping of its items by id."""
    out = {}
    for p in sorted(directory.rglob("*")):
        if p.is_file():
            data = gzip.decompress(p.read_bytes()) if p.suffix == ".gz" else p.read_bytes()
            for k, path in enumerate((directory,) + tuple(replace)):
                data = data.replace(str(path).encode(), f"<dir{k}>".encode())
            if keyed and ".jsonl" in p.name:
                items = [json.loads(line) for line in data.decode().splitlines()]
                data = {item["id"]: item for item in items}
                assert len(data) == len(items)
            out[str(p.relative_to(directory))] = data
    return out


def _prepare(pkg, recipe, args, kwargs, out):
    """One package's ``prepare_*`` after its own ``fix_random_seed(0)``."""
    (fix_random_seed if pkg == "port" else jfix)(0)
    return (P if pkg == "port" else JP)[recipe](*args, output_dir=out, **kwargs)


@pytest.mark.parametrize("case", sorted(CASES))
def test_prepare_equals_jax(tmp_path, case):
    """The returned manifests and every file that each package's
    ``prepare_*`` writes on the same layout are equal."""
    recipe, layout, extra = CASES[case]
    args, kwargs = TREES[recipe](tmp_path / "corpus", layout)
    kwargs = {**kwargs, **extra}
    ours = _prepare("port", recipe, args, kwargs, tmp_path / "ours")
    theirs = _prepare("jax", recipe, args, kwargs, tmp_path / "jax")
    if recipe == "librispeechmix":  # gathered as completed in JAX
        assert _dicts_keyed(_keyed(ours)) == _dicts_keyed(_keyed(theirs))
    else:
        assert _dicts(ours) == _dicts(theirs)
    keyed = recipe == "librispeechmix"
    written = _files(tmp_path / "ours", keyed=keyed)
    assert written and written == _files(tmp_path / "jax", keyed=keyed)
    if recipe == "spatial_librispeech":  # its output_dir also defaults to the corpus
        return
    if isinstance(ours, tuple):
        assert len(ours[1]) > 0
    else:
        assert all(len(v) > 0 for part in ours.values() for v in part.values())


def _keyed(manifests):
    """A recipe's nested returns with each cut set as a mapping by cut id."""
    if isinstance(manifests, dict):
        return {k: _keyed(v) for k, v in manifests.items()}
    return {c.id: c for c in manifests}


def _dicts_keyed(manifests, replace=()):
    """``_keyed`` as plain dicts, each path of ``replace`` swapped out."""
    if isinstance(manifests, dict) and not hasattr(next(iter(manifests.values()), None), "to_dict"):
        return {k: _dicts_keyed(v, replace) for k, v in manifests.items()}
    text = json.dumps({k: c.to_dict() for k, c in manifests.items()})
    for k, path in enumerate(replace):
        text = text.replace(str(path), f"<dir{k}>")
    return json.loads(text)


# -- LibriMix ---------------------------------------------------------------------------


def _librimix_both(tmp_path, layout, n_src, num_jobs, tag=""):
    args, kwargs = librimix_tree(tmp_path / "corpus", layout, n_src)
    kwargs = {**kwargs, "num_jobs": num_jobs}
    works = tmp_path / f"work_ours{tag}", tmp_path / f"work_jax{tag}"
    ours = _prepare("port", "librimix", args + (works[0],), kwargs, tmp_path / f"ours{tag}")
    theirs = _prepare("jax", "librimix", args + (works[1],), kwargs, tmp_path / f"jax{tag}")
    return args, works, _keyed(ours), _keyed(theirs)


@pytest.mark.parametrize("layout,n_src,num_jobs", [
    ("tranche18", 2, 1), ("tranche18-short", 2, 1), ("wide", 2, 1), ("wide", 3, 1),
    ("wide", 2, 4), ("wide", 3, 4)])
def test_librimix_equals_jax(tmp_path, layout, n_src, num_jobs):
    """``prepare_librimix`` on the same layout in each package, each with a
    work directory of its own: the returns and the written cut sets keyed by
    cut id are equal with the work directories swapped out; the extended
    noise WAVs are byte-equal; every mixture's audio is within 1e-6 of JAX's
    ``load_audio``. A second run reads the cached manifests, as JAX's does."""
    args, works, ours, theirs = _librimix_both(tmp_path, layout, n_src, num_jobs)
    parts = {f"libri{n_src}mix_train-100", f"libri{n_src}mix_train-100_noisy"} | (
        {f"libri{n_src}mix_train-360", f"libri{n_src}mix_train-360_noisy"}
        if layout == "wide" else set())
    assert set(ours) == parts
    assert _dicts_keyed(ours, works[:1]) == _dicts_keyed(theirs, works[1:])
    written = _files(tmp_path / "ours", works[:1], keyed=True)
    assert sorted(written) == sorted(f"librimix_cutset_{p}.jsonl.gz" for p in parts)
    assert written == _files(tmp_path / "jax", works[1:], keyed=True)
    extended = _files(works[0])
    assert extended == _files(works[1])
    assert bool(extended) == (layout != "tranche18")  # the short noises were extended
    for part in parts:
        for cid, cut in ours[part]["cutset"].items():
            audio, jaudio = cut.load_audio(), theirs[part]["cutset"][cid].load_audio()
            assert audio.shape == jaudio.shape == (1, round(cut.duration * SR))
            np.testing.assert_allclose(audio, jaudio, rtol=0, atol=1e-6)
    again = _prepare("port", "librimix", args + (works[0],), {"n_src": n_src},
                     tmp_path / "ours")
    jagain = _prepare("jax", "librimix", args + (works[1],), {"n_src": n_src}, tmp_path / "jax")
    assert _dicts_keyed(_keyed(again), works[:1]) == _dicts_keyed(_keyed(jagain), works[1:])
    assert _dicts_keyed(_keyed(again), works[:1]) == _dicts_keyed(ours, works[:1])


def test_librimix_mixtures_as_the_jax_test_expects(tmp_path):
    """tests/test_recipes_tranche18.py:231: the clean mixture is the
    gain-scaled sum of its sources ('max' mode), the noisy one keeps its id
    and differs, and a short noise renders an extended WAV into the work
    directory (the port's as JAX's)."""
    _, works, ours, _ = _librimix_both(tmp_path, "tranche18-short", 2, 1)
    clean = ours["libri2mix_train-100"]["cutset"]["1089-134686-0000_1188-133604-0002"]
    noisy = ours["libri2mix_train-100_noisy"]["cutset"]["1089-134686-0000_1188-133604-0002"]
    expected = _sig(1.0, 1) * 1.2
    expected[: int(0.8 * SR)] += _sig(0.8, 2) * 0.8
    np.testing.assert_allclose(clean.load_audio()[0], expected, atol=2e-4)
    assert noisy.load_audio().shape == (1, SR) and not np.allclose(noisy.load_audio(),
                                                                   clean.load_audio())
    assert [p.name for p in works[0].iterdir()] == [
        "40na010x_1.2422_01xo031b_-1.2422_vp0.5_1089-134686-0000_1188-133604-0002.wav"]


def test_librimix_dev_and_test_csvs_where_jax_raises(tmp_path):
    """The published metadata names its dev and test CSVs
    ``libri2mix_dev.csv`` and ``libri2mix_test.csv``. The JAX recipe takes the
    WHAM! split from the name with its suffix ("dev.csv") and raises
    ``KeyError``; the port reads the WHAM! cv and tt manifests for them
    (ROADMAP.md C2)."""
    args, _ = librimix_tree(tmp_path / "corpus", "tranche18")
    ls_root, wham, meta = args
    for part in ("dev", "test"):
        (meta / "Libri2Mix" / f"libri2mix_{part}.csv").write_text(
            (meta / "Libri2Mix" / "libri2mix_train-100.csv").read_text())
        (ls_root / f"librispeech_cutset_{part}.jsonl.gz").write_bytes(
            (ls_root / "librispeech_cutset_train-100.jsonl.gz").read_bytes())
    with pytest.raises(KeyError, match=r"(dev|test)\.csv"):
        _prepare("jax", "librimix", args + (tmp_path / "jwork",), {}, tmp_path / "jax")
    ours = _prepare("port", "librimix", args + (tmp_path / "work",), {}, tmp_path / "ours")
    assert sorted(ours) == sorted(f"libri2mix_{p}{s}" for p in ("dev", "test", "train-100")
                                  for s in ("", "_noisy"))
    for part in ("dev", "test"):
        (noisy,) = ours[f"libri2mix_{part}_noisy"]["cutset"]
        assert noisy.tracks[-1].cut.recording.id == "40na010x_1.2422_01xo031b_-1.2422_vp0.5"


@pytest.mark.parametrize("length,target", [(16000, 16000 * 5), (5, 37), (3, 11), (1000, 1000),
                                            (24001, 60000)])
def test_extend_noise_equals_jax(length, target):
    """The half-Hanning crossfade loop, on noise of every length class: longer
    than the fade, shorter than it, and as short as it can be."""
    noise = np.random.RandomState(length).randn(length).astype(np.float32)
    ours, theirs = plibrimix._extend_noise(noise, target), jlibrimix._extend_noise(noise, target)
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs) and len(ours) == target
    flat = plibrimix._extend_noise(np.ones(SR * 2, np.float32), SR * 5)
    assert float(flat.min()) > 0.95 and float(flat.max()) < 1.05


class _CountingNumpy:
    """numpy, but ``concatenate`` raises on its 1000th call."""

    def __init__(self):
        self.calls = 0

    def __getattr__(self, name):
        return getattr(np, name)

    def concatenate(self, *args, **kwargs):
        self.calls += 1
        if self.calls >= 1000:
            raise RuntimeError("still looping")
        return np.concatenate(*args, **kwargs)


@pytest.mark.parametrize("length", [1, 2])
def test_extend_noise_of_fewer_than_three_samples_raises_where_jax_loops(monkeypatch, length):
    """A noise of one or two samples never grows in the crossfade loop (each
    pass adds ``len - fade - 1`` samples): the JAX function loops forever
    (here stopped after 1000 passes), the port raises ``ValueError``
    (ROADMAP.md C2). Such a noise long enough already is returned cut."""
    noise = np.ones(length, np.float32)
    with pytest.raises(ValueError, match="cannot be extended"):
        plibrimix._extend_noise(noise, 9)
    assert np.array_equal(plibrimix._extend_noise(noise, 1), jlibrimix._extend_noise(noise, 1))
    counting = _CountingNumpy()
    monkeypatch.setattr(jlibrimix, "np", counting)
    with pytest.raises(RuntimeError, match="still looping"):
        jlibrimix._extend_noise(noise, 9)
    assert counting.calls == 1000


def test_wham_speed_variants_equal_jax(tmp_path):
    """tests/test_recipes_tranche18.py:305: the train split carries 0.8, 1.0
    and 1.2 speed variants with 'sp08'-style ids, in both packages."""
    rec = J.Recording.from_file(_wav(tmp_path / "noisefile.wav", 1.0, 3))
    for name in ("tr", "cv", "tt"):
        J.RecordingSet.from_recordings([rec]).to_file(tmp_path / f"wham_recordings_{name}.jsonl.gz")
    ours, theirs = plibrimix._load_wham_recordings(tmp_path), jlibrimix._load_wham_recordings(tmp_path)
    assert _dicts(ours) == _dicts(theirs)
    assert sorted(r.id for r in ours["train"]) == ["noisefile", "noisefilesp08", "noisefilesp12"]
    assert abs(ours["train"]["noisefilesp08"].duration - 1.25) < 0.01
    assert np.array_equal(ours["train"]["noisefilesp12"].load_audio(),
                          theirs["train"]["noisefilesp12"].load_audio())
    csv_path = tmp_path / "rows.csv"
    csv_path.write_text("mixture_ID,source_1_gain,noise_path,noise_gain\nm,1.5,tr/a.wav,0.25\n")
    assert plibrimix._read_metadata_csv(csv_path) == jlibrimix._read_metadata_csv(csv_path) == [
        {"mixture_ID": "m", "source_1_gain": 1.5, "noise_path": "tr/a.wav", "noise_gain": 0.25}]


# -- LibriSpeechMix, MiniLibriMix, DIHARD III, Earnings ---------------------------------


@pytest.mark.parametrize("num_jobs", [1, 4])
def test_librispeechmix_equals_jax_at_any_num_jobs(tmp_path, num_jobs):
    """The wide layout at 1 and 4 jobs: the mixtures keyed by id equal JAX's
    (padding cut ids aside at 4 jobs, where threads draw the ``uuid4``
    sequence in their own order), each within 1e-6 of JAX's audio, their
    delays as the metadata says; a second run reads the cache."""
    args, _ = librispeechmix_tree(tmp_path / "corpus", "wide")
    ours = _keyed(_prepare("port", "librispeechmix", args, {"num_jobs": num_jobs}, tmp_path / "o"))
    theirs = _keyed(_prepare("jax", "librispeechmix", args, {"num_jobs": num_jobs},
                             tmp_path / "j"))
    assert set(ours) == {"test-clean-2mix", "test-clean-3mix"}

    def padding_ids_out(d):
        for cut in d.values():
            for track in cut["tracks"]:
                if track["type"] == "PaddingCut":
                    track["cut"]["id"] = "<padding>"
        return d

    for part in ours:
        a = {k: c.to_dict() for k, c in ours[part]["cutset"].items()}
        b = {k: c.to_dict() for k, c in theirs[part]["cutset"].items()}
        if num_jobs > 1:
            a, b = padding_ids_out(a), padding_ids_out(b)
        assert a == b and len(a) == (12 if part.endswith("2mix") else 6)
        for cid, cut in ours[part]["cutset"].items():
            np.testing.assert_allclose(cut.load_audio(),
                                       theirs[part]["cutset"][cid].load_audio(), rtol=0, atol=1e-6)
            assert len(cut.supervisions) == int(part[-4])
    meta = [json.loads(x) for x in (args[1] / "test-clean-2mix.jsonl").read_text().splitlines() if x]
    for entry in meta:
        cut = ours["test-clean-2mix"]["cutset"][entry["id"].split("/")[-1]]
        starts = sorted(round(s.start, 3) for s in cut.supervisions)
        assert starts == sorted(round(d, 3) for d in entry["delays"])
    cached = _keyed(_prepare("port", "librispeechmix", args, {}, tmp_path / "o"))
    assert _dicts_keyed(cached) == _dicts_keyed(ours) or num_jobs > 1


def test_librispeechmix_as_the_jax_test_expects(tmp_path):
    """tests/test_recipes_tranche3.py:483: one mixture of two sources, the
    second delayed by 0.5 s, 2.0 s long."""
    from lhotse_tpu_torch.cut import PaddingCut

    args, _ = librispeechmix_tree(tmp_path / "corpus", "tranche3")
    (cut,) = _prepare("port", "librispeechmix", args, {}, tmp_path / "o")["dev-clean-2mix"]["cutset"]
    assert cut.id == "mix1" and cut.duration == 2.0
    speech = [t for t in cut.tracks if not isinstance(t.cut, PaddingCut)]
    assert sorted(t.offset for t in speech) == [0.0, 0.5]


def test_librimix_mini_as_the_jax_tests_expect(tmp_path):
    """tests/test_recipes_tranche11.py:14 and tranche3.py:458: two-source
    'sources' recordings (channels 0 and 1), a supervision per channel, the
    short rows dropped, premixed audio of the row's length."""
    (csv_path,), _ = librimix_mini_tree(tmp_path / "t11", "tranche11")
    m = pmini.prepare_librimix_mini(csv_path, output_dir=tmp_path / "out",
                                    with_precomputed_mixtures=True, min_segment_seconds=3.0)
    recs, sups = m["sources"]["recordings"], m["sources"]["supervisions"]
    assert sorted(r.id for r in recs) == ["mix0", "mix1"]
    assert [s.channels for s in recs["mix0"].sources] == [[0], [1]]
    assert recs["mix0"].load_audio().shape == (2, 4 * SR)
    assert len(list(sups.find("mix0"))) == 2
    assert m["premixed"]["recordings"]["mix1"].load_audio().shape == (1, 5 * SR)
    (csv_path,), _ = librimix_mini_tree(tmp_path / "t3", "tranche3")
    m = pmini.prepare_librimix_mini(csv_path, with_precomputed_mixtures=True)
    assert set(m) == {"sources", "premixed", "noise"}
    assert [s.channel for s in sorted(m["sources"]["supervisions"], key=lambda s: s.id)] == [0, 1]
    made = pmini.make_corresponding_supervisions(m["sources"]["recordings"])
    assert _dicts(made) == _dicts(jmini.make_corresponding_supervisions(
        J.RecordingSet.from_dicts(r.to_dict() for r in m["sources"]["recordings"])))


def test_dihard3_as_the_jax_tests_expect(tmp_path):
    """tests/test_recipes_tranche14.py:13: RTTM turns with the table's
    domain metadata, UEM regions, and no ``uem`` without ``uem_manifest``."""
    _, kwargs = dihard3_tree(tmp_path / "corpus", "tranche14")
    m = pdihard3.prepare_dihard3(**kwargs, output_dir=tmp_path / "out")
    sups = {s.id: s for s in m["dev"]["supervisions"]}
    s = sups["DH_DEV_0001-spkA-000050-000150"]
    assert (s.start, s.duration, s.speaker, s.language) == (0.5, 1.0, "spkA", "eng")
    assert s.custom["domain"] == "clinical" and s.custom["in_core"] is True
    uem = {u.id: u for u in m["dev"]["uem"]}
    assert (uem["DH_DEV_0001-000025-000275"].start, uem["DH_DEV_0001-000025-000275"].duration) == (
        0.25, 2.5)
    assert "uem" not in pdihard3.prepare_dihard3(**kwargs, uem_manifest=False)["dev"]
    table = tmp_path / "corpus" / "dihard_dev" / "recordings.tbl"
    assert pdihard3.parse_metadata(table) == jdihard3.parse_metadata(table)


def test_earnings_parsers_equal_jax(tmp_path):
    """tests/test_recipes.py:557: Earnings-22's ``.nlp`` reader (which keeps
    a token's trailing newline-free text), metadata reader and normaliser;
    Earnings-21's reader and normaliser."""
    nlp = tmp_path / "4320211.nlp"
    nlp.write_text("token|speaker|ts|endTs|punct|case|tags|wer_tags\n"
                   "Hello|1|0.0|0.5|||[]|[]\n"
                   "world.|1|0.5|0.9|||[]|[]\n")
    assert pearn22.parse_nlp_file(nlp) == jearn22.parse_nlp_file(nlp) == ["Hello", "world."]
    assert pearn21.parse_nlp_file(nlp) == jearn21.parse_nlp_file(nlp) == ["Hello", "world."]
    meta = tmp_path / "metadata.csv"
    meta.write_text("file,source,ticker,date,sector,lang_region,other,x\n"
                    "4320211,rev,ABC,2022,tech,en-US,misc,1\n")
    assert pearn22.read_metadata(meta) == jearn22.read_metadata(meta)
    assert pearn22.read_metadata(meta)["4320211"][4] == "en-US"
    for text in ("Hello, World!", "Q3 revenue: up 12.5% (year-over-year)...", ""):
        assert pearn22.normalize(text) == jearn22.normalize(text) == pearn21.normalize(text)
    assert pearn22.normalize("Hello, World!") == "hello world"


@pytest.mark.skipif(not _mp3_available(), reason="the system MP3 libraries are not present")
@pytest.mark.parametrize("recipe", ["earnings21", "earnings22"])
def test_earnings_mp3_calls_equal_jax(tmp_path, recipe):
    """Real MP3 media (libmp3lame): the manifests equal JAX's, and the calls
    decode (libmpg123) to equal samples in both packages."""
    args, _ = TREES[recipe](tmp_path / "corpus", "mp3")
    ours = _prepare("port", recipe, args, {}, tmp_path / "ours")
    theirs = _prepare("jax", recipe, args, {}, tmp_path / "jax")
    assert _dicts(ours) == _dicts(theirs)
    assert _files(tmp_path / "ours") == _files(tmp_path / "jax")
    for rec in ours[0]:
        audio = rec.load_audio()
        assert audio.shape[0] == 1 and np.isfinite(audio).all()
        assert np.array_equal(audio, theirs[0][rec.id].load_audio())


# -- refusals and downloads -------------------------------------------------------------


def _no_pandas(monkeypatch):
    for module in (pspatial, jspatial):
        monkeypatch.setattr(module, "is_module_available", lambda *names: False)


REFUSALS = {
    # recipe-case: layout maker over an empty root -> (args, kwargs)
    "librimix-no-metadata": lambda r: ((r, r, r / "none", r / "work"), {}),
    "librimix-no-wham": lambda r: _librimix_broken(r, remove="wham"),
    "librimix-no-cutset": lambda r: _librimix_broken(
        r, remove="librispeech/librispeech_cutset_train-100.jsonl.gz"),
    "librimix-unknown-source": lambda r: _librimix_broken(
        r, replace=("1188-133604-0002.wav", "missing.wav")),
    "librimix-unknown-noise": lambda r: _librimix_broken(r, replace=("tr/40na010x", "tr/nothere")),
    "librispeechmix-unknown-source": lambda r: _mix_meta_replaced(r),
    "librimix_mini-no-csv": lambda r: ((r / "none.csv",), {}),
    "librimix_mini-no-length": lambda r: _mini_without_length(r),
    "spatial_librispeech-no-parquet": lambda r: ((r,), {}),
    "spatial_librispeech-unknown-part": lambda r: (spatial_librispeech_tree(r)[0],
                                                   {"dataset_parts": ["dev"]}),
    "spatial_librispeech-no-such-dir": lambda r: ((r / "none",), {}),
    "dihard3-no-table": lambda r: _dihard_without(r, "recordings.tbl"),
    "dihard3-no-rttm": lambda r: _dihard_without(r, "DH_DEV_0002.rttm"),
    "dihard3-no-uem": lambda r: _dihard_without(r, "DH_DEV_0001.uem"),
    "voxconverse-no-rttm": lambda r: _vox_without_rttm(r),
    "earnings21-nlp-without-audio": lambda r: _earnings_without_audio(r, "earnings21"),
    "earnings22-nlp-without-audio": lambda r: _earnings_without_audio(r, "earnings22"),
    "earnings22-no-metadata": lambda r: _earnings22_without_metadata(r),
    "earnings22-no-such-dir": lambda r: ((r / "none",), {}),
}


def _librimix_broken(root, remove=None, replace=None):
    """The tranche18 LibriMix layout with a file or directory taken away, or
    a string of its CSV replaced."""
    import shutil

    args, kwargs = librimix_tree(root, "tranche18")
    if remove is not None:
        target = root / remove
        shutil.rmtree(target) if target.is_dir() else target.unlink()
    if replace is not None:
        csv_path = args[2] / "Libri2Mix" / "libri2mix_train-100.csv"
        csv_path.write_text(csv_path.read_text().replace(*replace))
    return args + (root / "work",), kwargs


def _earnings22_without_metadata(root):
    args, kwargs = earnings22_tree(root, "tranche4")
    (root / "metadata.csv").unlink()
    return args, kwargs


def _mix_meta_replaced(root):
    args, kwargs = librispeechmix_tree(root, "tranche3")
    path = args[1] / "dev-clean-2mix.jsonl"
    path.write_text(path.read_text().replace("w/a2.wav", "w/a9.wav"))
    return args, kwargs


def _mini_without_length(root):
    (csv_path,), kwargs = librimix_mini_tree(root, "tranche3")
    csv_path.write_text(csv_path.read_text().replace(",length", ",size"))
    return (csv_path,), kwargs


def _dihard_without(root, name):
    _, kwargs = dihard3_tree(root, "tranche14")
    next(root.rglob(name)).unlink()
    return (), kwargs


def _vox_without_rttm(root):
    args, kwargs = voxconverse_tree(root, "tranche2")
    (root / "test" / "xyz.rttm").unlink()
    return args, kwargs


def _earnings_without_audio(root, recipe):
    args, kwargs = TREES[recipe](root, "tranche2" if recipe == "earnings21" else "tranche4")
    (root / "transcripts" / "nlp_references" / "4999999.nlp").write_text(NLP_HEADER + "\nx|1\n")
    return args, kwargs


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refuses_as_jax(tmp_path, monkeypatch, case):
    """Each package raises the same error with the same message on the same
    broken layout, having written the same manifests (VoxConverse writes the
    dev split before it fails on test)."""
    recipe = case.split("-")[0]
    root = tmp_path / "corpus"
    root.mkdir()
    args, kwargs = REFUSALS[case](root)
    errors = []
    for pkg, prepare in (("port", P[recipe]), ("jax", JP[recipe])):
        with pytest.raises(Exception) as info:
            prepare(*args, output_dir=tmp_path / pkg, **kwargs)
        errors.append((type(info.value).__name__, str(info.value).replace(str(tmp_path), ""),
                       sorted(p.name for p in (tmp_path / pkg).rglob("*.jsonl.gz"))))
    assert errors[0] == errors[1]


def test_spatial_librispeech_at_two_jobs_where_jax_raises(tmp_path):
    """``num_jobs=2`` scans the FLACs in worker processes. The JAX recipe
    hands them a lambda for the recording ids, which does not pickle, and
    raises ``AttributeError``; the port's gives the same manifests as one
    job (ROADMAP.md C2)."""
    args, _ = spatial_librispeech_tree(tmp_path / "corpus", "wide")
    with pytest.raises(AttributeError, match="lambda"):
        JP["spatial_librispeech"](*args, output_dir=tmp_path / "jax", num_jobs=2)
    two = P["spatial_librispeech"](*args, output_dir=tmp_path / "two", num_jobs=2)
    one = P["spatial_librispeech"](*args, output_dir=tmp_path / "one")
    assert _dicts(two) == _dicts(one) and len(two["train"]["recordings"]) == 6
    assert _files(tmp_path / "two") == _files(tmp_path / "one")


def test_spatial_librispeech_without_pandas_raises_as_jax(tmp_path, monkeypatch):
    """Without pandas both packages raise the same ``ImportError`` before
    they read the layout."""
    _no_pandas(monkeypatch)
    errors = []
    for prepare in (P["spatial_librispeech"], JP["spatial_librispeech"]):
        with pytest.raises(ImportError) as info:
            prepare(tmp_path / "none")
        errors.append(str(info.value))
    assert errors[0] == errors[1] and "pandas" in errors[0]


def test_downloads_are_left_out():
    """The port defines none of the JAX modules' downloads or fetchers, and
    its modules import no network library."""
    left_out = {plibrimix: ("download_librimix", "download_github_dir", "_fetch_json",
                            "_fetch_bytes"),
                plsmix: ("download_librispeechmix", "download_github_dir"),
                pmini: ("download_librimix_mini",),
                pspatial: ("download_spatial_librispeech", "_fetch_audio"),
                pvox: ("download_voxconverse", "_fetch_and_flatten"),
                pearn21: ("download_earnings21",), pearn22: ("download_earnings22",)}
    jax_modules = {plibrimix: jlibrimix, plsmix: jlsmix, pmini: jmini, pspatial: jspatial,
                   pvox: jvox, pearn21: jearn21, pearn22: jearn22}
    for module, names in left_out.items():
        for name in names:
            assert hasattr(jax_modules[module], name)
            assert not hasattr(module, name), f"{module.__name__}.{name}"
        source = open(module.__file__).read()
        assert "urllib" not in source and "requests" not in source
        assert "resumable_download" not in source


# -- the prepare commands --------------------------------------------------------------------

COMMANDS = {
    # command: (argv from (args, kwargs) of the layout, the layout maker, the function's call)
    "librimix": (lambda a, k: ["librimix", *a, "{out}/work", "{out}", "--n-src", "3", "-j", "2"],
                 lambda r: librimix_tree(r, "wide", 3),
                 lambda a, k, o: P["librimix"](*a, o / "work", output_dir=o, n_src=3, num_jobs=2)),
    "librimix-mini": (lambda a, k: ["librimix-mini", a[0], "{out}", "--with-precomputed-mixtures",
                                    "--sampling-rate", "8000", "--min-segment-seconds", "2.5"],
                      lambda r: librimix_mini_tree(r, "wide"),
                      lambda a, k, o: P["librimix_mini"](
                          a[0], output_dir=o, with_precomputed_mixtures=True, sampling_rate=8000,
                          min_segment_seconds=2.5)),
    "librispeechmix": (lambda a, k: ["librispeechmix", *a, "{out}"],
                       lambda r: librispeechmix_tree(r, "wide"),
                       lambda a, k, o: P["librispeechmix"](*a, output_dir=o)),
    "spatial-librispeech": (lambda a, k: ["spatial-librispeech", a[0], "{out}", "-p", "train",
                                          "-p", "test", "--normalize-text", "lower"],
                            lambda r: spatial_librispeech_tree(r, "wide"),
                            lambda a, k, o: P["spatial_librispeech"](
                                a[0], output_dir=o, normalize_text="lower")),
    "dihard3": (lambda a, k: ["dihard3", "{out}", "--dev", k["dev_audio_dir"], "--eval",
                              k["eval_audio_dir"], "--no-uem"],
                lambda r: dihard3_tree(r, "wide"),
                lambda a, k, o: P["dihard3"](**k, output_dir=o, uem_manifest=False)),
    "voxconverse": (lambda a, k: ["voxconverse", a[0], "{out}", "--split-test"],
                    lambda r: voxconverse_tree(r, "wide"),
                    lambda a, k, o: P["voxconverse"](a[0], output_dir=o, split_test=True)),
    "earnings21": (lambda a, k: ["earnings21", a[0], "{out}", "--normalize-text"],
                   lambda r: earnings21_tree(r, "wide"),
                   lambda a, k, o: P["earnings21"](a[0], output_dir=o, normalize_text=True)),
    "earnings22": (lambda a, k: ["earnings22", a[0], "{out}"],
                   lambda r: earnings22_tree(r, "wide"),
                   lambda a, k, o: P["earnings22"](a[0], output_dir=o)),
}


@pytest.mark.parametrize("name", sorted(COMMANDS))
def test_prepare_command_writes_what_its_function_writes(tmp_path, name):
    """Each ``prepare`` command writes the files its function writes, and
    the JAX CLI's command the same, with the output directory replaced
    (LibriMix's and LibriSpeechMix's cut sets keyed by cut id)."""
    from test_torch_cli import _both as both_clis

    argv, build, function = COMMANDS[name]
    args, kwargs = build(tmp_path / "corpus")
    keyed = name in ("librimix", "librispeechmix")
    runs = both_clis(tmp_path, "prepare", *argv(args, kwargs), seed=0)
    fix_random_seed(0)
    function(args, kwargs, tmp_path / "function")
    (pout, _), (jout, _) = runs["port"], runs["jax"]
    ours = _files(pout, keyed=keyed)
    assert ours and ours == _files(tmp_path / "function", keyed=keyed) == _files(jout, keyed=keyed)


# -- the slice: LibriMix into the on-device chain, LibriSpeechMix into SURT --------------------


@pytest.fixture(scope="module")
def librimix_slice(tmp_path_factory):
    root = tmp_path_factory.mktemp("librimix_slice")
    args, _ = librimix_tree(root / "corpus", "wide", 2)
    made = {}
    for pkg in ("port", "jax"):
        out = _prepare(pkg, "librimix", args + (root / f"work_{pkg}",), {"n_src": 2},
                       root / f"out_{pkg}")
        made[pkg] = [c for part in ("libri2mix_train-100_noisy", "libri2mix_train-360_noisy")
                     for c in out[part]["cutset"]]
    return root, made["port"], made["jax"]


def test_librimix_noisy_mixtures_through_the_augmenter_equal_jax(librimix_slice):
    """The nine noisy Libri2Mix mixtures, loaded by each package in the
    port's order, in batches of the 2 s x 4 bucket through each package's
    augmenter with the same MUSAN noise pool and real RIR, speed 1.1, SNR
    (10, 20) and SpecAugment: the port within ``AUG_TOL`` of the JAX
    augmenter whose fbank stage is its kernel route in float64."""
    root, ours, theirs = librimix_slice
    by_id = {c.id: c for c in theirs}
    theirs = [by_id[c.id] for c in ours]
    assert len(ours) == 9
    musan, rirs = musan_tree(root / "musan", "pool"), rir_noise_tree(root / "RIRS", 2)
    pool = noise_pool(pmusan.prepare_musan(musan, parts="noise")["noise"]["recordings"])
    rir = seeded_rir(prir.prepare_rir_noise(rirs, parts="real_rir")["real_rir"]["recordings"])
    assert np.array_equal(
        pool, noise_pool(jmusan.prepare_musan(musan, parts="noise")["noise"]["recordings"]))
    assert np.array_equal(
        rir, seeded_rir(jrir.prepare_rir_noise(rirs, parts="real_rir")["real_rir"]["recordings"]))
    common = dict(speed_factor=1.1, noise_pool=pool, rir=rir, snr=(10, 20), mix_prob=0.5, seed=5,
                  wire_format="int16")
    port = OnDeviceAugmenter([(3.0, 4)], specaugment=SpecAugment(seed=7), device="cpu", **common)
    jax_aug = JAugmenter([(3.0, 4)], specaugment=JSpecAugment(seed=7), fbank=_JaxKernelRoute64(),
                         **common)
    batches = _bucketed(ours, (3.0, 4))
    for (audio, lens), (jaudio, jlens) in zip(batches, _bucketed(theirs, (3.0, 4))):
        np.testing.assert_allclose(audio, jaudio, rtol=0, atol=1e-6)
        assert np.array_equal(lens, jlens)
    mixed = 0
    for audio, lens in batches:
        s_ours, s_theirs = port.stage(audio, lens), jax_aug.stage(audio, lens)
        mixed += int(np.asarray(s_ours.kwargs["mix_mask"]).sum())
        feats, feat_lens = port.compute(s_ours)
        jfeats, jfeat_lens = jax_aug.compute(s_theirs)
        feats, jfeats = feats.numpy(), np.asarray(jfeats)
        assert feats.shape == jfeats.shape and np.isfinite(feats).all()
        assert np.array_equal(feat_lens.numpy(), np.asarray(jfeat_lens))
        np.testing.assert_allclose(feats, jfeats, rtol=0, atol=AUG_TOL)
    assert mixed > 0


def test_librispeechmix_through_surt_on_the_fly_equals_jax(tmp_path, monkeypatch):
    """The two-speaker LibriSpeechMix mixtures through ``K2SurtDataset(
    num_channels=2)`` with ``OnTheFlyFeatures``: the port's features within
    ``EXTRACTOR_TOL`` of the JAX extractor's host chain in float64, the
    supervisions per channel and the texts equal to JAX's."""
    args, _ = librispeechmix_tree(tmp_path / "corpus", "wide")
    ours = _prepare("port", "librispeechmix", args, {}, tmp_path / "o")["test-clean-2mix"]["cutset"]
    theirs = {c.id: c for c in _prepare("jax", "librispeechmix", args, {},
                                        tmp_path / "j")["test-clean-2mix"]["cutset"]}
    ours = list(ours)
    theirs = [theirs[c.id] for c in ours]
    dataset = K2SurtDataset(num_channels=2, return_cuts=True,
                            input_strategy=OnTheFlyFeatures(Fbank(FbankConfig(device="cpu"))))
    j64 = JSurt(num_channels=2, return_cuts=True,
                input_strategy=JOnTheFly(JFbank(JFbankConfig(device="cpu"))))
    monkeypatch.setenv("LHOTSE_TPU_HOST_FFT_DTYPE", "float64")
    overlapped = 0
    for i in range(0, len(ours), 4):
        a = dataset[CutSet.from_cuts(ours[i:i + 4])]
        b = j64[J.CutSet.from_cuts(theirs[i:i + 4])]
        x, y = np.asarray(a["inputs"]), np.asarray(b["inputs"])
        assert x.shape == y.shape and np.isfinite(x).all()
        np.testing.assert_allclose(x, y, rtol=0, atol=EXTRACTOR_TOL)
        assert np.array_equal(np.asarray(a["input_lens"]), np.asarray(b["input_lens"]))
        assert a["text"] == b["text"]
        assert [[[s.to_dict() for s in ch] for ch in cut] for cut in a["supervisions"]] == [
            [[s.to_dict() for s in ch] for ch in cut] for cut in b["supervisions"]]
        overlapped += sum(1 for cut in a["supervisions"] if cut[1])
    assert overlapped > 0


def test_dihard3_and_voxconverse_feed_diarization_as_jax(tmp_path):
    """DIHARD III and VoxConverse sessions in 2 s windows through
    ``DiarizationDataset``: the speaker activity of each batch equals JAX's."""
    from lhotse_tpu.dataset.diarization import DiarizationDataset as JDiar
    from lhotse_tpu_torch.dataset.diarization import DiarizationDataset

    for recipe, build in (("dihard3", dihard3_tree), ("voxconverse", voxconverse_tree)):
        args, kwargs = build(tmp_path / recipe, "wide")
        made = {}
        for pkg, CS in (("port", CutSet), ("jax", J.CutSet)):
            parts = _prepare(pkg, recipe, args, kwargs, tmp_path / f"{recipe}_{pkg}")
            part = parts["dev"]
            cuts = CS.from_manifests(recordings=part["recordings"],
                                     supervisions=part["supervisions"])
            made[pkg] = cuts.cut_into_windows(2.0).filter(
                lambda c: abs(c.duration - 2.0) < 1e-6).to_eager()
        ours, theirs = made["port"], made["jax"]
        assert [c.id for c in ours] == [c.id for c in theirs] and len(ours) >= 9
        fbank = Fbank(FbankConfig(device="cpu"))
        jfbank = JFbank(JFbankConfig(device="cpu"))
        ours = ours.compute_and_store_features(fbank, tmp_path / f"{recipe}_pf").to_eager()
        theirs = theirs.compute_and_store_features(jfbank, tmp_path / f"{recipe}_jf").to_eager()
        a = DiarizationDataset(ours, min_speaker_dim=4, global_speaker_ids=True)
        b = JDiar(theirs, min_speaker_dim=4, global_speaker_ids=True)
        ids = [c.id for c in ours][:6]
        x = a[ours.subset(cut_ids=ids)]
        y = b[theirs.subset(cut_ids=ids)]
        assert np.array_equal(np.asarray(x["speaker_activity"]), np.asarray(y["speaker_activity"]))
        assert np.asarray(x["speaker_activity"]).sum() > 0
