"""
The port's command line (``lhotse_tpu_torch.bin``) held to the JAX
package's (``lhotse_tpu.bin``): the cases of ``tests/test_cli.py`` and
``tests/test_cli_pipeline.py`` whose commands are ported, each run through
both CLIs with click's ``CliRunner``, each CLI writing into a directory of
its own. Output manifests are compared as dicts, with each CLI's output
directory replaced by one placeholder; Kaldi files and text output byte for
byte. Features are extracted on the CPU through a ``device: cpu`` config
and compared in LTC1 ticks (2^-5), as ``tests/test_torch_precomputed.py``
compares features the two packages compute separately: none more than one
tick apart, and at most a 1e-3 share of the values one tick apart.
"""
import json
from pathlib import Path

import numpy as np
import pytest
from click.testing import CliRunner

SR = 16000
N_RECS = 6
TICK = 2.0**-5
TICK_SHARE = 1e-3


def _cli(package):
    if package == "jax":
        from lhotse_tpu.bin.modes import cli
    else:
        from lhotse_tpu_torch.bin.modes import cli
    return cli


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Six recordings of noise under a quiet tone (1.5 s to 3.0 s), their
    supervisions, a ``device: cpu`` fbank config and the trimmed cuts, all
    written once by the JAX package, as tests/test_cli_pipeline.py does."""
    from lhotse_tpu import RecordingSet, SupervisionSegment, SupervisionSet
    from lhotse_tpu.audio.wavio import write_wav

    d = tmp_path_factory.mktemp("cli_corpus")
    rng = np.random.RandomState(0)
    for i in range(N_RECS):
        t = np.arange(int(SR * (1.5 + 0.3 * i))) / SR
        sig = 0.05 * np.sin(2 * np.pi * (180 + 30 * i) * t) + 0.1 * rng.randn(t.size)
        write_wav(d / f"utt{i}.wav", sig.astype(np.float32), SR)
    RecordingSet.from_dir(d, "*.wav").to_file(d / "recordings.jsonl.gz")
    SupervisionSet.from_segments([
        SupervisionSegment(
            id=f"s{i}", recording_id=f"utt{i}", start=0.1, duration=1.0, channel=0,
            text=f"word{i}", speaker=f"spk{i % 2}", language="English")
        for i in range(N_RECS)
    ]).to_file(d / "supervisions.jsonl.gz")
    res = CliRunner().invoke(_cli("jax"), ["feat", "write-default-config", str(d / "cpu.yaml")])
    assert res.exit_code == 0, res.output
    assert "device: cpu" in (d / "cpu.yaml").read_text()
    for args in (["cut", "simple", "-r", d / "recordings.jsonl.gz", "-s",
                  d / "supervisions.jsonl.gz", d / "cuts.jsonl.gz"],
                 ["cut", "trim-to-supervisions", d / "cuts.jsonl.gz", d / "trimmed.jsonl"]):
        res = CliRunner().invoke(_cli("jax"), [str(a) for a in args], catch_exceptions=False)
        assert res.exit_code == 0, res.output
    return d


def _both(tmp_path, *args, seed=None, expect_ok=True):
    """Run ``args`` through each CLI; ``{out}`` in an argument is that CLI's
    own output directory. Returns {package: (output directory, result)}."""
    runs = {}
    for package in ("jax", "port"):
        out = tmp_path / package
        out.mkdir(exist_ok=True)
        argv = (["-s", str(seed)] if seed is not None else []) + [
            str(a).replace("{out}", str(out)) for a in args]
        res = CliRunner().invoke(_cli(package), argv, catch_exceptions=False)
        if expect_ok:
            assert res.exit_code == 0, f"{package} {argv}: {res.output}"
        runs[package] = (out, res)
    return runs


def _normalized(manifest_path: Path, out: Path) -> list:
    from lhotse_tpu_torch.serialization import load_manifest

    text = json.dumps([item.to_dict() for item in load_manifest(manifest_path)])
    return json.loads(text.replace(str(out), "<out>"))


def _same_manifest(runs, name):
    (jout, _), (pout, _) = runs["jax"], runs["port"]
    ours = _normalized(pout / name, pout)
    assert ours == _normalized(jout / name, jout)
    return ours


def _features_of(cuts_path):
    from lhotse_tpu_torch.cut import CutSet

    return {c.id: c.load_features() for c in CutSet.from_file(cuts_path)}


def _assert_ticks(ours: np.ndarray, theirs: np.ndarray) -> None:
    assert ours.shape == theirs.shape
    diff = np.abs(ours - theirs)
    assert diff.max() <= TICK, diff.max()
    assert np.count_nonzero(diff) <= TICK_SHARE * diff.size, np.count_nonzero(diff) / diff.size


def _same_features(runs, name):
    (jout, _), (pout, _) = runs["jax"], runs["port"]
    ours, theirs = _features_of(pout / name), _features_of(jout / name)
    assert sorted(ours) == sorted(theirs)
    for cid in ours:
        _assert_ticks(ours[cid], theirs[cid])
    return ours


# -- tests/test_cli.py -------------------------------------------------------------------


@pytest.mark.parametrize("args", [
    ["validate", "{corpus}/recordings.jsonl.gz"],
    ["validate", "--read-data", "{corpus}/cuts.jsonl.gz"],
    ["validate-pair", "{corpus}/recordings.jsonl.gz", "{corpus}/supervisions.jsonl.gz"],
])
def test_validate(corpus, tmp_path, args):
    runs = _both(tmp_path, *[a.replace("{corpus}", str(corpus)) for a in args])
    assert runs["port"][1].output == runs["jax"][1].output == ""


def test_validate_reports_a_broken_pair(corpus, tmp_path):
    from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet

    SupervisionSet.from_segments([SupervisionSegment(
        id="late", recording_id="utt0", start=5.0, duration=1.0)]).to_file(tmp_path / "late.jsonl")
    runs = _both(tmp_path, "validate-pair", corpus / "recordings.jsonl.gz", tmp_path / "late.jsonl")
    assert runs["port"][1].output == runs["jax"][1].output
    assert runs["port"][1].output.startswith("Validation failed:")


def test_fix(corpus, tmp_path):
    runs = _both(tmp_path, "fix", corpus / "recordings.jsonl.gz", corpus / "supervisions.jsonl.gz",
                 "{out}/fixed")
    assert len(_same_manifest(runs, "fixed/recordings.jsonl.gz")) == N_RECS
    _same_manifest(runs, "fixed/supervisions.jsonl.gz")


@pytest.mark.parametrize("eager", [False, True])
def test_cut_simple_and_describe(corpus, tmp_path, eager):
    runs = _both(tmp_path, "cut", "simple", "-r", corpus / "recordings.jsonl.gz", "-s",
                 corpus / "supervisions.jsonl.gz", *(["--force-eager"] if eager else []),
                 "{out}/cuts.jsonl.gz")
    cuts = _same_manifest(runs, "cuts.jsonl.gz")
    assert len(cuts) == N_RECS and all(len(c["supervisions"]) == 1 for c in cuts)
    runs = _both(tmp_path, "cut", "describe", "{out}/cuts.jsonl.gz")
    assert "Cuts count:" in runs["port"][1].output
    assert runs["port"][1].output == runs["jax"][1].output


def test_subset_split_combine_filter(corpus, tmp_path):
    trimmed = corpus / "trimmed.jsonl"
    runs = _both(tmp_path, "subset", "--first", 3, trimmed, "{out}/sub.jsonl.gz")
    assert len(_same_manifest(runs, "sub.jsonl.gz")) == 3
    runs = _both(tmp_path, "subset", "--last", 2, trimmed, "{out}/last.jsonl.gz")
    _same_manifest(runs, "last.jsonl.gz")
    from lhotse_tpu_torch.cut import CutSet

    wanted = [c.id for c in CutSet.from_file(trimmed)][4:0:-3]
    runs = _both(tmp_path, "subset", "--cutids", json.dumps(wanted), trimmed, "{out}/ids.jsonl.gz")
    assert [c["id"] for c in _same_manifest(runs, "ids.jsonl.gz")] == wanted
    runs = _both(tmp_path, "split", 2, trimmed, "{out}/splits")
    parts = sorted(p.name for p in (runs["port"][0] / "splits").iterdir())
    assert parts == sorted(p.name for p in (runs["jax"][0] / "splits").iterdir())
    assert len(parts) == 2
    for part in parts:
        _same_manifest(runs, f"splits/{part}")
    runs = _both(tmp_path, "combine", *[f"{{out}}/splits/{p}" for p in parts],
                 "{out}/recombined.jsonl.gz")
    assert len(_same_manifest(runs, "recombined.jsonl.gz")) == N_RECS
    runs = _both(tmp_path, "filter", "duration>0.9", trimmed, "{out}/filtered.jsonl.gz")
    assert len(_same_manifest(runs, "filtered.jsonl.gz")) == N_RECS
    runs = _both(tmp_path, "filter", "duration>2.1", corpus / "recordings.jsonl.gz",
                 "{out}/long.jsonl.gz")
    assert len(_same_manifest(runs, "long.jsonl.gz")) == 3


def test_filter_without_survivors_and_bad_predicates(corpus, tmp_path):
    runs = _both(tmp_path, "filter", "duration>100", corpus / "trimmed.jsonl",
                 "{out}/none.jsonl.gz")
    assert runs["port"][1].output == runs["jax"][1].output == "No items satisfying the predicate.\n"
    runs = _both(tmp_path, "filter", "nope>1", corpus / "trimmed.jsonl", "{out}/x.jsonl.gz",
                 expect_ok=False)
    assert runs["port"][1].exit_code == runs["jax"][1].exit_code == 1
    assert runs["port"][1].output == runs["jax"][1].output


def test_copy_and_split_lazy(corpus, tmp_path):
    runs = _both(tmp_path, "copy", corpus / "trimmed.jsonl", "{out}/copy.json")
    assert len(_same_manifest(runs, "copy.json")) == N_RECS
    runs = _both(tmp_path, "split-lazy", corpus / "trimmed.jsonl", "{out}/lazy", 4)
    parts = sorted(p.name for p in (runs["port"][0] / "lazy").iterdir())
    assert parts == ["trimmed.00000000.jsonl.gz", "trimmed.00000001.jsonl.gz"]
    for part in parts:
        _same_manifest(runs, f"lazy/{part}")


def test_feat_extract_cuts(corpus, tmp_path):
    runs = _both(tmp_path, "feat", "extract-cuts", "-f", corpus / "cpu.yaml", corpus / "trimmed.jsonl",
                 "{out}/cuts_feats.jsonl.gz", "{out}/storage")
    cuts = _same_manifest(runs, "cuts_feats.jsonl.gz")
    assert all("features" in c for c in cuts)
    feats = _same_features(runs, "cuts_feats.jsonl.gz")
    assert all(f.shape == (100, 80) for f in feats.values())


def test_feat_extract_cuts_batch(corpus, tmp_path):
    runs = _both(tmp_path, "feat", "extract-cuts-batch", "-f", corpus / "cpu.yaml", "-j", 1,
                 corpus / "cuts.jsonl.gz", "{out}/cuts_feats.jsonl.gz", "{out}/storage")
    _same_manifest(runs, "cuts_feats.jsonl.gz")
    _same_features(runs, "cuts_feats.jsonl.gz")


def test_feat_extract_recordings_and_config(corpus, tmp_path):
    runs = _both(tmp_path, "feat", "extract", "-f", corpus / "cpu.yaml", "-t", -4,
                 corpus / "recordings.jsonl.gz", "{out}/feats")
    _same_manifest(runs, "feats/feature_manifest.json.gz")
    from lhotse_tpu_torch.features import FeatureSet

    ours = FeatureSet.from_file(runs["port"][0] / "feats/feature_manifest.json.gz")
    theirs = FeatureSet.from_file(runs["jax"][0] / "feats/feature_manifest.json.gz")
    for a, b in zip(ours, theirs):
        diff = np.abs(a.load() - b.load())
        assert diff.max() <= 2 * TICK and np.count_nonzero(diff) <= TICK_SHARE * diff.size
    runs = _both(tmp_path, "feat", "write-default-config", "-f", "kaldi-mfcc", "{out}/mfcc.yaml")
    ours, theirs = ((runs[p][0] / "mfcc.yaml").read_text() for p in ("port", "jax"))
    assert ours.replace("device: cuda", "device: cpu") == theirs


def test_feat_extract_refuses_without_a_card(corpus, tmp_path):
    """With no card and no ``device: cpu`` config, the port's extraction
    commands stop with an error that says so; nothing runs on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for args in (["feat", "extract-cuts-batch", corpus / "cuts.jsonl.gz", tmp_path / "o.jsonl.gz",
                  tmp_path / "storage"],
                 ["feat", "extract-cuts", corpus / "trimmed.jsonl", tmp_path / "o.jsonl.gz",
                  tmp_path / "storage"]):
        res = CliRunner().invoke(_cli("port"), [str(a) for a in args])
        assert res.exit_code == 1
        assert "runs on a CUDA card, and this machine has none" in res.output
        assert "device: cpu" in res.output
        assert not (tmp_path / "o.jsonl.gz").exists() and not (tmp_path / "storage").exists()


def test_shar_export_and_index(corpus, tmp_path):
    runs = _both(tmp_path, "shar", "export", "-a", "wav", "--no-compress-jsonl",
                 corpus / "trimmed.jsonl", "{out}/shar")
    files = sorted(p.name for p in (runs["port"][0] / "shar").iterdir())
    assert files == sorted(p.name for p in (runs["jax"][0] / "shar").iterdir())
    for name in files:
        assert (runs["port"][0] / "shar" / name).read_bytes() == (
            runs["jax"][0] / "shar" / name).read_bytes(), name
    from lhotse_tpu_torch.cut import CutSet

    back = CutSet.from_shar(in_dir=runs["port"][0] / "shar")
    assert back.has_constant_time_access and len(back) == N_RECS
    runs = _both(tmp_path, "validate-shar", "--read-data", "{out}/shar")
    assert runs["port"][1].output == runs["jax"][1].output == "OK\n"


def test_list_backends():
    """The ``list-*`` commands print JAX's lists minus the backends the port
    does not have (the I/O and storage backends are all ported)."""
    left_out = {
        "list-audio-backends": set(),
        "list-io-backends": set(),
        "list-storage-backends": set(),
        "list-resampling-backends": {"sox"},
    }
    for command, missing in left_out.items():
        outputs = {}
        for package in ("jax", "port"):
            res = CliRunner().invoke(_cli(package), [command])
            assert res.exit_code == 0, res.output
            text = res.output.strip()
            outputs[package] = (set(eval(text)) if text.startswith("[")  # noqa: S307
                                else set(text.splitlines()))
        assert outputs["port"] == outputs["jax"] - missing, command
        assert outputs["port"]
    assert "default" in CliRunner().invoke(_cli("port"), ["list-resampling-backends"]).output


# -- tests/test_cli_pipeline.py ----------------------------------------------------------


def test_pipeline_keeps_every_supervision(corpus, tmp_path):
    runs = _both(tmp_path, "fix", corpus / "recordings.jsonl.gz", corpus / "supervisions.jsonl.gz",
                 "{out}/fixed")
    runs = _both(tmp_path, "cut", "simple", "-r", "{out}/fixed/recordings.jsonl.gz",
                 "-s", "{out}/fixed/supervisions.jsonl.gz", "{out}/cuts.jsonl.gz")
    runs = _both(tmp_path, "cut", "trim-to-supervisions", "{out}/cuts.jsonl.gz", "{out}/trimmed.jsonl")
    cuts = _same_manifest(runs, "trimmed.jsonl")
    assert len(cuts) == N_RECS and all(len(c["supervisions"]) == 1 for c in cuts)
    runs = _both(tmp_path, "cut", "trim-to-supervisions", "--keep-all-channels", "-d", 1.5,
                 "-c", "left", "{out}/cuts.jsonl.gz", "{out}/trimmed_kac.jsonl.gz")
    assert len(_same_manifest(runs, "trimmed_kac.jsonl.gz")) == N_RECS


def test_feat_extract_then_shar_roundtrip(corpus, tmp_path):
    _both(tmp_path, "feat", "extract-cuts", "-f", corpus / "cpu.yaml", corpus / "trimmed.jsonl",
          "{out}/cuts_feats.jsonl.gz", "{out}/feats")
    runs = _both(tmp_path, "shar", "export", "-a", "flac", "-f", "lilcom", "--no-compress-jsonl",
                 "{out}/cuts_feats.jsonl.gz", "{out}/shar")
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.shar.readers.indexed import LazyIndexedSharIterator

    pout, jout = runs["port"][0], runs["jax"][0]
    ours = list(CutSet.from_shar(in_dir=pout / "shar"))
    theirs = {c.id: c for c in CutSet.from_shar(in_dir=jout / "shar")}
    assert len(ours) == N_RECS
    for c in ours:
        assert c.load_features().shape[1] == 80 and c.supervisions
        assert np.array_equal(c.load_audio(), theirs[c.id].load_audio())
        _assert_ticks(c.load_features(), theirs[c.id].load_features())
    idx = LazyIndexedSharIterator(in_dir=pout / "shar")
    assert len(idx) == N_RECS and idx[3].load_features().shape[1] == 80


def test_shar_compute_features(corpus, tmp_path):
    _both(tmp_path, "shar", "export", "-a", "flac", "-s", 4, corpus / "trimmed.jsonl", "{out}/shar")
    runs = _both(tmp_path, "shar", "compute-features", "-f", corpus / "cpu.yaml", "{out}/shar")
    from lhotse_tpu_torch.cut import CutSet

    def feats(out):
        fields = {"cuts": sorted((out / "shar").glob("cuts.*.jsonl.gz")),
                  "features": sorted((out / "shar").glob("features.*.tar"))}
        return {c.id: c.load_features() for c in CutSet.from_shar(fields=fields)}

    ours, theirs = feats(runs["port"][0]), feats(runs["jax"][0])
    assert sorted(ours) == sorted(theirs) and len(ours) == N_RECS
    for cid in ours:
        assert ours[cid].shape == (100, 80)
        assert np.abs(ours[cid] - theirs[cid]).max() <= 1e-3  # numpy, not lilcom: raw float32


def test_kaldi_export_import_roundtrip(corpus, tmp_path):
    runs = _both(tmp_path, "kaldi", "export", corpus / "recordings.jsonl.gz",
                 corpus / "supervisions.jsonl.gz", "{out}/kaldi_dir")
    for name in ("wav.scp", "segments", "text", "utt2spk", "utt2dur", "reco2dur", "utt2lang"):
        assert (runs["port"][0] / "kaldi_dir" / name).read_bytes() == (
            runs["jax"][0] / "kaldi_dir" / name).read_bytes(), name
    runs = _both(tmp_path, "kaldi", "import", "{out}/kaldi_dir", SR, "{out}/kaldi_back")
    assert len(_same_manifest(runs, "kaldi_back/recordings.jsonl.gz")) == N_RECS
    sups = _same_manifest(runs, "kaldi_back/supervisions.jsonl.gz")
    assert sorted(s["recording_id"] for s in sups) == [f"utt{i}" for i in range(N_RECS)]


@pytest.mark.parametrize("args,name", [
    (["cut", "truncate", "--max-duration", 1.5, "{corpus}/cuts.jsonl.gz", "{out}/t.jsonl.gz"],
     "t.jsonl.gz"),
    (["cut", "truncate", "--preserve-id", "-d", 1.0, "-o", "end", "{corpus}/cuts.jsonl.gz",
      "{out}/t.jsonl.gz"], "t.jsonl.gz"),
    (["cut", "pad", "--duration", 5.0, "{corpus}/cuts.jsonl.gz", "{out}/p.jsonl.gz"], "p.jsonl.gz"),
    (["cut", "pad", "{corpus}/trimmed.jsonl", "{out}/p.jsonl.gz"], "p.jsonl.gz"),
    (["cut", "mix-sequential", "{corpus}/cuts.jsonl.gz", "{corpus}/trimmed.jsonl",
      "{out}/m.jsonl.gz"], "m.jsonl.gz"),
    (["cut", "mix-by-recording-id", "{corpus}/cuts.jsonl.gz", "{corpus}/trimmed.jsonl",
      "{out}/m.jsonl.gz"], "m.jsonl.gz"),
    (["cut", "append", "{corpus}/trimmed.jsonl", "{corpus}/trimmed.jsonl", "{out}/a.jsonl.gz"],
     "a.jsonl.gz"),
    (["cut", "trim-to-supervision-groups", "--max-pause", 0.5, "{corpus}/cuts.jsonl.gz",
      "{out}/g.jsonl.gz"], "g.jsonl.gz"),
])
def test_cut_manipulation(corpus, tmp_path, args, name):
    runs = _both(tmp_path, *[str(a).replace("{corpus}", str(corpus)) for a in args], seed=0)
    cuts = _same_manifest(runs, name)
    assert cuts
    from lhotse_tpu.cut import CutSet as JCutSet
    from lhotse_tpu_torch.cut import CutSet

    for ours, theirs in zip(CutSet.from_file(runs["port"][0] / name),
                            JCutSet.from_file(runs["jax"][0] / name)):
        assert np.array_equal(ours.load_audio(), theirs.load_audio())


def test_cut_decompose_and_estimate_bucket_bins(corpus, tmp_path):
    runs = _both(tmp_path, "cut", "decompose", corpus / "cuts.jsonl.gz", "{out}/decomposed")
    for name in ("recordings.jsonl.gz", "supervisions.jsonl.gz"):
        _same_manifest(runs, f"decomposed/{name}")
    runs = _both(tmp_path, "cut", "estimate-bucket-bins", "-b", 3, corpus / "trimmed.jsonl")
    assert runs["port"][1].output == runs["jax"][1].output
    runs = _both(tmp_path, "cut", "estimate-bucket-bins", "-b", 2, "-s", 4, corpus / "cuts.jsonl.gz")
    assert runs["port"][1].output == runs["jax"][1].output


def test_cut_trim_to_alignments(corpus, tmp_path):
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.supervision import AlignmentItem

    from lhotse_tpu_torch.utils import fastcopy

    words = [AlignmentItem("a", 0.1, 0.3), AlignmentItem("b", 0.5, 0.2), AlignmentItem("c", 0.75, 0.2)]
    CutSet.from_cuts(
        fastcopy(c, supervisions=[fastcopy(s, alignment={"word": words}) for s in c.supervisions])
        for c in CutSet.from_file(corpus / "cuts.jsonl.gz")).to_file(tmp_path / "aligned.jsonl.gz")
    runs = _both(tmp_path, "cut", "trim-to-alignments", "--max-pause", 0.06, "-d", "_",
                 tmp_path / "aligned.jsonl.gz", "{out}/ta.jsonl.gz")
    trimmed = _same_manifest(runs, "ta.jsonl.gz")
    assert [s["text"] for c in trimmed for s in c["supervisions"]][:2] == ["a", "b_c"]


def test_index_commands(corpus, tmp_path):
    runs = _both(tmp_path, "copy", corpus / "trimmed.jsonl", "{out}/trimmed.jsonl")
    runs = _both(tmp_path, "index", "jsonl", "{out}/trimmed.jsonl")
    for package in ("jax", "port"):
        assert runs[package][1].output == (
            f"Created index: {runs[package][0] / 'trimmed.jsonl.idx'}\n")
    assert (runs["port"][0] / "trimmed.jsonl.idx").read_bytes() == (
        runs["jax"][0] / "trimmed.jsonl.idx").read_bytes()
    _both(tmp_path, "shar", "export", "-a", "wav", "--no-compress-jsonl", "-s", 3,
          corpus / "trimmed.jsonl", "{out}/shar")
    runs = _both(tmp_path, "index", "tar", "-o", "{out}/idx", "{out}/shar/recording.000000.tar")
    assert (runs["port"][0] / "idx/recording.000000.tar.idx").read_bytes() == (
        runs["jax"][0] / "idx/recording.000000.tar.idx").read_bytes()
    runs = _both(tmp_path, "index", "shar", "-o", "{out}/shar_idx", "{out}/shar")
    names = sorted(p.name for p in (runs["port"][0] / "shar_idx").iterdir())
    assert names == sorted(p.name for p in (runs["jax"][0] / "shar_idx").iterdir()) and names
    for name in names:
        assert (runs["port"][0] / "shar_idx" / name).read_bytes() == (
            runs["jax"][0] / "shar_idx" / name).read_bytes()


def test_supervision_with_alignment_from_ctm(corpus, tmp_path):
    (tmp_path / "a.ctm").write_text("utt0 0 0.10 0.40 word0 0.9\nutt0 0 0.55 0.30 again\n"
                                    "utt3 1 0.20 0.50 word3\n")
    for match in ([], ["--match-channel"]):
        runs = _both(tmp_path, "supervision", "with-alignment-from-ctm", "--ctm-file",
                     tmp_path / "a.ctm", *match, corpus / "supervisions.jsonl.gz",
                     "{out}/aligned.jsonl.gz")
        sups = _same_manifest(runs, "aligned.jsonl.gz")
        assert any(s.get("alignment") for s in sups)


def test_prepare_librispeech(tmp_path):
    from lhotse_tpu_torch.audio.flacio import write_flac

    chapter = tmp_path / "LibriSpeech" / "dev-clean" / "100" / "2000"
    chapter.mkdir(parents=True)
    rng = np.random.RandomState(3)
    lines = []
    for u in range(3):
        utt = f"100-2000-{u:04d}"
        write_flac(str(chapter / f"{utt}.flac"), (rng.randn(SR) * 0.1).astype(np.float32), SR)
        lines.append(f"{utt} HELLO WORLD {u}")
    (chapter / "100-2000.trans.txt").write_text("\n".join(lines) + "\n")
    runs = _both(tmp_path, "prepare", "librispeech", "-p", "dev-clean", tmp_path / "LibriSpeech",
                 "{out}/manifests")
    for name in ("librispeech_recordings_dev-clean.jsonl.gz",
                 "librispeech_supervisions_dev-clean.jsonl.gz"):
        assert len(_same_manifest(runs, f"manifests/{name}")) == 3


# -- the commands of the meeting-simulation and sharded-format slice ---------------------


@pytest.mark.parametrize("method,extra", [
    ("independent", []),
    ("conversational", ["--allow-3fold-overlap"]),
    ("conversational", ["-f", "{corpus}/supervisions.jsonl.gz", "--reverberate"]),
])
def test_workflows_simulate_meetings(corpus, tmp_path, method, extra):
    extra = [str(a).replace("{corpus}", str(corpus)) for a in extra]
    runs = _both(tmp_path, "workflows", "simulate-meetings", "-m", method, "-n", 3, "-s", "2",
                 *extra, corpus / "trimmed.jsonl", "{out}/meetings.jsonl", seed=0)
    meetings = _same_manifest(runs, "meetings.jsonl")
    assert len(meetings) == 3 and all(m["type"] == "MixedCut" for m in meetings)
    from lhotse_tpu.cut import CutSet as JCutSet
    from lhotse_tpu_torch.cut import CutSet

    ours = CutSet.from_file(runs["port"][0] / "meetings.jsonl")
    theirs = JCutSet.from_file(runs["jax"][0] / "meetings.jsonl")
    for a, b in zip(ours, theirs):
        assert np.array_equal(a.load_audio(), b.load_audio())


def test_cut_export_to_webdataset(corpus, tmp_path):
    runs = _both(tmp_path, "cut", "export-to-webdataset", "--shard-size", 4,
                 corpus / "trimmed.jsonl", "{out}/shard-%06d.tar")
    names = sorted(p.name for p in runs["port"][0].iterdir())
    assert names == sorted(p.name for p in runs["jax"][0].iterdir()) == [
        "shard-000000.tar", "shard-000001.tar"]
    for name in names:
        assert (runs["port"][0] / name).read_bytes() == (runs["jax"][0] / name).read_bytes()


def test_index_verify_pack(corpus, tmp_path):
    from lhotse_tpu_torch.index_pack import IndexPackCollectionSpec, write_index_pack
    from lhotse_tpu_torch.indexing import create_jsonl_index

    (tmp_path / "src").mkdir()
    paths = []
    for k in range(2):
        path = tmp_path / "src" / f"trimmed-{k}.jsonl"
        lines = (corpus / "trimmed.jsonl").read_text().splitlines(keepends=True)
        path.write_text("".join(lines[k::2]))
        create_jsonl_index(path)
        paths.append(path)
    pack = write_index_pack(tmp_path / "src" / "cuts.idxpack", [IndexPackCollectionSpec(
        role="records", kind="json-lines", source_spec="trimmed-{0..1}.jsonl", paths=paths)])
    runs = _both(tmp_path, "index", "verify-pack", pack)
    assert runs["port"][1].output == runs["jax"][1].output == "OK (2 segments)\n"
    raw = bytearray(pack.read_bytes())
    raw[-5] ^= 0xFF
    pack.write_bytes(bytes(raw))
    runs = _both(tmp_path, "index", "verify-pack", pack)
    assert runs["port"][1].output == runs["jax"][1].output
    assert runs["port"][1].output.startswith("Verification failed: Index-pack CRC mismatch")


# -- the prepare commands of the noise, RIR, meeting and single-stream recipes --------------

def _recipe_cases():
    """(id, the function that writes the corpus layout, the command's
    arguments, the port's function call) for each new ``prepare`` command;
    ``{c}`` in an argument is the corpus, whose layouts are the CPU recipe
    tests'."""
    from lhotse_tpu_torch.recipes import (
        prepare_aishell4, prepare_ali_meeting, prepare_but_reverb_db, prepare_chime6,
        prepare_dipco, prepare_icsi, prepare_libricss, prepare_musan, prepare_notsofar1,
        prepare_rir_noise, prepare_wham)
    from test_torch_recipes_meetings import (
        aishell4_tree, ali_meeting_tree, chime6_tree, dipco_tree, icsi_tree, libricss_tree,
        notsofar1_tree)
    from test_torch_recipes_noise import but_reverb_tree, musan_tree, rir_noise_tree, wham_tree

    return [
        ("musan", lambda r: musan_tree(r, "pool"), ["musan", "{c}"],
         lambda c, o: prepare_musan(c, output_dir=o)),
        ("musan-noise-music-no-vocals", lambda r: musan_tree(r, "tranche6"),
         ["musan", "-p", "noise", "-p", "music", "--no-vocals", "{c}"],
         lambda c, o: prepare_musan(c, output_dir=o, parts=("noise", "music"), use_vocals=False)),
        ("rir-noise", lambda r: rir_noise_tree(r, n_rirs=2), ["rir-noise", "{c}"],
         lambda c, o: prepare_rir_noise(c, output_dir=o)),
        ("rir-noise-real-rir", lambda r: rir_noise_tree(r, n_rirs=2),
         ["rir-noise", "-p", "real_rir", "{c}"],
         lambda c, o: prepare_rir_noise(c, output_dir=o, parts=["real_rir"])),
        ("wham", wham_tree, ["wham", "{c}"], lambda c, o: prepare_wham(c, output_dir=o)),
        ("but-reverb-db", but_reverb_tree, ["but-reverb-db", "{c}"],
         lambda c, o: prepare_but_reverb_db(c, output_dir=o)),
        ("but-reverb-db-rir", but_reverb_tree, ["but-reverb-db", "-p", "rir", "{c}"],
         lambda c, o: prepare_but_reverb_db(c, output_dir=o, parts=["rir"])),
        ("aishell4", lambda r: aishell4_tree(r, "array"), ["aishell4", "--normalize-text", "{c}"],
         lambda c, o: prepare_aishell4(c, output_dir=o, normalize_text=True)),
        ("ali-meeting", ali_meeting_tree, ["ali-meeting", "{c}"],
         lambda c, o: prepare_ali_meeting(c, output_dir=o)),
        ("ali-meeting-near-m2met", ali_meeting_tree,
         ["ali-meeting", "--mic", "near", "--normalize-text", "m2met", "{c}"],
         lambda c, o: prepare_ali_meeting(c, output_dir=o, mic="near", normalize_text="m2met")),
        ("icsi-mdm-save-to-wav", lambda r: icsi_tree(r, "sphere")[0].parent,
         ["icsi", "--transcripts-dir", "{c}/transcripts", "--mic", "mdm", "--save-to-wav",
          "{c}/speech"],
         lambda c, o: prepare_icsi(c / "speech", transcripts_dir=c / "transcripts", output_dir=o,
                                   mic="mdm", save_to_wav=True)),
        ("icsi-ihm", lambda r: icsi_tree(r, "ihm")[0].parent,
         ["icsi", "--transcripts-dir", "{c}/transcripts", "{c}/speech"],
         lambda c, o: prepare_icsi(c / "speech", transcripts_dir=c / "transcripts", output_dir=o)),
        ("notsofar1", lambda r: notsofar1_tree(r, "wide"), ["notsofar1", "{c}"],
         lambda c, o: prepare_notsofar1(c, output_dir=o)),
        ("libricss-ihm-segmented", libricss_tree,
         ["libricss", "--type", "ihm", "--segmented", "{c}"],
         lambda c, o: prepare_libricss(c, output_dir=o, type="ihm", segmented_cuts=True)),
        ("libricss", libricss_tree, ["libricss", "{c}"],
         lambda c, o: prepare_libricss(c, output_dir=o)),
        ("chime6-ihm", chime6_tree, ["chime6", "-p", "dev", "--mic", "ihm", "{c}"],
         lambda c, o: prepare_chime6(c, output_dir=o, dataset_parts=["dev"], mic="ihm")),
        ("chime6-mdm-reference-array", chime6_tree,
         ["chime6", "-p", "dev", "--use-reference-array", "{c}"],
         lambda c, o: prepare_chime6(c, output_dir=o, dataset_parts=["dev"],
                                     use_reference_array=True)),
        ("dipco-ihm-chime7", dipco_tree,
         ["dipco", "--mic", "ihm", "--use-chime7-offset", "{c}"],
         lambda c, o: prepare_dipco(c, output_dir=o, mic="ihm", use_chime7_offset=True)),
    ] + _single_stream_cases()


def _opus_mls_tree(root):
    from lhotse_tpu_torch.audio.syscodecs import opus_available
    from test_torch_recipes_asr import mls_tree

    if not opus_available():
        pytest.skip("the system Opus and Ogg libraries are not present")
    return mls_tree(root, "opus")


def _single_stream_cases():
    """The cases of the single-stream ASR, TTS and speaker recipes, on the
    layouts of tests/test_torch_recipes_asr.py and
    tests/test_torch_recipes_tts.py."""
    from lhotse_tpu_torch.recipes import (
        prepare_aishell, prepare_aishell2, prepare_librilight, prepare_libritts,
        prepare_librittsr, prepare_ljspeech, prepare_mls, prepare_peoples_speech,
        prepare_spgispeech, prepare_tedlium, prepare_tedlium2, prepare_timit, prepare_vctk,
        prepare_voxceleb, prepare_yesno)
    from test_torch_recipes_asr import (
        aishell2_tree, aishell_tree, librilight_tree, mls_tree, peoples_speech_tree,
        spgispeech_tree, tedlium2_tree, tedlium_tree, timit_tree, voxceleb1_tree, yesno_tree)
    from test_torch_recipes_tts import libritts_tree, ljspeech_tree, vctk_tree

    return [
        ("yesno", lambda r: yesno_tree(r, "tranche6"), ["yesno", "{c}"],
         lambda c, o: prepare_yesno(c, output_dir=o)),
        ("aishell", aishell_tree, ["aishell", "{c}"], lambda c, o: prepare_aishell(c, output_dir=o)),
        ("aishell2", aishell2_tree, ["aishell2", "{c}"],
         lambda c, o: prepare_aishell2(c, output_dir=o)),
        ("tedlium-kaldi", tedlium_tree,
         ["tedlium", "-p", "dev", "-p", "test", "--normalize-text", "kaldi", "{c}"],
         lambda c, o: prepare_tedlium(c, output_dir=o, dataset_parts=("dev", "test"),
                                      normalize_text="kaldi")),
        ("tedlium2-upper", lambda r: tedlium2_tree(r, "sphere"),
         ["tedlium2", "--normalize-text", "upper", "{c}"],
         lambda c, o: prepare_tedlium2(c, output_dir=o, normalize_text="upper")),
        ("libritts-linked", lambda r: libritts_tree(r, "slice", n_chapters=2),
         ["libritts", "-p", "dev-clean", "--link-previous-utt", "{c}"],
         lambda c, o: prepare_libritts(c, output_dir=o, dataset_parts="dev-clean",
                                       link_previous_utt=True)),
        ("librittsr", lambda r: libritts_tree(r, "slice", n_chapters=2),
         ["librittsr", "-p", "dev-clean", "-p", "test-clean", "{c}"],
         lambda c, o: prepare_librittsr(c, output_dir=o, dataset_parts=("dev-clean", "test-clean"))),
        ("librilight", librilight_tree, ["librilight", "{c}"],
         lambda c, o: prepare_librilight(c, output_dir=o)),
        ("mls-flac", lambda r: mls_tree(r, "flac"), ["mls", "--flac", "{c}"],
         lambda c, o: prepare_mls(c, output_dir=o, opus=False)),
        ("mls-opus", _opus_mls_tree, ["mls", "{c}"], lambda c, o: prepare_mls(c, output_dir=o)),
        ("peoples-speech", peoples_speech_tree, ["peoples-speech", "{c}"],
         lambda c, o: prepare_peoples_speech(c, output_dir=o)),
        ("spgispeech-raw", spgispeech_tree, ["spgispeech", "--no-normalize-text", "{c}"],
         lambda c, o: prepare_spgispeech(c, o, normalize_text=False)),
        ("ljspeech", lambda r: ljspeech_tree(r, "tranche9"), ["ljspeech", "{c}"],
         lambda c, o: prepare_ljspeech(c, output_dir=o)),
        ("vctk-0.92-mic1", lambda r: vctk_tree(r, "0.92"),
         ["vctk", "--use-edinburgh-vctk-url", "--mic-id", "mic1", "{c}"],
         lambda c, o: prepare_vctk(c, output_dir=o, use_edinburgh_vctk_url=True, mic_id="mic1")),
        ("timit-39", lambda r: timit_tree(r, "tranche7"), ["timit", "-p", "39", "{c}"],
         lambda c, o: prepare_timit(c, output_dir=o, num_phones=39)),
        ("voxceleb1-trials", lambda r: voxceleb1_tree(r)[0],
         ["voxceleb", "--voxceleb1", "{c}", "--trials-path", "{c}/trials.txt"],
         lambda c, o: prepare_voxceleb(voxceleb1_root=c, trials_path=c / "trials.txt",
                                       output_dir=o)),
    ]


RECIPE_CASES = {case[0]: case for case in _recipe_cases()}


@pytest.mark.parametrize("name", sorted(RECIPE_CASES))
def test_prepare_recipe_command_writes_what_its_function_writes(tmp_path, name):
    """Each new ``prepare`` command writes the manifests its function writes,
    and the JAX CLI's, compared as dicts with the output directory replaced.
    The one exception is LibriCSS's segments, which the JAX package leaves
    empty (tests/test_torch_recipes_meetings.py::test_libricss_segments_where_jax_finds_none)."""
    import gzip

    from lhotse_tpu_torch.utils import fix_random_seed

    _, build, args, function = RECIPE_CASES[name]
    corpus = build(tmp_path / "corpus")
    runs = _both(tmp_path, "prepare", *[a.replace("{c}", str(corpus)) for a in args], "{out}",
                 seed=0)
    fix_random_seed(0)  # the CLI's -s 0: LibriCSS segments take uuid4 ids
    function(corpus, tmp_path / "function")
    (pout, _), (jout, _) = runs["port"], runs["jax"]
    names = sorted(p.name for p in pout.glob("*.jsonl.gz"))
    assert names and names == sorted(p.name for p in (tmp_path / "function").glob("*.jsonl.gz"))
    for name_ in names:
        ours = _normalized(pout / name_, pout)
        assert ours and _normalized(tmp_path / "function" / name_, tmp_path / "function") == ours
        if name_.endswith("_segments_all.jsonl.gz"):
            assert gzip.decompress((jout / name_).read_bytes()) == b""
        else:
            assert _normalized(jout / name_, jout) == ours


def test_prepare_chime6_array_sync_stops_as_not_ported(tmp_path):
    from test_torch_recipes_meetings import chime6_tree

    corpus = chime6_tree(tmp_path / "corpus")
    for flag in ("--perform-array-sync", "--verify-md5-checksums"):
        res = CliRunner().invoke(_cli("port"), ["prepare", "chime6", "-p", "dev", flag,
                                                str(corpus), str(tmp_path / "out")])
        assert res.exit_code != 0 and isinstance(res.exception, NotImplementedError)
