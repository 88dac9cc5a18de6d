"""
The port's CSJ recipe (``lhotse_tpu_torch/recipes/csj.py``) against the JAX
package's: the SDB word and segment model, the disfluency-tag parser with
its ``DECISIONS``, the linking of tags that span segments, the transcript
directory that ``prepare_csj`` builds (dialogue sessions split into L and R
channels, the eval, valid and excluded sessions moved, a ``-trans.txt``
beside each SDB), the manifests, cached re-runs, ``concat_csj_supervisions``,
the errors on broken layouts and the ``prepare csj`` command through both
CLIs. The layouts: tests/test_recipes_tranche3.py:897 and
tests/test_refdiff_recipes.py:1935 (one lecture in ``core``, no transcript
directory), and a wider corpus of Shift-JIS SDBs made from a numpy seed with
eleven sessions over both volumes and every part, two of them dialogues.
"""
import shutil

import numpy as np
import pytest

from lhotse_tpu.audio.wavio import write_wav
from lhotse_tpu.recipes import csj as jcsj
from lhotse_tpu_torch.recipes import csj as pcsj
from test_torch_recipes_asr import _dicts
from test_torch_recipes_overlap import _files

SR = 16000
# (surface, pronunciation, part of speech) of the words the sessions draw.
WORDS = [("それ", "ソレ", "代名詞"), ("は", "ワ", "助詞"), ("です", "デス", "助動詞"),
         ("日本", "ニッポン", "名詞"), ("語", "ゴ", "接尾辞"), ("話し", "ハナシ", "動詞"),
         ("ます", "マス", "助動詞"), ("んー", "ンー", "感動詞"), ("研究", "ケンキュー", "名詞"),
         ("<H>", "<H>", "記号"), ("Ａ型", "エーガタ", "名詞"), ("一・", "イチ", "数詞")]
TAGGED = [("(F えー)", "(F エー)", "感動詞"), ("(D ど)", "(D ド)", "言いよどみ"),
          ("(W アタシ;ワタシ)", "(W アタシ;ワタシ)", "代名詞"),
          ("(A 百;１００)", "(A ヒャク;イチゼロゼロ)", "数詞"),
          ("(A ＡＢＣ;エービーシー)", "(A エービーシー;エービーシー)", "名詞"),
          ("(? はい)", "(? ハイ)", "感動詞"), ("(? はい,ええ)", "(? ハイ,エー)", "感動詞"),
          ("(笑 そう)", "(笑 ソー)", "副詞"), ("(K て;テ)", "(K テ;テ)", "助詞"),
          ("(F (D あ)の)", "(F (D ア)ノ)", "感動詞"), ("(B だ)", "(B ダ)", "助動詞")]
SESSIONS = {
    # session id: (volume, the part it ends in)
    "A01M0110": ("core", "eval1"), "A01M0056": ("core", "eval2"), "S00M0112": ("core", "eval3"),
    "S05M0613": ("noncore", "excluded"), "D01M0019": ("core", "excluded"),
    "A01M0264": ("core", "valid"), "D03F0058": ("core", "valid"), "A01M0007": ("core", "core"),
    "D02F0001": ("core", "core"), "S01F0151": ("noncore", "noncore"),
    "R01M0002": ("noncore", "noncore"),
}
SECONDS = 8.0


def _sig(seconds, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(1, int(seconds * SR)) * 0.1).astype(np.float32)


def sdb_row(sgid, start, end, surface, pron, spkid="A01M0007", side="L", pos="感動詞"):
    """tests/test_recipes_tranche3.py:903's row of 17 tab-separated columns,
    with the part of speech and the morphology columns filled."""
    cols = [""] * 17
    cols[0], cols[1], cols[2] = "0001", "x", spkid
    cols[3] = f"{sgid} {start}-{end} {side}:x"
    cols[5], cols[10], cols[11] = surface, pron, pos
    cols[12], cols[14], cols[15] = "連用形", "一般", "サ変"
    return "\t".join(cols)


def _segments(rng, spkid, side, t, n=4, specials=()):
    """``n`` segments of 2-4 words from ``t`` on, each word 0.1-0.3 s; the
    ``specials`` replace the words of the segment they name. Returns the
    rows and the time after the last word."""
    rows = []
    for s in range(n):
        sgid = f"{s + 1:04d}" if side == "L" else f"{s + 51:04d}"
        words = [WORDS[i] if rng.rand() < 0.6 else TAGGED[rng.randint(len(TAGGED))]
                 for i in rng.randint(0, len(WORDS), rng.randint(2, 5))]
        words = dict(specials).get(s, words)
        for surface, pron, pos in words:
            dur = float(rng.uniform(0.1, 0.3))
            rows.append((t, sdb_row(sgid, f"{t:.3f}", f"{t + dur:.3f}", surface, pron, spkid,
                                    side, pos)))
            t += dur
        t += float(rng.uniform(0.1, 0.3))
    return rows, t


# Segments whose words open a tag that the next segment closes: R links
# (unlinked, the segments stay apart) and F (the segments are joined).
SPANNING_R = {1: [("研究", "ケンキュー", "名詞"), ("(R 山", "(R ヤマ", "名詞")],
              2: [("田)", "ダ)", "名詞"), ("です", "デス", "助動詞")]}
SPANNING_F = {0: [("(F え", "(F エ", "感動詞")], 1: [("ー)", "ー)", "感動詞"), ("は", "ワ", "助詞")]}
CROSSED = {2: [("×", "×", "記号"), ("それ", "ソレ", "代名詞")]}


def csj_tree(root, layout="tranche3", seed=0):
    """``tranche3``: tests/test_recipes_tranche3.py:897 and
    tests/test_refdiff_recipes.py:1935 (the 10 s lecture A01M0007, two
    segments, an F tag); ``wide``: the eleven sessions of ``SESSIONS`` (two dialogues
    with an L and an R wav each, the rest lectures), 8 s of audio each,
    four segments of tagged and plain words per side, segments linked by
    R and F tags that span them and a segment with ``×``, written in
    Shift-JIS; ``lectures``: ``wide`` without its dialogues, which need a
    transcript directory."""
    if layout == "tranche3":
        vol = root / "MORPH" / "SDB" / "core"
        vol.mkdir(parents=True)
        (root / "WAV" / "core").mkdir(parents=True)
        write_wav(root / "WAV" / "core" / "A01M0007.wav", _sig(10.0, 71), SR)
        (vol / "A01M0007.sdb").write_text(
            sdb_row("0001", "0.5", "1.2", "(F_えー)", "(F_エー)") + "\n"
            + sdb_row("0001", "0.5", "1.2", "それ", "ソレ") + "\n"
            + sdb_row("0002", "2.0", "3.0", "はい", "ハイ") + "\n", encoding="shift_jis")
        return root
    rng = np.random.RandomState(seed)
    for k, (session, (vol, _)) in enumerate(SESSIONS.items()):
        if layout == "lectures" and session[0] == "D":
            continue
        sdb_dir, wav_dir = root / "MORPH" / "SDB" / vol, root / "WAV" / vol
        sdb_dir.mkdir(parents=True, exist_ok=True)
        wav_dir.mkdir(parents=True, exist_ok=True)
        specials = {"A01M0007": SPANNING_R, "S01F0151": SPANNING_F, "D02F0001": CROSSED,
                    "A01M0264": CROSSED}.get(session, {})
        if session[0] == "D":
            left, _ = _segments(rng, session, "L", 0.2, specials=specials)
            right, _ = _segments(rng, session, "R", 0.35)
            rows = [r for _, r in sorted(left + right, key=lambda x: x[0])]
            for side, offset in (("L", 0), ("R", 1)):
                write_wav(wav_dir / f"{session}-{side}.wav", _sig(SECONDS, 900 + 2 * k + offset),
                          SR)
        else:
            rows = [r for _, r in _segments(rng, session, "L", 0.3, specials=specials)[0]]
            write_wav(wav_dir / f"{session}.wav", _sig(SECONDS, 900 + 2 * k), SR)
        (sdb_dir / f"{session}.sdb").write_text("\n".join(rows) + "\n", encoding="shift_jis")
    return root


def _prepare_both(tmp_path, root, transcript=True, **kwargs):
    """Each package's ``prepare_csj`` into its own manifest directory (and
    transcript directory); returns both returns."""
    made = {}
    for pkg, module in (("port", pcsj), ("jax", jcsj)):
        out = tmp_path / pkg
        made[pkg] = module.prepare_csj(
            root, transcript_dir=out / "trans" if transcript else None,
            manifest_dir=out / "manifests", **kwargs)
    return made["port"], made["jax"]


CASES = {
    "tranche3": ("tranche3", False, {"dataset_parts": ["core"]}),
    "lectures": ("lectures", False, {}),
    "lectures-core-as-str": ("lectures", False, {"dataset_parts": "core"}),
    "wide": ("wide", True, {}),
    "wide-two-parts": ("wide", True, {"dataset_parts": ["valid", "excluded"], "nj": 4}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_prepare_csj_equals_jax(tmp_path, case):
    """The returned manifests, every manifest written and, with a transcript
    directory, every file of it (the split dialogue SDBs, the wav lists,
    the moved sessions and the ``-trans.txt`` beside each SDB) are equal."""
    layout, transcript, kwargs = CASES[case]
    root = csj_tree(tmp_path / "corpus", layout)
    ours, theirs = _prepare_both(tmp_path, root, transcript, **kwargs)
    assert _dicts(ours) == _dicts(theirs)
    assert all(len(part["supervisions"]) > 0 for part in ours.values())
    written = _files(tmp_path / "port")
    assert written and written == _files(tmp_path / "jax")
    if transcript:
        names = set(written)
        assert "trans/excluded/D01M0019/D01M0019-R.sdb" in names
        assert "trans/valid/D03F0058/D03F0058-L-trans.txt" in names
        assert "trans/.done_mv" in names and not any(n.startswith("trans/noncore/S05") for n in names)


def test_csj_as_the_jax_test_expects(tmp_path):
    root = csj_tree(tmp_path / "corpus")
    m = pcsj.prepare_csj(root, dataset_parts=["core"], manifest_dir=tmp_path / "out")
    sups = sorted(m["core"]["supervisions"], key=lambda s: s.start)
    assert len(sups) == 2
    assert sups[0].text == "えーそれ"
    assert sups[0].custom["disfluent_tag"].startswith("F,F")
    assert sups[0].gender == "Male"
    assert sups[1].text == "はい"


def test_wide_corpus_holds_what_it_should(tmp_path):
    """The dialogues' sides are recordings of their own with their own
    speakers; the R link leaves its segments apart and the F link joins
    them; every part is filled."""
    root = csj_tree(tmp_path / "corpus", "wide")
    m = pcsj.prepare_csj(root, transcript_dir=tmp_path / "trans", manifest_dir=tmp_path / "m")
    assert set(m) == set(pcsj._FULL_DATA_PARTS)
    assert {r.id for r in m["core"]["recordings"]} == {"A01M0007", "D02F0001-L", "D02F0001-R"}
    assert {s.speaker for s in m["valid"]["supervisions"]} == {
        "A01M0264", "D03F0058-L", "D03F0058-R"}
    raw = [s.custom["raw"] for s in m["core"]["supervisions"] if s.recording_id == "A01M0007"]
    assert len(raw) == 4 and "(R" not in "".join(raw)
    texts = [s.text for s in m["noncore"]["supervisions"] if s.recording_id == "S01F0151"]
    assert len(texts) == 3 and texts[0].startswith("え")
    assert all(s.gender == ("Male" if s.recording_id[3] == "M" else "Female")
               for part in m.values() for s in part["supervisions"])


@pytest.mark.parametrize("transcript", [False, True])
def test_cached_rerun_equals_the_first_run(tmp_path, transcript):
    """A second call reads every part back from the manifest directory (and
    leaves a finished transcript directory as it is), in both packages."""
    root = csj_tree(tmp_path / "corpus", "wide" if transcript else "lectures")
    first = _prepare_both(tmp_path, root, transcript)
    files = _files(tmp_path / "port")
    again = _prepare_both(tmp_path, root, transcript)
    assert _dicts(again[0]) == _dicts(again[1]) == _dicts(first[0]) == _dicts(first[1])
    assert _files(tmp_path / "port") == files == _files(tmp_path / "jax")


@pytest.mark.parametrize("gap,maxlen,extend", [
    (0.5, 10.0, 0.0), (0.05, 10.0, 0.0), (0.5, 1.0, 0.0), (0.2, 2.5, 0.1), (10.0, 100.0, 0.5)])
def test_concat_csj_supervisions_equals_jax(tmp_path, gap, maxlen, extend):
    root = csj_tree(tmp_path / "corpus", "wide")
    ours, theirs = _prepare_both(tmp_path, root, True, dataset_parts=["core", "valid"])
    for part in ("core", "valid"):
        a = pcsj.concat_csj_supervisions(ours[part]["supervisions"], gap, maxlen, extend)
        b = jcsj.concat_csj_supervisions(theirs[part]["supervisions"], gap, maxlen, extend)
        assert [s.to_dict() for s in a] == [s.to_dict() for s in b] and len(a) > 0
        assert _dicts(ours[part]) == _dicts(theirs[part])  # the input is left as it was


PARSER_TEXTS = [
    "(F_えー)+感動詞+(F_エー) それ+代名詞+ソレ", "(W_アタシ;ワタシ)+代名詞+X",
    "(F_えー)+感動詞+X それ+代名詞+X", "(A_百;１００)+数詞+X", "(A_ＡＢＣ;エービーシー)+名詞+X",
    "(?_はい,ええ)+感動詞+X", "(笑_そう)+副詞+X", "(F_(D_あ)の)+感動詞+X", "(K_て;テ)+助詞+X",
    "(D2_ど)+x+X", "(X_ばつ)+x+X (L_ええ)+x+X (O_おけ)+x+X (M_む)+x+X", "plain+x+X text+y+Y",
    "(泣_ない)+x+X (咳_ごほ)+x+X", "un(closed+x+X", "x)+y+Z", "", "(F_)+x+X"]


def _outcome(fn, *args, **kwargs):
    """What a call returns, or the type and message of what it raises."""
    try:
        return fn(*args, **kwargs)
    except Exception as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("text", PARSER_TEXTS)
def test_parser_equals_jax(text):
    """The parse of each text, with and without tags, at three separators,
    is JAX's (ASCII letters are tag names to the parser, so a bare ASCII
    word before a closing bracket is an unknown tag in both packages)."""
    ours, theirs = pcsj.CSJSDBParser(), jcsj.CSJSDBParser()
    for sep in ("", " ", "_"):
        for with_tags in (False, True):
            assert _outcome(ours.parse, text, sep=sep, with_tags=with_tags) == _outcome(
                theirs.parse, text, sep=sep, with_tags=with_tags)


def test_parser_as_the_jax_test_expects_and_its_errors():
    parser = pcsj.CSJSDBParser()
    assert parser.parse("(F_えー)+感動詞+(F_エー) それ+代名詞+ソレ", sep="") == "えーそれ"
    assert parser.parse("(W_アタシ;ワタシ)+代名詞+X", sep="") == "ワタシ"
    chars, tags = zip(*parser.parse("(F_えー)+感動詞+X それ+代名詞+X", sep="", with_tags=True))
    assert "".join(chars) == "えーそれ" and tags[0] == "F" and tags[-1] == ""
    assert pcsj.DECISIONS == jcsj.DECISIONS and pcsj.CSJSDBParser.JPN_NUM == jcsj.CSJSDBParser.JPN_NUM
    for module in (pcsj, jcsj):
        with pytest.raises(NotImplementedError, match="Unknown tag Z"):
            module.CSJSDBParser().parse("(Z_x)+a+B")
        with pytest.raises(Exception, match="cannot be resolved"):
            module.CSJSDBParser({"F": "both"}).parse("(F_え)+a+B")
    pron = lambda text: " ".join(w.split("+")[-1] for w in text.split(" "))  # noqa: E731
    assert pcsj.CSJSDBParser(preprocess=pron).parse("(F_え)+a+(F_エ) b+c+ド") == \
        jcsj.CSJSDBParser(preprocess=pron).parse("(F_え)+a+(F_エ) b+c+ド") == "エド"


def test_sdb_model_equals_jax(tmp_path):
    """Words from rows (the elongation, marker and morphology clean-up, the
    dialogue side in the speaker), segments to and from lines, and
    ``_read_one_sdb`` over every SDB of the wide corpus."""
    rng = np.random.RandomState(3)
    rows, _ = _segments(rng, "D09M0001", "R", 0.5, n=6)
    rows += _segments(rng, "A09F0001", "L", 0.5, n=6)[0]
    for _, row in rows + [(0, sdb_row("0001", "0.5", "1.0", "ん ー<H>・", "<PLx>ン ー"))]:
        a, b = pcsj._CSJSDBWord.from_line(row), jcsj._CSJSDBWord.from_line(row)
        assert vars(a) == vars(b) and repr(a) == repr(b) and bool(a) == bool(b)
    root = csj_tree(tmp_path / "corpus", "wide")
    for sdb in sorted(root.rglob("*.sdb")):
        if sdb.name.startswith("D"):
            continue  # a dialogue SDB is read once split into its sides
        ours, theirs = pcsj._read_one_sdb(sdb), jcsj._read_one_sdb(sdb)
        assert [s.to_line() for s in ours] == [s.to_line() for s in theirs] and ours
        for seg in ours:
            back = pcsj._CSJSDBSegment.from_line(seg.to_line())
            assert back.to_line() == jcsj._CSJSDBSegment.from_line(seg.to_line()).to_line()
            assert seg.verify_line() == jcsj._CSJSDBSegment.from_line(seg.to_line()).verify_line()


def test_move_sessions_equals_jax(tmp_path):
    """``_move_sessions`` on two copies of one tree: the same files in the
    same places, the emptied session directories removed."""
    for pkg, module in (("port", pcsj), ("jax", jcsj)):
        trans = tmp_path / pkg
        for vol, session in (("core", "A01M0110"), ("noncore", "S00M0112"), ("core", "A01M0007")):
            d = trans / vol / session
            d.mkdir(parents=True)
            for name in (f"{session}.sdb", f"{session}-wav.list", f"{session}-trans.txt"):
                (d / name).write_text(name)
        module._move_sessions(trans, ["A01M0110", "S00M0112", "X00M0000"], "eval9")
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert sorted(p.name for p in (tmp_path / "port" / "eval9").iterdir()) == ["A01M0110", "S00M0112"]
    assert not (tmp_path / "port" / "core" / "A01M0110").exists()


def _without(root, rel):
    path = root / rel
    shutil.rmtree(path) if path.is_dir() else path.unlink()


BROKEN = {
    "no-corpus": ("wide", True, lambda r: _without(r, "")),
    "lecture-without-wav": ("wide", True, lambda r: _without(r, "WAV/noncore/R01M0002.wav")),
    "dialogue-without-its-right-side": ("wide", True, lambda r: _without(r, "WAV/core/D02F0001-R.wav")),
    "no-transcript-dir-and-a-dialogue": ("wide", False, None),
    "no-transcript-dir-and-no-wav": ("lectures", False, lambda r: _without(r, "WAV/core/A01M0007.wav")),
    "tranche3-default-parts": ("tranche3", False, None),
}


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_refuses_as_jax(tmp_path, case):
    """Both packages raise the same error on a broken corpus."""
    layout, transcript, breaker = BROKEN[case]
    root = csj_tree(tmp_path / "corpus", layout)
    if breaker is not None:
        breaker(root)
    errors = []
    for pkg, module in (("port", pcsj), ("jax", jcsj)):
        out = tmp_path / pkg
        with pytest.raises(Exception) as info:
            module.prepare_csj(root, transcript_dir=out / "trans" if transcript else None,
                               manifest_dir=out / "manifests")
        errors.append((type(info.value).__name__, str(info.value).replace(str(out), "<out>")))
    assert errors[0] == errors[1]


def test_prepare_manifests_refuses_a_missing_transcript_dir_as_jax(tmp_path):
    for module in (pcsj, jcsj):
        with pytest.raises(AssertionError, match="No such directory for transcript_dir"):
            module.prepare_manifests(tmp_path / "nowhere")


def test_prepare_command_writes_what_its_function_writes(tmp_path):
    """``prepare csj`` with a transcript directory inside the output
    directory writes the files ``prepare_csj`` writes, and the JAX CLI's
    command the same, with the output directory replaced."""
    from test_torch_cli import _both as both_clis

    root = csj_tree(tmp_path / "corpus", "wide")
    runs = both_clis(tmp_path, "prepare", "csj", root, "{out}", "-t", "{out}/trans", "-j", "2")
    pcsj.prepare_csj(root, transcript_dir=tmp_path / "function" / "trans",
                     manifest_dir=tmp_path / "function", nj=2)
    (pout, _), (jout, _) = runs["port"], runs["jax"]
    ours = _files(pout)
    assert ours and ours == _files(tmp_path / "function") == _files(jout)
    assert sum(n.startswith("csj_supervisions_") for n in ours) == 7
