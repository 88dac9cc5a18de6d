"""
The port's package namespaces (ROADMAP C3) against the JAX package's: every
name that a JAX package's ``__init__`` exports (its imports, the ``__all__``
of its star imports, and its own ``__all__``) resolves on the port's package
of the same path, except the names of ``NOT_PORTED``; the port's ``__all__``
lists the JAX ``__all__`` minus those names; and ``NOT_PORTED`` stays true:
each of its names is exported by JAX and defined nowhere in the port, so a
name that gets ported must leave the list. The JAX exports are read with
``ast``, so the test imports no JAX package.
"""
import ast
import importlib
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

# The names each JAX package exports that the port does not have yet, by
# package path ("" is the top level), each with its reason: video (it needs
# a video decoder neither machine has), openSMILE and S3PRL (their packages
# and weights), every recipe download (A6: the network), and the Whisper,
# DNSMOS and forced-alignment workflows (weights; forced alignment is A8).
# The storage and I/O backends of A5 and the leftovers of A7 are ported.
NOT_PORTED = {
    "": """
        OpenSmileConfig OpenSmileExtractor S3PRLSSL S3PRLSSLConfig
    """,
    "audio": """
        VideoMixer suppress_video_loading_errors
    """,
    "bin.modes.recipes": """
        adept_dl aishell3_dl aishell4_dl ali_meeting_dl audio_mnist_dl chime6_dl cmu_arctic_dl
        daily_talk_dl dipco_dl earnings21_dl ears_dl heroico_dl hifitts_dl libricss_dl
        librilight_dl mdcc_dl mobvoihotwords_dl rir_noise_dl speechcommands_dl tedlium2_dl
        voxconverse_dl voxpopuli_dl wham_dl
    """,
    "dataset": """
        UnsupervisedAudioVideoDataset collate_video
    """,
    "features": """
        OpenSmileConfig OpenSmileExtractor S3PRLSSL S3PRLSSLConfig
    """,
    "recipes": """
        download_adept download_aidatatang_200zh download_aishell download_aishell3
        download_aishell4 download_ali_meeting download_ami download_and_untar download_atcosim
        download_audio_mnist download_baker_zh download_but_reverb_db download_bvcc download_chime6
        download_cmu_arctic download_cmu_indic download_commonvoice download_daily_talk
        download_dipco download_earnings21 download_earnings22 download_ears download_edacc
        download_fleurs download_gigaspeech download_gigast download_grid download_heroico
        download_hifitts download_himia download_icsi download_libricss download_librimix
        download_librimix_mini download_librispeechmix download_libritts download_librittsr
        download_ljspeech download_magicdata download_mdcc download_medical download_mgb2
        download_mobvoihotwords download_mtedx download_musan download_notsofar1
        download_oto_speech download_primewords download_reazonspeech download_rir_noise
        download_sbcsae download_spatial_librispeech download_speechcommands download_spgispeech
        download_stcmds download_tedlium download_tedlium2 download_thchs_30
        download_this_american_life download_timit download_uwb_atcc download_vctk
        download_voxceleb1 download_voxceleb2 download_voxconverse download_voxpopuli download_wham
        download_xbmu_amdo31 download_yesno
    """,
    "workflows": """
        FailedToAlign ForcedAligner TransformersForcedAligner align_supervisions
        align_with_torchaudio annotate_dnsmos annotate_with_whisper
    """,
}
# JAX subpackages with no counterpart in the port: forced alignment (A8).
NOT_PORTED_PACKAGES = ("workflows.forced_alignment",)


def _module_file(module: str) -> Path:
    path = ROOT / (module.replace(".", "/") + ".py")
    return path if path.exists() else ROOT / module.replace(".", "/") / "__init__.py"


def _all_of(tree: ast.Module):
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            try:
                return set(ast.literal_eval(node.value))
            except ValueError:  # __all__ = [...] + list(...): its literal part only
                return {n.value for n in ast.walk(node.value) if isinstance(n, ast.Constant)
                        and isinstance(n.value, str)}
    return set()


def _jax_exports(package: str) -> tuple:
    """(every exported name, the names of ``__all__``) of a JAX package."""
    tree = ast.parse(_module_file(package).read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            module = node.module if node.level == 0 else f"{package}.{node.module or ''}"
            for alias in node.names:
                if alias.name == "*":
                    names |= _all_of(ast.parse(_module_file(module).read_text()))
                elif not (alias.asname or alias.name).startswith("_"):
                    names.add(alias.asname or alias.name)
    declared = _all_of(tree)
    return names | declared, declared


def _packages() -> list:
    found = sorted(str(p.parent.relative_to(ROOT / "lhotse_tpu")).replace("/", ".")
                   for p in (ROOT / "lhotse_tpu").rglob("__init__.py"))
    return ["" if p == "." else p for p in found]


def _port_definitions() -> set:
    defined = set()
    for path in (ROOT / "lhotse_tpu_torch").rglob("*.py"):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                defined.add(node.name)
            elif isinstance(node, ast.Assign):
                defined |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        if path.name == "__init__.py":
            defined.add(path.parent.name)
        else:
            defined.add(path.stem)
    return defined


def _name(package: str, prefix: str) -> str:
    return f"{prefix}.{package}" if package else prefix


PORTED_PACKAGES = [p for p in _packages()
                   if not p.startswith(NOT_PORTED_PACKAGES)]


@pytest.mark.parametrize("package", PORTED_PACKAGES, ids=lambda p: p or "top")
def test_port_exports_what_jax_exports(package):
    port = importlib.import_module(_name(package, "lhotse_tpu_torch"))
    exported, declared = _jax_exports(_name(package, "lhotse_tpu"))
    skip = set(NOT_PORTED.get(package, "").split())
    missing = sorted(n for n in exported - skip if not hasattr(port, n))
    assert not missing, f"{_name(package, 'lhotse_tpu_torch')} lacks {missing}"
    if declared - skip:
        unlisted = sorted(declared - skip - set(getattr(port, "__all__", ())))
        assert not unlisted, f"{_name(package, 'lhotse_tpu_torch')}.__all__ lacks {unlisted}"


def test_not_ported_names_are_exported_by_jax_and_absent_from_the_port():
    defined = _port_definitions()
    for package, names in NOT_PORTED.items():
        exported, _ = _jax_exports(_name(package, "lhotse_tpu"))
        port = importlib.import_module(_name(package, "lhotse_tpu_torch"))
        for name in names.split():
            assert name in exported, f"{package}: {name} is not a JAX export"
            assert name not in defined, f"{package}: {name} is ported; take it off NOT_PORTED"
            assert not hasattr(port, name), f"{package}: {name} resolves on the port"


@pytest.mark.parametrize("package", NOT_PORTED_PACKAGES)
def test_packages_not_ported(package):
    assert importlib.util.find_spec(_name(package.split(".")[0], "lhotse_tpu")) is not None
    assert importlib.util.find_spec(_name(package, "lhotse_tpu_torch")) is None


def test_top_level_names_are_the_port_s_own():
    """The top level resolves lazily to the port's objects: the same objects
    as their home modules, and a name it does not export raises."""
    import lhotse_tpu_torch as port
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.features.kaldi.extractors import Fbank

    assert port.CutSet is CutSet and port.Fbank is Fbank
    assert port.dataset.__name__ == "lhotse_tpu_torch.dataset"
    assert {"CutSet", "Fbank", "load_manifest", "dataset"} <= set(dir(port))
    with pytest.raises(AttributeError):
        port.not_a_name
    assert port.dataset.signal_transforms.GlobalMVN is port.dataset.GlobalMVN
    with pytest.raises(AttributeError):
        port.dataset.not_a_name
