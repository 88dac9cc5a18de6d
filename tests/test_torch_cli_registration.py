"""
The port's command tree (``lhotse_tpu_torch.bin.modes.cli``) against the
JAX package's: every port command parses ``--help``, and the port registers
exactly the JAX package's commands minus the ones named below as left out
and the ``prepare``/``download`` commands of the recipes the port lacks. A
command added to one CLI and not to the other fails here.
"""
import click
import pytest
from click.testing import CliRunner

from lhotse_tpu_torch.bin.modes import cli

# Each left-out command with the ROADMAP.md item it waits for.
LEFT_OUT = {
    "copy-feats": "A7 (Cut.copy_feats)",
    "feat.upload": "A7 (the lilcom_url storage backend)",
    "workflows.activity-detection": "A7 (the energy VAD workflow)",
    "workflows.annotate-with-whisper": "weights (Whisper)",
    "workflows.annotate-dnsmos": "weights (DNSMOS)",
    "workflows.align-with-torchaudio": "weights (torchaudio alignment)",
    "install-sph2pipe": "the network (the command is a download)",
}
# The recipes whose prepare command the port registers; their downloads
# are left out with every other download.
# MDCC's command is registered twice, as "MDCC" and "mdcc", as in JAX.
PORTED_RECIPES = {
    "MDCC", "aidatatang-200zh", "aishell", "aishell2", "aishell3", "aishell4", "ali-meeting",
    "ami", "babel", "baker-zh", "bengaliai-speech", "broadcast-news", "but-reverb-db", "bvcc",
    "callhome-egyptian", "callhome-english", "cdsd", "chime6", "commonvoice", "csj", "dihard3",
    "dipco", "earnings21", "earnings22", "emilia", "eval2000", "fisher-english",
    "fisher-spanish", "gale-arabic", "gale-mandarin", "gigaspeech2", "gigast", "heroico",
    "icmcasr", "icsi", "iwslt22-ta", "kespeech", "ksponspeech", "libricss", "librilight",
    "librimix", "librimix-mini", "librispeech", "librispeechmix", "libritts", "librittsr",
    "ljspeech", "magicdata", "mdcc", "mgb2", "mls", "mtedx", "musan", "must-c", "notsofar1",
    "nsc", "peoples-speech", "primewords", "reazonspeech", "rir-noise", "spatial-librispeech",
    "speechio", "spgispeech", "stcmds", "switchboard", "tal-asr", "tal-csasr", "tedlium",
    "tedlium2", "thchs-30", "timit", "vctk", "voxceleb", "voxconverse", "voxpopuli",
    "wenetspeech4tts", "wham", "xbmu-amdo31", "yesno"}


def _walk(cmd, prefix=()):
    yield prefix, cmd
    if isinstance(cmd, click.Group):
        for name in cmd.commands:
            yield from _walk(cmd.commands[name], prefix + (name,))


def _tree(root):
    return {".".join(p): isinstance(c, click.Group) for p, c in _walk(root) if p}


PORT_COMMANDS = [n for n, group in sorted(_tree(cli).items()) if not group]


def test_command_tree_equals_jax_minus_the_left_out():
    from lhotse_tpu.bin.modes import cli as jax_cli

    theirs, ours = _tree(jax_cli), _tree(cli)
    expected = {
        name: group for name, group in theirs.items()
        if name not in LEFT_OUT
        and not name.startswith("download.")
        and not (name.startswith("prepare.") and name.split(".")[1] not in PORTED_RECIPES)
    }
    assert ours == expected
    assert set(LEFT_OUT) <= set(theirs)
    leaves = [n for n, group in ours.items() if not group]
    assert len([n for n in leaves if not n.startswith("prepare.")]) == 41
    assert sorted(n for n in leaves if n.startswith("prepare.")) == [
        f"prepare.{r}" for r in sorted(PORTED_RECIPES)]


@pytest.mark.parametrize("path", ["<root>"] + [n for n, _ in sorted(_tree(cli).items())])
def test_every_command_parses_help(path):
    res = CliRunner().invoke(cli, ([] if path == "<root>" else path.split(".")) + ["--help"])
    assert res.exit_code == 0, f"{path}: {res.output[-300:]}"
    assert "Usage:" in res.output


@pytest.mark.parametrize("path", PORT_COMMANDS)
def test_help_matches_jax(path):
    """Each ported command takes the JAX command's parameters."""
    from lhotse_tpu.bin.modes import cli as jax_cli

    def params(root):
        cmd = root
        for part in path.split("."):
            cmd = cmd.commands[part]
        return [(p.name, tuple(p.opts), p.required, p.multiple, p.nargs) for p in cmd.params]

    assert params(cli) == params(jax_cli)
