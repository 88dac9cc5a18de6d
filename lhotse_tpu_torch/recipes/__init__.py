"""Corpus recipes of the PyTorch port, without their downloads (but
LibriSpeech's): LibriSpeech, AMI and CommonVoice; the noise and room
impulse response corpora MUSAN, RIRS_NOISES, the BUT Reverb DB and WHAM!;
the far-field meeting corpora AISHELL-4, AliMeeting, ICSI, NOTSOFAR-1,
LibriCSS, CHiME-6 (an already synchronised layout) and DiPCo; and the
manifest caching helpers. The JAX package's other recipes are not
ported."""
from lhotse_tpu_torch.recipes.aishell4 import prepare_aishell4
from lhotse_tpu_torch.recipes.ali_meeting import prepare_ali_meeting
from lhotse_tpu_torch.recipes.ami import prepare_ami
from lhotse_tpu_torch.recipes.but_reverb_db import prepare_but_reverb_db
from lhotse_tpu_torch.recipes.chime6 import prepare_chime6
from lhotse_tpu_torch.recipes.commonvoice import prepare_commonvoice
from lhotse_tpu_torch.recipes.dipco import prepare_dipco
from lhotse_tpu_torch.recipes.icsi import prepare_icsi
from lhotse_tpu_torch.recipes.libricss import prepare_libricss
from lhotse_tpu_torch.recipes.librispeech import download_librispeech, prepare_librispeech
from lhotse_tpu_torch.recipes.musan import prepare_musan
from lhotse_tpu_torch.recipes.notsofar1 import prepare_notsofar1
from lhotse_tpu_torch.recipes.rir_noise import prepare_rir_noise
from lhotse_tpu_torch.recipes.utils import (
    finalize_manifests, manifests_exist, read_manifests_if_cached)
from lhotse_tpu_torch.recipes.wham import prepare_wham

__all__ = [
    "download_librispeech", "finalize_manifests", "manifests_exist", "prepare_aishell4",
    "prepare_ali_meeting", "prepare_ami", "prepare_but_reverb_db", "prepare_chime6",
    "prepare_commonvoice", "prepare_dipco", "prepare_icsi", "prepare_libricss",
    "prepare_librispeech", "prepare_musan", "prepare_notsofar1", "prepare_rir_noise",
    "prepare_wham", "read_manifests_if_cached"]
