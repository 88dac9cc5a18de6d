"""Corpus recipes of the PyTorch port, without their downloads (but
LibriSpeech's, and IWSLT 2022 Tunisian's, which only logs where the corpus
comes from): the single-stream ASR corpora LibriSpeech, CommonVoice,
YesNo, AISHELL, AISHELL-2, TED-LIUM 2 and 3, Libri-Light, MLS, People's
Speech, SPGISpeech and TIMIT; the TTS corpora LibriTTS(-R), LJSpeech and
VCTK; the speaker corpus VoxCeleb; AMI; the noise and room impulse
response corpora MUSAN, RIRS_NOISES, the BUT Reverb DB and WHAM!; the
far-field meeting corpora AISHELL-4, AliMeeting, ICSI, NOTSOFAR-1,
LibriCSS, CHiME-6 (with its array synchroniser) and DiPCo; the
overlapped-speech corpora LibriMix, MiniLibriMix, LibriSpeechMix and
Spatial LibriSpeech; the diarization corpora DIHARD III and VoxConverse;
the long-form earnings calls Earnings-21 and Earnings-22; the Chinese
corpora THCHS-30, ST-CMDS, Primewords, MagicData, aidatatang_200zh,
KeSpeech, TAL-ASR, TAL-CSASR, CDSD, SpeechIO, AISHELL-3, Baker,
WenetSpeech4TTS, XBMU-AMDO31 (Tibetan) and MDCC (Cantonese); the LDC
telephone and broadcast corpora Switchboard-1, Eval2000, Fisher English,
Fisher Spanish, CALLHOME English, CALLHOME Egyptian, GALE Arabic, GALE
Mandarin, MGB-2 and 1997 English Broadcast News; the speech-translation
and multilingual corpora MuST-C, mTEDx, IWSLT 2022 Tunisian Arabic,
GigaST, VoxPopuli, GigaSpeech 2, CSJ (Japanese), Emilia and BVCC (MOS
ratings); the large ASR training corpora KsponSpeech (Korean), NSC
(Singapore English), BABEL, Heroico (Spanish), ICMC-ASR (in-car Mandarin),
ReazonSpeech (Japanese) and Bengali.AI Speech; and the manifest caching
helpers. The JAX package's other recipes are not ported."""
from lhotse_tpu_torch.recipes.aidatatang_200zh import prepare_aidatatang_200zh
from lhotse_tpu_torch.recipes.aishell import prepare_aishell
from lhotse_tpu_torch.recipes.aishell2 import prepare_aishell2
from lhotse_tpu_torch.recipes.aishell3 import prepare_aishell3
from lhotse_tpu_torch.recipes.aishell4 import prepare_aishell4
from lhotse_tpu_torch.recipes.ali_meeting import prepare_ali_meeting
from lhotse_tpu_torch.recipes.ami import prepare_ami
from lhotse_tpu_torch.recipes.babel import prepare_single_babel_language
from lhotse_tpu_torch.recipes.baker_zh import prepare_baker_zh
from lhotse_tpu_torch.recipes.bengaliai_speech import prepare_bengaliai_speech
from lhotse_tpu_torch.recipes.broadcast_news import prepare_broadcast_news
from lhotse_tpu_torch.recipes.but_reverb_db import prepare_but_reverb_db
from lhotse_tpu_torch.recipes.bvcc import prepare_bvcc
from lhotse_tpu_torch.recipes.callhome_egyptian import prepare_callhome_egyptian
from lhotse_tpu_torch.recipes.callhome_english import prepare_callhome_english
from lhotse_tpu_torch.recipes.cdsd import prepare_cdsd
from lhotse_tpu_torch.recipes.chime6 import prepare_chime6
from lhotse_tpu_torch.recipes.commonvoice import prepare_commonvoice
from lhotse_tpu_torch.recipes.csj import concat_csj_supervisions, prepare_csj
from lhotse_tpu_torch.recipes.dihard3 import prepare_dihard3
from lhotse_tpu_torch.recipes.dipco import prepare_dipco
from lhotse_tpu_torch.recipes.earnings21 import prepare_earnings21
from lhotse_tpu_torch.recipes.earnings22 import prepare_earnings22
from lhotse_tpu_torch.recipes.emilia import prepare_emilia
from lhotse_tpu_torch.recipes.eval2000 import prepare_eval2000
from lhotse_tpu_torch.recipes.fisher_english import prepare_fisher_english
from lhotse_tpu_torch.recipes.fisher_spanish import prepare_fisher_spanish
from lhotse_tpu_torch.recipes.gale_arabic import prepare_gale_arabic
from lhotse_tpu_torch.recipes.gale_mandarin import prepare_gale_mandarin
from lhotse_tpu_torch.recipes.gigaspeech2 import prepare_gigaspeech2
from lhotse_tpu_torch.recipes.gigast import prepare_gigast
from lhotse_tpu_torch.recipes.heroico import prepare_heroico
from lhotse_tpu_torch.recipes.icmcasr import prepare_icmcasr
from lhotse_tpu_torch.recipes.icsi import prepare_icsi
from lhotse_tpu_torch.recipes.iwslt22_ta import download_iwslt22_ta, prepare_iwslt22_ta
from lhotse_tpu_torch.recipes.kespeech import prepare_kespeech
from lhotse_tpu_torch.recipes.ksponspeech import prepare_ksponspeech
from lhotse_tpu_torch.recipes.libricss import prepare_libricss
from lhotse_tpu_torch.recipes.librilight import prepare_librilight
from lhotse_tpu_torch.recipes.librimix import prepare_librimix
from lhotse_tpu_torch.recipes.librimix_mini import prepare_librimix_mini
from lhotse_tpu_torch.recipes.librispeech import download_librispeech, prepare_librispeech
from lhotse_tpu_torch.recipes.librispeechmix import prepare_librispeechmix
from lhotse_tpu_torch.recipes.libritts import prepare_libritts, prepare_librittsr
from lhotse_tpu_torch.recipes.ljspeech import prepare_ljspeech
from lhotse_tpu_torch.recipes.magicdata import prepare_magicdata
from lhotse_tpu_torch.recipes.mdcc import prepare_mdcc
from lhotse_tpu_torch.recipes.mgb2 import prepare_mgb2
from lhotse_tpu_torch.recipes.mls import prepare_mls
from lhotse_tpu_torch.recipes.mtedx import prepare_mtedx
from lhotse_tpu_torch.recipes.musan import prepare_musan
from lhotse_tpu_torch.recipes.must_c import prepare_must_c
from lhotse_tpu_torch.recipes.notsofar1 import prepare_notsofar1
from lhotse_tpu_torch.recipes.nsc import prepare_nsc
from lhotse_tpu_torch.recipes.peoples_speech import prepare_peoples_speech
from lhotse_tpu_torch.recipes.primewords import prepare_primewords
from lhotse_tpu_torch.recipes.reazonspeech import prepare_reazonspeech
from lhotse_tpu_torch.recipes.rir_noise import prepare_rir_noise
from lhotse_tpu_torch.recipes.spatial_librispeech import prepare_spatial_librispeech
from lhotse_tpu_torch.recipes.speechio import prepare_speechio
from lhotse_tpu_torch.recipes.spgispeech import prepare_spgispeech
from lhotse_tpu_torch.recipes.stcmds import prepare_stcmds
from lhotse_tpu_torch.recipes.switchboard import prepare_switchboard
from lhotse_tpu_torch.recipes.tal_asr import prepare_tal_asr
from lhotse_tpu_torch.recipes.tal_csasr import prepare_tal_csasr
from lhotse_tpu_torch.recipes.tedlium import prepare_tedlium
from lhotse_tpu_torch.recipes.tedlium2 import prepare_tedlium2
from lhotse_tpu_torch.recipes.thchs_30 import prepare_thchs_30
from lhotse_tpu_torch.recipes.timit import prepare_timit
from lhotse_tpu_torch.recipes.utils import (
    finalize_manifests, manifests_exist, read_manifests_if_cached)
from lhotse_tpu_torch.recipes.vctk import prepare_vctk
from lhotse_tpu_torch.recipes.voxceleb import prepare_voxceleb
from lhotse_tpu_torch.recipes.voxconverse import prepare_voxconverse
from lhotse_tpu_torch.recipes.voxpopuli import prepare_voxpopuli
from lhotse_tpu_torch.recipes.wenetspeech4tts import prepare_wenetspeech4tts
from lhotse_tpu_torch.recipes.wham import prepare_wham
from lhotse_tpu_torch.recipes.xbmu_amdo31 import prepare_xbmu_amdo31
from lhotse_tpu_torch.recipes.yesno import prepare_yesno

__all__ = [
    "concat_csj_supervisions", "download_iwslt22_ta", "download_librispeech",
    "finalize_manifests", "manifests_exist", "prepare_aidatatang_200zh", "prepare_aishell",
    "prepare_aishell2", "prepare_aishell3", "prepare_aishell4", "prepare_ali_meeting",
    "prepare_ami", "prepare_baker_zh", "prepare_bengaliai_speech", "prepare_broadcast_news",
    "prepare_but_reverb_db", "prepare_bvcc", "prepare_callhome_egyptian",
    "prepare_callhome_english", "prepare_cdsd", "prepare_chime6", "prepare_commonvoice",
    "prepare_csj", "prepare_dihard3", "prepare_dipco", "prepare_earnings21",
    "prepare_earnings22", "prepare_emilia", "prepare_eval2000", "prepare_fisher_english",
    "prepare_fisher_spanish", "prepare_gale_arabic", "prepare_gale_mandarin",
    "prepare_gigaspeech2", "prepare_gigast", "prepare_heroico", "prepare_icmcasr",
    "prepare_icsi", "prepare_iwslt22_ta", "prepare_kespeech", "prepare_ksponspeech",
    "prepare_libricss", "prepare_librilight", "prepare_librimix", "prepare_librimix_mini",
    "prepare_librispeech", "prepare_librispeechmix", "prepare_libritts", "prepare_librittsr",
    "prepare_ljspeech", "prepare_magicdata", "prepare_mdcc", "prepare_mgb2", "prepare_mls",
    "prepare_mtedx", "prepare_musan", "prepare_must_c", "prepare_notsofar1", "prepare_nsc",
    "prepare_peoples_speech", "prepare_primewords", "prepare_reazonspeech",
    "prepare_rir_noise", "prepare_single_babel_language", "prepare_spatial_librispeech",
    "prepare_speechio", "prepare_spgispeech", "prepare_stcmds", "prepare_switchboard",
    "prepare_tal_asr", "prepare_tal_csasr", "prepare_tedlium", "prepare_tedlium2",
    "prepare_thchs_30", "prepare_timit", "prepare_vctk", "prepare_voxceleb",
    "prepare_voxconverse", "prepare_voxpopuli", "prepare_wenetspeech4tts", "prepare_wham",
    "prepare_xbmu_amdo31", "prepare_yesno", "read_manifests_if_cached"]
