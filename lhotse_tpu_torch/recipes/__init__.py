"""Corpus recipes of the PyTorch port: LibriSpeech, AMI and CommonVoice
(without their downloads, but LibriSpeech's) and the manifest caching
helpers. The JAX package's other recipes are not ported."""
from lhotse_tpu_torch.recipes.ami import prepare_ami
from lhotse_tpu_torch.recipes.commonvoice import prepare_commonvoice
from lhotse_tpu_torch.recipes.librispeech import download_librispeech, prepare_librispeech
from lhotse_tpu_torch.recipes.utils import (
    finalize_manifests, manifests_exist, read_manifests_if_cached)

__all__ = [
    "download_librispeech", "finalize_manifests", "manifests_exist", "prepare_ami",
    "prepare_commonvoice", "prepare_librispeech", "read_manifests_if_cached"]
