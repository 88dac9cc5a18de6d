from lhotse_tpu_torch.bin.modes.recipes.ami import *  # noqa: F401,F403
from lhotse_tpu_torch.bin.modes.recipes.commonvoice import *  # noqa: F401,F403
from lhotse_tpu_torch.bin.modes.recipes.librispeech import *  # noqa: F401,F403
