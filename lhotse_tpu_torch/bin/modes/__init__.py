"""
The port's command line, mirroring ``lhotse_tpu/bin/modes``: every command of
the JAX package's CLI whose library path the port has. Not registered (see
ROADMAP.md): ``feat upload``, ``copy-feats``, ``install-sph2pipe``, the
``workflows`` commands other than ``simulate-meetings``, every ``download``
command, and the ``prepare`` commands of the recipes the port lacks (the
package ``lhotse_tpu_torch.recipes`` names the recipes it has).

Only this package imports click; the library modules it calls do not.
"""
from lhotse_tpu_torch.bin.modes.cli_base import cli, download, prepare
from lhotse_tpu_torch.bin.modes.cut import *  # noqa: F401,F403
from lhotse_tpu_torch.bin.modes.features import *  # noqa: F401,F403
from lhotse_tpu_torch.bin.modes.index import *  # noqa: F401,F403
from lhotse_tpu_torch.bin.modes.kaldi import *  # noqa: F401,F403
from lhotse_tpu_torch.bin.modes.manipulation import *  # noqa: F401,F403
from lhotse_tpu_torch.bin.modes.recipes import *  # noqa: F401,F403
from lhotse_tpu_torch.bin.modes.shar import *  # noqa: F401,F403
from lhotse_tpu_torch.bin.modes.supervision import *  # noqa: F401,F403
from lhotse_tpu_torch.bin.modes.utils import *  # noqa: F401,F403
from lhotse_tpu_torch.bin.modes.validate import *  # noqa: F401,F403
from lhotse_tpu_torch.bin.modes.workflows import *  # noqa: F401,F403
