from lhotse_tpu_torch.bin.modes import cli
