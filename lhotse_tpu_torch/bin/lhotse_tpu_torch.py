"""
Console entry point of the port (declared in pyproject as
``lhotse-tpu-torch``; also ``python -m lhotse_tpu_torch.bin.lhotse_tpu_torch``).
"""
from lhotse_tpu_torch.bin.modes import cli

if __name__ == "__main__":
    cli()
