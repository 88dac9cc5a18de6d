"""
Phase 35 of chip_smoke.py alone on a CUDA card: the fbank kernel and the
host libraries built, phase 23's MUSAN noise and RIRS_NOISES corpora
written and prepared (the augmenter's noise pool and RIR), then
``_phase_leftovers`` as chip_smoke.py runs it (the energy VAD, the saved
cuts into the device chain, ``copy_data``, ``attach_tensor``, the Shar read
through ``AudioCache``, ``dereverb_wpe_torch`` and ``data_parallel_mesh``).
It prints the card's name and power limit, each leg's line, the phase's
seconds and the kernel's launches per path, and exits non-zero when a leg
fails or no card is found.

    python3 chip_phase35.py
"""
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_phase35.py needs a CUDA card; torch.cuda.is_available() is False.")
    from lhotse_tpu_torch.audio import flacio
    from lhotse_tpu_torch.codecs import lilcom_codec
    from lhotse_tpu_torch.ops import fbank_cuda, host_dsp
    from lhotse_tpu_torch.recipes import prepare_musan, prepare_rir_noise

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    fbank_cuda._lib()
    for get_lib in (flacio._get_lib, host_dsp._get_lib, lilcom_codec._native_lib):
        get_lib()
    (cs.ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cs.ROOT / "build") as tmp:
        workdir = Path(tmp)
        t0 = time.perf_counter()
        corpora = cs._write_noise_corpora(
            workdir / "noise_meetings", np.random.default_rng(cs.NOISE_SEED))
        manifests = workdir / "noise_meetings" / "manifests"
        prepare_musan(corpora["musan"], output_dir=manifests / "musan" / "function",
                      parts=["noise"])
        prepare_rir_noise(corpora["rir_noise"], output_dir=manifests / "rir_noise" / "function",
                          parts=["real_rir"])
        print(f"phase 23's noise corpora written and prepared in {time.perf_counter() - t0!r} s")
        t0 = time.perf_counter()
        launches, err, not_run = cs._phase_leftovers(workdir, torch.device("cuda"), fbank_cuda, smi)
        print(f"phase 35 took {time.perf_counter() - t0!r} s")
    print(f"launches per path {launches}; largest kernel vs plain error {err!r} (tol "
          f"{cs.CHAIN_TOL}); legs not run: {len(not_run)}")
    if not all(n > 0 for n in launches.values()) or not err <= cs.CHAIN_TOL:
        raise AssertionError("phase 35: a path launched no kernel or the kernel disagrees")


if __name__ == "__main__":
    main()
