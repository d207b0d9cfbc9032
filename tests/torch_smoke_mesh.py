"""``chip_smoke.phase_mesh`` alone on the card: build the kernels, then
serve and train on the model meshes (ROADMAP M9b.8) as the smoke does.

    python3 tests/torch_smoke_mesh.py

Prints the card's name and power limit, the build's seconds, the phase's
``[mesh]`` lines and its wall with the launch counts. Imports no jax.
"""
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the ranks import chip_smoke by name: the repository's root on the path
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

if __name__ == "__main__":
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    counts = {}
    t0 = time.perf_counter()
    chip_smoke.phase_mesh(torch.device("cuda"), counts,
                          torch.cuda.get_device_name(0))
    print(f"phase_mesh wall {time.perf_counter() - t0:.1f} s; launches "
          f"{counts}", flush=True)
