"""The card a run uses, and what the process has imported."""
from __future__ import annotations

import subprocess
import sys

# Top-level module names that no run may hold once its window has closed:
# JAX and its libraries, the JAX package the port was made from, and the
# benchmark that measures that package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def require_cards(chips: int) -> None:
    """Exit (code 3, no result) unless ``chips`` CUDA cards are here."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("portbench: no CUDA card (torch.cuda.is_available() is "
                 "false); the benchmark runs on the card only")
    have = torch.cuda.device_count()
    if have < chips:
        sys.exit(f"portbench: the cell needs {chips} cards, "
                 f"torch.cuda.device_count() is {have}")


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip().replace("\n", "; ") or "not read"


def forbidden_modules() -> list[str]:
    """Modules in ``sys.modules`` whose whole top-level name is one of
    ``FORBIDDEN`` (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})
