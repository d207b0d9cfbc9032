"""The token rows of ``chip_smoke.phase_train``, as the port's ``make_batch``
makes them on this machine.

    PYTHONPATH=src python3 tests/torch_smoke_train_rows.py OUT.npz

The data pipeline draws its token rows with numpy's ``Generator.zipf``,
whose numbers depend on the numpy version (2.0.2 and 2.3.5 give other
rows from the same seeds). The training phase's JAX constants must be
made on the rows the card's ``make_batch`` gives, so this script, run
where the smoke runs, writes them (``tokens`` and ``labels`` of each of
``chip_smoke.TRAIN_STEPS`` batches, and the numpy version) to OUT.npz;
commit that file as ``chip_smoke.TRAIN_ROWS`` and remake the constants
(``tests/torch_smoke_constants.py train``) from it. Imports no ``jax``.
"""
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_batch  # noqa: E402


def main(out: str) -> None:
    cfg = get_config(chip_smoke.TRAIN_ARCH)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=chip_smoke.TRAIN_S,
                      global_batch=chip_smoke.TRAIN_B, seed=chip_smoke.SEED)
    batches = [make_batch(dcfg, step, "cpu")
               for step in range(chip_smoke.TRAIN_STEPS)]
    np.savez_compressed(
        out, numpy_version=np.__version__,
        tokens=np.stack([b["tokens"].numpy() for b in batches]),
        labels=np.stack([b["labels"].numpy() for b in batches]))
    print(f"wrote {out}: {chip_smoke.TRAIN_STEPS} batches of "
          f"{chip_smoke.TRAIN_B} x {chip_smoke.TRAIN_S} tokens, numpy "
          f"{np.__version__}")


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__.split("\n\n")[1])
    main(sys.argv[1])
