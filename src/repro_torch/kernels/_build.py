"""Build ``csrc/*.cu`` with ``nvcc`` into shared libraries, load with ctypes.

Each source becomes its own library with a plain C interface (no PyTorch
headers, so a build takes seconds), compiled for ``sm_90a`` into
``build/repro_torch_kernels/`` at the root of the checkout. The file name
carries a hash of the sources and flags, so an edit to a ``.cu`` or to any
``.cuh`` it may include triggers a rebuild and a stale library is never
loaded. ``build_all`` starts one ``nvcc`` per source, all at once.

Every C entry point takes its pointers and the CUDA stream as
``c_void_p`` and returns ``cudaGetLastError()`` after its launches;
``check`` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3]
             / "build" / "repro_torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.is_file():
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin); the repro_torch CUDA "
            "kernels are compiled from src/repro_torch/kernels/csrc at "
            "first use")
    return str(path)


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; ``None`` if its library is current."""
    out = _lib_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    """Wait for a build started by ``_start``; returns nvcc's output."""
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)      # atomic: concurrent builders never see halves
    return log


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> dict[str, str]:
    """Build every source that is not current, all ``nvcc`` in parallel.

    Returns ``{name: nvcc output}`` (register and spill report of
    ``-Xptxas -v``; empty for a library that was already built).
    """
    with _lock:
        jobs = {name: _start(name) for name in sources()}
        return {name: _finish(name, job) for name, job in jobs.items()}


def load(name: str, protos: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.

    ``protos`` maps each C entry point to its ``argtypes``; every entry
    point returns an ``int`` CUDA error code.
    """
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            for fn, argtypes in protos.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def on_card(t) -> bool:
    """Where a wrapper runs: True (the kernel) for a CUDA tensor, False (the
    plain version) for a CPU one; raises for any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def card_branch(t) -> bool:
    """``on_card``, but True also for a ``meta`` tensor, which describes the
    card's work without doing it (the dry run): for wrappers whose kernel
    is one op with a ``meta`` version (K6)."""
    return t.device.type == "meta" or on_card(t)


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point of ``lib`` reported a CUDA error."""
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg}) at launch")
