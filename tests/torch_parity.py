"""Shared helpers of the ``tests/test_torch_*.py`` parity tests.

The JAX package and the PyTorch port get the same numpy inputs; every leaf
they return is compared for EXACT equality (dtype, shape and
``np.array_equal``): the instances are integer-valued, so every float32
value and sum is exact in both and no tolerance is needed.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.interop import to_numpy


@pytest.fixture
def cuda_device():
    """The card, or a skip: kernel-vs-plain tests run only on a CUDA card.

    Decided when the test runs, never at import, so every worker collects
    the same tests.
    """
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel vs its plain version)")
    return torch.device("cuda")


def assert_same(a, b, path: str = "") -> None:
    """Exact equality of two structures (named tuples, dicts of numpy
    arrays, tensors or arrays), leaf by leaf, dtypes included."""
    plain = (tuple, list)
    if (isinstance(a, plain) and not hasattr(a, "_fields")
            and isinstance(b, plain) and not hasattr(b, "_fields")):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
        return
    if not isinstance(a, (dict, np.ndarray)) and a is not None:
        a = to_numpy(a)
    if not isinstance(b, (dict, np.ndarray)) and b is not None:
        b = to_numpy(b)
    if isinstance(a, dict) or isinstance(b, dict):
        assert isinstance(a, dict) and isinstance(b, dict), path
        assert a.keys() == b.keys(), (path, a.keys(), b.keys())
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
        return
    if a is None or b is None:
        assert a is None and b is None, path
        return
    assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
    assert a.shape == b.shape, (path, a.shape, b.shape)
    assert np.array_equal(a, b), path


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality of two 32-bit tensors (-0.0 differs from 0.0)."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.int32),
                            b.contiguous().view(torch.int32)))
