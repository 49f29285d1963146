"""The port's dtype names and device resolution
(``paddle_tpu_torch/core``) against the JAX package's ``core/dtype.py``:
every dtype name the reference accepts maps to the torch dtype of the same
name, and bfloat16 arrays cross from numpy bit for bit."""
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.core import dtype as ref_dtype
from paddle_tpu_torch.core import convert_dtype, dtype_name, numpy_to_torch


@pytest.mark.parametrize("name", sorted(ref_dtype._STR_ALIASES))
def test_dtype_names_match_reference(name):
    got = convert_dtype(name)
    assert isinstance(got, torch.dtype)
    assert dtype_name(name) == ref_dtype.dtype_name(name)
    assert dtype_name(got) == ref_dtype.dtype_name(name)


def test_numpy_dtypes_and_refusals():
    assert convert_dtype(np.float32) is torch.float32
    assert convert_dtype(ml_dtypes.bfloat16) is torch.bfloat16
    assert convert_dtype(torch.int8) is torch.int8
    with pytest.raises(TypeError):
        convert_dtype("float8")


def test_numpy_to_torch_keeps_bf16_bits_and_owns_its_memory():
    a = np.random.default_rng(0).normal(0, 3, (5, 7)).astype(
        ml_dtypes.bfloat16)
    t = numpy_to_torch(a)
    assert t.dtype is torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                  a.view(np.uint16))
    b = np.arange(6, dtype=np.float32)
    tb = numpy_to_torch(b)
    b[0] = 99.0
    assert tb[0].item() == 0.0
