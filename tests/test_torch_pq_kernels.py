# The port's IVF-PQ lookup-table kernels (spark_rapids_ml_tpu_torch/ops/
# pq_kernels: B9 lut_accumulate, B10 fastscan_lut_accumulate) against the JAX
# package's Pallas kernels in interpret mode and its numpy oracle
# (tests/test_pq_engine.py), on the same numpy inputs.  Here on the CPU the
# wrappers take their plain PyTorch versions (the CUDA kernels are held
# against those on the card by chip_smoke.py).
#
# Tolerance: none.  The sum over subspaces is sequential in float32 and each
# term an exact table read, so every version agrees bit for bit.
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_ml_tpu.ops.pallas_pq import (
    _fastscan_pallas,
    _lut_accumulate_pallas,
    pack_codes4 as ref_pack_codes4,
    unpack_codes4 as ref_unpack_codes4,
)
from spark_rapids_ml_tpu_torch.ops import pq_kernels as pk

# (B, R, m_sub, ksub): the JAX tests' shapes, and one like the ANN path's
# (m_sub 32 over several probed lists, narrow R)
LUT_SHAPES = [(3, 700, 4, 16), (1, 512, 2, 256), (2, 33, 8, 5), (2, 3 * 1024, 32, 256)]
FASTSCAN_SHAPES = [(3, 700, 4, 16), (1, 512, 2, 16), (2, 33, 8, 5), (2, 3 * 1024, 32, 16)]


def _oracle(T, C):
    """tests/test_pq_engine.py's numpy oracle: sequential j, float32."""
    want = np.zeros(C.shape[:2], np.float32)
    for j in range(T.shape[1]):
        want += np.take_along_axis(T[:, j, :], C[:, :, j].astype(np.int64), axis=1)
    return want


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("shape", LUT_SHAPES, ids=str)
def test_lut_accumulate_equals_pallas_and_oracle_bitwise(shape):
    b, r, m_sub, ksub = shape
    rng = np.random.default_rng(5)
    T = rng.standard_normal((b, m_sub, ksub)).astype(np.float32)
    C = rng.integers(0, ksub, size=(b, r, m_sub)).astype(np.uint8)
    got = pk.lut_accumulate(torch.from_numpy(T), torch.from_numpy(C)).numpy()
    ref = np.asarray(_lut_accumulate_pallas(jnp.asarray(T), jnp.asarray(C), interpret=True))
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    np.testing.assert_array_equal(_bits(got), _bits(_oracle(T, C)))


@pytest.mark.parametrize("shape", FASTSCAN_SHAPES, ids=str)
def test_fastscan_equals_pallas_and_oracle_bitwise(shape):
    b, r, m_sub, ksub = shape
    rng = np.random.default_rng(11)
    T = rng.standard_normal((b, m_sub, ksub)).astype(np.float32)
    C = rng.integers(0, ksub, size=(b, r, m_sub)).astype(np.uint8)
    packed = np.stack([pk.pack_codes4(C[i]) for i in range(b)])
    got = pk.fastscan_lut_accumulate(torch.from_numpy(T), torch.from_numpy(packed)).numpy()
    ref = np.asarray(_fastscan_pallas(jnp.asarray(T), jnp.asarray(packed), interpret=True))
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    np.testing.assert_array_equal(_bits(got), _bits(_oracle(T, C)))


@pytest.mark.parametrize("ksub,hi", [(200, 256), (5, 16)])
def test_out_of_range_codes_add_zero_as_in_pallas(ksub, hi):
    """A code >= ksub contributes 0.0 (the Pallas kernels' compare-select
    finds no lane), one-byte and packed."""
    rng = np.random.default_rng(3)
    T = rng.standard_normal((2, 8, ksub)).astype(np.float32)
    C = rng.integers(0, hi, size=(2, 300, 8)).astype(np.uint8)
    assert (C >= ksub).any()
    kept = np.where(C < ksub, C, 0)
    masked = _oracle(np.concatenate([T, np.zeros((2, 8, 1), np.float32)], axis=2), np.where(C < ksub, C, ksub))
    got = pk.lut_accumulate(torch.from_numpy(T), torch.from_numpy(C)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(masked))
    np.testing.assert_array_equal(
        _bits(got), _bits(np.asarray(_lut_accumulate_pallas(jnp.asarray(T), jnp.asarray(C), interpret=True)))
    )
    assert not np.array_equal(got, _oracle(T, kept))
    if hi <= 16:
        packed = pk.pack_codes4(C.reshape(-1, 8)).reshape(2, 300, 4)
        got4 = pk.fastscan_lut_accumulate(torch.from_numpy(T), torch.from_numpy(packed)).numpy()
        ref4 = np.asarray(_fastscan_pallas(jnp.asarray(T), jnp.asarray(packed), interpret=True))
        np.testing.assert_array_equal(_bits(got4), _bits(ref4))
        np.testing.assert_array_equal(_bits(got4), _bits(masked))


def test_pack_and_unpack_equal_the_jax_package():
    rng = np.random.default_rng(7)
    C = rng.integers(0, 16, size=(257, 12)).astype(np.uint8)
    packed = pk.pack_codes4(C)
    np.testing.assert_array_equal(packed, ref_pack_codes4(C))
    un = pk.unpack_codes4(torch.from_numpy(packed[None])).numpy()
    np.testing.assert_array_equal(un, np.asarray(ref_unpack_codes4(jnp.asarray(packed[None]))))
    np.testing.assert_array_equal(un[0], C)
    for bad, match in ((np.zeros((4, 3), np.uint8), "even"), (np.full((4, 2), 16, np.uint8), "4-bit")):
        with pytest.raises(ValueError, match=match):
            pk.pack_codes4(bad)
        with pytest.raises(ValueError, match=match):
            ref_pack_codes4(bad)


@pytest.mark.parametrize(
    "t_shape,p_shape,match",
    [((1, 3, 16), (1, 5, 1), "even"), ((1, 4, 17), (1, 5, 2), "ksub <= 16"), ((1, 4, 16), (1, 5, 3), "bytes/item")],
    ids=["odd_m_sub", "ksub_over_16", "packed_width"],
)
def test_fastscan_typed_rejections_match_the_jax_check(t_shape, p_shape, match):
    from spark_rapids_ml_tpu.ops.pallas_pq import _fastscan_check as ref_check

    T, P = np.zeros(t_shape, np.float32), np.zeros(p_shape, np.uint8)
    with pytest.raises(ValueError, match=match) as got:
        pk.fastscan_lut_accumulate(torch.from_numpy(T), torch.from_numpy(P))
    with pytest.raises(ValueError, match=match) as want:
        ref_check(jnp.asarray(T), jnp.asarray(P))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize(
    "tables,codes,error",
    [
        (torch.zeros(1, 2, 4, dtype=torch.float64), torch.zeros(1, 3, 2, dtype=torch.uint8), TypeError),
        (torch.zeros(1, 2, 4), torch.zeros(1, 3, 2, dtype=torch.int32), TypeError),
        (torch.zeros(1, 2, 4), torch.zeros(1, 3, 3, dtype=torch.uint8), ValueError),
        (torch.zeros(1, 2, 300), torch.zeros(1, 3, 2, dtype=torch.uint8), ValueError),
        (torch.zeros(1, 4, 2).transpose(1, 2), torch.zeros(1, 3, 2, dtype=torch.uint8), ValueError),
    ],
    ids=["tables_f64", "codes_int32", "codes_width", "ksub_over_256", "not_contiguous"],
)
def test_lut_wrapper_rejects_what_the_kernel_does_not_take(tables, codes, error):
    with pytest.raises(error):
        pk.lut_accumulate(tables, codes)


def test_plain_versions_take_the_cpu_and_count_no_launch():
    before = (pk.lut_accumulate.launches, pk.fastscan_lut_accumulate.launches)
    T = torch.randn(1, 2, 16)
    pk.lut_accumulate(T, torch.zeros(1, 5, 2, dtype=torch.uint8))
    pk.fastscan_lut_accumulate(T, torch.zeros(1, 5, 1, dtype=torch.uint8))
    assert (pk.lut_accumulate.launches, pk.fastscan_lut_accumulate.launches) == before
