"""The port's DFT matrices, half-axis transforms and shell mask against the
JAX package's (mvtb_tpu_torch/ops/dft.py, ops/masks.py).

Matrices and masks are built by the same numpy code on both sides, so they
must be bit-identical. The half transforms are float32 matmuls in another
summation order than XLA's: 1e-5 of the output's max.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtb_tpu.ops import dft as jdft
from mvtb_tpu.ops import masks as jmasks
from mvtb_tpu_torch.ops import dft as tdft
from mvtb_tpu_torch.ops import masks as tmasks


@pytest.mark.parametrize("n", [1, 8, 15, 155, 240])
@pytest.mark.parametrize("inverse", [False, True])
def test_matrices_bit_exact(n, inverse):
    for a, b in zip(tdft._dft_matrix_f64(n, inverse),
                    jdft._dft_matrix_f64(n, inverse)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tdft._gauss_dft_matrices_np(n, inverse),
                    jdft._gauss_dft_matrices_np(n, inverse)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tdft._half_dft_matrix_np(n), jdft._half_dft_matrix_np(n)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tdft._half_idft_matrix_np(n), jdft._half_idft_matrix_np(n)):
        np.testing.assert_array_equal(a, b)
    assert tdft.MATMUL_DFT_MAX_N == jdft.MATMUL_DFT_MAX_N


@pytest.mark.parametrize("spatial,axes", [
    ((16, 12, 10), (6.0, 5.0, 4.0)),
    ((15, 11, 9), (4.0, 4.0, 3.0)),
    ((240, 240, 155), (55.0, 55.0, 30.0)),
])
def test_shell_mask_bit_exact(spatial, axes):
    a = tmasks.ellipsoid_shell_mask(spatial, *axes)
    b = jmasks.ellipsoid_shell_mask(spatial, *axes)
    assert a.dtype == b.dtype == np.bool_
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tmasks.shell_flat_indices(spatial, *map(float, axes)),
        np.flatnonzero(b))


@pytest.mark.parametrize("shape,axis", [
    ((2, 16, 12, 10), 1), ((3, 15, 7), 1), ((4, 9), -1), ((6, 5, 8), 0)])
def test_half_axis_transforms_match(shape, axis):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    n = shape[axis]
    ref = jdft.half_dft_axis(jnp.asarray(x), axis)
    re, im = tdft.half_dft_axis(torch.from_numpy(x), axis)
    scale = float(jnp.abs(ref).max())
    assert float(np.abs(re.numpy() - np.asarray(ref.real)).max()) < 1e-5 * scale
    assert float(np.abs(im.numpy() - np.asarray(ref.imag)).max()) < 1e-5 * scale

    back_ref = jdft.half_idft_axis_real(ref, n, axis)
    back = tdft.half_idft_axis_real(re, im, n, axis)
    scale = float(jnp.abs(back_ref).max())
    assert float(np.abs(back.numpy() - np.asarray(back_ref)).max()) < 1e-5 * scale
    np.testing.assert_allclose(back.numpy(), x, atol=1e-4 * float(np.abs(x).max()))
