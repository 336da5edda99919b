"""The Triton denoise kernel (run through the Pallas interpreter)
against the XLA stencil and the oracle's float64 NumPy denoise."""

import jax.numpy as jnp
import numpy as np
import pytest

from voxtracer import parity
from voxtracer.engine.params import DenoiseParams
from voxtracer.ops import denoise as denoise_op
from voxtracer.ops import denoise_triton
from voxtracer.oracle import renderer as oracle

PARAMS = DenoiseParams(sigma_distance=3.0, sigma_range=2.0,
                       albedo_factor=0.75)


def _inputs(h, w, seed):
    colors, normal, depth, albedo, material, cam = parity.denoise_inputs(
        h, w, seed
    )
    return (colors, normal, depth, albedo, material), cam


@pytest.mark.parametrize("radius,size", [(1, (9, 40)), (2, (21, 37)),
                                         (8, (19, 33))])
def test_triton_denoise_matches_numpy_and_xla(radius, size):
    """Odd sizes: the edge tiles are masked and frame-edge taps are
    skipped exactly as the reference skips them."""
    h, w = size
    arrays, cam = _inputs(h, w, radius)
    dev = [jnp.asarray(a) for a in arrays]
    cam_j = tuple(jnp.asarray(c) for c in cam)
    got = np.asarray(
        denoise_triton.denoise(*dev, cam_j, PARAMS, radius, interpret=True)
    )
    ref = oracle.denoise(*arrays, cam, PARAMS, radius)
    np.testing.assert_allclose(got, ref, rtol=parity.DENOISE_TOL,
                               atol=parity.DENOISE_TOL)
    xla = np.asarray(denoise_op.denoise(*dev, cam_j, PARAMS, radius=radius))
    np.testing.assert_allclose(got, xla, rtol=1e-5, atol=1e-6)


def test_triton_denoise_row_slab():
    """A slab (``row0``/``out_rows``, how each device filters its rows
    under shard_map) equals those rows of the whole-image filter."""
    h, w, radius = 20, 24, 2
    arrays, cam = _inputs(h, w, 3)
    dev = [jnp.asarray(a) for a in arrays]
    cam_j = tuple(jnp.asarray(c) for c in cam)
    full = np.asarray(
        denoise_triton.denoise(*dev, cam_j, PARAMS, radius, interpret=True)
    )
    slab = np.asarray(
        denoise_triton.denoise(*dev, cam_j, PARAMS, radius, row0=13,
                               out_rows=7, interpret=True)
    )
    np.testing.assert_allclose(slab, full[13:20], rtol=1e-6, atol=1e-7)
