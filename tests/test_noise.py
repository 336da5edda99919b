import os
import tempfile

import numpy as np
import pytest

from voxtracer.io.f32zip import read_f32zip, write_f32zip
from voxtracer.ops import bluenoise
from voxtracer.ops import noise as noise_op


def test_noise_plane_indexing():
    """plane[k][y,x] must equal buffer[(frame+1+k) % S, y % 128, x % 128]
    (the reference's rand() slice advance, voxels.comp:268-275)."""
    buf = noise_op.white_noise_buffer(seed=3, count=16, size=8)
    planes = noise_op.noise_planes(buf, frame=7, height=20, width=11, count=5)
    assert planes.shape == (5, 20, 11)
    for k in range(5):
        s = (7 + 1 + k) % 16
        for y, x in [(0, 0), (7, 7), (13, 9), (19, 10)]:
            assert planes[k, y, x] == buf[s, y % 8, x % 8]


def test_f32zip_roundtrip():
    noise = np.random.default_rng(0).random((4, 16, 16)).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "bn.zip")
        write_f32zip(path, noise)
        back = read_f32zip(path)
    np.testing.assert_array_equal(noise, back)


def test_bluenoise_small():
    """Tiny void-and-cluster bake: values are a permutation of
    (rank+0.5)/N and the spectrum is blue (energy pushed to high
    frequencies)."""
    size = 16
    noise = bluenoise.generate(count=2, size=size, seed=1)
    assert noise.shape == (2, size, size)
    n = size * size
    for s in range(2):
        vals = np.sort(noise[s].reshape(-1))
        np.testing.assert_allclose(vals, (np.arange(n) + 0.5) / n, atol=1e-6)

    # spectral check: thresholded binary pattern should have little
    # low-frequency energy relative to white noise
    pat = (noise[0] < 0.25).astype(np.float64)
    pat -= pat.mean()
    spec = np.abs(np.fft.fft2(pat)) ** 2
    freq = np.fft.fftfreq(size)
    fy, fx = np.meshgrid(freq, freq, indexing="ij")
    rad = np.sqrt(fy**2 + fx**2)
    low = spec[(rad < 0.15) & (rad > 0)].mean()
    high = spec[rad > 0.3].mean()
    assert high > 2.0 * low, f"not blue: low {low}, high {high}"
