"""Blue-noise texture generation (void-and-cluster), JAX-accelerated.

The reference streams pre-baked blue noise from
``resources/blue-noise-128.zip`` (``src/context.rs:1019-1116``) — an
asset this rebuild regenerates from scratch: Ulichney's void-and-cluster
method, vmapped over all slices at once so a full 512 x 128 x 128 set
bakes on an accelerator in seconds (hours in naive numpy).

Method per slice:
  1. a random initial binary pattern is relaxed by repeatedly moving the
     "tightest cluster" (max Gaussian energy among ones) into the
     "largest void" (min energy among zeros) until it cycles;
  2. ranks below the initial count are assigned by deleting tightest
     clusters; ranks above by inserting into largest voids (with the
     classical inversion past the 50% fill point);
  3. ``noise = (rank + 0.5) / N`` gives uniform values whose spatial
     spectrum is blue.

Energy bookkeeping is incremental: toggling a pixel adds/subtracts a
precomputed torus-wrapped Gaussian, realized as a double ``jnp.roll``.
"""

from __future__ import annotations

import logging
import os
import numpy as np

log = logging.getLogger("voxtracer.ops.bluenoise")

SIGMA = 1.9


def _wrapped_gaussian(size: int, sigma: float) -> np.ndarray:
    ax = np.arange(size)
    d = np.minimum(ax, size - ax).astype(np.float64)
    g1 = np.exp(-(d**2) / (2 * sigma**2))
    k = np.outer(g1, g1)
    k[0, 0] = 0.0  # self-energy excluded so argmax prefers neighbors
    return k.astype(np.float32)


def generate(
    count: int,
    size: int = 128,
    seed: int = 0,
    initial_fraction: float = 0.1,
) -> np.ndarray:
    """Generate ``count`` independent blue-noise slices -> (count, size,
    size) float32 in [0, 1)."""
    import jax
    import jax.numpy as jnp

    n = size * size
    n1 = max(1, int(n * initial_fraction))
    kernel = jnp.asarray(_wrapped_gaussian(size, SIGMA))

    def roll2(k, y, x):
        return jnp.roll(jnp.roll(k, y, axis=0), x, axis=1)

    def energy_of(pattern):
        # full convolution via FFT (used once per phase start)
        kf = jnp.fft.rfft2(kernel)
        pf = jnp.fft.rfft2(pattern.astype(jnp.float32))
        return jnp.fft.irfft2(kf * pf, s=pattern.shape)

    def tightest(pattern, energy):
        e = jnp.where(pattern > 0, energy, -jnp.inf)
        idx = jnp.argmax(e.reshape(-1))
        return idx // size, idx % size

    def largest_void(pattern, energy):
        e = jnp.where(pattern > 0, jnp.inf, energy)
        idx = jnp.argmin(e.reshape(-1))
        return idx // size, idx % size

    def relax(pattern):
        energy = energy_of(pattern)

        def body(state):
            i, pattern, energy, _ = state
            cy, cx = tightest(pattern, energy)
            pattern = pattern.at[cy, cx].set(0)
            energy = energy - roll2(kernel, cy, cx)
            vy, vx = largest_void(pattern, energy)
            pattern = pattern.at[vy, vx].set(1)
            energy = energy + roll2(kernel, vy, vx)
            moved = (vy != cy) | (vx != cx)
            return i + 1, pattern, energy, moved

        def cond(state):
            i, _, _, moved = state
            return jnp.logical_and(i < 4 * n1, moved)

        _, pattern, energy, _ = jax.lax.while_loop(
            cond, body, (jnp.int32(0), pattern, energy, jnp.bool_(True))
        )
        return pattern, energy

    def rank_slice(key):
        pattern0 = jnp.zeros((size, size), jnp.int32)
        flat = jax.random.permutation(key, n)[:n1]
        pattern0 = pattern0.reshape(-1).at[flat].set(1).reshape(size, size)
        pattern0, _ = relax(pattern0)

        ranks = jnp.zeros((size, size), jnp.int32)

        # phase 1: delete tightest clusters, ranks n1-1 .. 0
        def phase1(i, state):
            pattern, energy, ranks = state
            cy, cx = tightest(pattern, energy)
            pattern = pattern.at[cy, cx].set(0)
            energy = energy - roll2(kernel, cy, cx)
            ranks = ranks.at[cy, cx].set(n1 - 1 - i)
            return pattern, energy, ranks

        p1 = pattern0
        e1 = energy_of(p1)
        _, _, ranks = jax.lax.fori_loop(0, n1, phase1, (p1, e1, ranks))

        # phase 2: insert into largest voids, ranks n1 .. n/2-1
        def phase2(i, state):
            pattern, energy, ranks = state
            vy, vx = largest_void(pattern, energy)
            pattern = pattern.at[vy, vx].set(1)
            energy = energy + roll2(kernel, vy, vx)
            ranks = ranks.at[vy, vx].set(n1 + i)
            return pattern, energy, ranks

        half = n // 2
        p2 = pattern0
        e2 = energy_of(p2)
        p2, e2, ranks = jax.lax.fori_loop(
            0, half - n1, phase2, (p2, e2, ranks)
        )

        # phase 3: past 50% fill, track the zeros ("minority") instead:
        # repeatedly delete the tightest cluster of zeros
        def phase3(i, state):
            pattern, energy, ranks = state
            zy, zx = tightest(1 - pattern, energy)
            pattern = pattern.at[zy, zx].set(1)
            energy = energy - roll2(kernel, zy, zx)
            ranks = ranks.at[zy, zx].set(half + i)
            return pattern, energy, ranks

        e3 = energy_of(1 - p2)
        _, _, ranks = jax.lax.fori_loop(
            0, n - half, phase3, (p2, e3, ranks)
        )

        return (ranks.astype(jnp.float32) + 0.5) / n

    keys = jax.random.split(jax.random.PRNGKey(seed), count)
    out = jax.jit(jax.vmap(rank_slice))(keys)
    return np.asarray(out, dtype=np.float32)


def cached_buffer(
    count: int = 512,
    size: int = 128,
    seed: int = 0,
    cache_dir: str | None = None,
) -> np.ndarray:
    """Generate-or-load the engine's blue-noise buffer."""
    cache_dir = cache_dir or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
        "assets",
        "generated",
    )
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(
        cache_dir, f"bluenoise-{size}x{size}x{count}-s{seed}.npz"
    )
    if os.path.exists(path):
        return np.load(path)["noise"]
    log.info("baking blue noise %dx%dx%d ...", count, size, size)
    noise = generate(count, size, seed)
    np.savez_compressed(path, noise=noise)
    return noise
