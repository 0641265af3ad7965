"""The Triton ring-read kernel (interpret mode) against the plain read."""

import numpy as np
import pytest

import jax.numpy as jnp

from oddio_tpu.ops._dev import split_ds
from oddio_tpu.ops.ring_read_triton import ring_read_triton
from oddio_tpu.spatial import _ring_read


def ring_read_operands(V, n, cap=2048, rowlen=4096, front=1024, seed=0):
    """Random ring and per-ear read operands, with ring wrap, frozen
    (ds = 0) and masked voices; the args of ``_ring_read``."""
    rng = np.random.default_rng(seed)
    ring = rng.standard_normal((V + 2, rowlen)).astype(np.float32)
    vidx = rng.permutation(V + 2)[:V].astype(np.int32)
    base = [rng.integers(0, cap, V).astype(np.int32) for _ in range(2)]
    base[0][0] = cap - 7
    ds = [rng.uniform(0.97, 1.03, V).astype(np.float32) for _ in range(2)]
    frozen = np.arange(V) % 7 == 1  # offset-clamped voices read ds = 0
    ds[0][frozen] = ds[1][frozen] = np.float32(0.0)
    mask = (np.arange(V) % 5 != 4).astype(np.float32)
    return (
        jnp.asarray(ring.reshape(-1)),
        jnp.asarray(vidx * rowlen + front),
        [jnp.asarray(b) for b in base],
        [jnp.asarray(rng.uniform(0, 1, V), jnp.float32) for _ in range(2)],
        [tuple(jnp.asarray(x) for x in split_ds(d)) for d in ds],
        [jnp.asarray(rng.uniform(0, 1, V) * mask, jnp.float32)
         for _ in range(2)],
        [jnp.asarray(rng.uniform(-1e-3, 1e-3, V) * mask, jnp.float32)
         for _ in range(2)],
        n,
        cap,
    )


@pytest.mark.parametrize("V,n", [(3, 512), (64, 512), (13, 88)])
def test_triton_ring_read_matches_plain(V, n):
    args = ring_read_operands(V, n, seed=V)
    want = np.asarray(_ring_read(*args))
    got = np.asarray(ring_read_triton(*args, interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-5)
