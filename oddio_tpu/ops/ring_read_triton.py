"""Fused delay-ring read for NVIDIA GPUs (Pallas through Triton).

Same contract as ``spatial._ring_read``: fractional per-ear reads with
gain ramps, summed over voices (ring.rs:51-79, spatial.rs:409-431).  Each
program takes ``TV`` voices over the whole block and both ears: it
rebuilds the exact split-ds positions in registers, gathers the lerp pair
with masked pointer loads, and reduces its voices to one (2, n) partial,
so no (V, 2, n) intermediate reaches device memory.  XLA sums the
per-program partials (no float atomics: the output is deterministic).
Everything is f32 elementwise math; there is no matrix product, so no
TF32 rounding.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

#: voices per program
TV = 8


def _kernel(ring_ref, ints_ref, flt_ref, out_ref, *, n, cap):
    j = jnp.arange(n, dtype=jnp.int32)
    jf = j.astype(jnp.float32)
    off = ints_ref[:, 0]
    for e in range(2):
        base = ints_ref[:, 1 + e]
        ds_int = ints_ref[:, 3 + e]
        frac = flt_ref[:, e]
        f_hi = flt_ref[:, 2 + e]
        f_lo = flt_ref[:, 4 + e]
        g0 = flt_ref[:, 6 + e]
        dg = flt_ref[:, 8 + e]
        # ops/_dev.py::exact_positions, term for term
        H = jf[None, :] * f_hi[:, None]
        Hint = H.astype(jnp.int32)
        u = (H - Hint.astype(jnp.float32)) + (
            frac[:, None] + jf[None, :] * f_lo[:, None]
        )
        fl_u = jnp.floor(u)
        fr = u - fl_u
        whole = j[None, :] * ds_int[:, None] + Hint + fl_u.astype(jnp.int32)
        x = jax.lax.rem(base[:, None] + whole, cap)
        x = jnp.where(x < 0, x + cap, x)
        x1 = jnp.where(x + 1 == cap, 0, x + 1)
        a = ring_ref[off[:, None] + x]
        b = ring_ref[off[:, None] + x1]
        s = a + fr * (b - a)
        gains = g0[:, None] + jf[None, :] * dg[:, None]
        out_ref[e, :] = jnp.sum(s * gains, axis=0)


def ring_read_triton(flat, voff, base_c, frac_c, split_c, g0_c, dg_c, n,
                     cap, *, interpret=False):
    """Drop-in for ``spatial._ring_read``; returns (2, n)."""
    V = voff.shape[0]
    Vp = -(-V // TV) * TV
    n_p = 1 << max(n - 1, 0).bit_length()  # Triton tensors are pow2-sized
    z = jnp.zeros((V,), jnp.int32)
    ints = jnp.stack(
        [voff.astype(jnp.int32), base_c[0], base_c[1],
         split_c[0][0], split_c[1][0], z, z, z], axis=-1,
    )
    zf = jnp.zeros((V,), jnp.float32)
    flts = jnp.stack(
        [frac_c[0], frac_c[1], split_c[0][1], split_c[1][1],
         split_c[0][2], split_c[1][2], g0_c[0], g0_c[1], dg_c[0], dg_c[1]]
        + [zf] * 6, axis=-1,
    )
    # padded voices read ring sample 0 with zero gains
    ints = jnp.pad(ints, ((0, Vp - V), (0, 0)))
    flts = jnp.pad(flts, ((0, Vp - V), (0, 0)))
    parts = pl.pallas_call(
        functools.partial(_kernel, n=n_p, cap=cap),
        out_shape=jax.ShapeDtypeStruct((Vp // TV, 2, n_p), jnp.float32),
        grid=(Vp // TV,),
        in_specs=[
            pl.BlockSpec(flat.shape, lambda i: (0,)),
            pl.BlockSpec((TV, 8), lambda i: (i, 0)),
            pl.BlockSpec((TV, 16), lambda i: (i, 0)),
        ],
        out_specs=pl.BlockSpec((None, 2, n_p), lambda i: (i, 0, 0)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="ring_read",
    )(flat, ints, flts)
    return jnp.sum(parts, axis=0)[:, :n]
