"""Small device-side helpers shared by op kernels."""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

#: cursor splitting is exact for frame indices below this (12-bit i times a
#: 12-bit-quantized fractional step stays within the f32 mantissa)
SPLIT_MAX_N = 4096


def iota_f32(n):
    return jnp.arange(n, dtype=jnp.float32)


def lerp(a, b, t):
    """frame::lerp (reference frame.rs:39-41): a + t*(b-a), elementwise."""
    return a + t * (b - a)


def split_ds(ds):
    """Host-side exact decomposition of an f32 step ``ds`` into
    ``(ds_int:int32, f_hi:f32, f_lo:f32)`` with ``ds == ds_int + f_hi + f_lo``
    exactly, ``f_hi`` holding at most 12 mantissa bits of the fraction.

    Device f64 is slow or absent, but playback cursors advance by ``i*ds`` for i up to the
    block size; computing that product in plain f32 costs up to ~n*eps sample
    positions.  With this split, ``i*ds_int`` is exact integer math and
    ``i*f_hi`` is an exact f32 product for i < 4096, so device cursor
    positions are within ~2 ulps-of-1.0 (~2e-7 samples) of exact — far inside
    the reference's own intra-block f32 accumulation wobble.
    """
    ds64 = np.asarray(ds, np.float64)
    ds_int = np.floor(ds64).astype(np.int32)
    f = ds64 - ds_int  # exact in f64
    f_hi = (np.floor(f * 4096.0) / 4096.0).astype(np.float32)  # 12-bit, exact
    f_lo = (f - f_hi).astype(np.float32)
    return ds_int, f_hi, f_lo


def exact_positions(offset0, ds_int, f_hi, f_lo, n, signed=False):
    """Device-side near-exact cursor positions ``offset0 + i*ds`` decomposed
    as ``(whole:int32, fract:f32)`` per frame, matching the reference's
    truncate-toward-zero / ``fract = offset - trunc`` convention
    (frames.rs:189-196, ring.rs:59-77).

    ``offset0`` must lie in (-1, 1).  With ``signed=False`` positions are
    assumed nonnegative (fract in [0, 1)); with ``signed=True`` negative
    positions get the toward-zero adjustment (fract in (-1, 0]).
    Returns (whole, fract) with shapes (..., n).
    """
    i_f = jnp.arange(n, dtype=jnp.float32)
    i_i = jnp.arange(n, dtype=jnp.int32)
    H = i_f * f_hi[..., None]  # exact
    g = offset0[..., None] + i_f * f_lo[..., None]
    Hint = H.astype(jnp.int32)  # H >= 0 when f_hi >= 0
    u = (H - Hint.astype(jnp.float32)) + g
    fl_u = jnp.floor(u)
    r = u - fl_u
    whole = i_i * ds_int[..., None] + Hint + fl_u.astype(jnp.int32)
    if not signed:
        return whole, r
    adjust = (whole < 0) & (r > 0)
    whole = jnp.where(adjust, whole + 1, whole)
    fract = jnp.where(adjust, r - 1.0, r)
    return whole, fract


def device_split_ds(ds):
    """jnp variant of split_ds for steps only known on device (f32 input;
    the decomposition of the f32 value is exact)."""
    ds_int = jnp.floor(ds)
    f = ds - ds_int
    f_hi = jnp.floor(f * 4096.0) * jnp.float32(1.0 / 4096.0)
    f_lo = f - f_hi
    return ds_int.astype(jnp.int32), f_hi, f_lo


def device_advance(base, frac, count, ds_int, f_hi, f_lo):
    """Advance an (int32 base, f32 frac) sample cursor by ``count*ds`` with
    near-exact arithmetic (count < 4096).  Returns floor-normalized
    (base', frac' in [0,1))."""
    cf = count.astype(jnp.float32)
    H = cf * f_hi  # exact
    Hfl = jnp.floor(H)
    u = (H - Hfl) + (frac + cf * f_lo)
    fl = jnp.floor(u)
    base2 = base + count * ds_int + Hfl.astype(jnp.int32) + fl.astype(jnp.int32)
    return base2, u - fl


#: Taylor coefficients of sin(pi*r) on r in [-1/2, 1/2] (f64-derived;
#: truncation error ~6e-8, below f32 evaluation noise)
_SINPI_C = tuple(
    np.float32(c)
    for c in (
        3.141592653589793, -5.16771278004997, 2.550164039877345,
        -0.5992645293207921, 0.08214588661112823,
        -0.007370430945714351, 0.00046630280576761255,
    )
)


def sin_turns(x):
    """``sin(2*pi*x)`` for already-wrapped phase ``x`` in [0, 1).

    The engine's phase cursors are kept wrapped in cycles, so the generic
    libm-style range reduction inside XLA's ``sin`` is wasted work on the
    hot paths; this quarter-wave odd polynomial evaluates the same value
    within ~1e-7 (inside the |sin_f32 - sin_exact| <= ~1e-5 tolerance the
    parity contract already grants transcendentals, PARITY.md)."""
    h = x + x  # half-turns in [0, 2)
    k = jnp.floor(h + 0.5)  # nearest integer: 0, 1 or 2
    r = h - k  # [-1/2, 1/2]
    sign = 1.0 - 2.0 * (k - 2.0 * jnp.floor(k * 0.5))  # (-1)^k
    r2 = r * r
    p = _SINPI_C[6]
    for c in _SINPI_C[5::-1]:
        p = p * r2 + c
    return sign * r * p


def top12(x):
    """f32 with the mantissa truncated to its top 12 bits (exact split:
    x == top12(x) + (x - top12(x)), both halves <= 12 mantissa bits)."""
    xi = np.asarray(x, np.float32).view(np.int32)
    return (xi & ~np.int32(0xFFF)).view(np.float32)


#: frames per position-walk chunk: resample/select windows stay bounded and
#: the 12-bit split products stay exact (t < 4096) for ANY block size
WARP_CHUNK = 512


def chunked_frames(eval_chunk, advance, cursor, n, chunk=WARP_CHUNK):
    """Evaluate a per-frame position walk in <=chunk-frame pieces along the
    last axis: ``eval_chunk(cursor, n_c) -> (..., n_c)`` renders one piece,
    ``advance(cursor, n_c) -> cursor`` moves to the next chunk start with
    the exact split arithmetic (ops/_dev.py), so chunked and unchunked
    positions agree to ~1 ulp.  This is how every kernel-windowed op meets
    the reference's any-output-length contract (signal.rs:19) without
    unbounded gather windows."""
    if n <= chunk:
        return eval_chunk(cursor, n)
    parts = []
    for j0 in range(0, n, chunk):
        n_c = min(chunk, n - j0)
        parts.append(eval_chunk(cursor, n_c))
        if j0 + n_c < n:
            cursor = advance(cursor, n_c)
    return jnp.concatenate(parts, axis=-1)


def device_top12(x):
    """jnp twin of top12 (device-side mantissa split)."""
    import jax

    xi = jax.lax.bitcast_convert_type(x, jnp.int32)
    return jax.lax.bitcast_convert_type(xi & ~jnp.int32(0xFFF), jnp.float32)


def warp_shift(rate, r_hi, t):
    """Near-exact sample shift ``t * rate`` for f32 seconds ``t`` against a
    per-voice f32 ``rate`` pre-split as ``r_hi = top12(rate)``.

    ``t`` splits on its mantissa (``t_a = top12(t)``, exact at ANY
    magnitude), so all four partial products are exact 12x12-bit f32
    products; only their summation rounds.  Error ~ulp(|t*rate|/4096):
    ~1e-6 samples for |t| <= 1 s, ~1e-5 at 10 s (3.4 km of propagation
    delay), degrading gently beyond — the earlier 4096th-based split lost
    exactness outright past |t| = 1 s.  Broadcasts ``t``'s trailing axes;
    returns (shift_int:int32, frac in [0,1)) in floor form."""
    extra = t.ndim - rate.ndim
    r = rate.reshape(rate.shape + (1,) * extra)
    rh = r_hi.reshape(r_hi.shape + (1,) * extra)
    rl = r - rh  # exact (<= 12 residual mantissa bits)
    ti = device_top12(t)
    tl = t - ti  # exact
    A = ti * rh  # exact
    rest = ti * rl + tl * r  # exact + near-exact terms; sums round
    Af = jnp.floor(A)
    u = (A - Af) + rest
    uf = jnp.floor(u)
    return (Af + uf).astype(jnp.int32), u - uf


def to_trunc_form(base, frac):
    """Renormalize a floor-form cursor (frac in [0,1)) to the reference's
    truncate-toward-zero form (frac in (-1,1) with the sign of the position),
    matching frames.rs:189-196 for negative positions."""
    neg = (base < 0) & (frac > 0)
    return jnp.where(neg, base + 1, base), jnp.where(neg, frac - 1.0, frac)
