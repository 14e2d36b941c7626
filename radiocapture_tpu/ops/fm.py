"""FM demodulation kernels: quadrature discriminator, de-emphasis, NBFM.

Batched JAX equivalents of the reference's ``analog.quadrature_demod_cf``
(p25_control_demod.py:121, edacs_control_demod.py:84,
moto_control_demod.py:105) and ``analog.fm_demod_cf`` with 75 µs
de-emphasis (logging_receiver.py:214, file_to_wav.py:51).

The discriminator is elementwise; the one-pole de-emphasis IIR is a
linear recurrence evaluated with ``lax.associative_scan`` so it costs
O(log n) depth instead of a per-sample loop.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from radiocapture_tpu.ops.fir import FirState, fir_filter


class QuadDemodState(NamedTuple):
    prev: jax.Array  # last complex sample of the previous block


def quad_demod_init(batch_shape=()) -> QuadDemodState:
    return QuadDemodState(prev=jnp.zeros(batch_shape, jnp.complex64))


def quadrature_demod(state: QuadDemodState, x: jax.Array, gain: float
                     ) -> tuple[QuadDemodState, jax.Array]:
    """y[n] = gain * arg(conj(x[n-1]) * x[n]); batched over leading dims.

    ``gain`` is typically ``samp_rate / (2π·max_deviation)`` so full
    deviation maps to ±1 (or the symbol spacing the slicer expects).
    """
    xm1 = jnp.concatenate([state.prev[..., None], x[..., :-1]], axis=-1)
    d = x * jnp.conj(xm1)
    y = gain * jnp.arctan2(d.imag, d.real)
    return QuadDemodState(prev=x[..., -1]), y


def first_order_iir(x: jax.Array, a: jax.Array, b: jax.Array,
                    y0: jax.Array) -> jax.Array:
    """y[n] = a·y[n-1] + b·x[n] along the last axis, via associative scan."""
    bx = b * x
    a_full = jnp.broadcast_to(jnp.asarray(a, x.dtype), x.shape)
    # Seed the recurrence with y0 by folding it into the first element.
    bx = bx.at[..., 0].add(a_full[..., 0] * y0)

    def combine(l, r):
        al, bl = l
        ar, br = r
        return al * ar, ar * bl + br

    _, y = jax.lax.associative_scan(combine, (a_full, bx), axis=-1)
    return y


class DeemphState(NamedTuple):
    y_last: jax.Array
    x_last: jax.Array


def deemph_init(batch_shape=()) -> DeemphState:
    return DeemphState(y_last=jnp.zeros(batch_shape, jnp.float32),
                       x_last=jnp.zeros(batch_shape, jnp.float32))


def fm_deemphasis(state: DeemphState, x: jax.Array, samp_rate: float,
                  tau: float = 75e-6) -> tuple[DeemphState, jax.Array]:
    """Single-pole de-emphasis, bilinear-matched to RC time constant tau."""
    import math
    w_c = 1.0 / tau
    w_ca = 2.0 * samp_rate * math.tan(w_c / (2.0 * samp_rate))
    k = -w_ca / (2.0 * samp_rate)
    z1 = (1.0 + k) / (1.0 - k)
    b0 = -k / (1.0 - k)
    # H(z) = b0(1+z^-1)/(1-z1 z^-1): implement as y = z1 y + b0 (x + x_prev)
    xprev = jnp.concatenate([state.x_last[..., None], x[..., :-1]], axis=-1)
    y = first_order_iir(x + xprev, jnp.float32(z1), jnp.float32(b0),
                        state.y_last)
    return DeemphState(y_last=y[..., -1], x_last=x[..., -1]), y


class NbfmState(NamedTuple):
    quad: QuadDemodState
    deemph: DeemphState
    audio_fir: FirState


def nbfm_init(audio_taps) -> NbfmState:
    return NbfmState(
        quad=quad_demod_init(),
        deemph=deemph_init(),
        audio_fir=FirState(history=jnp.zeros((len(audio_taps) - 1,),
                                             jnp.float32)),
    )


def nbfm_demod(state: NbfmState, x: jax.Array, samp_rate: float,
               max_dev: float, audio_taps: jax.Array, audio_decim: int = 1,
               tau: float = 75e-6) -> tuple[NbfmState, jax.Array]:
    """Narrowband FM voice demod: discriminator → de-emphasis → audio LPF.

    Matches the reference analog voice chain (logging_receiver.py:210-222)
    up to the rational resampler, which is applied separately
    (ops.resample) so callers can pick the output audio rate.
    """
    import math
    gain = samp_rate / (2.0 * math.pi * max_dev)
    qs, disc = quadrature_demod(state.quad, x, gain)
    ds, de = fm_deemphasis(state.deemph, disc, samp_rate, tau)
    fs, audio = fir_filter(state.audio_fir, de, audio_taps, audio_decim)
    return NbfmState(quad=qs, deemph=ds, audio_fir=fs), audio
