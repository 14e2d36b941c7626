"""Streaming FIR / frequency-translating FIR kernels.

Batched JAX replacement for GNU Radio's ``freq_xlating_fir_filter_ccc``
(reference: rc_frontend/channel.py:35, p25_control_demod.py:108) and
``fir_filter_fff``. A stream is processed in fixed-shape blocks; the last
``ntaps-1`` input samples and the mixer phase are carried in an explicit
state pytree so block boundaries are seamless (the role GNU Radio's C++
scheduler history plays; SURVEY.md §5.7).

Convolution is expressed through ``lax.conv_general_dilated`` with re/im
stacked as conv features.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class FirState(NamedTuple):
    """Carried state for a streaming FIR: the trailing ntaps-1 inputs."""
    history: jax.Array  # [ntaps-1] same dtype as the stream


def fir_init(taps, dtype=jnp.complex64) -> FirState:
    return FirState(history=jnp.zeros((len(taps) - 1,), dtype=dtype))


def _conv1d(x: jax.Array, taps: jax.Array, stride: int) -> jax.Array:
    """Causal 1-D convolution y[n] = sum_k h[k] x[n*stride - k + K - 1].

    ``x`` already includes K-1 samples of history at the front, so the
    output is exactly ``(len(x) - K + 1) // stride`` "valid" samples.
    Complex x with real taps is handled as two real feature channels;
    complex taps via the 3-multiply decomposition is in ``_cconv_bank``
    (channelizer.py).
    """
    k = taps.shape[0]
    hrev = taps[::-1]
    if jnp.iscomplexobj(x):
        xr = jnp.stack([x.real, x.imag])  # [2, T]
        if jnp.iscomplexobj(taps):
            # (a+jb)*(c+jd): 4 real convs arranged as a 2->2 feature conv.
            kern = jnp.stack([
                jnp.stack([hrev.real, -hrev.imag]),
                jnp.stack([hrev.imag, hrev.real]),
            ])  # [out=2, in=2, K]
        else:
            eye = jnp.eye(2, dtype=hrev.dtype)
            kern = eye[:, :, None] * hrev[None, None, :]
        out = jax.lax.conv_general_dilated(
            xr[None].astype(jnp.float32), kern.astype(jnp.float32),
            window_strides=(stride,), padding="VALID",
            dimension_numbers=("NCH", "OIH", "NCH"),
        )[0]
        return (out[0] + 1j * out[1]).astype(jnp.complex64)
    out = jax.lax.conv_general_dilated(
        x[None, None].astype(jnp.float32),
        hrev[None, None].astype(jnp.float32),
        window_strides=(stride,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
    )
    return out[0, 0]


def fir_filter(state: FirState, x: jax.Array, taps: jax.Array,
               decim: int = 1) -> tuple[FirState, jax.Array]:
    """Streaming (optionally decimating) FIR.

    Returns ``len(x)//decim`` outputs; ``len(x)`` must be a multiple of
    ``decim`` (static-shape streaming contract).
    """
    k = taps.shape[0]
    z = jnp.concatenate([state.history, x])
    y = _conv1d(z, taps, decim)
    new_hist = z[z.shape[0] - (k - 1):] if k > 1 else state.history
    return FirState(history=new_hist), y


class XlatState(NamedTuple):
    """Streaming freq-xlating FIR state: input history + mixer phase.

    ``phase`` is the mixer phase at the first output instant of the next
    block, in uint32 fixed point (cycles × 2^32). Integer wraparound makes
    the ramp bit-exact across arbitrary block splits and drift-free over
    unbounded streams — float phase accumulation is neither.
    """
    history: jax.Array   # [ntaps-1] complex64
    phase: jax.Array     # scalar uint32, cycles * 2^32


_PHASE_SCALE = 4294967296.0  # 2^32


def _phase_step_u32(offset_norm, decim):
    """Per-output-sample mixer step, cycles * 2^32 as uint32.

    float32 quantizes the step to ~2^-24 cycles/sample (≲ mHz at channel
    rates) — the *accumulation* stays exact in integer arithmetic.
    """
    step = jnp.mod(-jnp.asarray(offset_norm, jnp.float32) * decim, 1.0)
    return (step * _PHASE_SCALE).astype(jnp.uint32)


def _u32_to_angle(u):
    return u.astype(jnp.float32) * jnp.float32(2.0 * jnp.pi / _PHASE_SCALE)


def xlat_init(ntaps: int) -> XlatState:
    return XlatState(history=jnp.zeros((ntaps - 1,), jnp.complex64),
                     phase=jnp.zeros((), jnp.uint32))


def freq_xlating_fir(state: XlatState, x: jax.Array, taps: jax.Array,
                     offset_norm: jax.Array, decim: int
                     ) -> tuple[XlatState, jax.Array]:
    """Mix ``x`` down by ``offset_norm`` (cycles/sample), low-pass with
    ``taps`` and decimate by ``decim`` — one channel of the reference's
    ``freq_xlating_fir_filter_ccc`` contract.

    Implemented via tap modulation: g[k] = h[k]·e^{jwk}, then
    y[n] = e^{-jw n D}·(g ⊛ x)[nD], which keeps the conv kernel static
    while the (cheap) phase ramp carries the tune frequency. That makes
    retunes ("set_offset", reference rc_frontend/channel.py:61-63) a pure
    data change — no recompilation.
    """
    k = taps.shape[0]
    kk = jnp.arange(k, dtype=jnp.float32)
    g = taps.astype(jnp.complex64) * jnp.exp(
        (2j * jnp.pi) * offset_norm * kk)
    z = jnp.concatenate([state.history, x])
    y = _conv1d(z, g, decim)
    n_out = y.shape[0]
    # Per-output mixer phase ramp, exact uint32 fixed-point.
    step = _phase_step_u32(offset_norm, decim)
    ramp = state.phase + step * jnp.arange(n_out, dtype=jnp.uint32)
    y = y * jnp.exp(1j * _u32_to_angle(ramp))
    new_phase = state.phase + step * jnp.uint32(n_out)
    new_hist = z[z.shape[0] - (k - 1):]
    return XlatState(history=new_hist, phase=new_phase), y


def design_channel_taps(samp_rate: float, channel_rate: float,
                        transition_frac: float = 0.2) -> np.ndarray:
    """Standard channel-extraction taps: low-pass at channel_rate/2 with a
    transition band of ``transition_frac·channel_rate`` (matches the
    reference's per-channel filter intent, rc_frontend/channel.py:33)."""
    from radiocapture_tpu.ops import taps as _taps
    return _taps.low_pass_2(1.0, samp_rate, channel_rate / 2.0,
                            transition_frac * channel_rate, 60.0)
