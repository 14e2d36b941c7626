"""CQPSK (P25 LSM) symbol recovery as a batched ``lax.scan`` kernel.

Batched JAX replacement for op25's ``repeater.gardner_costas_cc`` +
``digital.diff_phasor_cc`` + ``blocks.complex_to_arg`` chain (reference
p25_control_demod.py:136-168 and logging_receiver.py:278-333): joint
Gardner symbol-timing recovery and carrier tracking on the complex
baseband, differential phase detection, and rescale by 1/(pi/4) so the
output feeds the same 4-level slicer as the C4FM path (levels
[-2, 0, 2, 4], p25_control_demod.py:167).

Design deviation from the reference (documented, output-contract
preserving): op25 runs a QPSK Costas phase loop (alpha=0.04,
beta=0.125*alpha^2, fmax=+/-2*pi*1200/fs) *before* differential
detection. Because ``diff_phasor`` output is invariant to any constant
phase rotation, only the residual *frequency* offset matters — it shows
up as a constant bias on every differential phase. This kernel therefore
tracks frequency directly in the differential domain (decision-directed
error on the scaled diff-phase vs the nearest of {+/-1, +/-3}),
integrating into an NCO that de-rotates the input. That removes the
phase-ambiguity/false-lock modes of a Costas loop on the pi/4-shifted
constellation while keeping the identical external contract: float
symbols in quarter-pi units, sliced to identical dibits, same +/-1200 Hz
pull-in clamp.

Timing is classic Gardner on interpolated mid-symbol samples
(gain_mu=0.025, gain_omega=0.1*gain_mu^2, omega clamped to +/-2% of
nominal — the reference's constructor constants). The per-sample
sequential loop is a ``lax.scan`` whose per-step body is a wide vector op
vmapped across channel slots (SURVEY.md §7 hard part 1); interpolation
reuses the fsk4 kernel's polyphase windowed-sinc bank.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from radiocapture_tpu.demod.fsk4 import _FARROW, _VAL_BANK, NPHASES

#: value-tap Farrow polynomials (the first HIST columns of the fsk4
#: combined bank): 8 interpolator taps as degree-4 polynomials in the
#: fractional position — pure FMA, no table gather.
_VAL_FARROW = _FARROW[:, :8]

GAIN_MU = 0.025
GAIN_OMEGA = 0.1 * GAIN_MU * GAIN_MU
K_FREQ = 0.02          # diff-domain AFC integrator gain
FMAX_HZ = 1200.0       # carrier pull-in clamp (reference fmax)
OMEGA_REL = 0.02       # omega clamp, +/-2% of nominal
HIST_C = 24            # complex history span (samples)
_DELAY = 4.0           # fixed interpolator group delay (samples)

_QPSK_LEVELS = np.array([-3.0, -1.0, 1.0, 3.0], np.float32)


class CqpskState(NamedTuple):
    t: jax.Array         # [...], samples since last symbol instant
    omega: jax.Array     # [...], samples/symbol estimate
    freq: jax.Array      # [...], carrier correction (rad/sample)
    phase: jax.Array     # [...], NCO phase (rad)
    hist_re: jax.Array   # [..., HIST_C]
    hist_im: jax.Array   # [..., HIST_C]
    prev_re: jax.Array   # [...], last emitted symbol (diff + Gardner ref)
    prev_im: jax.Array


def cqpsk_init(samp_rate: float, symbol_rate: float, batch_shape=()
               ) -> CqpskState:
    omega0 = float(samp_rate) / float(symbol_rate)
    return CqpskState(
        t=jnp.zeros(batch_shape, jnp.float32),
        omega=jnp.full(batch_shape, omega0, jnp.float32),
        freq=jnp.zeros(batch_shape, jnp.float32),
        phase=jnp.zeros(batch_shape, jnp.float32),
        hist_re=jnp.zeros(batch_shape + (HIST_C,), jnp.float32),
        hist_im=jnp.zeros(batch_shape + (HIST_C,), jnp.float32),
        prev_re=jnp.zeros(batch_shape, jnp.float32),
        prev_im=jnp.zeros(batch_shape, jnp.float32),
    )


def _interp(hist_re, hist_im, p):
    """Evaluate the complex history ``p`` samples before the newest one
    (reference/test path — per-lane dynamic window + phase-table
    gathers; the hot scan uses :func:`_interp_fixed` instead).

    p in [0, HIST_C-9]; uses the fsk4 polyphase bank: bank[ph] applied to
    an 8-wide window starting at s evaluates window position 4 - ph/N,
    i.e. absolute index s + 4 - frac. Solving s + 4 - frac = HIST_C-1 - p
    with p = n0 + frac gives integer s = HIST_C - 5 - n0.
    """
    n0 = jnp.clip(jnp.floor(p), 0.0, HIST_C - 9.0)
    frac = jnp.clip(p - n0, 0.0, 0.999)
    ph = (frac * NPHASES).astype(jnp.int32)
    taps = jnp.asarray(_VAL_BANK)[ph]                       # [..., 8]
    s = (HIST_C - 5 - n0).astype(jnp.int32)                 # [...]
    idx = s[..., None] + jnp.arange(8)                      # [..., 8]
    w_re = jnp.take_along_axis(hist_re, idx, axis=-1)
    w_im = jnp.take_along_axis(hist_im, idx, axis=-1)
    return (jnp.sum(w_re * taps, axis=-1),
            jnp.sum(w_im * taps, axis=-1))


def _interp_fixed(hist_re, hist_im, n0: int, frac):
    """Farrow interpolation at ``n0 + frac`` samples before the newest
    history sample with a COMPILE-TIME integer ``n0``: static window
    slice + polynomial taps, zero gathers.

    The gather form (:func:`_interp`) pays four per-lane
    `take_along_axis`/table gathers per sample. The interpolation
    positions' integer parts have tiny static ranges (p_sym ∈ [4,5);
    p_half spans ≤2 integer windows at ±2% omega), so each candidate
    window is a static slice and the caller selects between the few
    candidates with `where`."""
    s = HIST_C - 5 - n0
    w_re = hist_re[..., s:s + 8]
    w_im = hist_im[..., s:s + 8]
    cf = jnp.asarray(_VAL_FARROW)                            # [deg+1, 8]
    tt = cf[0]
    fr = frac[..., None]
    for j in range(1, cf.shape[0]):
        tt = tt * fr + cf[j]                                 # [..., 8]
    return jnp.sum(w_re * tt, axis=-1), jnp.sum(w_im * tt, axis=-1)


def cqpsk_demod(state: CqpskState, x: jax.Array, samp_rate: float,
                symbol_rate: float,
                gain_mu: float = GAIN_MU,
                gain_omega: float = GAIN_OMEGA,
                k_freq: float = K_FREQ,
                ) -> tuple[CqpskState, tuple[jax.Array, jax.Array]]:
    """Recover differential-phase symbols from a complex baseband block.

    x: [..., n] complex64 (batch dims lead). Input should be roughly
    unit-RMS (use :func:`block_agc` — the reference's
    ``feedforward_agc_cc(1024, 1.0)``).

    Returns (state, (symbols [..., n] f32 in quarter-pi units,
    valid [..., n] bool)).
    """
    omega_n = jnp.float32(samp_rate / symbol_rate)
    omega_lo = omega_n * (1.0 - OMEGA_REL)
    omega_hi = omega_n * (1.0 + OMEGA_REL)
    fmax = jnp.float32(2.0 * math.pi * FMAX_HZ / samp_rate)
    K_MU = jnp.float32(gain_mu)
    K_OM = jnp.float32(gain_omega)
    K_F = jnp.float32(k_freq)
    two_pi = jnp.float32(2.0 * math.pi)
    quarter_pi = jnp.float32(math.pi / 4.0)
    # static integer-window candidates for the mid-symbol interpolation
    # point p_half = p_sym + omega/2 (see _interp_fixed): omega is
    # clamped to ±OMEGA_REL so the float range is known at trace time.
    omega0 = samp_rate / symbol_rate
    half_lo = _DELAY + omega0 * (1.0 - OMEGA_REL) * 0.5
    half_hi = _DELAY + 0.999 + omega0 * (1.0 + OMEGA_REL) * 0.5
    half_n0s = list(range(int(math.floor(half_lo)),
                          int(math.floor(half_hi)) + 1))
    # _interp_fixed's window must fit the history: start s = HIST_C-5-n0
    # needs 0 <= s and s+8 <= HIST_C. The old dynamic interpolator
    # silently clipped out-of-range positions to wrong samples; fail
    # loudly instead (HIST_C bounds the supported samples-per-symbol).
    if half_n0s and not (3 <= half_n0s[0]
                         and half_n0s[-1] <= HIST_C - 5):
        raise ValueError(
            f"samples/symbol {omega0:.1f} needs mid-symbol window "
            f"n0∈{half_n0s} outside the {HIST_C}-sample history; "
            "raise HIST_C for rates above ~28 samples/symbol")

    def scan_fn(carry: CqpskState, xn):
        t, omega, freq, phase, h_re, h_im, p_re, p_im = carry
        # Carrier NCO de-rotation (replaces the Costas VCO).
        phase = jnp.mod(phase + freq + two_pi, two_pi)
        c, s = jnp.cos(phase), jnp.sin(phase)
        xr = jnp.real(xn) * c + jnp.imag(xn) * s      # x * exp(-i*phase)
        xi = jnp.imag(xn) * c - jnp.real(xn) * s
        h_re = jnp.concatenate([h_re[..., 1:], xr[..., None]], axis=-1)
        h_im = jnp.concatenate([h_im[..., 1:], xi[..., None]], axis=-1)

        t = t + 1.0
        emit = t >= omega
        frac_late = jnp.where(emit, t - omega, 0.0)
        p_sym = frac_late + _DELAY
        p_half = p_sym + omega * 0.5
        # gather-free interpolation: p_sym ∈ [4, 5) always (static
        # window n0=4); p_half falls in one of the few precomputed
        # integer windows — evaluate each static candidate and select.
        y_re, y_im = _interp_fixed(
            h_re, h_im, int(_DELAY),
            jnp.clip(p_sym - _DELAY, 0.0, 0.999))
        m_re = m_im = None
        for n0 in half_n0s:
            fr = jnp.clip(p_half - jnp.float32(n0), 0.0, 0.999)
            c_re, c_im = _interp_fixed(h_re, h_im, n0, fr)
            if m_re is None:
                m_re, m_im = c_re, c_im
            else:
                sel = p_half >= jnp.float32(n0)
                m_re = jnp.where(sel, c_re, m_re)
                m_im = jnp.where(sel, c_im, m_im)

        # Gardner timing error: Re{(y_k - y_{k-1}) conj(y_mid)}; positive
        # when the instant is late (measured S-curve), so both corrections
        # advance the clock on e_t > 0: raise t (emit sooner) and shrink
        # the period estimate.
        e_t = (y_re - p_re) * m_re + (y_im - p_im) * m_im
        e_t = jnp.clip(e_t, -1.0, 1.0)
        omega = jnp.where(emit,
                          jnp.clip(omega - K_OM * e_t, omega_lo, omega_hi),
                          omega)
        t = jnp.where(emit, frac_late + K_MU * e_t, t)

        # Differential phase in quarter-pi units.
        z_re = y_re * p_re + y_im * p_im              # y * conj(prev)
        z_im = y_im * p_re - y_re * p_im
        arg = jnp.arctan2(z_im, z_re) / quarter_pi
        # x4 power-law AFC: every ideal diff-phase is an odd multiple of
        # pi/4, so 4*dphi == pi (mod 2pi) regardless of the dibit; a
        # residual carrier offset b rad/symbol shifts the wrapped value
        # by 4b. Decision-free, monotone pull-in over +/-(symbol_rate/8)
        # = +/-600 Hz — double the +/-300 Hz a decision-directed detector
        # manages on this constellation.
        err4 = jnp.mod(arg * jnp.pi - jnp.pi + jnp.pi, two_pi) - jnp.pi
        err = err4 * 0.25                              # rad/symbol
        freq = jnp.where(
            emit, jnp.clip(freq + K_F * err / omega, -fmax, fmax), freq)

        p_re = jnp.where(emit, y_re, p_re)
        p_im = jnp.where(emit, y_im, p_im)
        new = CqpskState(t, omega, freq, phase, h_re, h_im, p_re, p_im)
        return new, (arg, emit)

    n = x.shape[-1]
    # Chunked scan: W samples unrolled per scan step, amortizing scan
    # dispatch over W samples (identical math/op order — same trick as
    # fsk4_demod's w-unroll).
    w = next(w for w in (25, 20, 16, 10, 8, 5, 4, 2, 1) if n % w == 0)

    def chunk_fn(carry, xw):
        ys, emits = [], []
        for i in range(w):
            carry, (y, e) = scan_fn(carry, xw[i])
            ys.append(y)
            emits.append(e)
        return carry, (jnp.stack(ys), jnp.stack(emits))

    xs = jnp.moveaxis(x, -1, 0)
    xs = xs.reshape((n // w, w) + xs.shape[1:])
    new_state, (ys, emits) = jax.lax.scan(chunk_fn, state, xs)
    ys = ys.reshape((n,) + ys.shape[2:])
    emits = emits.reshape((n,) + emits.shape[2:])
    return new_state, (jnp.moveaxis(ys, 0, -1), jnp.moveaxis(emits, 0, -1))


def block_agc(x: jax.Array, target: float = 1.0) -> jax.Array:
    """Feedforward AGC: normalize block RMS per batch row (the
    reference's ``analog.feedforward_agc_cc(1024, 1.0)``,
    p25_control_demod.py:149)."""
    rms = jnp.sqrt(jnp.mean(jnp.abs(x) ** 2, axis=-1, keepdims=True))
    return x * (target / jnp.maximum(rms, 1e-9))
