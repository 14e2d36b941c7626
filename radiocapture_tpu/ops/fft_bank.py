"""Overlap-save FFT channelizer bank — the F-engine form of ``XlatBank``.

Same contract as :class:`radiocapture_tpu.ops.channelizer.XlatBank`
(``(state, x[T], offsets_norm[C]) -> (state, y[C, T//D])``, slot offsets
are runtime data), but the work is one big forward FFT per wideband
block plus per-slot band extraction, instead of a [T/D, K] x [K, C]
matmul:

    z = hist(V) | x(T)            N_fft = V + T = D * N_blk
    X = FFT(z)                    (four-step: pow2 FFT + small DFT)
    per slot c:  b_c = round(f_c * N_fft)      (integer-bin center)
      Y_c[k''] = X[(b_c + k'') mod N_fft] * Hband[k'']   (N_blk bins)
      w_c      = IFFT_{N_blk}(Y_c)
      y_c[n]   = (1/D) * w_c[n] * e^{i*u32angle(phase + comb_step*n)}

where Hband folds the channel filter's DFT with the overlap-save time
shift, and ``comb_step`` folds the XlatBank mixer step with the exact
(pow2-denominator) ``b_c/N_blk`` extraction rotation so the slot lands
at DC with bit-exact cross-block phase continuity (same uint32 phase
accumulator semantics as XlatBank).

Approximation vs the time-domain bank: the filter response is truncated
to the extracted N_blk-bin band (±channel_fs/2 around the slot) — i.e.
the effective filter is the FIR's response multiplied by a brickwall.
Inside the band the response is *identical* (overlap-save is exact);
outside it rejection becomes infinite instead of the FIR's stopband
floor. The residual error vs XlatBank is the FIR's stopband leakage
(~-60 dB, tested ≤ 1e-3 relative RMS), far below symbol-decision
tolerances. The filter is also centered on the nearest FFT bin
(≤ fs/(2*N_fft) ≈ 5 Hz at production shapes) — negligible against the
6.25 kHz passband.

Why: the xlat bank does O(T/D * K * C) multiply-adds per block
(K = 1440 taps at 2.4 MS/s); the FFT form does O(T log T) + O(C * N_blk)
work and maps onto pow2 FFT + one tiny DFT matmul. Replaces the same
reference component (per-channel ``freq_xlating_fir_filter_ccc``,
rc_frontend/channel.py:29-38) — this is the "F-engine" architecture of
the radio-astronomy channelizers the design survey points at (SURVEY.md
§2.3, PAPERS.md).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from radiocapture_tpu.ops import taps as _taps
from radiocapture_tpu.ops.fir import _phase_step_u32, _u32_to_angle


def _big_fft(x: jax.Array, r: int, s: int) -> jax.Array:
    """FFT of length N = r*s over the last axis, as FFT_s (pow2) x
    DFT_r (tiny matmul) with twiddles — avoids relying on the backend's
    mixed-radix path for sizes like 3*2^16.

    x[..., n] with n = r*si + ri  ->  X[..., k1*s + k2].
    """
    if r == 1:
        return jnp.fft.fft(x)
    n = r * s
    a = x.reshape(x.shape[:-1] + (s, r))              # A[s_i, r_i]
    f = jnp.fft.fft(a, axis=-2)                       # [k2, r_i]
    # host-side f64 twiddles, embedded as constants
    k2 = np.arange(s, dtype=np.float64)[:, None]
    ri = np.arange(r, dtype=np.float64)[None, :]
    tw = np.exp(-2j * np.pi * k2 * ri / n).astype(np.complex64)
    dft = np.exp(-2j * np.pi * np.arange(r)[:, None]
                 * np.arange(r)[None, :] / r).astype(np.complex64)
    c = f * tw                                        # [k2, r_i]
    xk = jnp.einsum("...kr,rq->...qk", c, dft)        # [k1, k2]
    return xk.reshape(x.shape[:-1] + (n,))


def _pow2_split(n: int) -> tuple[int, int]:
    s = n & (-n)          # largest power of two dividing n
    return n // s, s


class FftXlatBankState(NamedTuple):
    history: jax.Array  # [V] complex64 wideband history
    phase: jax.Array    # [num_slots] uint32 mixer phase (cycles * 2^32)


class FftXlatBank:
    """Drop-in for :class:`XlatBank` built on overlap-save FFTs.

    ``block_multiple`` is the per-window valid length T = D*N_blk - V;
    inputs may be any multiple of it (windows chain through the history
    state exactly like XlatBank blocks).
    """

    def __init__(self, num_slots: int, decim: int, taps: np.ndarray,
                 n_blk: int = 2048):
        if n_blk & (n_blk - 1):
            raise ValueError("n_blk must be a power of two")
        self.num_slots = num_slots
        self.decim = decim
        self.n_blk = n_blk
        self.n_fft = decim * n_blk
        k = len(taps)
        if k >= self.n_fft // 2:
            raise ValueError("taps too long for the FFT window")
        self.ntaps = k
        # overlap: smallest multiple of D covering the filter history
        self.v = -((-(k - 1)) // decim) * decim
        self.t_window = self.n_fft - self.v
        if self.t_window <= 0:
            raise ValueError("filter longer than the FFT window")
        self.block_multiple = self.t_window
        # Hband[k'] = H(koff) * e^{2πi koff V / N_fft}, natural IFFT
        # order (host f64 -> c64 constant).
        hfull = np.fft.fft(np.asarray(taps, np.float64), self.n_fft)
        kp = np.arange(n_blk)
        koff = np.where(kp < n_blk // 2, kp, kp - n_blk)
        self._hband = (hfull[koff % self.n_fft]
                       * np.exp(2j * np.pi * koff * self.v / self.n_fft)
                       / decim).astype(np.complex64)
        self._koff = koff.astype(np.int32)
        self._r, self._s = _pow2_split(self.n_fft)

    @classmethod
    def for_rates(cls, num_slots: int, samp_rate: float,
                  channel_rate: float,
                  out_per_channel_rate: float | None = None,
                  n_blk: int = 2048) -> "FftXlatBank":
        """Same tap/rate contract as ``XlatBank.for_rates`` (channel IQ
        at 2x channel_rate, reference p25_control_demod.py:81,106)."""
        out_rate = out_per_channel_rate or 2.0 * channel_rate
        decim = int(round(samp_rate / out_rate))
        taps = _taps.low_pass_2(1.0, samp_rate, channel_rate / 2.0,
                                0.5 * channel_rate, 60.0)
        return cls(num_slots, decim, taps, n_blk=n_blk)

    def init(self) -> FftXlatBankState:
        return FftXlatBankState(
            history=jnp.zeros((self.v,), jnp.complex64),
            phase=jnp.zeros((self.num_slots,), jnp.uint32),
        )

    def _window(self, hist: jax.Array, x: jax.Array, phase: jax.Array,
                offsets_norm: jax.Array
                ) -> tuple[jax.Array, jax.Array, jax.Array]:
        """One overlap-save window: hist[V] + x[T] -> y [C, T//D]."""
        d, nb, nf = self.decim, self.n_blk, self.n_fft
        n_out = self.t_window // d
        z = jnp.concatenate([hist, x])                  # [N_fft]
        xf = _big_fft(z, self._r, self._s)              # [N_fft]
        # integer-bin slot centers (float64 keeps b_c exact for any
        # production N_fft; offsets are float32 wire data)
        bc = jnp.round(offsets_norm.astype(jnp.float64)
                       * nf).astype(jnp.int32)          # [C]
        idx = jnp.mod(bc[:, None]
                      + jnp.asarray(self._koff)[None, :], nf)
        yb = jnp.take(xf, idx, axis=0)                  # [C, N_blk]
        # y_full[V+Dn] = (N_blk/N_fft) * IFFTnorm(...) = (1/D) * IFFTnorm;
        # the 1/D is folded into _hband.
        w = jnp.fft.ifft(yb * jnp.asarray(self._hband)[None, :],
                         axis=-1)                       # [C, N_blk]
        w = w[:, :n_out]
        # mixer: XlatBank's exact uint32 ramp, plus the pow2-exact
        # extraction terms b_c*n/N_blk and b_c*(V/D)/N_blk
        log2_nb = int(np.log2(nb))
        bmod = jnp.mod(bc, nb).astype(jnp.uint32)
        comb = (_phase_step_u32(offsets_norm, d)
                + (bmod << jnp.uint32(32 - log2_nb)))   # [C]
        const = jnp.mod(bc * (self.v // d), nb).astype(jnp.uint32) \
            << jnp.uint32(32 - log2_nb)
        ramp = (phase + const)[:, None] + comb[:, None] \
            * jnp.arange(n_out, dtype=jnp.uint32)[None, :]
        # Filter-centering phase: the band filter sits at b_c/N_fft, a
        # residual δ_c = f_c - b_c/N_fft off the true slot center; its
        # linear phase sampled δ_c off-center contributes a constant
        # -2πδ_c(K-1)/2 (b_c/N_blk has a pow2 denominator, so δ_c is
        # exact in f32).
        delta = offsets_norm - bc.astype(jnp.float32) / jnp.float32(nf)
        phi = (jnp.float32(2.0 * np.pi) * delta
               * jnp.float32((self.ntaps - 1) / 2.0))
        y = w * jnp.exp(1j * (_u32_to_angle(ramp) + phi[:, None]))
        new_phase = phase + _phase_step_u32(offsets_norm, d) \
            * jnp.uint32(n_out)
        new_hist = z[nf - self.v:]
        return new_hist, new_phase, y.astype(jnp.complex64)

    def __call__(self, state: FftXlatBankState, x: jax.Array,
                 offsets_norm: jax.Array
                 ) -> tuple[FftXlatBankState, jax.Array]:
        """x: [T] complex64, T % block_multiple == 0 →
        (state, y [C, T//decim])."""
        t = x.shape[0]
        if t % self.t_window:
            raise ValueError(
                f"block {t} not a multiple of window {self.t_window}")
        hist, phase = state.history, state.phase
        outs = []
        for w0 in range(0, t, self.t_window):
            hist, phase, y = self._window(
                hist, x[w0:w0 + self.t_window], phase, offsets_norm)
            outs.append(y)
        y = outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=-1)
        return FftXlatBankState(history=hist, phase=phase), y
