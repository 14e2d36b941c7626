"""Wideband channelizers — the framework's primary hot kernels.

Replaces the reference's per-channel GNU Radio processes:

- ``XlatBank``: N channel *slots* extracted from one wideband stream by a
  bank of frequency-translating decimating FIRs evaluated as P polyphase
  matrix products. This is the batched form of "xlat" mode
  (reference rc_frontend/receiver.py:282-341 + rc_frontend/channel.py:29-38)
  where the reference spawns one ``freq_xlating_fir_filter_ccc`` flowgraph
  per requested channel. Slot offsets are runtime data, so channel
  create/release/retune never recompiles (SURVEY.md §7 "slot allocation").

- ``PfbChannelizer``: critically-sampled M-channel polyphase FFT
  channelizer — "pfb" mode (reference rc_frontend/receiver.py:242-261,
  ``pfb.channelizer_ccf``). Windowing is a dense einsum, followed by a
  batched FFT across the channel axis.

Both are ``(state, block) -> (state, channels)`` streaming ops with
static shapes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from radiocapture_tpu.ops import taps as _taps
from radiocapture_tpu.ops.fir import _phase_step_u32, _u32_to_angle


class XlatBankState(NamedTuple):
    history: jax.Array  # [ntaps-1] complex64 wideband history
    phase: jax.Array    # [num_slots] uint32 mixer phase (cycles * 2^32)


class XlatBank:
    """A bank of ``num_slots`` freq-xlating decimating FIR channels.

    Slot frequencies are passed per-block as ``offsets_norm`` (cycles per
    input sample, relative to the wideband center); inactive slots simply
    carry a don't-care offset and are masked downstream. All slots share
    taps and decimation — matching the reference, where every channel is
    12.5 kHz at channel_rate×2 (p25_control_demod.py:81,106).
    """

    def __init__(self, num_slots: int, decim: int, taps: np.ndarray):
        # Pad taps to a multiple of decim: P = K / D polyphase branches.
        pad = (-len(taps)) % decim
        if pad:
            taps = np.concatenate([taps, np.zeros(pad, taps.dtype)])
        self.num_slots = num_slots
        self.decim = decim
        self.taps = np.asarray(taps, np.float32)
        self.ntaps = len(taps)
        self.p = self.ntaps // decim

    @classmethod
    def for_rates(cls, num_slots: int, samp_rate: float, channel_rate: float,
                  out_per_channel_rate: float | None = None) -> "XlatBank":
        """Build a bank delivering IQ at 2x channel_rate like the reference
        (25 kS/s for 12.5 kHz channels).

        Filter: 60 dB stopband with a half-channel transition — the
        reference's per-channel filter uses the same transition width at
        only 20 dB (rc_frontend/channel.py:33 low_pass_2(..,
        channel_rate/2, channel_rate/2, 20)), so this keeps 40 dB more
        adjacent-channel rejection at the adjacent carrier while costing
        half the taps of a quarter-channel transition (the bank's K
        dimension is the framework's single hottest axis)."""
        out_rate = out_per_channel_rate or 2.0 * channel_rate
        decim = int(round(samp_rate / out_rate))
        taps = _taps.low_pass_2(1.0, samp_rate, channel_rate / 2.0,
                                0.5 * channel_rate, 60.0)
        return cls(num_slots, decim, taps)

    def init(self) -> XlatBankState:
        return XlatBankState(
            history=jnp.zeros((self.ntaps - 1,), jnp.complex64),
            phase=jnp.zeros((self.num_slots,), jnp.uint32),
        )

    def __call__(self, state: XlatBankState, x: jax.Array,
                 offsets_norm: jax.Array
                 ) -> tuple[XlatBankState, jax.Array]:
        """Extract all slots from one block.

        x: [block] complex64 wideband, block % decim == 0
        offsets_norm: [num_slots] float32 cycles/sample
        returns channels [num_slots, block // decim] complex64
        """
        k = self.ntaps
        d = self.decim
        # slot count from the offsets themselves: sharded callers pass a
        # per-device slot subset (parallel/mesh.py)
        c = offsets_norm.shape[0]
        kk = jnp.arange(k, dtype=jnp.float32)
        # Per-slot modulated taps g[c,k] = h[k] e^{j 2π f_c k}, reversed to
        # correlation form: y[c,n] = Σ_k grev[c,k] · z[nD + k].
        ang = (2.0 * jnp.pi) * offsets_norm[:, None] * kk[None, :]
        g = self.taps[None, :] * jnp.exp(1j * ang)      # [C, K]
        grev = g[:, ::-1]
        z = jnp.concatenate([state.history, x])          # [T + K-1]
        n_out = x.shape[0] // d
        p = self.p
        # Polyphase form: frame z into rows of D samples, re/im
        # interleaved ([N+P-1, 2D]); row n+q is branch q of output n, so
        # y = Σ_q frame[q : q+N] @ G[q] — P matrix products against a
        # real [2D, 2C] tap block per branch (row 2j multiplies Re z,
        # row 2j+1 Im z; columns [re | im] outputs). No window matrix is
        # materialized.
        zr = jnp.stack([jnp.real(z), jnp.imag(z)], axis=-1)
        zf = zr[: (n_out + p - 1) * d].reshape(n_out + p - 1, 2 * d)
        gr = jnp.real(grev).T.reshape(p, d, c)
        gi = jnp.imag(grev).T.reshape(p, d, c)
        g2 = jnp.concatenate(
            [jnp.stack([gr, -gi], axis=2).reshape(p, 2 * d, c),
             jnp.stack([gi, gr], axis=2).reshape(p, 2 * d, c)],
            axis=-1).astype(jnp.float32)                 # [P, 2D, 2C]
        # DEFAULT precision: TF32 operands with f32 accumulation on the
        # GPU, ~3e-4 rel-RMS against a float64 reference at production
        # width — inside the 2e-3 budget (chip_smoke.py's bank phase).
        acc = sum(jnp.dot(zf[q:q + n_out], g2[q],
                          precision=jax.lax.Precision.DEFAULT)
                  for q in range(p))                     # [N, 2C]
        y = jax.lax.complex(acc[:, :c], acc[:, c:]).T    # [C, N]
        # Per-slot mixer phase ramp, exact uint32 fixed-point (see
        # ops.fir._phase_step_u32): bit-exact across block splits.
        step = _phase_step_u32(offsets_norm, d)           # [C] uint32
        ramp = (state.phase[:, None]
                + step[:, None] * jnp.arange(n_out, dtype=jnp.uint32)[None, :])
        y = y * jnp.exp(1j * _u32_to_angle(ramp))
        new_phase = state.phase + step * jnp.uint32(n_out)
        new_hist = z[z.shape[0] - (k - 1):]
        return XlatBankState(history=new_hist, phase=new_phase), y


class PfbState(NamedTuple):
    history: jax.Array  # [(P-1)*M] complex64


class PfbChannelizer:
    """Critically-sampled M-channel polyphase FFT channelizer.

    Channel ``c`` is centered at ``+c·fs/M`` (FFT bin ordering; c > M/2
    aliases to negative offsets), delivered at ``fs/M`` — the same
    contract as ``pfb.channelizer_ccf`` with oversample 1.0 (reference
    rc_frontend/receiver.py:249-261, bins of 400 kS/s).
    """

    def __init__(self, num_channels: int, taps: np.ndarray):
        m = num_channels
        pad = (-len(taps)) % m
        if pad:
            taps = np.concatenate([taps, np.zeros(pad, taps.dtype)])
        self.num_channels = m
        self.ntaps = len(taps)
        self.p = self.ntaps // m
        hp = np.asarray(taps, np.float32).reshape(self.p, m).T  # [M, P]
        # Branch m of the analysis filter sees x[nM - m - pM]; after the
        # row-reshape trick the branch index arrives reversed, so store the
        # reversed-row polyphase matrix (see __call__). Host numpy so it
        # embeds as a trace-time constant without a device round trip.
        self.hp2 = np.ascontiguousarray(hp[::-1])  # [M, P] rows m' = M-1-m

    @classmethod
    def for_rates(cls, samp_rate: float, num_channels: int,
                  atten_db: float = 60.0) -> "PfbChannelizer":
        bin_bw = samp_rate / num_channels
        taps = _taps.optimal_low_pass(1.0, samp_rate, 0.40 * bin_bw,
                                      0.55 * bin_bw,
                                      stopband_atten_db=atten_db)
        return cls(num_channels, taps)

    def init(self) -> PfbState:
        return PfbState(history=jnp.zeros(
            ((self.p - 1) * self.num_channels,), jnp.complex64))

    def __call__(self, state: PfbState, x: jax.Array
                 ) -> tuple[PfbState, jax.Array]:
        """x: [block] with block % M == 0 → channels [M, block//M]."""
        m = self.num_channels
        p = self.p
        n = x.shape[0] // m
        z = jnp.concatenate([state.history, x])          # [(N+P-1)*M]
        zr = z.reshape(n + p - 1, m)                     # rows of M samples
        # W[t, q, :] = zr[t + P-1-q, :]; v'[t, m'] = sum_q hp2[m', q] W
        w = jnp.stack([zr[p - 1 - q: p - 1 - q + n] for q in range(p)],
                      axis=1)                            # [N, P, M]
        vp = jnp.einsum("tqm,mq->tm", w, self.hp2.astype(jnp.complex64))
        v = vp[:, ::-1]                                  # undo branch flip
        # Down-converting channel c by e^{-j2πc t/M} makes the branch
        # combiner an IDFT: y[n,c] = Σ_m v[n,m] e^{+j2πcm/M}, plus a
        # constant per-channel rotation from the K-1 group-delay offset.
        y = jnp.fft.ifft(v, axis=1) * m                  # [N, M]
        rot = jnp.exp((2j * jnp.pi / m)
                      * jnp.arange(m, dtype=jnp.float32))
        y = y * rot[None, :]
        new_hist = z[z.shape[0] - (p - 1) * m:]
        return PfbState(history=new_hist), y.T.astype(jnp.complex64)

    def channel_offset_hz(self, c: int, samp_rate: float) -> float:
        m = self.num_channels
        return ((c + m // 2) % m - m // 2) * samp_rate / m


class PfbXlatBankState(NamedTuple):
    pfb: PfbState
    fine: object    # vmapped XlatState: history [C, K2-1], phase [C]


class PfbXlatBank:
    """'pfb' frontend mode: coarse PFB into ``bin_rate`` bins, then a
    per-slot fine freq-xlating FIR from each slot's bin — the batched
    form of the reference's two-stage pfb path where ``channelizer_ccf``
    bins at 400 kS/s feed per-channel xlat flowgraphs at ``pfb_offset =
    offset - chan·pfb_samp_rate`` (rc_frontend/receiver.py:242-261,
    343-423). Drop-in for :class:`XlatBank` in the capture pipelines:
    same ``(state, x, offsets_norm) -> (state, y[C, T//decim])``
    contract, slot retunes are runtime data (bin index and fine offset
    are computed from ``offsets_norm`` inside the step).
    """

    def __init__(self, num_slots: int, samp_rate: float,
                 channel_rate: float, bin_rate: float = 400e3,
                 out_per_channel_rate: float | None = None):
        from radiocapture_tpu.ops import fir as _fir
        m = int(round(samp_rate / bin_rate))
        if abs(samp_rate - m * bin_rate) > 1e-3:
            raise ValueError("samp_rate not round enough"  # reference
                             f" for {bin_rate} Hz bins: {samp_rate}")
        self.num_slots = num_slots
        self.samp_rate = float(samp_rate)
        self.bin_rate = float(bin_rate)
        self.m = m
        self.pfb = PfbChannelizer.for_rates(samp_rate, m, atten_db=80.0)
        out_rate = out_per_channel_rate or 2.0 * channel_rate
        self.decim2 = int(round(bin_rate / out_rate))
        self.decim = m * self.decim2
        self.fine_taps = np.asarray(_taps.low_pass_2(
            1.0, bin_rate, channel_rate / 2.0, 0.25 * channel_rate, 60.0),
            np.float32)
        self.ntaps2 = len(self.fine_taps)
        self._fine = jax.vmap(_fir.freq_xlating_fir,
                              in_axes=(0, 0, None, 0, None))

    def init(self) -> PfbXlatBankState:
        from radiocapture_tpu.ops import fir as _fir
        fine = jax.tree.map(
            lambda l: jnp.broadcast_to(l, (self.num_slots,) + l.shape),
            _fir.xlat_init(self.ntaps2))
        return PfbXlatBankState(pfb=self.pfb.init(), fine=fine)

    def __call__(self, state: PfbXlatBankState, x: jax.Array,
                 offsets_norm: jax.Array
                 ) -> tuple[PfbXlatBankState, jax.Array]:
        """x: [T] complex64, T % (M·decim2) == 0; offsets_norm [C]
        cycles/input-sample → y [C, T // decim] complex64."""
        ps, bins = self.pfb(state.pfb, x)                # [M, T/M]
        # Slot → bin routing (reference chan = round(offset/pfb_rate),
        # negative wraps by +num_channels; rc_frontend/receiver.py:394-400).
        cyc_per_bin = offsets_norm * jnp.float32(self.m)  # cycles/bin-sample
        chan = jnp.round(cyc_per_bin).astype(jnp.int32)
        fine_norm = cyc_per_bin - chan.astype(jnp.float32)
        sel = bins[jnp.mod(chan, self.m)]                # [C, T/M]
        fs, y = self._fine(state.fine, sel,
                           jnp.asarray(self.fine_taps), fine_norm,
                           self.decim2)                  # [C, T/decim]
        return PfbXlatBankState(pfb=ps, fine=fs), y.astype(jnp.complex64)
