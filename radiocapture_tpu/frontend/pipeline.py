"""Batched capture pipelines: wideband IQ block → per-slot symbol streams.

This is the batched inversion of the reference's process zoo (SURVEY.md
§7): instead of one GNU Radio flowgraph per channel (reference
rc_frontend/receiver.py:282-341 spawning ``channel.channel`` per request,
and one demod process per system, p25_control_demod.py:106-183), a single
jitted step consumes a wideband block ``[T]`` and produces sliced symbols
for *all* ``num_slots`` channel slots at once:

    xlat bank (polyphase dots)  →  quadrature discriminator
      →  boxcar symbol filter (conv)  →  fsk4/M&M tracking (lax.scan)
      →  slicer

Slot center frequencies are runtime data (``offsets_norm``), so channel
create/release/retune never recompiles. Streaming continuity is carried in
an explicit state pytree; every array keeps a static shape.

One ``ControlPipeline`` instance is specialized to one air-interface class
(symbol rate + decision alphabet): P25 C4FM 4800 Bd 4-level
(p25_control_demod.py:82), EDACS 9600 Bd binary (edacs_control_demod.py:45),
Motorola 3600 Bd binary (moto_control_demod.py:50). Mixed deployments run
one pipeline per class — at most a handful of compiled variants, matching
the reference's per-protocol demod classes.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from radiocapture_tpu.demod import cqpsk as _cqpsk
from radiocapture_tpu.demod import fsk4 as _fsk4
from radiocapture_tpu.ops.channelizer import (XlatBank, XlatBankState,
                                              PfbXlatBank)
from radiocapture_tpu.ops import fm as _fm
from radiocapture_tpu.utils import wire as _wire


def _bank_step(bank, bank_state, x, offsets_norm):
    """One channelizer step; ``[T, 2]`` re/im wire blocks become complex
    first."""
    if not jnp.iscomplexobj(x):
        x = x.astype(jnp.float32)
        x = jax.lax.complex(x[..., 0], x[..., 1])
    return bank(bank_state, x, offsets_norm)


def _make_bank(frontend: str, num_slots: int, samp_rate: float,
               channel_rate: float):
    """Channel-extraction stage per config ``frontend_mode``
    (rc_frontend/receiver.py:242: 'xlat' per-channel filters, 'pfb'
    coarse polyphase bins + fine xlat; 'fft' is this framework's
    overlap-save F-engine form of xlat — same filter, ~10x fewer
    FLOPs, see ops/fft_bank.py)."""
    if frontend == "pfb":
        return PfbXlatBank(num_slots, samp_rate, channel_rate)
    if frontend == "xlat":
        return XlatBank.for_rates(num_slots, samp_rate, channel_rate)
    if frontend == "fft":
        from radiocapture_tpu.ops.fft_bank import FftXlatBank
        return FftXlatBank.for_rates(num_slots, samp_rate, channel_rate)
    raise ValueError(f"unknown frontend_mode {frontend!r}")


def _batched_fir(hist: jax.Array, x: jax.Array, taps: jax.Array,
                 stride: int = 1) -> tuple[jax.Array, jax.Array]:
    """Streaming FIR over ``[slots, T]`` with shared real taps,
    optionally decimating by ``stride``.

    Returns (new_hist [slots, K-1], y [slots, T // stride]).
    """
    k = taps.shape[0]
    z = jnp.concatenate([hist, x], axis=-1)          # [C, T+K-1]
    # DEFAULT: on the H100 this conv ran at f32 accuracy (card and CPU
    # symbols agree to ~1e-6 RMS, chip_smoke.py's pipeline phase).
    y = jax.lax.conv_general_dilated(
        z[:, None, :].astype(jnp.float32),
        taps[::-1][None, None, :].astype(jnp.float32),
        window_strides=(stride,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.DEFAULT,
    )[:, 0, :]
    return z[:, z.shape[-1] - (k - 1):], y


class ControlPipelineState(NamedTuple):
    bank: XlatBankState
    quad: _fm.QuadDemodState         # prev: [slots] complex64
    sym_hist: jax.Array              # [slots, sym_ntaps-1] float32
    fsk4: _fsk4.Fsk4State            # batch (slots,)


class ControlPipeline:
    """Wideband block → per-slot (symbols, valid, dibits)."""

    def __init__(self, num_slots: int, samp_rate: float,
                 channel_rate: float = 12500.0,
                 symbol_rate: float = 4800.0,
                 levels: tuple = (-3.0, -1.0, 1.0, 3.0),
                 deviation_hz: float = 600.0,
                 frontend: str = "xlat"):
        self.num_slots = num_slots
        self.samp_rate = float(samp_rate)
        self.channel_rate = float(channel_rate)
        self.symbol_rate = float(symbol_rate)
        self.levels = tuple(levels)
        self.deviation_hz = float(deviation_hz)
        self.bank = _make_bank(frontend, num_slots, samp_rate,
                               channel_rate)
        self.channel_fs = self.samp_rate / self.bank.decim
        # Discriminator gain maps ±deviation to the outer slicer levels
        # (reference symbol scaling: p25_control_demod.py:118-127).
        self.disc_gain = (self.channel_fs
                          / (2.0 * math.pi * float(deviation_hz)))
        self.sym_taps = _fsk4.boxcar_taps(self.channel_fs, self.symbol_rate)
        # Decimate the discriminator stream before the tracking scan when
        # ≥2.2 samples/symbol survive: the scan's cost grows with its
        # sequential steps, so halving the rate into it halves the scan.
        # P25 4800 Bd tracks at 12.5 kS/s (2.6 sps); EDACS 9600 Bd stays
        # at 25 kS/s.
        self.sym_decim = 2 if (self.channel_fs / 2.0
                               >= 2.2 * self.symbol_rate) else 1
        self.track_fs = self.channel_fs / self.sym_decim
        # Block-feedback symbol tracking (demod.fsk4.fsk4_demod_block):
        # chunk the sample-stepped scan, holding loop feedback constant
        # within a chunk (time constants 40-500 symbols >> the chunk).
        # Off by default; its speed on the GPU is not measured yet.
        # 0/1 = exact sample-stepped scan.
        self.fsk4_block = 0
        # State crosses the jit boundary wire-encoded (utils.wire);
        # complex math stays inside jit.
        self._state_spec = _wire.abstract(self._init_decoded)
        self._step = jax.jit(self._step_impl, donate_argnums=(0,),
                             static_argnames=("with_track",))

    # -- constructors matching the three reference control-channel classes
    @classmethod
    def p25_c4fm(cls, num_slots: int, samp_rate: float,
                 frontend: str = "xlat") -> "ControlPipeline":
        return cls(num_slots, samp_rate, 12500.0, 4800.0,
                   (-3.0, -1.0, 1.0, 3.0), 600.0, frontend=frontend)

    @classmethod
    def edacs(cls, num_slots: int, samp_rate: float,
              frontend: str = "xlat") -> "ControlPipeline":
        # 9600 Bd binary FSK; discriminator scaled so ±dev → ±1
        # (edacs_control_demod.py:81-90 quad gain 5 ≈ fs/2π·800 at 25 kS/s).
        return cls(num_slots, samp_rate, 12500.0, 9600.0,
                   (-1.0, 1.0), 4000.0, frontend=frontend)

    @classmethod
    def moto(cls, num_slots: int, samp_rate: float,
             frontend: str = "xlat") -> "ControlPipeline":
        # 3600 Bd binary FSK (moto_control_demod.py:105-115).
        return cls(num_slots, samp_rate, 12500.0, 3600.0,
                   (-1.0, 1.0), 4000.0, frontend=frontend)

    @property
    def decim(self) -> int:
        return self.bank.decim

    @property
    def block_multiple(self) -> int:
        """Input block length must be a multiple of this."""
        return int(np.lcm(getattr(self.bank, "block_multiple",
                                  self.bank.decim),
                          self.bank.decim * self.sym_decim))

    def _init_decoded(self) -> ControlPipelineState:
        c = self.num_slots
        return ControlPipelineState(
            bank=self.bank.init(),
            quad=_fm.quad_demod_init(batch_shape=(c,)),
            sym_hist=jnp.zeros((c, self.sym_taps.shape[0] - 1), jnp.float32),
            fsk4=_fsk4.fsk4_init(batch_shape=(c,)),
        )

    def init(self) -> ControlPipelineState:
        """Initial state, wire-encoded (all-zero either way)."""
        return _wire.zeros(_wire.encode(self._state_spec))

    def _step_impl(self, wire_state: ControlPipelineState, x: jax.Array,
                   offsets_norm: jax.Array, with_track: bool = False):
        state = _wire.decode(wire_state, self._state_spec)
        bs, chans = _bank_step(self.bank, state.bank, x, offsets_norm)
        qs, disc = _fm.quadrature_demod(state.quad, chans, self.disc_gain)
        sh, filt = _batched_fir(state.sym_hist, disc, self.sym_taps,
                                stride=self.sym_decim)
        if self.fsk4_block > 1:
            fs, (syms, valid) = _fsk4.fsk4_demod_block(
                state.fsk4, filt, self.track_fs, self.symbol_rate,
                levels=self.levels, block=self.fsk4_block)
        else:
            fs, (syms, valid) = _fsk4.fsk4_demod(
                state.fsk4, filt, self.track_fs, self.symbol_rate,
                levels=self.levels)
        if len(self.levels) == 4:
            dibits = _fsk4.slice_dibits_jax(syms).astype(jnp.int32)
        else:
            dibits = (syms > 0.0).astype(jnp.int32)
        new_state = ControlPipelineState(bank=bs, quad=qs, sym_hist=sh,
                                         fsk4=fs)
        outs = (syms, valid.astype(jnp.int32), dibits)
        if with_track:
            outs = outs + (filt,)
        return _wire.encode(new_state), outs

    def step(self, state: ControlPipelineState, x: jax.Array,
             offsets_norm: jax.Array):
        """One jitted streaming step.

        x: [T] complex64 wideband (or [T, 2] float32/bfloat16 re/im
        pairs — the ingest wire layout), T % block_multiple == 0.
        offsets_norm: [num_slots] float32, slot center offset in
          cycles/input-sample (i.e. offset_hz / samp_rate).
        Returns (state, (symbols [C, N] f32, valid [C, N] int32 0/1,
        dibits [C, N] int32)) with N = T // (decim · sym_decim).
        """
        return self._step(state, x, offsets_norm)

    def step_debug(self, state: ControlPipelineState, x: jax.Array,
                   offsets_norm: jax.Array):
        """Like :meth:`step` but the output tuple carries a 4th element:
        the pre-scan track-rate stream [C, N] (channelized →
        discriminated → symbol-filtered, before the fsk4 tracking scan).
        Used by the sequence-parallel equivalence tests, which assert
        this stream is *exactly* equal across sharding layouts."""
        return self._step(state, x, offsets_norm, with_track=True)

    def offsets_for(self, freqs_hz: np.ndarray, center_hz: float
                    ) -> np.ndarray:
        """Per-slot ``offsets_norm`` for absolute channel frequencies."""
        return ((np.asarray(freqs_hz, np.float64) - center_hz)
                / self.samp_rate).astype(np.float32)

    # ---- AFC instrumentation (reference demod_watcher probe,
    #      p25_control_demod.py:564-581) ----
    def fine_freq_hz(self, state: ControlPipelineState) -> np.ndarray:
        """Per-slot tracked residual carrier offset in Hz.

        The fsk4 scan's ``fine_freq`` carry converges to the
        discriminator DC in deviation units (±deviation_hz ↦ ±1);
        scaling back gives the frequency error the reference reads off
        its moving-average probe (p25_control_demod.py:123-127, 578).
        Works on the wire-encoded state (fine_freq is float32 either
        way)."""
        return np.asarray(state.fsk4.fine_freq) * self.deviation_hz

    def apply_freq_shift(self, state: ControlPipelineState,
                         delta_hz) -> ControlPipelineState:
        """Fold a source AFC retune of ``delta_hz`` into every slot's
        tracking carry, so the loop doesn't transiently re-correct an
        offset the mixer bank already removed (the reference avoids
        this with its 5 Hz dead-band + slow accumulation,
        rc_frontend/receiver.py:453-460; here the retune is exact so
        the carry is compensated exactly). ``delta_hz``: scalar, or an
        array broadcasting against the (possibly source-stacked)
        ``fine_freq`` carry — e.g. [S, 1] for a per-source shift on a
        grouped state."""
        ff = state.fsk4.fine_freq + (
            np.asarray(delta_hz, np.float32)
            / np.float32(self.deviation_hz))
        return state._replace(fsk4=state.fsk4._replace(fine_freq=ff))


class CqpskPipelineState(NamedTuple):
    bank: XlatBankState
    cqpsk: _cqpsk.CqpskState         # batch (slots,)


class CqpskControlPipeline:
    """Batched CQPSK capture: wideband block → per-slot (symbols, valid,
    dibits) for P25 LSM control/voice channels.

    Mirrors the reference chain prefilter → feedforward AGC →
    gardner_costas → diff_phasor → complex_to_arg → ×1/(pi/4) → slicer
    (p25_control_demod.py:136-168); here the AGC is per-block RMS
    normalization and timing/carrier tracking is the ``demod.cqpsk`` scan
    kernel vmapped across slots. Output dibits use the same slicer levels
    [-2, 0, 2, 4] as the C4FM path, so the frame layer is shared.
    """

    def __init__(self, num_slots: int, samp_rate: float,
                 channel_rate: float = 12500.0,
                 symbol_rate: float = 4800.0,
                 frontend: str = "xlat"):
        self.num_slots = num_slots
        self.samp_rate = float(samp_rate)
        self.channel_rate = float(channel_rate)
        self.symbol_rate = float(symbol_rate)
        self.bank = _make_bank(frontend, num_slots, samp_rate,
                               channel_rate)
        self.channel_fs = self.samp_rate / self.bank.decim
        self._state_spec = _wire.abstract(self._init_decoded)
        self._step = jax.jit(self._step_impl, donate_argnums=(0,))

    @classmethod
    def p25_cqpsk(cls, num_slots: int, samp_rate: float,
                  tdma: bool = False,
                  frontend: str = "xlat") -> "CqpskControlPipeline":
        # TDMA voice channels run 6000 Bd (logging_receiver.py:285-287).
        return cls(num_slots, samp_rate, 12500.0,
                   6000.0 if tdma else 4800.0, frontend=frontend)

    @property
    def decim(self) -> int:
        return self.bank.decim

    @property
    def block_multiple(self) -> int:
        return int(getattr(self.bank, "block_multiple", self.bank.decim))

    def _init_decoded(self) -> CqpskPipelineState:
        return CqpskPipelineState(
            bank=self.bank.init(),
            cqpsk=_cqpsk.cqpsk_init(self.channel_fs, self.symbol_rate,
                                    batch_shape=(self.num_slots,)),
        )

    def init(self) -> CqpskPipelineState:
        # Unlike the FM pipelines, CQPSK state is NOT all-zero (omega
        # starts at nominal samples/symbol); built and wire-encoded in
        # one jitted call.
        return jax.jit(lambda: _wire.encode(self._init_decoded()))()

    def _step_impl(self, wire_state: CqpskPipelineState, x: jax.Array,
                   offsets_norm: jax.Array):
        state = _wire.decode(wire_state, self._state_spec)
        bs, chans = _bank_step(self.bank, state.bank, x, offsets_norm)
        chans = _cqpsk.block_agc(chans)
        cs, (syms, valid) = _cqpsk.cqpsk_demod(
            state.cqpsk, chans, self.channel_fs, self.symbol_rate)
        dibits = _fsk4.slice_dibits_jax(syms).astype(jnp.int32)
        new_state = CqpskPipelineState(bank=bs, cqpsk=cs)
        return _wire.encode(new_state), (syms, valid.astype(jnp.int32),
                                         dibits)

    def step(self, state: CqpskPipelineState, x: jax.Array,
             offsets_norm: jax.Array):
        """Same contract as :meth:`ControlPipeline.step`."""
        return self._step(state, x, offsets_norm)

    def offsets_for(self, freqs_hz: np.ndarray, center_hz: float
                    ) -> np.ndarray:
        return ((np.asarray(freqs_hz, np.float64) - center_hz)
                / self.samp_rate).astype(np.float32)


class VoicePipelineState(NamedTuple):
    bank: XlatBankState
    quad: _fm.QuadDemodState
    deemph: _fm.DeemphState


class AnalogVoicePipeline:
    """Batched NBFM voice: wideband block → [slots, T'] audio at channel
    rate (resample to 8 kHz happens in the recorder; ops.resample).

    Replaces the reference's per-call ``analog`` flowgraph
    (logging_receiver.py:210-222: pwr_squelch → fm_demod_cf(deemph 75µs)
    → high-pass 300 Hz → resample); squelch is applied downstream as a
    power mask so the kernel stays branch-free. The voice band-pass
    (300 Hz high-pass + 3.4 kHz low-pass) moved downstream too — into
    the per-call recorder at 8 kHz (audio/recorder.py:_to_8k), where
    the reference's per-call flowgraph always ran it, instead of a
    401-tap channel-rate FIR for every slot of every source, for audio
    that only ACTIVE calls consume.
    """

    def __init__(self, num_slots: int, samp_rate: float,
                 channel_rate: float = 12500.0, max_dev: float = 5000.0,
                 frontend: str = "xlat"):
        self.num_slots = num_slots
        self.samp_rate = float(samp_rate)
        self.bank = _make_bank(frontend, num_slots, samp_rate,
                               channel_rate)
        self.channel_fs = self.samp_rate / self.bank.decim
        self.max_dev = float(max_dev)
        self._state_spec = _wire.abstract(self._init_decoded)
        self._step = jax.jit(self._step_impl, donate_argnums=(0,))

    @property
    def decim(self) -> int:
        return self.bank.decim

    @property
    def block_multiple(self) -> int:
        return int(getattr(self.bank, "block_multiple", self.bank.decim))

    def _init_decoded(self) -> VoicePipelineState:
        c = self.num_slots
        return VoicePipelineState(
            bank=self.bank.init(),
            quad=_fm.quad_demod_init(batch_shape=(c,)),
            deemph=_fm.deemph_init(batch_shape=(c,)),
        )

    def init(self) -> VoicePipelineState:
        return _wire.zeros(_wire.encode(self._state_spec))

    def _step_impl(self, wire_state: VoicePipelineState, x: jax.Array,
                   offsets_norm: jax.Array):
        state = _wire.decode(wire_state, self._state_spec)
        bs, chans = _bank_step(self.bank, state.bank, x, offsets_norm)
        gain = self.channel_fs / (2.0 * math.pi * self.max_dev)
        qs, disc = _fm.quadrature_demod(state.quad, chans, gain)
        ds, audio = _fm.fm_deemphasis(state.deemph, disc, self.channel_fs)
        power = jnp.mean(jnp.abs(chans) ** 2, axis=-1)   # [C] squelch meter
        new_state = VoicePipelineState(bank=bs, quad=qs, deemph=ds)
        return _wire.encode(new_state), (audio, power)

    def step(self, state: VoicePipelineState, x: jax.Array,
             offsets_norm: jax.Array):
        """x: [T] → (state, (audio [C, T//decim], power [C]))."""
        return self._step(state, x, offsets_norm)


class SpectrumSplit2:
    """``receiver_split2`` mode: one wideband source → two half-rate
    sources centered at ∓fs/4 (reference rc_frontend/receiver.py:205-237,
    a pair of ``freq_xlating_fir_filter_ccc(decim=2, ±fs/4)``).

    In the reference this spreads one dongle's stream across two CPU
    flowgraph pools; here it is the first stage of a radix channelizer
    tree (SURVEY.md §2.2) — both halves come out of one 2-slot
    ``XlatBank`` step, and each half then feeds its own batched pipeline
    as an independent logical source. Tap design matches the reference:
    ``firdes.low_pass(1, fs, (fs/2)/2, 0.5·(fs/2)/2)``.
    """

    def __init__(self, samp_rate: float):
        from radiocapture_tpu.ops import taps as _taps
        self.samp_rate = float(samp_rate)
        channel_rate = (samp_rate / 2.0) / 2.0
        taps = _taps.low_pass(1.0, samp_rate, channel_rate,
                              0.5 * channel_rate)
        self.bank = XlatBank(2, 2, taps)
        # Halves at center - fs/4 (index 0) and center + fs/4 (index 1),
        # the reference's newsource1/newsource2 ordering.
        self._offsets = np.array([-0.25, 0.25], np.float32)
        self._state_spec = _wire.abstract(self.bank.init)
        self._step = jax.jit(self._step_impl, donate_argnums=(0,))

    def init(self):
        return _wire.zeros(_wire.encode(self._state_spec))

    def half_center(self, center_freq: float, idx: int) -> float:
        return center_freq + (idx * 2 - 1) * self.samp_rate / 4.0

    def _step_impl(self, wire_state, x: jax.Array):
        state = _wire.decode(wire_state, self._state_spec)
        if not jnp.iscomplexobj(x):
            x = x.astype(jnp.float32)
            x = jax.lax.complex(x[..., 0], x[..., 1])
        st, y = self.bank(state, x, jnp.asarray(self._offsets))  # [2, T/2]
        return _wire.encode(st), jnp.stack(
            [jnp.real(y), jnp.imag(y)], axis=-1)     # [2, T/2, 2] f32

    def step(self, state, x):
        """x: [T] complex64 or [T, 2] float32, T % 2 == 0 →
        (state, halves [2, T//2, 2] float32 re/im)."""
        return self._step(state, x)
