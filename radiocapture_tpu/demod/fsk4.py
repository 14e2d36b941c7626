"""C4FM / 4-FSK symbol recovery as a batched ``lax.scan`` kernel.

Batched JAX replacement for op25's ``fsk4_demod_ff`` (C++: joint fine-
frequency + decision-directed symbol-timing tracking; used at
p25_control_demod.py:135, logging_receiver.py:247). The per-sample
sequential loop becomes a ``lax.scan`` whose carry holds the loop state,
vmapped across channel slots so hundreds of control/voice channels track
concurrently — the per-step work is one wide vector op, not a scalar loop
(SURVEY.md §7 hard part 1).

Contract: input is the FM discriminator output scaled so the four C4FM
deviation levels sit at -3,-1,+1,+3 (discriminator gain
fs / (2π·600 Hz)), already boxcar-filtered over ~one symbol. Output is
one float per symbol at the symbol rate plus a validity mask (a block of
N samples yields a data-dependent symbol count; shapes stay static).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# Loop gains, in the neighborhood op25's fsk4 uses (spread/fine-freq/
# timing); retuned for the unit-level normalization here.
K_FINE_FREQ = 0.002
K_TIMING = 0.025
HIST = 8          # interpolator span (samples)
NPHASES = 128     # polyphase interpolation resolution

_LEVELS = np.array([-3.0, -1.0, 1.0, 3.0], np.float32)


def _interp_banks() -> tuple[np.ndarray, np.ndarray]:
    """8-tap windowed-sinc interpolator + its derivative, NPHASES phases.

    The symbol instant sits ``frac`` samples *before* the newest history
    sample; with a fixed 3-sample group delay the interpolation position
    is ``hist[4 - frac]`` — bank[p] evaluates position 4 - p/NPHASES, and
    the derivative bank is taken w.r.t. +frac so the timing loop's
    gradient sign matches the clock accumulator's direction.
    """
    val = np.zeros((NPHASES, HIST), np.float32)
    dval = np.zeros((NPHASES, HIST), np.float32)
    win = np.hamming(HIST)
    eps = 1e-4

    def sinc_taps(pos):
        t = np.arange(HIST) - pos
        h = np.sinc(t) * win
        return h / np.sum(h)

    for p in range(NPHASES):
        frac = p / NPHASES
        val[p] = sinc_taps(4.0 - frac)
        dval[p] = (sinc_taps(4.0 - (frac + eps))
                   - sinc_taps(4.0 - (frac - eps))) / (2 * eps)
    return val, dval


_VAL_BANK, _DVAL_BANK = _interp_banks()
# Value and derivative taps fused side by side: the scan body then needs
# ONE [NPHASES, 2*HIST] gather per sample instead of two.
_COMB_BANK = np.concatenate([_VAL_BANK, _DVAL_BANK], axis=1)


def _farrow_coeffs(degree: int = 4) -> np.ndarray:
    """Farrow form of the interpolator: each of the 2·HIST combined taps
    as a ``degree``-order polynomial in the fractional phase.

    Evaluating the taps as polynomials instead of a per-lane table
    gather (``comb_bank[phase]``) is pure FMA work and is *more*
    accurate than the 128-phase table (max fit error ~2e-3 vs the
    1/128-phase quantization). Returns [degree+1, 2·HIST], highest
    power first (Horner order).
    """
    ph = np.arange(NPHASES) / NPHASES
    return np.stack([np.polyfit(ph, _COMB_BANK[:, k], degree)
                     for k in range(2 * HIST)], axis=1).astype(np.float32)


_FARROW = _farrow_coeffs()
_FARROW3 = _farrow_coeffs(3)   # see fsk4_demod(farrow_degree=3)


class Fsk4State(NamedTuple):
    clock: jax.Array       # [...], symbol-phase accumulator in [0,1)
    fine_freq: jax.Array   # [...], DC offset tracker (symbol units)
    hist: jax.Array        # [..., HIST] recent input samples


def fsk4_init(batch_shape=()) -> Fsk4State:
    return Fsk4State(
        clock=jnp.zeros(batch_shape, jnp.float32),
        fine_freq=jnp.zeros(batch_shape, jnp.float32),
        hist=jnp.zeros(batch_shape + (HIST,), jnp.float32),
    )


def fsk4_demod(state: Fsk4State, x: jax.Array, samp_rate: float,
               symbol_rate: float, levels: tuple = (-3.0, -1.0, 1.0, 3.0),
               k_fine_freq: float = K_FINE_FREQ,
               k_timing: float = K_TIMING,
               farrow_degree: int = 4,
               track_dtype=None,
               ) -> tuple[Fsk4State, tuple[jax.Array, jax.Array]]:
    """Track and sample symbols from a block.

    x: [..., n] discriminator samples (batch dims lead).
    Returns (state, (symbols [..., n], valid [..., n] bool)) — at most one
    symbol is emitted per input sample (sps > 1); invalid lanes are masked.

    ``levels`` selects the decision alphabet: 4-level C4FM by default;
    (-1, 1) turns this into the binary clock-recovery kernel the EDACS
    (9600 Bd) and Motorola (3600 Bd) FSK paths share — the batched
    stand-in for GNU Radio's ``clock_recovery_mm_ff``
    (edacs_control_demod.py:85, moto_control_demod.py:113).
    """
    step = jnp.float32(symbol_rate / samp_rate)
    lv = np.asarray(levels, np.float32)
    # Uniformly spaced alphabets (all of C4FM/EDACS/Moto) decide the
    # nearest level arithmetically — ~6 vector ops vs ~15 for the
    # distance/argmin form, identical result away from the measure-zero
    # midpoint ties.
    spacing = np.diff(lv)
    uniform = len(lv) > 1 and np.allclose(spacing, spacing[0])
    levels = jnp.asarray(lv)
    K_FF = jnp.float32(k_fine_freq)
    K_T = jnp.float32(k_timing)
    batch = x.shape[:-1]
    # Farrow coefficients laid out [deg+1, 2·HIST, 1...] so every scan-
    # body op broadcasts over the *minor* batch dims — the tap axis stays
    # major and each vector op runs over the whole batch.
    far = {4: _FARROW, 3: _FARROW3}.get(farrow_degree)
    if far is None:
        far = _farrow_coeffs(farrow_degree)
    cf = jnp.asarray(far).reshape(far.shape + (1,) * len(batch))
    # track_dtype=bfloat16 halves the bytes of the scan body's
    # [2·HIST, ...batch] intermediates. Interp products round at ~2^-9
    # of the ±4 symbol span — far under the half-level slicer margin —
    # while the loop carries (clock/ff) and the emitted y stay float32.
    tdt = track_dtype or jnp.float32
    cf = cf.astype(tdt)

    def sample_body(carry, xn):
        clock, ff, hist = carry              # hist: [HIST, ...batch]
        hist = jnp.concatenate([hist[1:], (xn - ff)[None]], axis=0)
        clock = clock + step
        emit = clock >= 1.0
        clockw = jnp.where(emit, clock - 1.0, clock)
        # Fractional position of the symbol instant inside this sample
        # period, in units of samples: the symbol fired clockw/step of a
        # sample-period ago.
        frac = jnp.clip(clockw / step, 0.0, 0.999)
        # Horner evaluation of the 2·HIST interpolator taps at frac.
        tt = cf[0]
        fr = frac.astype(tdt)
        for j in range(1, cf.shape[0]):
            tt = tt * fr[None] + cf[j]       # [2·HIST, ...batch]
        h = hist.astype(tdt)
        y = jnp.sum(h * tt[:HIST], axis=0, dtype=jnp.float32)
        dy = jnp.sum(h * tt[HIST:], axis=0, dtype=jnp.float32)
        # Decision-directed error vs nearest C4FM level.
        if uniform:
            s0, lo = jnp.float32(spacing[0]), jnp.float32(lv[0])
            idx = jnp.clip(jnp.round((y - lo) / s0), 0.0, len(lv) - 1)
            dec = lo + s0 * idx
        else:
            dist = jnp.abs(y[..., None] - levels)
            dec = levels[jnp.argmin(dist, axis=-1)]
        err = y - dec
        ff = jnp.where(emit, ff + K_FF * err, ff)
        clockw = jnp.where(
            emit, clockw - K_T * jnp.tanh(err * dy), clockw)
        return (clockw, ff, hist), (y, emit)

    n = x.shape[-1]
    # Chunked scan: W samples unrolled inside each scan step, amortizing
    # per-step scan dispatch over W samples (identical math/op order).
    w = next(w for w in (50, 25, 20, 16, 10, 8, 5, 4, 3, 2, 1) if n % w == 0)

    def scan_fn(carry, xw):
        ys, emits = [], []
        for i in range(w):
            carry, (y, e) = sample_body(carry, xw[i])
            ys.append(y)
            emits.append(e)
        return carry, (jnp.stack(ys), jnp.stack(emits))

    xs = jnp.moveaxis(x, -1, 0)  # [n, ...batch]
    xs = xs.reshape((n // w, w) + xs.shape[1:])
    carry0 = (state.clock, state.fine_freq,
              jnp.moveaxis(state.hist, -1, 0))
    (clock, ff, hist), (ys, emits) = jax.lax.scan(scan_fn, carry0, xs)
    new_state = Fsk4State(clock, ff, jnp.moveaxis(hist, 0, -1))
    ys = ys.reshape((n,) + ys.shape[2:])
    emits = emits.reshape((n,) + emits.shape[2:])
    return new_state, (jnp.moveaxis(ys, 0, -1), jnp.moveaxis(emits, 0, -1))


def fsk4_demod_block(state: Fsk4State, x: jax.Array, samp_rate: float,
                     symbol_rate: float,
                     levels: tuple = (-3.0, -1.0, 1.0, 3.0),
                     k_fine_freq: float = K_FINE_FREQ,
                     k_timing: float = K_TIMING,
                     block: int = 10,
                     ) -> tuple[Fsk4State, tuple[jax.Array, jax.Array]]:
    """Block-feedback variant of :func:`fsk4_demod`.

    The sample-stepped scan is latency-bound: its per-sample body is a
    ~15-op serial dependency chain (ff → hist → interp → err → ff), so
    1250 samples cost 1250 chain latencies regardless of lane count
    (measured 6.9 ms at the production batch — a third of the whole
    pipeline step). This version holds the two loop feedbacks constant
    within a ``block``-sample chunk, which makes every sample's
    interpolation/decision computable in parallel; the fine-freq and
    timing corrections accumulated over the chunk are applied once at
    the chunk boundary. The loops' time constants (1/K_FF = 500
    symbols, 1/K_T = 40 symbols) dwarf the ~4-symbol feedback delay, so
    tracking dynamics are essentially unchanged — decode equivalence vs
    the sample-stepped scan is asserted across SNR/offset/timing sweeps
    in tests/test_c4fm_chain.py.

    Emission bookkeeping is exact: with the clock frozen within a chunk
    the wrap sequence has the closed form ``emit_i = floor(b_i) >
    floor(b_{i-1})`` with ``b_i = clock0 + (i+1)·step`` (guarded to
    ignore the 0-crossing a negative post-correction clock passes).
    """
    step = jnp.float32(symbol_rate / samp_rate)
    lv = np.asarray(levels, np.float32)
    spacing = np.diff(lv)
    uniform = len(lv) > 1 and np.allclose(spacing, spacing[0])
    levels_j = jnp.asarray(lv)
    K_FF = jnp.float32(k_fine_freq)
    K_T = jnp.float32(k_timing)
    batch = x.shape[:-1]
    n = x.shape[-1]
    w = next(b for b in (block, 10, 8, 5, 4, 2, 1) if n % b == 0)
    nb = len(batch)
    cf = jnp.asarray(_FARROW).reshape(
        (_FARROW.shape[0], 1, _FARROW.shape[1]) + (1,) * nb)

    def chunk_body(carry, xw):
        clock0, ff0, hist = carry            # hist: [HIST, ...batch]
        adj = xw - ff0[None]                 # [w, ...batch]
        buf = jnp.concatenate([hist, adj], axis=0)   # [HIST+w, ...]
        # per-sample 8-sample windows, all at once: [w, HIST, ...batch]
        h = jnp.stack([buf[i + 1: i + 1 + HIST] for i in range(w)],
                      axis=0)
        i1 = jnp.arange(1, w + 1, dtype=jnp.float32).reshape(
            (w,) + (1,) * nb)
        b = clock0[None] + i1 * step
        fl = jnp.floor(b)
        # Baseline for the first sample's crossing test. Clamped to ≤0:
        # a chunk-end timing correction can leave clock0 ≥ 1 (an
        # emission pending from the previous chunk); floor(clock0)=1
        # would swallow that crossing and silently drop a symbol.
        fl_prev = jnp.concatenate(
            [jnp.minimum(jnp.floor(clock0[None]), 0.0), fl[:-1]], axis=0)
        emit = (fl > fl_prev) & (fl >= 1.0)
        clockw = b - jnp.maximum(fl, 0.0)
        frac = jnp.clip(clockw / step, 0.0, 0.999)
        tt = cf[0]
        for j in range(1, cf.shape[0]):
            tt = tt * frac[:, None] + cf[j]  # [w, 2·HIST, ...batch]
        y = jnp.sum(h * tt[:, :HIST], axis=1)
        dy = jnp.sum(h * tt[:, HIST:], axis=1)
        if uniform:
            s0, lo = jnp.float32(spacing[0]), jnp.float32(lv[0])
            idx = jnp.clip(jnp.round((y - lo) / s0), 0.0, len(lv) - 1)
            dec = lo + s0 * idx
        else:
            dist = jnp.abs(y[..., None] - levels_j)
            dec = levels_j[jnp.argmin(dist, axis=-1)]
        err = jnp.where(emit, y - dec, 0.0)
        ff1 = ff0 + K_FF * jnp.sum(err, axis=0)
        corr = K_T * jnp.sum(
            jnp.where(emit, jnp.tanh(err * dy), 0.0), axis=0)
        clock1 = clockw[-1] - corr
        return (clock1, ff1, buf[w:]), (y, emit)

    xs = jnp.moveaxis(x, -1, 0)
    xs = xs.reshape((n // w, w) + xs.shape[1:])
    carry0 = (state.clock, state.fine_freq,
              jnp.moveaxis(state.hist, -1, 0))
    (clock, ff, hist), (ys, emits) = jax.lax.scan(chunk_body, carry0, xs)
    new_state = Fsk4State(clock, ff, jnp.moveaxis(hist, 0, -1))
    ys = ys.reshape((n,) + ys.shape[2:])
    emits = emits.reshape((n,) + emits.shape[2:])
    return new_state, (jnp.moveaxis(ys, 0, -1),
                       jnp.moveaxis(emits, 0, -1))


def compact_symbols(symbols: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Host-side: keep only emitted symbols (1-D or per-row list)."""
    symbols = np.asarray(symbols)
    valid = np.asarray(valid)
    if symbols.ndim == 1:
        return symbols[valid]
    return [row[v] for row, v in zip(symbols, valid)]


def slice_dibits(symbols: np.ndarray) -> np.ndarray:
    """C4FM slicer, levels [-2, 0, 2] (op25 fsk4_slicer_fb contract,
    p25_control_demod.py:167-168): +3→1, +1→0, -1→2, -3→3."""
    s = np.asarray(symbols)
    return np.where(s > 2.0, 1,
                    np.where(s > 0.0, 0,
                             np.where(s > -2.0, 2, 3))).astype(np.uint8)


def slice_dibits_jax(symbols: jax.Array) -> jax.Array:
    s = symbols
    return jnp.where(s > 2.0, 1,
                     jnp.where(s > 0.0, 0,
                               jnp.where(s > -2.0, 2, 3))).astype(jnp.uint8)


def boxcar_taps(samp_rate: float, symbol_rate: float) -> np.ndarray:
    """Integrate-and-dump symbol filter.

    The reference integrates over a full symbol (sps taps,
    p25_control_demod.py:129-133); the TIA C4FM shaping filter's
    x/sin(x) term pre-compensates an integrate-and-dump of T/2, so a
    half-symbol boxcar is the matched choice — measured symbol RMS error
    0.09 vs 0.30 for the full-symbol filter on shaped fixtures.
    """
    n = max(1, int(round(samp_rate / symbol_rate / 2.0)))
    return np.full(n, 1.0 / n, np.float32)
