"""Channelizer bank parity: xlat bank vs single-channel xlat, PFB tones."""

import numpy as np
import jax.numpy as jnp

from radiocapture_tpu.ops import fir as F
from radiocapture_tpu.ops import taps as T
from radiocapture_tpu.ops.channelizer import XlatBank, PfbChannelizer
from radiocapture_tpu.testing import modulators as M


def test_xlat_bank_matches_single_channel(rng):
    fs = 2_400_000.0
    bank = XlatBank.for_rates(num_slots=4, samp_rate=fs, channel_rate=12500.0)
    x = (rng.standard_normal(bank.decim * 512)
         + 1j * rng.standard_normal(bank.decim * 512)).astype(np.complex64)
    offsets = np.array([0.05, -0.11, 0.2, 0.0], np.float32)

    st = bank.init()
    st, y = bank(st, jnp.asarray(x), jnp.asarray(offsets))
    y = np.asarray(y)

    for c in range(4):
        sst = F.xlat_init(bank.ntaps)
        _, yc = F.freq_xlating_fir(sst, jnp.asarray(x),
                                   jnp.asarray(bank.taps),
                                   jnp.float32(offsets[c]), bank.decim)
        np.testing.assert_allclose(y[c], np.asarray(yc), atol=2e-3)


def test_xlat_bank_extracts_tones():
    fs = 2_400_000.0
    bank = XlatBank.for_rates(num_slots=3, samp_rate=fs, channel_rate=12500.0)
    n = bank.decim * 1024
    wide = M.multi_channel(fs, [
        (100_000.0, M.upsample_to(M.tone(25000.0, 2000.0, 30000), 25000, fs)),
        (-400_000.0, M.upsample_to(M.tone(25000.0, -3000.0, 30000), 25000, fs)),
    ], n)
    offsets = np.array([100_000.0, -400_000.0, 700_000.0], np.float32) / fs

    st = bank.init()
    st, y = bank(st, jnp.asarray(wide), jnp.asarray(offsets))
    y = np.asarray(y)[:, 100:]
    fs_ch = fs / bank.decim

    def est_freq(z):
        d = np.angle(z[1:] * np.conj(z[:-1]))
        return np.mean(d) * fs_ch / (2 * np.pi)

    assert abs(est_freq(y[0]) - 2000.0) < 20.0
    assert abs(est_freq(y[1]) + 3000.0) < 20.0
    # Empty slot: only noise floor.
    assert np.mean(np.abs(y[2])) < 0.02 * np.mean(np.abs(y[0]))


def test_xlat_bank_block_split(rng):
    fs = 1_000_000.0
    bank = XlatBank.for_rates(num_slots=2, samp_rate=fs, channel_rate=12500.0)
    x = (rng.standard_normal(bank.decim * 256)
         + 1j * rng.standard_normal(bank.decim * 256)).astype(np.complex64)
    offsets = jnp.asarray(np.array([0.07, -0.3], np.float32))

    st = bank.init()
    _, y_once = bank(st, jnp.asarray(x), offsets)
    st = bank.init()
    outs = []
    for blk in x.reshape(4, -1):
        st, yb = bank(st, jnp.asarray(blk), offsets)
        outs.append(np.asarray(yb))
    np.testing.assert_allclose(np.concatenate(outs, axis=1),
                               np.asarray(y_once), atol=2e-3)


def test_pfb_channelizer_tone_routing():
    fs = 1_600_000.0
    m = 16  # 100 kHz bins
    pfb = PfbChannelizer.for_rates(fs, m)
    n = m * 4096
    # Tones in channels 2 (at +200k+5k) and 13 (== -3 → -300k-8k).
    wide = (M.tone(fs, 205_000.0, n) + M.tone(fs, -308_000.0, n)
            ).astype(np.complex64)
    st = pfb.init()
    st, y = pfb(st, jnp.asarray(wide))
    y = np.asarray(y)[:, 64:]
    fs_ch = fs / m

    def est_freq(z):
        d = np.angle(z[1:] * np.conj(z[:-1]))
        return np.mean(d) * fs_ch / (2 * np.pi)

    assert abs(est_freq(y[2]) - 5000.0) < 100.0
    assert abs(est_freq(y[13]) + 8000.0) < 100.0
    # Leakage into a quiet channel is far below the tone channels.
    p_sig = np.mean(np.abs(y[2]) ** 2)
    p_quiet = np.mean(np.abs(y[7]) ** 2)
    assert p_quiet < 1e-4 * p_sig


def test_xlat_bank_matches_float64_reference_at_production_width(rng):
    """XlatBank at the production width (2.4 MS/s, 64 slots, K = 1440,
    one 100 ms block, offsets spread across the band, mid-stream history
    and mixer phase) against a float64 direct correlation. On the CPU the
    bank computes in float32; the float32 tap phasors (angles up to
    ~2π·0.5·1440) bound it to ~5e-5 rel-RMS, so 2e-4 is the tolerance
    here (the GPU's TF32 budget is 2e-3, chip_smoke.py)."""
    from radiocapture_tpu.ops.channelizer import XlatBankState
    from radiocapture_tpu.testing import reference as R

    fs = 2_400_000.0
    bank = XlatBank.for_rates(num_slots=64, samp_rate=fs,
                              channel_rate=12500.0)
    assert (bank.ntaps, bank.decim) == (1440, 96)

    def cplx(n):
        return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
                / np.sqrt(2)).astype(np.complex64)

    x, hist = cplx(240_000), cplx(bank.ntaps - 1)
    offs = ((np.arange(64) - 31.5) * 0.95 / 64).astype(np.float32)
    phase0 = rng.integers(0, 2 ** 32, 64, dtype=np.uint64).astype(np.uint32)
    st = XlatBankState(jnp.asarray(hist), jnp.asarray(phase0))
    st2, y = bank(st, jnp.asarray(x), jnp.asarray(offs))
    ref = R.xlat_bank(x, hist, bank.taps, offs, phase0, bank.decim)
    assert y.shape == (64, 2500)
    assert R.rel_rms(np.asarray(y), ref) < 2e-4
    np.testing.assert_array_equal(np.asarray(st2.history),
                                  x[-(bank.ntaps - 1):])


def test_pipeline_accepts_bf16_wire_blocks(rng):
    """The ingest ring's bfloat16 wire layout (PERF.md §6) must flow
    through ControlPipeline like float32: same shapes, and near-
    identical symbols on the same input (bf16 rounds the 8-12
    significant bits of SDR IQ well below the slicer margins)."""
    import ml_dtypes
    from radiocapture_tpu.frontend.pipeline import ControlPipeline

    pipe = ControlPipeline.p25_c4fm(num_slots=4, samp_rate=200e3)
    n = pipe.block_multiple * 4
    x32 = rng.standard_normal((n, 2)).astype(np.float32) * 0.3
    x16 = x32.astype(ml_dtypes.bfloat16)
    offs = jnp.zeros(4, jnp.float32)
    sa = pipe.init()
    sb = pipe.init()
    sa, (ya, va, da) = pipe.step(sa, jnp.asarray(x32), offs)
    sb, (yb, vb, db) = pipe.step(sb, jnp.asarray(x16), offs)
    assert ya.shape == yb.shape and va.shape == vb.shape
    np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))
    scale = max(1e-6, float(jnp.abs(ya).max()))
    np.testing.assert_allclose(np.asarray(ya), np.asarray(yb),
                               atol=0.05 * scale)


def test_pfb_block_split(rng):
    fs = 800_000.0
    m = 8
    pfb = PfbChannelizer.for_rates(fs, m)
    x = (rng.standard_normal(m * 2048)
         + 1j * rng.standard_normal(m * 2048)).astype(np.complex64)
    st = pfb.init()
    _, y_once = pfb(st, jnp.asarray(x))
    st = pfb.init()
    outs = []
    for blk in x.reshape(4, -1):
        st, yb = pfb(st, jnp.asarray(blk))
        outs.append(np.asarray(yb))
    np.testing.assert_allclose(np.concatenate(outs, axis=1),
                               np.asarray(y_once), atol=2e-4)


def test_pfb_xlat_bank_matches_xlat_bank_tones():
    """'pfb' frontend (coarse bins + fine xlat) extracts the same
    channels as 'xlat' mode: same tone frequencies out, including a
    channel that does NOT sit on a bin center."""
    from radiocapture_tpu.ops.channelizer import PfbXlatBank

    fs = 2_400_000.0
    offs_hz = np.array([500_000.0, -433_000.0, 0.0], np.float32)
    bank = PfbXlatBank(3, fs, 12500.0)
    n = bank.decim * 512
    wide = (M.multi_channel(fs, [
        (500_000.0, M.upsample_to(M.tone(25000.0, 2000.0, 15000),
                                  25000, fs)),
        (-433_000.0, M.upsample_to(M.tone(25000.0, -3000.0, 15000),
                                   25000, fs)),
    ], n)).astype(np.complex64)

    st = bank.init()
    st, y = bank(st, jnp.asarray(wide), jnp.asarray(offs_hz / fs))
    y = np.asarray(y)[:, 200:]
    fs_ch = fs / bank.decim

    def est(z):
        return float(np.mean(np.angle(z[1:] * np.conj(z[:-1])))
                     * fs_ch / (2 * np.pi))

    assert abs(est(y[0]) - 2000.0) < 20.0
    assert abs(est(y[1]) + 3000.0) < 20.0
    assert np.mean(np.abs(y[2])) < 0.05 * np.mean(np.abs(y[0]))

    # streaming continuity across block splits
    st2 = bank.init()
    outs = []
    for blk in wide.reshape(4, -1):
        st2, yb = bank(st2, jnp.asarray(blk), jnp.asarray(offs_hz / fs))
        outs.append(np.asarray(yb))
    one = np.concatenate(outs, axis=1)
    st3 = bank.init()
    _, y_once = bank(st3, jnp.asarray(wide), jnp.asarray(offs_hz / fs))
    np.testing.assert_allclose(one, np.asarray(y_once), atol=2e-3)


def test_fft_bank_matches_xlat_bank():
    """The overlap-save F-engine bank (ops/fft_bank, frontend_mode
    'fft') must match XlatBank within the FIR's stopband leakage
    (~-60 dB → rel RMS ≲ 1e-2 at this tiny N_fft; production N_fft is
    96x larger so the residual band-centering error shrinks with it),
    including streaming continuity and the exact uint32 mixer phase."""
    from radiocapture_tpu.ops.fft_bank import FftXlatBank
    rng = np.random.default_rng(7)
    samp, ch = 200e3, 12.5e3
    xb = XlatBank.for_rates(5, samp, ch)
    fb = FftXlatBank(5, xb.decim, xb.taps, n_blk=256)
    assert fb.block_multiple % xb.decim == 0
    offs = np.array([0.0, 0.1, -0.23, 0.31, -0.05], np.float32)
    xs = (rng.standard_normal((3, fb.t_window))
          + 1j * rng.standard_normal((3, fb.t_window))
          ).astype(np.complex64)
    s1, s2 = xb.init(), fb.init()
    for blk in range(3):
        s1, y1 = xb(s1, jnp.asarray(xs[blk]), jnp.asarray(offs))
        s2, y2 = fb(s2, jnp.asarray(xs[blk]), jnp.asarray(offs))
        y1, y2 = np.asarray(y1), np.asarray(y2)
        assert y1.shape == y2.shape
        rel = np.sqrt(np.mean(np.abs(y1 - y2) ** 2)
                      / np.mean(np.abs(y1) ** 2))
        assert rel < 1.5e-2, (blk, rel)
    # multi-window blocks chain through the history state
    s3 = fb.init()
    _, y3 = fb(s3, jnp.asarray(xs.reshape(-1)), jnp.asarray(offs))
    s4 = fb.init()
    parts = []
    for blk in range(3):
        s4, yb = fb(s4, jnp.asarray(xs[blk]), jnp.asarray(offs))
        parts.append(np.asarray(yb))
    np.testing.assert_allclose(np.asarray(y3),
                               np.concatenate(parts, axis=1), atol=1e-5)


def test_fft_frontend_mode_pipeline():
    """frontend_mode='fft' drops into ControlPipeline: same decode
    contract, block_multiple = the bank's overlap-save window."""
    from radiocapture_tpu.frontend.pipeline import ControlPipeline
    pipe = ControlPipeline.p25_c4fm(num_slots=4, samp_rate=200e3,
                                    frontend="fft")
    assert pipe.block_multiple % (pipe.decim * pipe.sym_decim) == 0
    rng = np.random.default_rng(3)
    x = rng.standard_normal((pipe.block_multiple, 2)).astype(np.float32)
    st = pipe.init()
    st, (syms, valid, dibits) = pipe.step(st, jnp.asarray(x),
                                          jnp.zeros(4, jnp.float32))
    assert syms.shape[0] == 4
    assert syms.shape == valid.shape == dibits.shape
