"""Host-side FIR tap design (runs once at graph-build time, scipy/numpy).

Provides the tap families the reference obtains from GNU Radio's
``firdes.low_pass``/``low_pass_2``/``high_pass`` and ``optfir.low_pass``
(reference: rc_frontend/channel.py:33, p25_control_demod.py:107,
logging_receiver.py:215, rc_frontend/receiver.py:249-261). Taps are
computed on the host with scipy and baked into jitted kernels as
constants — tap design is never a device op.
"""

from __future__ import annotations

import numpy as np
from scipy import signal as _sig

# Approximate attenuation (dB) of the classic windows, used to size the
# filter from the requested transition width the same way windowed-sinc
# designers traditionally do.
_WINDOW_ATTEN_DB = {
    "hamming": 53.0,
    "hann": 44.0,
    "blackman": 74.0,
    "blackmanharris": 92.0,
    "rectangular": 21.0,
}


def _ntaps_from_transition(samp_rate: float, transition: float,
                           atten_db: float) -> int:
    """Number of taps needed for a given transition width and attenuation."""
    if transition <= 0:
        raise ValueError("transition width must be > 0")
    n = int(round(atten_db * samp_rate / (22.0 * transition)))
    if n % 2 == 0:
        n += 1
    return max(n, 3)


def low_pass(gain: float, samp_rate: float, cutoff: float, transition: float,
             window: str = "hamming") -> np.ndarray:
    """Windowed-sinc low-pass, sized from the transition width.

    Same contract as the reference's ``firdes.low_pass`` call sites: real
    taps, unity (×gain) DC response, cutoff at the half-amplitude point.
    """
    atten = _WINDOW_ATTEN_DB[window]
    ntaps = _ntaps_from_transition(samp_rate, transition, atten)
    taps = _sig.firwin(ntaps, cutoff, width=transition, fs=samp_rate,
                       window=window, pass_zero="lowpass")
    return (gain * taps).astype(np.float32)


def low_pass_2(gain: float, samp_rate: float, cutoff: float,
               transition: float, atten_db: float = 60.0) -> np.ndarray:
    """Attenuation-specified low-pass (Kaiser window).

    Mirrors ``firdes.low_pass_2`` usage (reference:
    rc_frontend/channel.py:33): the caller states stop-band attenuation
    explicitly instead of picking a window.
    """
    ntaps, beta = _sig.kaiserord(atten_db, transition / (0.5 * samp_rate))
    if ntaps % 2 == 0:
        ntaps += 1
    taps = _sig.firwin(ntaps, cutoff, fs=samp_rate, window=("kaiser", beta),
                       pass_zero="lowpass")
    return (gain * taps).astype(np.float32)


def high_pass(gain: float, samp_rate: float, cutoff: float,
              transition: float, window: str = "hamming") -> np.ndarray:
    """Windowed-sinc high-pass (reference: logging_receiver.py:215 uses a
    high-pass at 300 Hz to strip sub-audible signalling before the wav)."""
    atten = _WINDOW_ATTEN_DB[window]
    ntaps = _ntaps_from_transition(samp_rate, transition, atten)
    taps = _sig.firwin(ntaps, cutoff, width=transition, fs=samp_rate,
                       window=window, pass_zero="highpass")
    return (gain * taps).astype(np.float32)


def optimal_low_pass(gain: float, samp_rate: float, passband_end: float,
                     stopband_start: float, passband_ripple_db: float = 0.1,
                     stopband_atten_db: float = 60.0) -> np.ndarray:
    """Equiripple (Parks-McClellan) low-pass.

    Stands in for ``optfir.low_pass`` which the reference uses to build the
    PFB prototype filter (rc_frontend/receiver.py:249-261). Falls back to a
    Kaiser design if remez fails to converge for extreme specs.
    """
    delta_p = (10 ** (passband_ripple_db / 20.0) - 1) / \
              (10 ** (passband_ripple_db / 20.0) + 1)
    delta_s = 10 ** (-stopband_atten_db / 20.0)
    transition = stopband_start - passband_end
    # Bellanger's estimate for the remez order.
    n = int(np.ceil(2.0 / 3.0 * np.log10(1.0 / (10 * delta_p * delta_s))
                    * samp_rate / transition))
    n = max(n, 7)
    try:
        taps = _sig.remez(
            n + 1,
            [0, passband_end, stopband_start, 0.5 * samp_rate],
            [1, 0],
            weight=[1.0 / delta_p, 1.0 / delta_s],
            fs=samp_rate,
        )
    except Exception:
        return low_pass_2(gain, samp_rate, 0.5 * (passband_end + stopband_start),
                          transition, stopband_atten_db)
    return (gain * taps).astype(np.float32)


def root_raised_cosine(gain: float, samp_rate: float, symbol_rate: float,
                       alpha: float = 0.2, ntaps: int | None = None
                       ) -> np.ndarray:
    """Root-raised-cosine pulse (P25 C4FM-adjacent matched filtering)."""
    sps = samp_rate / symbol_rate
    if ntaps is None:
        ntaps = int(round(11 * sps))
        if ntaps % 2 == 0:
            ntaps += 1
    t = (np.arange(ntaps) - (ntaps - 1) / 2.0) / sps
    taps = np.zeros(ntaps)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-9:
            taps[i] = 1.0 - alpha + 4 * alpha / np.pi
        elif abs(abs(4 * alpha * ti) - 1.0) < 1e-9:
            taps[i] = (alpha / np.sqrt(2)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * alpha))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * alpha)))
        else:
            num = (np.sin(np.pi * ti * (1 - alpha))
                   + 4 * alpha * ti * np.cos(np.pi * ti * (1 + alpha)))
            den = np.pi * ti * (1 - (4 * alpha * ti) ** 2)
            taps[i] = num / den
    taps /= np.sqrt(np.sum(taps ** 2))
    return (gain * taps).astype(np.float32)


def c4fm_shaping(samp_rate: float, symbol_rate: float = 4800.0,
                 span_symbols: int = 8) -> np.ndarray:
    """P25 C4FM transmit shaping: raised-cosine Nyquist filter (α=0.2)
    cascaded with the TIA-102 sinc-compensation shaping response.

    Used by the synthetic C4FM modulator (testing.modulators) to produce
    on-air-shaped fixtures for the demod parity tests.
    """
    sps = samp_rate / symbol_rate
    ntaps = int(round(span_symbols * sps)) | 1
    t = (np.arange(ntaps) - (ntaps - 1) / 2.0) / sps
    alpha = 0.2
    # Raised cosine impulse response.
    rc = np.sinc(t) * np.cos(np.pi * alpha * t)
    den = 1.0 - (2 * alpha * t) ** 2
    rc = np.where(np.abs(den) < 1e-9, np.pi / 4 * np.sinc(1.0 / (2 * alpha)),
                  rc / np.where(np.abs(den) < 1e-9, 1.0, den))
    # TIA-102.BAAA shaping: H(f) = (pi f T / 2) / sin(pi f T / 2) applied in
    # frequency domain over |f| <= 2880 Hz.
    n_fft = 1 << int(np.ceil(np.log2(ntaps * 4)))
    freqs = np.fft.fftfreq(n_fft, d=1.0 / samp_rate)
    x = np.pi * freqs / (2.0 * symbol_rate)
    with np.errstate(divide="ignore", invalid="ignore"):
        comp = np.where(np.abs(x) < 1e-9, 1.0, x / np.sin(x))
    comp = np.where(np.abs(freqs) <= 0.6 * symbol_rate, comp, 1.0)
    spec = np.fft.fft(rc, n_fft) * comp
    shaped = np.real(np.fft.ifft(spec))[:ntaps]
    # Unit pulse peak: a lone +3 symbol reaches exactly 3x the deviation step.
    shaped /= shaped[(ntaps - 1) // 2]
    return shaped.astype(np.float32)


def voice_bandpass(samp_rate: float) -> np.ndarray:
    """The per-call voice band-pass: 300 Hz high-pass (reference
    logging_receiver.py:215) convolved with a 3.4 kHz low-pass — ONE
    definition shared by the live recorder (audio/recorder.py:_to_8k)
    and offline decode (tools/file_to_wav.py) so the two paths cannot
    drift. Cached per rate (recorders open per call, on the
    grant→first-audio latency path)."""
    key = float(samp_rate)
    taps = _VOICE_BP_CACHE.get(key)
    if taps is None:
        lp = low_pass(1.0, key, 3400.0, 600.0)
        hp = high_pass(1.0, key, 300.0, 200.0)
        taps = np.convolve(lp, hp).astype(np.float32)
        _VOICE_BP_CACHE[key] = taps
    return taps


_VOICE_BP_CACHE: dict = {}
