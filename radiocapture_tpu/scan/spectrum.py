"""Batched wideband spectrum measurement + channel-peak detection.

Batched JAX replacement for the reference's scan front half:

- ``fft_vector.py:37-60``: stream_to_vector(16384) → fft_vcc(blackman-
  harris, shifted) → mag² → nlog10 → moving_average(100 frames) →
  head/skiphead so exactly ONE averaged frame reaches the output file.
  Here the whole reduction is a single jitted step over ``[frames, L]``
  blocks — one batched FFT, and the streaming average is
  an explicit (count, sum) state instead of scheduler plumbing.

- ``fft_peak_detection.py:46-65``: min-shift to non-negative, scipy
  ``find_peaks`` with width ∈ [3 kHz, 30 kHz] in bins and prominence 1,
  keep peaks above 2× the mean, map bin → absolute frequency via
  ``bin·hz_per_bin − bw/2 + center``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from scipy import signal as _sig


class SpectrumState(NamedTuple):
    acc: jax.Array     # [fft_len] running sum of log-power frames (f32)
    count: jax.Array   # [] frames accumulated (f32)


class SpectrumScanner:
    """Streaming averaged log-power spectrum of a wideband source.

    ``step`` consumes ``[T]`` complex IQ (T a multiple of ``fft_len``)
    and accumulates per-frame log10(|FFT|²); ``spectrum_db`` reads the
    running average, DC-centered like the reference's shifted FFT
    (fft_vector.py:38).
    """

    def __init__(self, fft_len: int = 16384):
        self.fft_len = fft_len
        self.window = np.blackman(fft_len).astype(np.float32)
        # Blackman-Harris per the reference; numpy lacks the 4-term
        # variant so use scipy's.
        self.window = _sig.windows.blackmanharris(fft_len).astype(
            np.float32)
        self._step = jax.jit(self._step_impl, donate_argnums=(0,))

    def init(self) -> SpectrumState:
        return SpectrumState(acc=jnp.zeros((self.fft_len,), jnp.float32),
                             count=jnp.zeros((), jnp.float32))

    def _step_impl(self, state: SpectrumState, x: jax.Array
                   ) -> SpectrumState:
        if not jnp.iscomplexobj(x):
            x = jax.lax.complex(x[..., 0], x[..., 1])
        frames = x.reshape(-1, self.fft_len) * self.window[None, :]
        spec = jnp.fft.fftshift(jnp.fft.fft(frames, axis=-1), axes=-1)
        logp = jnp.log10(jnp.maximum(jnp.abs(spec) ** 2, 1e-30))
        return SpectrumState(acc=state.acc + jnp.sum(logp, axis=0),
                             count=state.count + frames.shape[0])

    def step(self, state: SpectrumState, x: jax.Array) -> SpectrumState:
        return self._step(state, x)

    @staticmethod
    def spectrum_db(state: SpectrumState) -> np.ndarray:
        """Averaged log10 power per bin, [fft_len], DC-centered."""
        acc = np.asarray(state.acc)
        n = float(np.asarray(state.count))
        return acc / max(n, 1.0)


@dataclass
class ChannelPeak:
    frequency: float       # absolute Hz
    bin: int
    power_db: float        # shifted log-power at the peak
    width_hz: float
    prominence: float


def find_channels(spectrum_db: np.ndarray, samp_rate: float,
                  center_freq: float, min_width_hz: float = 3000.0,
                  max_width_hz: float = 30000.0, prominence: float = 1.0,
                  mean_factor: float = 2.0) -> list[ChannelPeak]:
    """Peak detection with the reference's tuning
    (fft_peak_detection.py:52-72): widths in bins derived from Hz, peaks
    kept when the min-shifted value exceeds ``mean_factor`` × mean."""
    data = np.asarray(spectrum_db, np.float64).copy()
    n = len(data)
    hz_per_bin = samp_rate / n
    data += abs(data.min())
    avg = data.mean()
    idx, props = _sig.find_peaks(
        data, width=[min_width_hz / hz_per_bin, max_width_hz / hz_per_bin],
        prominence=prominence)
    out = []
    for i, b in enumerate(idx):
        if data[b] > avg * mean_factor:
            freq = b * hz_per_bin - samp_rate / 2.0 + center_freq
            out.append(ChannelPeak(
                frequency=float(int(freq)), bin=int(b),
                power_db=float(data[b]),
                width_hz=float(props["widths"][i] * hz_per_bin),
                prominence=float(props["prominences"][i])))
    return out
