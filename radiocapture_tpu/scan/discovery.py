"""System discovery: trial-demodulate every spectral peak in one batch.

Batched JAX replacement for the reference's ``fft_peak_detection.py:68-106``
(spawn one ``p25_control_demod`` OS process per detected peak, wait 30 s,
log which ones locked, measure frequency offsets) and the brute-force
band scanner ``ov_scan.py:34-111`` (40 parallel demods at ±offsets around
candidate control frequencies, retuning the dongle across 768-775 and
850-863 MHz).

Instead of a process per candidate, every candidate frequency becomes a
channel *slot* of one batched ``ControlPipeline`` step — trying 64
frequencies costs the same device time as trying one. Lock decisions and
site detail come from the per-slot host engines.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from radiocapture_tpu.demod.engines import P25ControlEngine
from radiocapture_tpu.frontend.pipeline import ControlPipeline


@dataclass
class TrialResult:
    frequency: float            # candidate absolute Hz
    locked: bool
    site_detail: dict = field(default_factory=dict)
    offset_hz: float | None = None   # candidate − decoded Control Channel
    quality: float = 0.0
    bad_messages: int = 0
    total_messages: int = 0

    def summary_line(self, index: int = 0) -> str:
        """The reference's ``fft.scan.output`` record
        (fft_peak_detection.py:100-101)."""
        detail = self.site_detail
        sid = "%s %s-%s %s-%s" % (
            detail.get("Control Channel"), detail.get("System ID"),
            detail.get("WACN ID"), detail.get("RF Sub-system ID"),
            detail.get("Site ID")) if self.locked else None
        return "%s %s %s %s %s %s" % (index, int(self.frequency),
                                      self.offset_hz, sid, self.quality,
                                      self.bad_messages)


def trial_p25_lock(wideband_iq: np.ndarray, samp_rate: float,
                   center_freq: float, candidates: list[float],
                   block_syms: int = 512, max_slots: int = 64
                   ) -> list[TrialResult]:
    """Feed one wideband capture to a batched P25 C4FM trial bank.

    candidates: absolute frequencies (e.g. ``ChannelPeak.frequency`` from
    :func:`radiocapture_tpu.scan.spectrum.find_channels`, or the ±offset
    grid of :func:`band_scan_candidates`).

    Returns one :class:`TrialResult` per candidate. Lock means the slot's
    engine saw a sustained framed TSDU stream (engine ``is_locked``,
    p25_control_demod.py:297-334 semantics); ``offset_hz`` is candidate
    minus the decoded Control Channel when IDEN/RFSS data resolved it
    (fft_peak_detection.py:84-96).
    """
    if not candidates:
        return []
    groups = [candidates[i:i + max_slots]
              for i in range(0, len(candidates), max_slots)]
    results: list[TrialResult] = []
    for group in groups:
        n_slots = len(group)
        pipe = ControlPipeline.p25_c4fm(num_slots=n_slots,
                                        samp_rate=samp_rate)
        offs = pipe.offsets_for(np.asarray(group), center_freq)
        engines = [P25ControlEngine() for _ in group]
        state = pipe.init()
        blk = pipe.decim * block_syms
        x = np.stack([wideband_iq.real, wideband_iq.imag],
                     axis=-1).astype(np.float32)
        n_blocks = len(wideband_iq) // blk
        for b in range(n_blocks):
            state, (syms, valid, dib) = pipe.step(
                state, x[b * blk:(b + 1) * blk], offs)
            valid = np.asarray(valid).astype(bool)
            dib = np.asarray(dib)
            for s, eng in enumerate(engines):
                eng.feed_dibits(dib[s][valid[s]])
        for freq, eng in zip(group, engines):
            good = eng.total_messages - eng.bad_messages
            detail = eng.site_detail
            offset = None
            if eng.is_locked and detail.get("Control Channel"):
                offset = freq - detail["Control Channel"]
            results.append(TrialResult(
                frequency=freq, locked=eng.is_locked,
                site_detail=dict(detail), offset_hz=offset,
                quality=(good / max(1, eng.total_messages)),
                bad_messages=eng.bad_messages,
                total_messages=eng.total_messages))
    return results


def average_offset(results: list[TrialResult], limit_hz: float = 5000.0
                   ) -> float | None:
    """AFC seed: mean measured offset of locked candidates within
    ±limit (fft_peak_detection.py:96-98, 103-106)."""
    offs = [r.offset_hz for r in results
            if r.locked and r.offset_hz is not None
            and -limit_hz < r.offset_hz < limit_hz]
    return sum(offs) / len(offs) if offs else None


def band_scan_candidates(ranges_hz: list[tuple[float, float]],
                         step_hz: float = 12.5e3,
                         offsets_hz: tuple = (0.0,),
                         ) -> list[float]:
    """Brute-force candidate grid for a band sweep (ov_scan.py:34-58:
    candidate control frequencies at channel raster across 768-775 and
    850-863 MHz, each optionally tried at several ± fine offsets)."""
    cands: list[float] = []
    for lo, hi in ranges_hz:
        f = lo
        while f <= hi:
            for d in offsets_hz:
                cands.append(f + d)
            f += step_hz
    return cands
