"""Terminal spectrum scope: inspect any live channel or wideband source.

Replaces the reference's Qt spectrum viewer (util/diag_scope.py:66-68 —
a GUI flowgraph attached to a live channel via frontend_connector) with
a terminal renderer fed by the same batched FFT used for scanning, so it
works over ssh next to a headless capture host.

    python -m radiocapture_tpu.tools.diag_scope capture.dat \
        --samp-rate 2400000 [--frames 32] [--width 100]
"""

from __future__ import annotations

import argparse

import numpy as np

from radiocapture_tpu.scan.spectrum import SpectrumScanner

BARS = " ▁▂▃▄▅▆▇█"


def render_spectrum(spectrum_db: np.ndarray, width: int = 100,
                    height_db: float = 60.0) -> str:
    """ASCII-art one-liner bins + axis labels."""
    n = len(spectrum_db)
    bins = np.array_split(np.asarray(spectrum_db, np.float64), width)
    vals = np.array([b.max() for b in bins])
    lo = np.percentile(vals, 10)
    scaled = np.clip((vals - lo) * 10.0 / (height_db / 10.0), 0,
                     len(BARS) - 1).astype(int)
    return "".join(BARS[v] for v in scaled)


def scope(iq: np.ndarray, samp_rate: float, center_freq: float = 0.0,
          fft_len: int = 4096, frames: int = 32, width: int = 100
          ) -> str:
    sc = SpectrumScanner(fft_len=fft_len)
    st = sc.init()
    n = min(len(iq), fft_len * frames) // fft_len * fft_len
    st = sc.step(st, np.stack([iq[:n].real, iq[:n].imag], -1))
    spec = sc.spectrum_db(st)
    line = render_spectrum(spec, width=width)
    f_lo = (center_freq - samp_rate / 2) / 1e6
    f_hi = (center_freq + samp_rate / 2) / 1e6
    label = f"{f_lo:.3f} MHz".ljust(width - 12) + f"{f_hi:.3f} MHz"
    return line + "\n" + label


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", help="complex64 IQ .dat")
    ap.add_argument("--samp-rate", type=float, required=True)
    ap.add_argument("--center-freq", type=float, default=0.0)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--width", type=int, default=100)
    args = ap.parse_args(argv)
    iq = np.fromfile(args.input, np.complex64)
    print(scope(iq, args.samp_rate, args.center_freq,
                frames=args.frames, width=args.width))


if __name__ == "__main__":
    main()
