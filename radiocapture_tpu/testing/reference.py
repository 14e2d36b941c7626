"""Plain float64 NumPy references for the device kernels."""

from __future__ import annotations

import numpy as np


def xlat_bank(x: np.ndarray, hist: np.ndarray, taps: np.ndarray,
              offsets_norm: np.ndarray, phase0: np.ndarray,
              decim: int) -> np.ndarray:
    """What :class:`radiocapture_tpu.ops.channelizer.XlatBank` computes
    for one block, as a float64 direct correlation of the slot-modulated
    taps over the history-prefixed block, then the bank's uint32 mixer
    ramp. Returns y [C, len(x) // decim] complex128."""
    k = len(taps)
    z = np.concatenate([hist, x]).astype(np.complex128)
    n = len(x) // decim
    g = (np.asarray(taps, np.float64)[None, :]
         * np.exp(2j * np.pi * np.asarray(offsets_norm, np.float64)[:, None]
                  * np.arange(k)))
    win = np.lib.stride_tricks.as_strided(
        z, (n, k), (z.strides[0] * decim, z.strides[0]))
    y = (win @ g[:, ::-1].T).T                                  # [C, n]
    # the bank's float32 step quantization, then exact uint32 wraps
    step = (np.mod(-np.asarray(offsets_norm, np.float32) * np.float32(decim),
                   np.float32(1.0)) * np.float32(2.0 ** 32)
            ).astype(np.uint32)
    ramp = (np.asarray(phase0, np.uint32)[:, None]
            + step[:, None] * np.arange(n, dtype=np.uint32))
    return y * np.exp(1j * ramp.astype(np.float64) * (2 * np.pi / 2 ** 32))


def rel_rms(got: np.ndarray, ref: np.ndarray) -> float:
    """||got - ref|| / ||ref|| over all elements."""
    return float(np.sqrt(np.sum(np.abs(got - ref) ** 2)
                         / np.sum(np.abs(ref) ** 2)))
