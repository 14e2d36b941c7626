"""Polyphase rational resampler (streaming, static-shape).

Batched JAX equivalent of ``filter.rational_resampler_fff`` used by the
reference to reach 8 kHz / 48 kHz audio rates
(logging_receiver.py:216-221, 338). The polyphase decomposition is
evaluated as one dense ``[n_out, kp] @ [kp]``-per-phase contraction with
trace-time-constant gather indices (interp/decim are static), so XLA sees
a fixed einsum — no per-sample Python.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from radiocapture_tpu.ops import taps as _taps


class RationalResamplerState(NamedTuple):
    history: jax.Array  # [hist_len] trailing input samples


def design_resampler_taps(interp: int, decim: int,
                          atten_db: float = 60.0) -> np.ndarray:
    """Prototype low-pass at min(π/interp, π/decim) with gain=interp."""
    cutoff = 0.5 / max(interp, decim)
    transition = 0.2 / max(interp, decim)
    t = _taps.low_pass_2(float(interp), 1.0, cutoff, transition, atten_db)
    # Pad to a multiple of interp so the polyphase split is rectangular.
    pad = (-len(t)) % interp
    if pad:
        t = np.concatenate([t, np.zeros(pad, np.float32)])
    return t


def resampler_init(taps, interp: int) -> RationalResamplerState:
    kp = len(taps) // interp
    return RationalResamplerState(history=jnp.zeros((kp,), jnp.float32))


def rational_resample(state: RationalResamplerState, x: jax.Array,
                      taps: jax.Array, interp: int, decim: int
                      ) -> tuple[RationalResamplerState, jax.Array]:
    """Resample by interp/decim. ``len(x)*interp`` must divide ``decim``.

    Semantics: upsample by ``interp`` (zero-stuffing), filter with
    ``taps`` (which include the ×interp gain), downsample by ``decim``.
    """
    k = taps.shape[0]
    kp = k // interp
    n_in = x.shape[0]
    n_out = n_in * interp // decim
    if n_in * interp % decim != 0:
        raise ValueError(
            f"block of {n_in} with {interp}/{decim} gives fractional output")

    # Polyphase matrix hp[p, j] = taps[j*interp + p].
    hp = taps.reshape(kp, interp).T  # [interp, kp]

    z = jnp.concatenate([state.history, x])  # [kp + n_in]
    # Output m sits at upsampled position p = m*decim:
    #   phase[m] = p % interp,  base[m] = p // interp  (input index)
    #   y[m] = sum_j hp[phase[m], j] * z_in[base[m] - j]
    m = np.arange(n_out)
    p = m * decim
    phase = (p % interp).astype(np.int32)
    base = (p // interp).astype(np.int32) + kp  # offset by history length
    j = np.arange(kp)
    gather_idx = base[:, None] - j[None, :]  # [n_out, kp], all >= 1

    frames = z[jnp.asarray(gather_idx)]          # [n_out, kp]
    coefs = hp[jnp.asarray(phase)]               # [n_out, kp]
    y = jnp.sum(frames * coefs, axis=-1)
    new_hist = z[z.shape[0] - kp:]
    return RationalResamplerState(history=new_hist), y


def resample_ratio(in_rate: float, out_rate: float) -> tuple[int, int]:
    """Smallest (interp, decim) with out = in * interp / decim."""
    g = math.gcd(int(round(in_rate)), int(round(out_rate)))
    return int(round(out_rate)) // g, int(round(in_rate)) // g
