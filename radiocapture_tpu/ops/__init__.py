"""Batched DSP kernels (pure JAX), the framework's compute core.

Every op is a pure function over ``(state, samples) -> (state, out)`` so an
unbounded stream is processed as a sequence of fixed-shape blocks with
carried state — the batched replacement for GNU Radio's per-block
C++ history buffers (reference: gr scheduler, SURVEY.md §5.7).
"""

from radiocapture_tpu.ops import taps  # noqa: F401
from radiocapture_tpu.ops.fir import (  # noqa: F401
    FirState,
    fir_filter,
    freq_xlating_fir,
    XlatState,
)
from radiocapture_tpu.ops.fm import (  # noqa: F401
    quadrature_demod,
    QuadDemodState,
    fm_deemphasis,
    DeemphState,
    nbfm_demod,
    NbfmState,
)
from radiocapture_tpu.ops.resample import (  # noqa: F401
    RationalResamplerState,
    rational_resample,
)
from radiocapture_tpu.ops.channelizer import (  # noqa: F401
    XlatBank,
    XlatBankState,
    PfbChannelizer,
    PfbState,
)
