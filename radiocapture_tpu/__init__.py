"""radiocapture_tpu — a JAX trunked-radio bulk-capture framework.

A from-scratch reimplementation of the capabilities of
MattMills/radiocapture-rf (reference mounted at /root/reference), designed
for JAX/XLA on a GPU rather than GNU Radio C++ blocks on CPU:

- ``ops``       batched DSP kernels: tap design, freq-xlating FIR banks,
                polyphase channelizers, FM demod, resamplers, spectral scan
- ``demod``     symbol recovery (C4FM fsk4, M&M, Gardner-Costas) as
                ``lax.scan`` kernels batched over channel slots
- ``fec``       error-control codecs: CRC16, 1/2-rate trellis, Golay(24,12),
                Hamming(10,6,3), RS(24,12) over GF(2^6), BCH(48,36), parity
- ``protocol``  P25 CAI / Motorola / EDACS message field decoding (host side)
- ``frontend``  channel-slot scheduler + wire-compatible channelizer server
- ``control``   call managers, recorders, event bus, supervision
- ``parallel``  device-mesh sharding of channel slots & time blocks
- ``scan``      FFT spectrum scan + peak detection (system discovery)
- ``audio``     wav/mp3 recording chain, vocoder interfaces
- ``testing``   synthetic modulators & fixtures (the test layer the
                reference lacks; see SURVEY.md §4)

The hot signal path runs as statically-shaped, batched arrays
``[channel_slots, block_time]`` under ``jit``; streaming continuity is
carried as explicit state pytrees (filter history, loop state, phase), and
multi-chip scale-out shards channel slots / time blocks over a
``jax.sharding.Mesh`` (see ``parallel``).
"""

__version__ = "0.1.0"
