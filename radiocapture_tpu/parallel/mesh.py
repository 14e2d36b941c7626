"""Device-mesh sharding of the capture pipelines.

The reference scales by processes: one per dongle, one per system demod,
one per call recorder, across hosts glued by ZMQ/Redis (SURVEY.md §2.2).
The scaling axes here are a 2-D ``jax.sharding.Mesh``:

- ``source`` axis — data parallel over wideband sources (the reference's
  "one process per dongle", rc_frontend/receiver.py:67-70). Each source's
  wideband block and its slot pool live on one mesh row.
- ``slot`` axis — model/tensor parallel over channel slots within a
  source: the xlat bank's per-slot modulated taps are sharded on the conv
  output-feature dimension, so each device computes its slot subset
  (the reference's per-channel flowgraph fan-out, channel.py:29-38).

Time/sequence parallelism (the reference's unbounded IQ stream, SURVEY.md
§5.7) is ``time_sharded_fir``: the block's time axis is sharded across
devices and each shard pulls its ``K-1``-sample filter halo from its left
neighbor with ``lax.ppermute`` inside ``shard_map`` — overlap-save with
ICI boundary exchange instead of GNU Radio scheduler history.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from radiocapture_tpu.frontend.pipeline import (
    ControlPipeline, ControlPipelineState)


def make_mesh(n_devices: int | None = None,
              axis_names: tuple[str, str] = ("source", "slot")) -> Mesh:
    """A 2-D mesh over the first ``n_devices`` devices; the source axis
    gets the largest factor ≤ √n so both axes are populated when possible."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    a = 1
    for d in range(int(np.sqrt(n)), 0, -1):
        if n % d == 0:
            a = d
            break
    return Mesh(np.asarray(devs).reshape(a, n // a), axis_names)


def state_specs(src: str | None = "source", slot: str | None = "slot"
                ) -> ControlPipelineState:
    """PartitionSpec pytree for a multi-source ``ControlPipelineState``
    with a leading [n_sources] axis on every leaf.

    States are wire-encoded (utils.wire): complex leaves carry a trailing
    [..., 2] re/im axis, which PartitionSpec leaves implicitly replicated
    (specs shorter than rank extend with None)."""
    from radiocapture_tpu.demod.fsk4 import Fsk4State
    from radiocapture_tpu.ops.channelizer import XlatBankState
    from radiocapture_tpu.ops.fm import QuadDemodState
    return ControlPipelineState(
        bank=XlatBankState(history=P(src, None), phase=P(src, slot)),
        quad=QuadDemodState(prev=P(src, slot)),
        sym_hist=P(src, slot, None),
        fsk4=Fsk4State(clock=P(src, slot), fine_freq=P(src, slot),
                       hist=P(src, slot, None)),
    )


class ShardedControlStep:
    """Multi-source, mesh-sharded control pipeline step.

    Runs the plain streaming pipeline per device via ``shard_map``:
    each device owns a (source subset × slot subset) tile — its own
    wideband replicas, its own slots' modulated taps, its own tracking
    state — so the dp×tp step emits **zero inter-device collectives**
    (verified from the partitioned HLO by tools/scaling_model.py),
    matching the reference's communication-free one-process-per-dongle
    scale-out (rc_frontend/receiver.py:67-70). An earlier GSPMD
    auto-partitioned formulation (jit with in_shardings over the same
    specs) re-replicated the conv inputs and the modulated taps with
    ~30 MB/block of all-gathers — ICI traffic the explicit form
    deletes.
    """

    def __init__(self, pipeline: ControlPipeline, mesh: Mesh,
                 n_sources: int):
        self.pipeline = pipeline
        self.mesh = mesh
        self.n_sources = n_sources
        src, slot = mesh.axis_names

        def sh(spec):
            return NamedSharding(mesh, spec)

        st_specs = state_specs(src, slot)
        self.state_shardings = jax.tree.map(sh, st_specs,
                                            is_leaf=lambda x: isinstance(
                                                x, P))
        self.x_sharding = sh(P(src, None))
        self.off_sharding = sh(P(src, slot))

        def local(state, x, offs):
            # [S_l] local sources × [C_l] local slots: the pipeline is
            # shape-polymorphic over both, and every input it needs
            # (wideband replica, slot offsets, carried state) is
            # already resident — no cross-device data dependence.
            return jax.vmap(pipeline._step_impl)(state, x, offs)

        out_specs = (st_specs, (P(src, slot, None),) * 3)
        f = jax.shard_map(local, mesh=mesh,
                          in_specs=(st_specs, P(src, None),
                                    P(src, slot)),
                          out_specs=out_specs, check_vma=False)
        self._step = jax.jit(f, donate_argnums=(0,))

    def init(self) -> ControlPipelineState:
        st = jax.tree.map(
            lambda l: jnp.broadcast_to(l, (self.n_sources,) + l.shape),
            self.pipeline.init())
        return jax.device_put(st, self.state_shardings)

    def step(self, state, x, offsets_norm):
        """x: [n_sources, T]; offsets_norm: [n_sources, num_slots]."""
        return self._step(state, x, offsets_norm)


def make_mesh3(n_devices: int | None = None,
               axis_names: tuple[str, str, str] = ("source", "slot", "time")
               ) -> Mesh:
    """A 3-D mesh (dp sources × tp slots × sequence-parallel time).

    Factorization favors the time axis last (it multiplies the slot
    split during the tracking phase, so any leftover factor helps)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    a = 1
    for d in range(int(round(n ** (1.0 / 3.0))), 0, -1):
        if n % d == 0:
            a = d
            break
    rem = n // a
    b = 1
    for d in range(int(np.sqrt(rem)), 0, -1):
        if rem % d == 0:
            b = d
            break
    return Mesh(np.asarray(devs).reshape(a, b, rem // b), axis_names)


class TimeShardedControlStep:
    """Full dp×tp×sequence-parallel control pipeline step (SURVEY.md
    §5.7 — the production form of :func:`time_sharded_fir`).

    The wideband block's *time* axis is sharded across devices: each
    time shard channelizes its chunk after pulling a filter+discriminator
    +symbol-filter halo from its left neighbor over ICI (``ppermute``)
    and offsetting the xlat mixer's exact uint32 phase analytically by
    its chunk position — so the front end (where the MS/s live) is
    embarrassingly parallel and *bit-identical* to the streaming
    single-device pipeline. The 100×-decimated track-rate streams are
    then re-partitioned with one ``all_to_all`` (split slots, gather
    time) so the sequential fsk4 tracking scan sees the whole block but
    only ``num_slots / (slot_shards × time_shards)`` lanes per device —
    the time axis multiplies the scan's lane parallelism instead of
    breaking its carry. No approximation, no stale tracking state.

    Contract matches :class:`ShardedControlStep`: ``step(state,
    x[n_sources, T, 2], offsets[n_sources, C]) -> (state, (syms, valid,
    dibits))`` with outputs ``[n_sources, C, T // block_multiple]``.
    Requires T divisible by ``time_shards × block_multiple`` and C
    divisible by ``slot_shards × time_shards``.
    """

    def __init__(self, pipeline: ControlPipeline, mesh: Mesh,
                 n_sources: int,
                 axes: tuple[str, str, str] = ("source", "slot", "time")):
        from radiocapture_tpu.utils import wire as _wire
        self.pipeline = pipeline
        self.mesh = mesh
        self.n_sources = n_sources
        self.ax_src, self.ax_slot, self.ax_time = axes
        bank = pipeline.bank
        if not hasattr(bank, "ntaps"):
            raise ValueError("time sharding requires the xlat frontend")
        # Left context for exact streaming equivalence: K-1 input samples
        # for the xlat FIR window plus sym_ntaps channel-rate samples
        # (1 for the discriminator's previous sample + sym_ntaps-1 for
        # the boxcar history).
        self.c_ctx = int(pipeline.sym_taps.shape[0])
        self.halo = (bank.ntaps - 1) + bank.decim * self.c_ctx
        self._wire = _wire
        self._state_spec = _wire.abstract(self._init_decoded)

        from radiocapture_tpu.demod.fsk4 import Fsk4State
        src, slot, time_ = self.ax_src, self.ax_slot, self.ax_time
        self._in_specs = (
            self._TimeState(
                in_hist=P(src, None, None),          # wire [S, H, 2]
                phase=P(src, slot),
                fsk4=Fsk4State(clock=P(src, (slot, time_)),
                               fine_freq=P(src, (slot, time_)),
                               hist=P(src, (slot, time_), None)),
            ),
            P(src, time_, None),                     # x [S, T, 2]
            P(src, slot),                            # offsets
        )
        self._out_specs = (
            self._in_specs[0],
            (P(src, (slot, time_), None),) * 3,
        )
        f = jax.shard_map(self._local_step, mesh=mesh,
                          in_specs=self._in_specs,
                          out_specs=self._out_specs, check_vma=False)
        self._step = jax.jit(f, donate_argnums=(0,))
        self._step_debug = None     # built on first step_debug() call

    class _TimeState(NamedTuple):
        in_hist: jax.Array   # [S, halo] complex64: block-end tail
        phase: jax.Array     # [S, C] uint32 mixer phase at block start
        fsk4: object         # Fsk4State, batch [S, C]

    def _init_decoded(self):
        from radiocapture_tpu.demod import fsk4 as _fsk4
        s, c = self.n_sources, self.pipeline.num_slots
        return self._TimeState(
            in_hist=jnp.zeros((s, self.halo), jnp.complex64),
            phase=jnp.zeros((s, c), jnp.uint32),
            fsk4=_fsk4.fsk4_init(batch_shape=(s, c)),
        )

    def init(self):
        st = self._wire.zeros(self._wire.encode(self._state_spec))
        shardings = jax.tree.map(
            lambda sp: NamedSharding(self.mesh, sp), self._in_specs[0],
            is_leaf=lambda x: isinstance(x, P))
        return jax.device_put(st, shardings)

    def step(self, state, x, offsets_norm):
        return self._step(state, x, offsets_norm)

    def step_debug(self, state, x, offsets_norm):
        """Like :meth:`step` but with the gathered pre-scan track-rate
        stream [S, C, N] as a 4th output — the stream the docstring
        claims is bit-identical to the streaming single-device
        pipeline. Tests assert exact equality on it."""
        if self._step_debug is None:
            src, slot, time_ = self.ax_src, self.ax_slot, self.ax_time
            out_specs = (self._in_specs[0],
                         (P(src, (slot, time_), None),) * 4)
            f = jax.shard_map(
                partial(self._local_step, with_track=True),
                mesh=self.mesh, in_specs=self._in_specs,
                out_specs=out_specs, check_vma=False)
            self._step_debug = jax.jit(f, donate_argnums=(0,))
        return self._step_debug(state, x, offsets_norm)

    def _local_step(self, wire_state, x_loc, offs_loc,
                    with_track: bool = False):
        from radiocapture_tpu.demod import fsk4 as _fsk4
        from radiocapture_tpu.ops.channelizer import XlatBankState
        from radiocapture_tpu.ops.fir import _phase_step_u32
        pipe = self.pipeline
        bank = pipe.bank
        state = self._wire.decode(wire_state, self._state_spec)
        d, k = bank.decim, bank.ntaps
        h, c_ctx = self.halo, self.c_ctx
        n_time = self.mesh.shape[self.ax_time]
        t_idx = jax.lax.axis_index(self.ax_time)
        x = jax.lax.complex(x_loc[..., 0], x_loc[..., 1])   # [S, Tl]
        if x.shape[1] < h:
            raise ValueError(
                f"time-shard chunk ({x.shape[1]} samples) shorter than "
                f"the halo ({h}): the immediate-left-neighbor exchange "
                f"needs T >= time_shards * halo samples per block")
        n_l = x.shape[1] // d                                # chan samples
        # Halo: my last `h` inputs go right; shard 0 uses the block-end
        # tail carried in state (ppermute feeds zeros into shard 0).
        halo = jax.lax.ppermute(
            x[:, -h:], self.ax_time,
            perm=[(i, i + 1) for i in range(n_time - 1)])
        ctx = jnp.where(t_idx == 0, state.in_hist, halo)     # [S, h]
        # Exact mixer phase of this shard's first xlat output: output
        # index t·n_l - c_ctx in the global stream (uint32 wraps).
        step = _phase_step_u32(offs_loc, d)                  # [S, Cl] u32
        goff = (jnp.uint32(n_l) * t_idx.astype(jnp.uint32)
                - jnp.uint32(c_ctx))
        trks = []
        for s in range(x.shape[0]):                          # local sources
            st = XlatBankState(history=ctx[s, :k - 1],
                               phase=state.phase[s] + step[s] * goff)
            zx = jnp.concatenate([ctx[s, k - 1:], x[s]])
            _, y = bank(st, zx, offs_loc[s])     # [Cl, c_ctx + n_l]
            # discriminator over the extended run (pairwise, ops.fm)
            dfc = y[:, 1:] * jnp.conj(y[:, :-1])
            disc = pipe.disc_gain * jnp.arctan2(dfc.imag, dfc.real)
            # boxcar symbol filter + decimation (VALID, same stride
            # phase as the streaming pipeline: n_l % sym_decim == 0)
            filt = jax.lax.conv_general_dilated(
                disc[:, None, :],
                pipe.sym_taps[::-1][None, None, :].astype(jnp.float32),
                window_strides=(pipe.sym_decim,), padding="VALID",
                dimension_numbers=("NCH", "OIH", "NCH"))[:, 0, :]
            trks.append(filt)                    # [Cl, n_l / sym_decim]
        trk = jnp.stack(trks)                    # [S, Cl, Ntl]
        # Re-partition for the tracking scan: split slots across the
        # time group, gather the full time range (one ICI all_to_all of
        # the decimated stream — ~1/block_multiple of the input bytes).
        trk = jax.lax.all_to_all(trk, self.ax_time, split_axis=1,
                                 concat_axis=2, tiled=True)
        fs, (syms, valid) = _fsk4.fsk4_demod(
            state.fsk4, trk, pipe.track_fs, pipe.symbol_rate,
            levels=pipe.levels)
        if len(pipe.levels) == 4:
            dibits = _fsk4.slice_dibits_jax(syms).astype(jnp.int32)
        else:
            dibits = (syms > 0.0).astype(jnp.int32)
        # Block-end carries: the global tail lives on the last time
        # shard; masked psum replicates it (slot group already uniform).
        tail = jnp.where(t_idx == n_time - 1, x[:, -h:],
                         jnp.zeros_like(x[:, -h:]))
        tail_f = jnp.stack([tail.real, tail.imag], -1)
        hist_f = jax.lax.psum(tail_f, self.ax_time)
        new_state = self._TimeState(
            in_hist=jax.lax.complex(hist_f[..., 0], hist_f[..., 1]),
            phase=state.phase + step * jnp.uint32(n_l * n_time),
            fsk4=fs,
        )
        outs = (syms, valid.astype(jnp.int32), dibits)
        if with_track:
            outs = outs + (trk,)
        return self._wire.encode(new_state), outs


def time_sharded_fir(mesh: Mesh, axis: str, taps: jax.Array,
                     decim: int = 1):
    """Overlap-save FIR with the time axis sharded over ``axis``.

    Returns a function ``f(x)`` for ``x: [T]`` sharded as ``P(axis)``;
    each shard fetches its K-1-sample left halo from the previous shard
    via ``ppermute`` (zeros flow into shard 0 — causal start), computes a
    valid conv, and the result is ``[T//decim]`` sharded the same way.
    """
    k = taps.shape[0]
    n_shards = mesh.shape[axis]
    hrev = taps[::-1]

    def local(x_local):
        # Send my *last* K-1 samples right; receive my left neighbor's.
        halo = jax.lax.ppermute(
            x_local[-(k - 1):], axis,
            perm=[(i, i + 1) for i in range(n_shards - 1)])
        z = jnp.concatenate([halo, x_local])
        if jnp.iscomplexobj(x_local):
            zr = jnp.stack([z.real, z.imag])[None]
            eye = jnp.eye(2, dtype=jnp.float32)
            kern = eye[:, :, None] * hrev[None, None, :].astype(jnp.float32)
            out = jax.lax.conv_general_dilated(
                zr.astype(jnp.float32), kern, window_strides=(decim,),
                padding="VALID", dimension_numbers=("NCH", "OIH", "NCH"))[0]
            return (out[0] + 1j * out[1]).astype(jnp.complex64)
        out = jax.lax.conv_general_dilated(
            z[None, None].astype(jnp.float32),
            hrev[None, None].astype(jnp.float32),
            window_strides=(decim,), padding="VALID",
            dimension_numbers=("NCH", "OIH", "NCH"))
        return out[0, 0]

    in_spec = P(axis)
    f = jax.shard_map(local, mesh=mesh, in_specs=(in_spec,),
                      out_specs=in_spec, check_vma=False)
    return jax.jit(f)
