"""Batched pipeline + mesh sharding: multi-slot decode and 8-device CPU
mesh execution (the multi-chip surface the driver dry-runs)."""

import jax
import jax.numpy as jnp
import numpy as np

from radiocapture_tpu.demod import fsk4 as FSK4
from radiocapture_tpu.demod.framer import Framer
from radiocapture_tpu.fec import bits as B
from radiocapture_tpu.frontend.pipeline import ControlPipeline
from radiocapture_tpu.parallel import mesh as MESH
from radiocapture_tpu.protocol import p25 as P
from radiocapture_tpu.testing import modulators as M

FS = 500000.0  # wideband rate; decim 20 -> 25 kS/s channels


def _control_iq(n_frames=6, nac=0x293):
    frames = []
    for i in range(n_frames):
        t = P.pack_tsbk("GRP_V_CH_GRANT", mfid=0, **{
            "Service Options": 0, "Channel": 0x1000 + i,
            "Group Address": 100 + i, "Source Address": 555000 + i})
        frames.append(P.build_tsdu_frame(nac, [t]))
    dibits = B.bits_to_dibits(np.concatenate(frames))
    return M.c4fm_modulate(dibits, fs=25000.0), n_frames


def _decode_slot(dibits_blocks, valid_blocks, slot):
    d = np.concatenate([np.asarray(b)[slot] for b in dibits_blocks])
    v = np.concatenate([np.asarray(b)[slot] for b in valid_blocks])
    framer = Framer()
    got = []
    for fb in framer.feed(d[v.astype(bool)].astype(np.uint8)):
        fr = P.parse_frame(fb)
        for t in fr.tsbks:
            if t.get("crc") == 0:
                got.append(t)
    return got


def test_control_pipeline_two_slots_end_to_end():
    """Two P25 control channels at different offsets in one wideband
    stream, decoded concurrently by one jitted step."""
    chan_iq, _ = _control_iq(5)
    up = M.upsample_to(chan_iq, 25000.0, FS)
    wide = M.multi_channel(FS, [(-150e3, up), (120e3, up)], n=len(up))
    pipe = ControlPipeline.p25_c4fm(num_slots=4, samp_rate=FS)
    offs = np.zeros(4, np.float32)
    offs[0] = -150e3 / FS
    offs[1] = 120e3 / FS
    state = pipe.init()
    block = pipe.decim * 500  # 500 channel-rate samples (20 ms) per block
    n = (len(wide) // block) * block
    assert n >= 4 * block
    dibs, vals = [], []
    for i in range(0, n, block):
        state, (syms, valid, dibits) = pipe.step(
            state, jnp.asarray(wide[i:i + block]), jnp.asarray(offs))
        dibs.append(dibits)
        vals.append(valid)
    for slot in (0, 1):
        tsbks = _decode_slot(dibs, vals, slot)
        grants = [t for t in tsbks if t["name"] == "GRP_V_CH_GRANT"]
        assert len(grants) >= 3, f"slot {slot}: {len(grants)} grants"
        for t in grants:
            assert t["Group Address"] - 100 == t["Channel"] - 0x1000


def test_sharded_control_step_8_devices():
    """dp(source) x tp(slot) sharded step runs on the 8-device CPU mesh
    and matches the unsharded pipeline bit-for-bit."""
    assert jax.device_count() >= 8
    mesh = MESH.make_mesh(8)
    assert mesh.devices.size == 8
    pipe = ControlPipeline.p25_c4fm(num_slots=8, samp_rate=FS)
    n_sources = mesh.shape["source"]
    sharded = MESH.ShardedControlStep(pipe, mesh, n_sources=n_sources)

    chan_iq, _ = _control_iq(5)
    up = M.upsample_to(chan_iq, 25000.0, FS)
    wide = M.multi_channel(FS, [(50e3, up)], n=len(up))
    bm = pipe.block_multiple
    block = (len(wide) // bm) * bm
    x1 = jnp.asarray(wide[:block])
    x = jnp.broadcast_to(x1, (n_sources, block))
    offs1 = jnp.zeros((8,), jnp.float32).at[0].set(50e3 / FS)
    offs = jnp.broadcast_to(offs1, (n_sources, 8))

    st = sharded.init()
    st, (syms, valid, dibits) = sharded.step(st, x, offs)
    assert syms.shape == (n_sources, 8, block // bm)

    ref_state = pipe.init()
    _, (rsyms, rvalid, rdibits) = pipe.step(ref_state, x1, offs1)
    # The fsk4 tracking loop is chaotic — float noise from the partitioned
    # matmul diverges late in a signal block — so equivalence is semantic:
    # each source decodes the same grants from its slot 0 as the
    # unsharded pipeline.
    ref_grants = [
        (t["Channel"], t["Group Address"]) for t in
        _decode_slot([rdibits], [rvalid], 0)
        if t["name"] == "GRP_V_CH_GRANT"]
    assert len(ref_grants) >= 1
    for s in range(n_sources):
        got = [
            (t["Channel"], t["Group Address"]) for t in
            _decode_slot([dibits[s]], [valid[s]], 0)
            if t["name"] == "GRP_V_CH_GRANT"]
        assert got == ref_grants


def test_time_sharded_control_step_matches_serial():
    """dp×tp×sequence-parallel production step (SURVEY §5.7): the
    wideband block's time axis sharded with ppermute halos + analytic
    uint32 mixer-phase offsets, tracking scan re-partitioned by
    all_to_all — decodes the same grants as the streaming single-device
    pipeline across multiple blocks, with bounded symbol delta."""
    assert jax.device_count() >= 8
    mesh = MESH.make_mesh3(8)
    assert mesh.shape == {"source": 2, "slot": 2, "time": 2}
    pipe = ControlPipeline.p25_c4fm(num_slots=8, samp_rate=FS)
    n_src = mesh.shape["source"]
    tsh = MESH.TimeShardedControlStep(pipe, mesh, n_sources=n_src)

    chan_iq, _ = _control_iq(6)
    up = M.upsample_to(chan_iq, 25000.0, FS)
    wide = M.multi_channel(FS, [(50e3, up)], n=len(up))
    bm = pipe.block_multiple * mesh.shape["time"]
    block = ((len(wide) // 3) // bm) * bm     # 3 blocks: carries matter
    offs1 = np.zeros(8, np.float32)
    offs1[0] = 50e3 / FS
    offs = jnp.broadcast_to(jnp.asarray(offs1), (n_src, 8))

    st = tsh.init()
    ref_st = pipe.init()
    dibs, vals, rdibs, rvals = [], [], [], []
    sy_delta = []
    for i in range(3):
        xb = wide[i * block:(i + 1) * block]
        xf = np.stack([xb.real, xb.imag], -1).astype(np.float32)
        x = jnp.broadcast_to(jnp.asarray(xf), (n_src, block, 2))
        st, (syms, valid, dibits, trk) = tsh.step_debug(st, x, offs)
        ref_st, (rs, rv, rd, rtrk) = pipe.step_debug(
            ref_st, jnp.asarray(xf), jnp.asarray(offs1))
        assert syms.shape == (n_src, 8, block // pipe.block_multiple)
        # The claim in TimeShardedControlStep's docstring, asserted
        # EXACTLY: the pre-scan channelized/discriminated/symbol-
        # filtered stream is bit-identical to the streaming serial
        # pipeline — ppermute halos + analytic uint32 mixer phase leave
        # no seam. Only the chaotic tracking scan may diverge in float.
        for s in range(n_src):
            np.testing.assert_array_equal(
                np.asarray(trk[s]), np.asarray(rtrk),
                err_msg=f"pre-scan seam at block {i} source {s}")
        dibs.append(np.asarray(dibits[0]))
        vals.append(np.asarray(valid[0]))
        rdibs.append(np.asarray(rd))
        rvals.append(np.asarray(rv))
        sy_delta.append(np.sqrt(np.mean(
            (np.asarray(syms[0, 0]) - np.asarray(rs[0])) ** 2)))
    ref_grants = [
        (t["Channel"], t["Group Address"]) for t in
        _decode_slot(rdibs, rvals, 0) if t["name"] == "GRP_V_CH_GRANT"]
    got = [
        (t["Channel"], t["Group Address"]) for t in
        _decode_slot(dibs, vals, 0) if t["name"] == "GRP_V_CH_GRANT"]
    assert len(ref_grants) >= 3
    assert got == ref_grants
    # front end is bit-identical; only the chaotic tracking loop may
    # accumulate float noise late in a block
    assert max(sy_delta) < 0.15, sy_delta


def test_time_sharded_fir_matches_serial():
    """Overlap-save halo exchange over the mesh == single-device conv."""
    mesh = MESH.make_mesh(8, axis_names=("t", "u"))
    # 1-D time sharding over the 't' axis of the 2-D mesh.
    taps = jnp.asarray(np.hanning(33).astype(np.float32))
    f = MESH.time_sharded_fir(mesh, "t", taps)
    rng = np.random.default_rng(3)
    n_t = mesh.shape["t"]
    x = rng.normal(size=(n_t * 256,)).astype(np.float32)
    from jax.sharding import NamedSharding, PartitionSpec as Pp
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, Pp("t")))
    y = np.asarray(f(xs))
    ref = np.convolve(np.concatenate([np.zeros(32, np.float32), x]),
                      np.asarray(taps), mode="valid")
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-5)


def test_spectrum_split2_tone_routing(rng):
    """receiver_split2: tones land in the correct half-rate half, and
    block-split streaming matches one-shot output."""
    import jax.numpy as jnp
    from radiocapture_tpu.frontend.pipeline import SpectrumSplit2
    from radiocapture_tpu.testing import modulators as M

    fs = 1_600_000.0
    sp = SpectrumSplit2(fs)
    n = 4096 * 2
    # Tone at -fs/4 - 10 kHz → half 0 (center -fs/4) at -10 kHz;
    # tone at +fs/4 + 30 kHz → half 1 at +30 kHz.
    wide = (M.tone(fs, -fs / 4 - 10e3, n)
            + M.tone(fs, fs / 4 + 30e3, n)).astype(np.complex64)
    st = sp.init()
    st, halves = sp.step(st, jnp.asarray(
        np.stack([wide.real, wide.imag], -1)))
    halves = np.asarray(halves)
    y0 = halves[0, 256:, 0] + 1j * halves[0, 256:, 1]
    y1 = halves[1, 256:, 0] + 1j * halves[1, 256:, 1]
    fs_h = fs / 2

    def est(z):
        return float(np.mean(np.angle(z[1:] * np.conj(z[:-1])))
                     * fs_h / (2 * np.pi))

    assert abs(est(y0) + 10e3) < 200.0
    assert abs(est(y1) - 30e3) < 200.0
    assert sp.half_center(850e6, 0) == 850e6 - fs / 4
    assert sp.half_center(850e6, 1) == 850e6 + fs / 4

    # streaming: two half-blocks equal the one-shot result
    st2 = sp.init()
    outs = []
    for blk in wide.reshape(2, -1):
        st2, h = sp.step(st2, jnp.asarray(
            np.stack([blk.real, blk.imag], -1)))
        outs.append(np.asarray(h))
    np.testing.assert_allclose(np.concatenate(outs, axis=1), halves,
                               atol=2e-3)


def test_runtime_split2_expands_sources():
    from radiocapture_tpu.runtime import SiteRuntime
    from radiocapture_tpu.rxconfig import RcConfig, SourceConfig, \
        SystemConfig

    fs = 2.4e6
    cfg = RcConfig(
        sources={0: SourceConfig(type="file", center_freq=851e6,
                                 samp_rate=fs)},
        systems={0: SystemConfig(type="p25", id="s",
                                 channels={0: 851e6 - fs / 4})},
        receiver_split2=True, num_slots_per_source=4)
    blocks = [np.zeros(0)]

    def provider(n):
        blocks[0] = np.zeros(n, np.complex64)
        return blocks[0]

    rt = SiteRuntime(cfg, iq_providers={0: provider})
    assert len(rt.cfg.sources) == 2
    assert rt.cfg.sources[0].center_freq == 851e6 - fs / 4
    assert rt.cfg.sources[1].center_freq == 851e6 + fs / 4
    assert rt.cfg.sources[0].samp_rate == fs / 2
    # the control channel sits in half 0's span → scheduler routed there
    assert rt.instances[0].source_idx == 0
    rt.step()     # providers deliver; split state advances without error
    assert rt.blocks == 1
    rt.close()


def test_dp_tp_step_emits_no_collectives():
    """The dp×tp sharded step's contract: each device owns a complete
    (source subset × slot subset) tile, so the partitioned HLO must
    contain ZERO inter-device collectives — the communication-free
    scale-out matching the reference's process-per-dongle layout
    (rc_frontend/receiver.py:67-70). GSPMD auto-partitioning of the
    same step used to re-replicate the conv inputs and modulated taps
    with ~30 MB/block of all-gathers; the shard_map form keeps it
    clean (full accounting: tools/scaling_model.py)."""
    import sys
    sys.path.insert(0, "tools")
    import os
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tools"))
    from scaling_model import collective_inventory
    from jax.sharding import Mesh

    pipe = ControlPipeline.p25_c4fm(num_slots=8, samp_rate=300e3)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2),
                ("source", "slot"))
    s = MESH.ShardedControlStep(pipe, mesh, n_sources=4)
    st = s.init()
    T = pipe.decim * 64
    x = np.zeros((4, T, 2), np.float32)
    offs = np.zeros((4, 8), np.float32)
    hlo = s._step.lower(st, x, offs).compile().as_text()
    inv = collective_inventory(hlo)
    assert inv == [], f"dp x tp step emitted collectives: {inv}"


def test_time_shard_collectives_match_formulas():
    """The time-sharded step must emit exactly the three designed
    collectives (halo ppermute, track-rate all_to_all, tail reduce)
    with per-device bytes matching the analytic formulas that the
    production scaling model evaluates (tools/scaling_model.py)."""
    import os
    import sys
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tools"))
    from scaling_model import collective_inventory
    from jax.sharding import Mesh

    pipe = ControlPipeline.p25_c4fm(num_slots=8, samp_rate=300e3)
    n_t, n_src = 4, 2
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(1, 1, 4),
                ("source", "slot", "time"))
    s = MESH.TimeShardedControlStep(pipe, mesh, n_src)
    st = s.init()
    bm = pipe.block_multiple
    T = n_t * bm * max(1, -(-s.halo // (bm))) * 4
    x = np.zeros((n_src, T, 2), np.float32)
    offs = np.zeros((n_src, 8), np.float32)
    hlo = s._step.lower(st, x, offs).compile().as_text()
    got = {}
    for e in collective_inventory(hlo):
        got[e["op"]] = got.get(e["op"], 0) + e["bytes"]
    nt = T // pipe.decim // pipe.sym_decim
    want = {
        "collective-permute": n_src * s.halo * 8,
        "all-to-all": n_src * 8 * (nt // n_t) * 4,
        "all-reduce": n_src * s.halo * 8,
    }
    assert got == want, (got, want)
