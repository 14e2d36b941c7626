"""Full-stack integration: wideband IQ → scheduler slot → jitted capture
pipeline → receive engine → bus → call manager → new_call CDR.

This is the grant→call path of the reference (SURVEY.md §3.2-3.3) driven
hardware-free from synthetic C4FM, crossing every seam: slot allocation,
the batched device pipeline, dibit compaction, framing/trellis/CRC, IDEN
resolution, and the call state machine.
"""

import time

import numpy as np
import pytest

from radiocapture_tpu.control.bus import InProcBus
from radiocapture_tpu.control.call_manager import P25CallManager
from radiocapture_tpu.demod.engines import P25ControlEngine
from radiocapture_tpu.fec import bits as B
from radiocapture_tpu.frontend.pipeline import ControlPipeline
from radiocapture_tpu.frontend.scheduler import ChannelScheduler
from radiocapture_tpu.protocol import p25 as P
from radiocapture_tpu.testing import modulators as M

SAMP_RATE = 2.4e6
CENTER = 857.0e6
CC_FREQ = 857.5e6


@pytest.mark.parametrize("frontend", ["xlat", "pfb"])
def test_wideband_to_new_call(frontend):
    tsbk_iden = P.pack_tsbk("IDEN_UP", **{
        "Identifier": 1, "BW": 100,
        "Base Frequency": int(851.00625e6 / 5),
        "Channel Spacing": 50, "Transmit Offset": 0x1B4})
    tsbk_grant = P.pack_tsbk("GRP_V_CH_GRANT", last_block=True, **{
        "Channel": 0x1064, "Group Address": 5001,
        "Source Address": 777})
    frames = [P.build_tsdu_frame(0x293, [tsbk_iden]),
              P.build_tsdu_frame(0x293, [tsbk_grant])] * 4
    dibits = B.bits_to_dibits(np.concatenate(frames))
    iq_ch = M.c4fm_modulate(dibits, fs=25000.0)
    iq_up = M.upsample_to(iq_ch, 25000.0, SAMP_RATE)
    wide = M.multi_channel(SAMP_RATE, [(CC_FREQ - CENTER, iq_up)],
                           n=len(iq_up))

    sched = ChannelScheduler({0: (CENTER, SAMP_RATE)}, num_slots=8)
    sched.connect("p25demod")
    _, slot, _ = sched.create_channel("p25demod", 25000, CC_FREQ)
    pipe = ControlPipeline.p25_c4fm(num_slots=8, samp_rate=SAMP_RATE,
                                    frontend=frontend)
    state = pipe.init()
    offs = sched.offsets_norm(0)

    bus = InProcBus(num_workers=1)
    inst = {"system_uuid": "sysA", "transmit_site_uuid": "tsA",
            "system_modulation": "C4FM", "site_detail": {}}
    cm = P25CallManager(bus, lambda u: inst)
    cm.notify_demod_new("p25", "inst1")
    new_calls = []
    bus.subscribe("/topic/call_management/new_call/*",
                  lambda ev: new_calls.append(ev))
    eng = P25ControlEngine(on_event=lambda ev: bus.send_event_lazy(
        "/topic/raw_control/inst1", ev))

    blk = pipe.decim * 256
    xw = np.stack([wide.real, wide.imag], -1).astype(np.float32)
    for i in range(len(wide) // blk):
        state, (syms, valid, dib) = pipe.step(
            state, xw[i * blk:(i + 1) * blk], offs)
        v = np.asarray(valid[slot]).astype(bool)
        eng.feed_dibits(np.asarray(dib[slot])[v])

    deadline = time.time() + 3.0
    while not new_calls and time.time() < deadline:
        time.sleep(0.05)
    assert eng.bad_messages == 0
    assert eng.is_locked
    assert len(new_calls) >= 1
    cdr = new_calls[0]
    assert cdr["system_group_local"] == 5001
    assert cdr["system_user_local"] == 777
    assert cdr["modulation_type"] == "p25"
    assert cdr["frequency"] == int((851.00625 + 0x64 * 6.25e-3) * 1e6)
    assert cdr["hang_time"] == 5.0
    bus.close()
