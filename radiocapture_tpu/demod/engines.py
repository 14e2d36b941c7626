"""Per-protocol receive engines (host side).

Each engine consumes the sliced symbol stream of one channel slot (the
batched device pipeline produces those for every active slot; see
frontend/pipeline.py) and runs the protocol state machine: framing,
FEC/decode, lock/quality tracking, control-channel-hunt signaling, and
event emission — the role of the reference's per-process Python
``receive_engine``/``control_decode`` threads
(p25_control_demod.py:278-537, edacs_control_demod.py:521-559,
moto_control_demod.py:212-529), re-cast as ordinary objects so thousands
can be stepped from one control loop.

Events are emitted through a callback ``(event_dict)`` and carry the
same field vocabulary the reference publishes to
``/topic/raw_control/<instance>``.
"""

from __future__ import annotations

import logging
import time
from typing import Callable

import numpy as np

from radiocapture_tpu.demod.framer import Framer
from radiocapture_tpu.fec import bits as B
from radiocapture_tpu.protocol import edacs as E
from radiocapture_tpu.protocol import moto as MO
from radiocapture_tpu.protocol import p25 as P


class EngineBase:
    """Shared counters + lock bookkeeping."""

    def __init__(self, on_event: Callable[[dict], None] | None = None,
                 on_lost_lock: Callable[[], None] | None = None,
                 instance_uuid: str | None = None,
                 system_id: str = ""):
        self.on_event = on_event or (lambda ev: None)
        self.on_lost_lock = on_lost_lock or (lambda: None)
        self.total_messages = 0
        self.bad_messages = 0
        self.is_locked = False
        self.quality: list[float] = []
        self.instance_uuid = instance_uuid
        self.system_id = system_id
        # Decoded-frame firehose → logs/protocol.log via logconfig
        # (reference p25_control_demod.py:62,535).
        self.protocol_log = logging.getLogger(
            f"protocol.{instance_uuid}" if instance_uuid else "protocol")
        self.quality_log = logging.getLogger(
            f"overseer.quality.{instance_uuid}" if instance_uuid
            else "overseer.quality")
        self._q_last_total = 0
        self._q_last_bad = 0

    def _emit(self, ev: dict) -> None:
        self.protocol_log.info(ev)
        self.on_event(ev)

    def record_quality(self, elapsed_s: float, desired_rate: float,
                       control_channel: float | int = 0,
                       site_id: str = "") -> None:
        """Quality ring from per-window packet deltas, plus the
        'System Status' health line operators grep for (reference
        p25_control_demod.py:538-560, README.md:103). Call every ~10 s."""
        cur = self.total_messages - self._q_last_total
        cur_bad = self.bad_messages - self._q_last_bad
        self._q_last_total = self.total_messages
        self._q_last_bad = self.bad_messages
        window_expected = desired_rate * elapsed_s
        if len(self.quality) >= 60:
            self.quality.pop(0)
        self.quality.append((cur - cur_bad) / window_expected
                            if window_expected else 0.0)
        self.quality_log.info(
            "System Status: %s %s (%s/%s) (%s/%s) CC: %s",
            self.system_id, site_id, cur, cur_bad,
            self.total_messages, self.bad_messages, control_channel)


class P25ControlEngine(EngineBase):
    """P25 trunking control channel: TSDU stream -> TSBK events.

    Maintains the channel-identifier (IDEN_UP*) table and site detail the
    call managers need for channel->frequency resolution
    (p25_control_demod.py:417-527, get_channel_detail:262-276).
    """

    DESIRED_RATE = 40.0  # TSBK/s at quality 1.0

    def __init__(self, **kw):
        super().__init__(**kw)
        self.framer = Framer()
        self.channel_identifier_table: dict[int, dict] = {}
        self.site_detail: dict = self._empty_site_detail()
        self.loops_locked = 0
        self.wrong_duid_count = 0

    @staticmethod
    def _empty_site_detail() -> dict:
        return {"WACN ID": None, "System ID": None, "Control Channel": None,
                "System Service Class": None, "Site ID": None,
                "RF Sub-system ID": None, "RFSS Network Connection": None,
                "NAC": None}

    def feed_dibits(self, dibits: np.ndarray) -> list[dict]:
        events = []
        frames = self.framer.feed(dibits)
        if frames:
            self.loops_locked = min(self.loops_locked + 100 * len(frames),
                                    1000)
        else:
            self.loops_locked -= 1
        if self.loops_locked > 500:
            self.is_locked = True
        elif self.is_locked:
            self.site_detail = self._empty_site_detail()
            self.is_locked = False
        for fb in frames:
            events.extend(self._process_frame(fb))
        return events

    def _process_frame(self, frame_bits: np.ndarray) -> list[dict]:
        out = []
        self.total_messages += 3
        try:
            fr = P.parse_frame(frame_bits)
        except Exception:
            self.bad_messages += 3
            return out
        if fr.duid != P.DUID_TSDU:
            self.wrong_duid_count += 1
            if self.wrong_duid_count > 10:
                self.on_lost_lock()
                self.loops_locked = 0
                self.wrong_duid_count = 0
            return out
        self.wrong_duid_count = 0
        for t in fr.tsbks:
            t["nac"] = fr.nac
            if t.get("crc") != 0:
                self.bad_messages += 1
                continue
            self._apply_tsbk(t)
            out.append(t)
            self._emit(t)
        return out

    # --- IDEN/site bookkeeping (semantics of p25_control_demod 417-527).
    # Like the reference, the scaled engineering values are written INTO
    # the emitted event (Base Frequency MHz, Channel Spacing kHz, BW
    # scaled, signed Transmit Offset, Access Type/Slots for TDMA) — the
    # call managers consume the scaled form (p25_call_manager.py:275-316).
    # Deviation: the reference's sign extraction `raw & 0x100 >> 8`
    # binds as `raw & 1` (precedence bug); we use bit 8 as TIA-102
    # specifies. The field is stored but not used downstream.
    def _apply_tsbk(self, t: dict) -> None:
        name = t.get("name")
        if name == "IDEN_UP_VU":
            t["Base Frequency"] = t["Base Frequency"] * 0.000005
            t["BW VU"] = {4: 6.25, 5: 12.5}.get(t["BW VU"], t["BW VU"])
            t["Channel Spacing"] = t["Channel Spacing"] * 0.125
            t["Transmit Offset VU"] = _signed_offset(t["Transmit Offset VU"])
            self.channel_identifier_table[t["Identifier"]] = {
                "BW": t["BW VU"],
                "Base Frequency": t["Base Frequency"],
                "Channel Spacing": t["Channel Spacing"],
                "Transmit Offset": t["Transmit Offset VU"],
                "Type": "FDMA", "Slots": 1,
            }
        elif name == "IDEN_UP":
            t["Base Frequency"] = t["Base Frequency"] * 0.000005
            t["BW"] = t["BW"] * 0.125
            t["Channel Spacing"] = t["Channel Spacing"] * 0.125
            t["Transmit Offset"] = _signed_offset(t["Transmit Offset"])
            self.channel_identifier_table[t["Identifier"]] = {
                "BW": t["BW"],
                "Base Frequency": t["Base Frequency"],
                "Channel Spacing": t["Channel Spacing"],
                "Transmit Offset": t["Transmit Offset"],
                "Type": "FDMA", "Slots": 1,
            }
        elif name == "IDEN_UP_TDMA":
            ct = t["Channel Type"]
            t["Base Frequency"] = t["Base Frequency"] * 0.000005
            t["Channel Spacing"] = t["Channel Spacing"] * 0.125
            t["Transmit Offset TDMA"] = _signed_offset(
                t["Transmit Offset TDMA"], mask=0x1FFF, scale=1.0)
            t["Access Type"] = "FDMA" if ct in (0, 1, 2) else "TDMA"
            t["Slots"] = {3: 2, 5: 2, 4: 4}.get(ct, 1)
            t["BW"] = {0: 12.5, 1: 12.5, 2: 6.25, 3: 12.5, 4: 25.0,
                       5: 12.5}.get(ct, 12.5)
            self.channel_identifier_table[t["Identifier"]] = {
                "BW": t["BW"],
                "Base Frequency": t["Base Frequency"],
                "Channel Spacing": t["Channel Spacing"],
                "Transmit Offset": t["Transmit Offset TDMA"],
                "Type": t["Access Type"], "Slots": t["Slots"],
            }
        elif name == "NET_STS_BCST":
            self.site_detail["WACN ID"] = hex(t["WACN ID"])
            self.site_detail["System ID"] = hex(t["System ID"])
            self.site_detail["System Service Class"] = \
                t["System Service Class"]
            cc, _, _ = self.get_channel_detail(t["Channel"])
            self.site_detail["Control Channel"] = cc
            self.site_detail["NAC"] = t["nac"]
        elif name == "RFSS_STS_BCST":
            self.site_detail["Site ID"] = t["Site ID"]
            self.site_detail["RF Sub-system ID"] = t["RF Sub-system ID"]
            self.site_detail["RFSS Network Connection"] = t["A"]
        elif name == "GRP_V_CH_GRANT" and t.get("Source Address") == 0:
            # Dispatch-console grants arrive with source 0 on some systems
            # (p25_control_demod.py:496-499).
            t["Source Address"] = 1

    def get_channel_detail(self, channel: int):
        """(frequency_hz, bandwidth_hz, slot) from the IDEN table
        (p25_control_demod.py:262-276)."""
        ident = (channel & 0xF000) >> 12
        number = channel & 0x0FFF
        entry = self.channel_identifier_table.get(ident)
        if entry is None:
            return False, False, False
        slots = entry["Slots"]
        freq_mhz = entry["Base Frequency"] \
            + (number // slots) * (entry["Channel Spacing"] / 1000.0)
        import math
        return (math.floor(freq_mhz * 1e6), entry["BW"] * 1000.0,
                number % slots)


def _signed_offset(raw: int, mask: int = 0xFF, scale: float = 0.25) -> float:
    sign = 1 if (raw & 0x100) >> 8 else -1
    return sign * (raw & mask) * scale


class EdacsControlEngine(EngineBase):
    """EDACS control channel: bit stream -> typed trunking events."""

    def __init__(self, channels: dict[int, float] | None = None,
                 esk: bool = False, **kw):
        super().__init__(**kw)
        self.channels = channels or {}
        self.esk = esk
        self.buf = np.zeros(0, np.uint8)
        self.failed_loops = 0
        self.patches: dict[int, dict[int, float]] = {}
        self.patch_timeout = 3.0
        self.site_detail: dict = {}
        self._sync_pm = E.FRAME_SYNC.astype(np.int32) * 2 - 1

    DESIRED_RATE = 66.6

    def feed_bits(self, bits: np.ndarray) -> list[dict]:
        self.buf = np.concatenate([self.buf, np.asarray(bits, np.uint8)])
        events = []
        while len(self.buf) >= E.FULL_FRAME + 48:
            frame = self._next_frame()
            if frame is None:
                break
            m1, m2 = E.split_frame(frame)
            self.total_messages += 2
            if self.esk:
                m1 = None if m1 is None else E.apply_esk(m1)
                m2 = None if m2 is None else E.apply_esk(m2)
            events.extend(self._process(m1, m2))
        self._reap_patches()
        return events

    def _next_frame(self) -> np.ndarray | None:
        pm = self.buf.astype(np.int32) * 2 - 1
        if len(pm) < 48:
            return None
        win = np.lib.stride_tricks.sliding_window_view(pm, 48)
        corr = win @ self._sync_pm
        hits = np.nonzero(np.abs(corr) >= 46)[0]
        usable = hits[hits + E.FULL_FRAME <= len(self.buf)]
        if len(usable) == 0:
            if len(hits) == 0:
                keep = min(len(self.buf), E.FULL_FRAME)
                self.buf = self.buf[-keep:]
                self.failed_loops += 1
                if self.failed_loops > 10:
                    self.failed_loops = 0
                    self.is_locked = False
                    self.on_lost_lock()
            return None
        pos = usable[0]
        inverted = corr[pos] < 0
        frame = self.buf[pos + 48: pos + E.FULL_FRAME]
        self.buf = self.buf[pos + E.FULL_FRAME:]
        if inverted:
            frame = 1 - frame
        self.failed_loops = max(self.failed_loops - 10, -1000)
        self.is_locked = True
        return frame

    def _process(self, m1, m2) -> list[dict]:
        out = []
        if E.is_double_message(m1):
            if m1 is None or m2 is None:
                self.bad_messages += 2
                return out
            ev = E.proc_cmd(m1, m2, self.channels)
            if ev is not None:
                self._post(ev)
                out.append(ev)
        else:
            for m in (m1, m2):
                if m is None:
                    self.bad_messages += 1
                    continue
                ev = E.proc_cmd(m, None, self.channels)
                if ev is not None:
                    self._post(ev)
                    out.append(ev)
        return out

    def _post(self, ev: dict) -> None:
        if ev["type"] == "patch":
            self.patches.setdefault(ev["sgid"], {})[ev["group"]] = \
                time.monotonic()
        elif ev["type"] == "site_id":
            self.site_detail = ev
        self._emit(ev)

    def _reap_patches(self) -> None:
        now = time.monotonic()
        for sgid in list(self.patches):
            groups = self.patches[sgid]
            for g in list(groups):
                if now - groups[g] > self.patch_timeout:
                    del groups[g]
            if not groups:
                del self.patches[sgid]


class MotoControlEngine(EngineBase):
    """Motorola Type II control channel: bit stream -> OSW events."""

    DESIRED_RATE = 42.9

    def __init__(self, channels: dict[int, float] | None = None,
                 system_id: int | None = None, control_channel: float = 0.0,
                 cmd_offset: int | None = None, force_p25: bool = False,
                 **kw):
        super().__init__(**kw)
        self.channels = channels or {}
        self.system_id = system_id
        self.control_channel = control_channel
        self.cmd_offset = cmd_offset
        self.force_p25 = force_p25
        self.buf = np.zeros(0, np.uint8)
        self.sync_loops = 0
        self.last_cmd = 0
        self.last_lid = 0
        self._sync_pm = MO.FRAME_SYNC.astype(np.int32) * 2 - 1

    def feed_bits(self, bits: np.ndarray) -> list[dict]:
        self.buf = np.concatenate([self.buf, np.asarray(bits, np.uint8)])
        events = []
        flen = MO.FRAME_BITS + len(MO.FRAME_SYNC)
        while len(self.buf) >= 2 * flen:
            pm = self.buf.astype(np.int32) * 2 - 1
            win = np.lib.stride_tricks.sliding_window_view(pm, 8)
            corr = win @ self._sync_pm
            hits = np.nonzero(corr == 8)[0]
            usable = hits[hits + flen <= len(self.buf)]
            if len(usable) == 0:
                self.buf = self.buf[-flen:]
                self.sync_loops -= 2
                if self.sync_loops < -100:
                    self.sync_loops = 0
                    self.is_locked = False
                    self.on_lost_lock()
                return events
            pos = usable[0]
            pkt = self.buf[pos + 8: pos + flen]
            self.buf = self.buf[pos + flen:]
            self.sync_loops = min(self.sync_loops + 10, 1000)
            self.is_locked = self.sync_loops > 50
            self.total_messages += 1
            data, had_err = MO.correct_parity(MO.deinterleave(pkt))
            if had_err:
                self.bad_messages += 1
            ev = MO.parse_osw(
                data, last_cmd=self.last_cmd, last_lid=self.last_lid,
                channels=self.channels, system_id=self.system_id,
                control_channel=self.control_channel,
                cmd_offset=self.cmd_offset, force_p25=self.force_p25)
            self.last_cmd = ev["cmd"]
            self.last_lid = ev["lid"]
            if ev["type"] != "own_cc_signal":
                self._emit(ev)
                events.append(ev)
        return events
