"""Differential bit-exactness tests against the reference's own decoders.

Every test here decodes the SAME bitstream with (1) this repo's protocol
layer and (2) the reference's runnable pure-Python decoders imported
from /root/reference (p25_general.procTSDU/procHDU/procLDU1/procTLC,
p25p2_lfsr, edacs_control_demod.bch_decode, moto_control_demod
.deinterleave + receive_engine parity logic), and asserts identical
output. The repo's closed-loop encoder/decoder tests cannot see a correlated
encoder+decoder bug; these can.

Frames are padded to a 72-bit multiple before handing to the reference:
its procStatus (p25_general.py:175-184) walks 72-bit strides and the
trailing-null strips (procHDU bitframe[:-10], procTLC bitframe[:-20])
assume the over-the-air frame length, which the pad reproduces exactly.
"""

from __future__ import annotations

import numpy as np
import pytest

from radiocapture_tpu.fec import bits as B
from radiocapture_tpu.fec import crc as CRC
from radiocapture_tpu.fec import lfsr as LFSR
from radiocapture_tpu.fec import trellis as TR
from radiocapture_tpu.protocol import edacs as E
from radiocapture_tpu.protocol import moto as M
from radiocapture_tpu.protocol import p25 as P
from radiocapture_tpu.protocol.p25_fields import TSBK_MOTO, TSBK_OSP

from tests import reference_loader

if not reference_loader.available():  # pragma: no cover
    pytest.skip("/root/reference not present", allow_module_level=True)

REF = reference_loader.load()
G = REF["p25_general"]


def bits_to_airbytes(bits: np.ndarray) -> bytes:
    """Pack frame bits to bytes, zero-padded to a 72-bit multiple (the
    reference receive engine always hands byte-aligned buffers whose
    status-symbol grid the pad restores — see module docstring)."""
    bits = np.asarray(bits, np.uint8)
    pad = (-len(bits)) % 72
    bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
    return np.packbits(bits).tobytes()


def rand_field_values(fields, rng):
    return {f: int(rng.integers(0, 1 << min(w, 24))) for f, w in fields}


# ------------------------------------------------------------------ TSDU
@pytest.mark.parametrize("opcode", sorted(TSBK_OSP))
def test_tsdu_osp_fields_match_reference(opcode, rng):
    """Repo-built TSDU -> reference procTSDU: every unpacked field equal
    (p25_general.py:75-155 path: deinterleave, trellis, CRC16, table)."""
    name, fields = TSBK_OSP[opcode]
    vals = rand_field_values(fields, rng)
    blk = P.pack_tsbk(name, mfid=0, last_block=True, **vals)
    frame = P.build_tsdu_frame(0x293, [blk])

    ref = G.procTSDU(bits_to_airbytes(frame))["tsbk"][0]
    mine = P.parse_frame(frame).tsbks[0]

    assert ref["crc"] == 0 == mine["crc"]
    assert ref["opcode"] == opcode == mine["opcode"]
    assert ref["name"] == name == mine["name"]
    assert ref["lb"] == "1" and mine["lb"] == 1
    for f, _w in fields:
        assert ref[f] == mine[f] == vals[f], f


@pytest.mark.parametrize("opcode", sorted(TSBK_MOTO))
def test_tsdu_moto_fields_match_reference(opcode, rng):
    """Motorola MFID 0x90 opcodes through the same differential path."""
    name, fields = TSBK_MOTO[opcode]
    vals = rand_field_values(fields, rng)
    blk = P.pack_tsbk(name, mfid=0x90, last_block=True, **vals)
    frame = P.build_tsdu_frame(0x293, [blk])

    ref = G.procTSDU(bits_to_airbytes(frame))["tsbk"][0]
    mine = P.parse_frame(frame).tsbks[0]

    assert ref["crc"] == 0 == mine["crc"]
    assert ref["mfid"] == 0x90 == mine["mfid"]
    assert ref["name"] == name == mine["name"]
    for f, _w in fields:
        assert ref[f] == mine[f] == vals[f], f


def test_tsdu_multiblock_match_reference(rng):
    """Multi-TSBK TSDUs agree block-for-block over the prefix the
    reference decodes (its loop peeks one raw interleaved bit for the
    last-block test, p25_general.py:86-89, so it may stop early — the
    blocks it does decode must match ours exactly)."""
    for _ in range(8):
        nblk = int(rng.integers(2, 4))
        blks, names = [], []
        for i in range(nblk):
            opcode = int(rng.choice(sorted(TSBK_OSP)))
            name, fields = TSBK_OSP[opcode]
            names.append(name)
            blks.append(P.pack_tsbk(name, mfid=0,
                                    last_block=(i == nblk - 1),
                                    **rand_field_values(fields, rng)))
        frame = P.build_tsdu_frame(0x293, blks)
        ref_tsbks = G.procTSDU(bits_to_airbytes(frame))["tsbk"]
        mine_tsbks = P.parse_frame(frame).tsbks
        assert len(mine_tsbks) == nblk
        assert 1 <= len(ref_tsbks) <= nblk
        for r, m, name in zip(ref_tsbks, mine_tsbks, names):
            assert r["crc"] == 0 == m["crc"]
            assert r["name"] == name == m["name"]
            for k, v in r.items():
                if k in ("lb", "p"):
                    assert int(v, 2) == m[k]
                elif k != "crc":
                    assert m[k] == v, k


def test_tsbk_trellis_error_correction_matches_reference(rng):
    """One flipped transmitted bit inside a 196-bit TSBK block: our
    Viterbi decode must always recover the block; the reference's greedy
    decoder (p25_general.py:234-273) can tie-break wrong on some single
    flips, but whenever it does correct, its output must equal ours."""
    ref_corrected = 0
    for _ in range(12):
        name, fields = TSBK_OSP[0x00]
        vals = rand_field_values(fields, rng)
        blk = P.pack_tsbk(name, mfid=0, last_block=True, **vals)
        tx = TR.tsbk_encode(blk)
        assert len(tx) == 196
        corrupt = tx.copy()
        corrupt[int(rng.integers(0, 192))] ^= 1

        ref = G.subprocTSBK("".join(map(str, corrupt)))
        mine, _errs = TR.tsbk_decode(corrupt)
        mine = P.unpack_tsbk(mine)
        assert mine["crc"] == 0
        assert mine["name"] == name
        for f, _w in fields:
            assert mine[f] == vals[f], f
        if ref["crc"] == 0:
            ref_corrected += 1
            assert ref["name"] == name
            for f, _w in fields:
                assert ref[f] == vals[f], f
    assert ref_corrected >= 6  # greedy still corrects most single flips


def test_tsbk_crc16_matches_reference(rng):
    """CRC16 (poly 0x11021-style 12-byte CCITT variant,
    p25_general.py:185-196) agrees on valid and corrupted blocks."""
    for _ in range(20):
        blk = CRC.tsbk_crc_encode(rng.integers(0, 2, 80).astype(np.uint8))
        s = "".join(map(str, blk))
        assert G.crc16(int(s, 2), 12) == 0
        assert CRC.tsbk_crc_check(blk)
        bad = blk.copy()
        bad[int(rng.integers(0, 96))] ^= 1
        sbad = "".join(map(str, bad))
        assert (G.crc16(int(sbad, 2), 12) == 0) == CRC.tsbk_crc_check(bad)


# ----------------------------------------------------------- other DUIDs
def test_tlc_frame_matches_reference(rng):
    """TLC link-control fields via reference procTLC
    (p25_general.py:101-112; fake Golay keeps systematic data bits,
    which our real Golay(24,12) encoder emits first)."""
    for _ in range(4):
        tgid = int(rng.integers(0, 1 << 16))
        src = int(rng.integers(0, 1 << 24))
        lc = P.make_link_control(0x0, tgid=tgid, source_id=src)
        frame = P.build_tlc_frame(0x293, lc)

        ref = G.procTLC(bits_to_airbytes(frame))["lc"]
        mine = P.parse_frame(frame).fields["lc"]
        assert ref["lcf"] == 0 == mine["lcf"]
        assert ref["tgid"] == tgid == mine["tgid"]
        assert ref["source_id"] == src == mine["source_id"]


def test_hdu_frame_matches_reference(rng):
    """HDU fields via reference procHDU (p25_general.py:21-36)."""
    for _ in range(3):
        mfid = int(rng.integers(0, 256))
        algid = int(rng.integers(0, 256))
        kid = int(rng.integers(0, 1 << 16))
        tgid = int(rng.integers(0, 1 << 16))
        mi = rng.integers(0, 2, 72).astype(np.uint8)
        frame = P.build_hdu_frame(0x293, mi=mi, mfid=mfid, algid=algid,
                                  kid=kid, tgid=tgid)
        ref = G.procHDU(bits_to_airbytes(frame))
        mine = P.parse_frame(frame).fields
        assert int(ref["mi"], 2) == B.bits_to_int(mi)
        assert int(mine["mi"], 16) == B.bits_to_int(mi)
        assert ref["mfid"] == mfid == mine["mfid"]
        assert ref["algid"] == algid == mine["algid"]
        assert ref["kid"] == kid == mine["kid"]
        assert ref["tgid"] == tgid == mine["tgid"]


def test_ldu1_frame_matches_reference(rng):
    """LDU1 voice-codeword slots, LSD, and link control all line up with
    reference procLDU1's interleave map (p25_general.py:45-74)."""
    tgid, src = 0x1234, 0xABCDE
    lc = P.make_link_control(0x0, tgid=tgid, source_id=src)
    vc = rng.integers(0, 2, (9, 144)).astype(np.uint8)
    frame = P.build_ldu1_frame(0x293, lc, vc_bits=vc)

    ref = G.procLDU1(bits_to_airbytes(frame))
    mine = P.parse_frame(frame).fields
    assert ref["lc"]["tgid"] == tgid == mine["lc"]["tgid"]
    assert ref["lc"]["source_id"] == src == mine["lc"]["source_id"]
    assert int(ref["lsd"], 2) == B.bits_to_int(mine["lsd"])


# ------------------------------------------------------------------ LFSR
def test_p2_lfsr_keystream_bit_identical(rng):
    """Phase 2 descrambler keystream == p25p2_lfsr.xorsyms
    (p25p2_lfsr.py:23-88) for random (NAC, SYSID, WACN) triples."""
    triples = [(0x293, 0x2C3, 0xBEE00), (0x001, 0x001, 0x00001),
               (0xFFF, 0xFFF, 0xFFFFF)]
    triples += [(int(rng.integers(0, 1 << 12)), int(rng.integers(0, 1 << 12)),
                 int(rng.integers(0, 1 << 20))) for _ in range(4)]
    for nac, sysid, wacn in triples:
        ref = np.array(REF["p25p2_lfsr"](nac, sysid, wacn).xorsyms,
                       np.uint8)
        mine = LFSR.keystream_dibits(nac, sysid, wacn)
        assert ref.shape == mine.shape
        np.testing.assert_array_equal(ref, mine, err_msg=str(
            (hex(nac), hex(sysid), hex(wacn))))


# ----------------------------------------------------------------- EDACS
def test_edacs_bch_differential(rng):
    """Our BCH(48,36) encode feeds the reference decoder
    (edacs_control_demod.py:451-518) cleanly and under 1- and 2-bit
    corruption; corrected outputs agree with our decoder."""
    ref_bch = reference_loader.ref_edacs_bch_decode()
    for _ in range(25):
        data = rng.integers(0, 2, 36).astype(np.uint8)
        cw = E.bch_encode(data)
        dstr = "".join(map(str, data))

        dec, loc = ref_bch("".join(map(str, cw)))
        assert dec and dec[:36] == dstr and loc == []

        for nerr in (1, 2):
            bad = cw.copy()
            bad[rng.choice(48, nerr, replace=False)] ^= 1
            ref_dec, ref_loc = ref_bch("".join(map(str, bad)))
            mine_dec, mine_n = E.bch_decode(bad)
            assert ref_dec and ref_dec[:36] == dstr, (nerr, ref_loc)
            assert mine_dec is not None and mine_n == nerr
            assert "".join(map(str, mine_dec[:36])) == dstr
            assert ref_dec == "".join(map(str, mine_dec))


def test_edacs_bch_uncorrectable_agreement(rng):
    """3-bit errors: both decoders either reject, or (if the corruption
    lands on another codeword) agree — neither silently diverges."""
    ref_bch = reference_loader.ref_edacs_bch_decode()
    for _ in range(15):
        data = rng.integers(0, 2, 36).astype(np.uint8)
        bad = E.bch_encode(data)
        bad[rng.choice(48, 3, replace=False)] ^= 1
        ref_dec, _ = ref_bch("".join(map(str, bad)))
        mine_dec, _ = E.bch_decode(bad)
        if ref_dec and mine_dec is not None:
            assert ref_dec == "".join(map(str, mine_dec))


# ------------------------------------------------------------------ Moto
def _ref_moto_parity_correct(pkt76: list[int]) -> list[int]:
    """Oracle transcription of the reference's inline parity corrector
    (moto_control_demod.py:284-318): alternating data/parity, expected
    parity p[x] = d[x-1]^d[x], adjacent parity-syndrome pairs flip the
    data bit between them."""
    data = pkt76[0::2]
    parity = pkt76[1::2]
    expected, last = [], 0
    for d in data:
        expected.append(last ^ d)
        last = d
    syndrome = [p ^ e for p, e in zip(parity, expected)]
    if any(syndrome):
        for x in range(len(syndrome) - 1):
            if syndrome[x] == 1 and syndrome[x + 1] == 1:
                data[x] ^= 1
    return data


def test_moto_deinterleave_matches_reference(rng):
    ref_deint = reference_loader.ref_moto_deinterleave()
    for _ in range(10):
        bits = rng.integers(0, 2, 76).astype(np.uint8)
        ref = ref_deint("".join(map(str, bits)))
        np.testing.assert_array_equal(M.deinterleave(bits),
                                      np.array(ref, np.uint8))


def test_moto_parity_correction_matches_reference(rng):
    """Clean + single-data-bit-flip frames: our correct_parity and the
    reference's syndrome walk recover the identical 38 data bits."""
    for _ in range(20):
        data = rng.integers(0, 2, 38).astype(np.uint8)
        pkt = M.add_parity(data)

        # clean
        ref = _ref_moto_parity_correct([int(b) for b in pkt])
        mine, had = M.correct_parity(pkt)
        assert not had
        np.testing.assert_array_equal(mine, np.array(ref, np.uint8))
        np.testing.assert_array_equal(mine, data)

        # flip one data bit (even index) — both must correct it
        bad = pkt.copy()
        bad[2 * int(rng.integers(0, 37))] ^= 1
        ref = _ref_moto_parity_correct([int(b) for b in bad])
        mine, had = M.correct_parity(bad)
        assert had
        np.testing.assert_array_equal(mine, np.array(ref, np.uint8))


def test_moto_osw_word_decode_matches_reference(rng):
    """lid/tg/status/ind/cmd extraction with the reference's XOR masks
    (moto_control_demod.py:325-330: lid^0xcc38, cmd^0xd5)."""
    for _ in range(20):
        bits = rng.integers(0, 2, 38).astype(np.uint8)
        s = "".join(map(str, bits))
        lid = int(s[:16], 2) ^ 0xCC38
        cmd = int(s[17:27], 2) ^ 0xD5
        p = M.parse_osw(bits)
        assert p["lid"] == lid
        assert p["tg"] == (lid & 0xFFF0)
        assert p["status"] == (lid & 0xF)
        assert p["ind"] == ("G" if int(s[16:17]) == 1 else "I")
        assert p["cmd"] == cmd


# ---------------------------------------------------------- field tables
def test_tsbk_field_tables_match_reference_exactly():
    """Every opcode in the reference's p25_cai.py:9 / p25_moto.py:9
    tables exists here with the identical name and identical
    (field name, bit width) sequence — and vice versa (no extras)."""
    for ref_table, mine_table in ((REF["cai_table"], TSBK_OSP),
                                  (REF["moto_table"], TSBK_MOTO)):
        assert set(ref_table) == set(mine_table)
        for op, ent in ref_table.items():
            name, fields = mine_table[op]
            assert ent["name"] == name, hex(op)
            ref_fields = [(f["name"], f["length"]) for f in ent["fields"]]
            assert ref_fields == list(fields), (hex(op), name)
