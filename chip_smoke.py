"""Smoke run of the capture site on one GPU.

Drives the served path once at the production-host shape and checks what
comes out. Phases, in order; any failure exits non-zero:

1. device   — JAX's default backend must be ``gpu``; prints the device
               kind and count and nvidia-smi's name and power limit.
2. bank     — XlatBank at real width (2.4 MS/s, 64 slots, K = 1440, one
               240 000-sample block) on the card against a float64 NumPy
               direct correlation; a two-block split against one block.
3. pipeline — ControlPipeline.p25_c4fm on a modulated P25 control channel,
               on the card and on the CPU in this process: the decided
               control-slot dibits must be identical.
4. site     — SiteRuntime with configs/config_site_10rtl.py (10 sources x
               2.4 MS/s x 64 slots, mixed systems); source 0 carries a
               modulated P25 control channel, the rest noise. The control
               instance must lock, every generated grant must decode with
               no bad messages, the call manager must emit the call and
               the recorder must open on the granted frequency.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

    python chip_smoke.py
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from radiocapture_tpu.fec import bits as B
from radiocapture_tpu.protocol import p25 as P
from radiocapture_tpu.testing import modulators as M
from radiocapture_tpu.testing.reference import rel_rms, xlat_bank

SAMP_RATE = 2.4e6
NUM_SLOTS = 64
CENTER = 857.0e6
CC_FREQ = 857.5e6
VC_FREQ = 856.2e6          # IDEN base frequency: channel number 0
GROUP, SOURCE_ID = 5001, 777
BANK_TOL = 2e-3            # rel-RMS, TF32/bf16 operands, f32 accumulation
SITE_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs", "config_site_10rtl.py")


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


# ---------------------------------------------------------------- inputs
def control_frames(n_pairs: int) -> list:
    """IDEN_UP + GRP_V_CH_GRANT TSDU pairs (grant -> VC_FREQ)."""
    iden = P.pack_tsbk("IDEN_UP", **{
        "Identifier": 1, "BW": 100, "Base Frequency": int(VC_FREQ / 5),
        "Channel Spacing": 50, "Transmit Offset": 0x1B4})
    grant = P.pack_tsbk("GRP_V_CH_GRANT", last_block=True, **{
        "Channel": 0x1000, "Group Address": GROUP,
        "Source Address": SOURCE_ID})
    return [P.build_tsdu_frame(0x293, [iden]),
            P.build_tsdu_frame(0x293, [grant])] * n_pairs


def control_capture(n: int) -> tuple[np.ndarray, np.ndarray]:
    """[n] complex64 wideband capture at CENTER with a C4FM control
    channel at CC_FREQ; returns (capture, sample index at which each
    modulated grant's frame ends)."""
    pair = len(B.bits_to_dibits(np.concatenate(control_frames(1))))
    pairs = -(-int(n / SAMP_RATE * 4800.0 + 1) // pair)
    dibits = B.bits_to_dibits(np.concatenate(control_frames(pairs)))
    iq = M.upsample_to(M.c4fm_modulate(dibits, fs=25000.0), 25000.0,
                       SAMP_RATE)
    wide = M.multi_channel(SAMP_RATE, [(CC_FREQ - CENTER, iq)], n)
    ends = np.arange(1, pairs + 1) * pair / 4800.0 * SAMP_RATE
    return wide, ends


def noise_capture(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (1e-3 / np.sqrt(2) * (rng.standard_normal(n)
                                 + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


# --------------------------------------------------------------- phase 1
def phase_device(jax) -> dict:
    platform = jax.default_backend()
    check(platform == "gpu", f"default backend is {platform!r}, not gpu")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()
    check(smi.returncode == 0 and bool(card), "nvidia-smi gave no card")
    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    print(f"device: platform={info['platform']} kind={info['kind']} "
          f"count={info['count']} nvidia-smi: {card[0]}", flush=True)
    return info


# --------------------------------------------------------------- phase 2
def phase_bank(jax, samp_rate=SAMP_RATE, num_slots=NUM_SLOTS,
               block=240_000) -> None:
    import jax.numpy as jnp
    from radiocapture_tpu.ops.channelizer import XlatBank, XlatBankState
    bank = XlatBank.for_rates(num_slots, samp_rate, 12500.0)
    rng = np.random.default_rng(11)
    cplx = lambda n: ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
                      / np.sqrt(2)).astype(np.complex64)
    x = cplx(block)
    hist = cplx(bank.ntaps - 1)
    spacing = 0.95 * samp_rate / num_slots
    offs = (((np.arange(num_slots) - num_slots / 2 + 0.5) * spacing)
            / samp_rate).astype(np.float32)
    phase0 = rng.integers(0, 2 ** 32, num_slots, dtype=np.uint64
                          ).astype(np.uint32)
    call = jax.jit(bank.__call__)
    st = XlatBankState(jnp.asarray(hist), jnp.asarray(phase0))
    _, y = call(st, jnp.asarray(x), jnp.asarray(offs))
    y = np.asarray(y)
    ref = xlat_bank(x, hist, bank.taps, offs, phase0, bank.decim)
    err = rel_rms(y, ref)
    err_max = float(np.max(np.abs(y - ref)) / np.max(np.abs(ref)))
    # two half blocks, state carried, against one block from init
    half = block // 2
    _, one = call(bank.init(), jnp.asarray(x), jnp.asarray(offs))
    s, y1 = call(bank.init(), jnp.asarray(x[:half]), jnp.asarray(offs))
    _, y2 = call(s, jnp.asarray(x[half:]), jnp.asarray(offs))
    split = rel_rms(np.concatenate([np.asarray(y1), np.asarray(y2)], 1),
                    np.asarray(one))
    print(f"bank: slots={num_slots} taps={bank.ntaps} decim={bank.decim} "
          f"block={block} rel_rms={err:.3e} max_err/max={err_max:.3e} "
          f"split_rel_rms={split:.3e} tol={BANK_TOL:.0e}", flush=True)
    check(y.shape == (num_slots, block // bank.decim), f"shape {y.shape}")
    check(err <= BANK_TOL, f"bank rel-RMS {err:.3e} > {BANK_TOL}")
    check(split <= BANK_TOL, f"split rel-RMS {split:.3e} > {BANK_TOL}")


# --------------------------------------------------------------- phase 3
def phase_pipeline(jax, num_slots=NUM_SLOTS, n_blocks=8,
                   block=240_000) -> None:
    from radiocapture_tpu.frontend.pipeline import ControlPipeline
    wide, _ = control_capture(n_blocks * block)
    xw = np.stack([wide.real, wide.imag], -1).astype(np.float32)
    offs = np.zeros(num_slots, np.float32)
    offs[0] = (CC_FREQ - CENTER) / SAMP_RATE
    offs[1:] = np.linspace(-0.45, 0.45, num_slots - 1, dtype=np.float32)

    def run(device):
        with jax.default_device(device):
            pipe = ControlPipeline.p25_c4fm(num_slots, SAMP_RATE)
            st = pipe.init()
            syms, dibs = [], []
            for i in range(n_blocks):
                st, (s, v, d) = pipe.step(st, xw[i * block:(i + 1) * block],
                                          offs)
                v = np.asarray(v[0]).astype(bool)
                syms.append(np.asarray(s[0])[v])
                dibs.append(np.asarray(d[0])[v])
        return np.concatenate(syms), np.concatenate(dibs)

    s_gpu, d_gpu = run(jax.devices()[0])
    s_cpu, d_cpu = run(jax.devices("cpu")[0])
    m = min(len(s_gpu), len(s_cpu))
    sym_rms = float(np.sqrt(np.mean((s_gpu[:m] - s_cpu[:m]) ** 2)))
    same = len(d_gpu) == len(d_cpu) and bool(np.all(d_gpu == d_cpu))
    print(f"pipeline: control-slot symbols gpu={len(d_gpu)} "
          f"cpu={len(d_cpu)} dibits_identical={same} "
          f"symbol_rms_diff={sym_rms:.3e}", flush=True)
    check(len(d_gpu) > 1000, "too few symbols on the control slot")
    check(same, "control-slot dibits differ between card and CPU")


# --------------------------------------------------------------- phase 4
def site_captures(cfg, n_blocks: int) -> tuple[dict, int]:
    """Synthetic captures for every configured source: source 0 carries
    the control channel, the rest noise (shorter, looped by FileSource).
    Also returns how many grants end inside the processed blocks, less
    20 ms for the pipeline's delay."""
    n = int(SAMP_RATE * cfg.block_seconds) * n_blocks
    caps = {}
    for idx in cfg.sources:
        if idx == 0:
            caps[idx], ends = control_capture(n)
        else:
            caps[idx] = noise_capture(int(SAMP_RATE * 0.5), seed=idx)
    return caps, int(np.sum(ends <= n - 0.02 * SAMP_RATE))


def phase_site(config_path=SITE_CONFIG, n_blocks=40, **overrides) -> None:
    from radiocapture_tpu.rxconfig import load_config
    from radiocapture_tpu.runtime import FileSource, SiteRuntime
    cfg = load_config(config_path)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    caps, sent = site_captures(cfg, n_blocks)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as audio_dir:
        cfg.audio_dir = audio_dir
        t0 = time.perf_counter()
        rt = SiteRuntime(cfg, {i: FileSource(c) for i, c in caps.items()})
        setup_s = time.perf_counter() - t0
        rt.use_stream_clock()
        grants, new_calls = [], []
        rt.bus.subscribe("/topic/raw_control/*", lambda ev: grants.append(
            ev) if ev.get("name") == "GRP_V_CH_GRANT" else None)
        rt.bus.subscribe("/topic/call_management/new_call/*",
                         new_calls.append)
        opened = {}
        step_ms = []
        try:
            for _ in range(n_blocks):
                t = time.perf_counter()
                rt.step()
                step_ms.append((time.perf_counter() - t) * 1e3)
                for cu, (rec, *_r) in list(rt.recorders.active.items()):
                    opened[cu] = rec.cdr["frequency"]
            rt.bus.flush()
            eng = rt.instances[0].engine
            locked, bad = eng.is_locked, eng.bad_messages
        finally:
            rt.close()
    first_s = step_ms[0] / 1e3
    steady = np.asarray(step_ms[2:])
    p50, p95 = np.percentile(steady, 50), np.percentile(steady, 95)
    print(f"site: sources={len(cfg.sources)} slots={cfg.num_slots_per_source}"
          f" blocks={n_blocks} locked={locked} grants_sent={sent} "
          f"grants_decoded={len(grants)} bad_messages={bad} "
          f"new_calls={len(new_calls)} recordings_opened={len(opened)} "
          f"step_p50_ms={p50:.2f} step_p95_ms={p95:.2f} deadline_ms="
          f"{cfg.block_seconds * 1e3:.0f}", flush=True)
    print(f"site compile: setup_s={setup_s:.2f} first_step_s={first_s:.2f}",
          flush=True)
    check(locked, "control instance did not lock")
    check(bad == 0, f"{bad} bad messages on the control channel")
    check(len(grants) >= sent > 0, f"decoded {len(grants)} of {sent} grants")
    check(any(c.get("system_group_local") == GROUP
              and c.get("system_user_local") == SOURCE_ID
              for c in new_calls), "no new_call for the generated grant")
    check(any(abs(f - VC_FREQ) < 100.0 for f in opened.values()),
          f"no recorder opened on {VC_FREQ:.0f} Hz: {opened}")


def main() -> int:
    import jax
    try:
        info = phase_device(jax)
        from radiocapture_tpu.utils import compile_cache
        compile_cache.enable()
        phase_bank(jax)
        phase_pipeline(jax)
        phase_site()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
