"""Multi-host scaling: HLO-verified collective accounting + model.

Compile the production sharded steps for a virtual 8-device CPU mesh,
inventory every cross-device collective GSPMD actually emitted (op kind
+ shape + bytes, from the partitioned HLO), check the inventory against
the analytic byte formulas derived from the pipeline constants, then
evaluate those formulas at the production shape against a single-device
step time and the link bandwidth.

Key structural facts this proves (not asserts):

- the **dp×tp step** (`ShardedControlStep`, sources × slots) compiles
  to ZERO inter-device collectives — scale-out over sources/slots is
  communication-free on the hot path, exactly like the reference's
  one-process-per-dongle layout (rc_frontend/receiver.py:67-70), so
  its weak-scaling efficiency is bounded only by the control plane
  (KB/s of JSON presence/events against MB/s-scale links);
- the **time-sharded step** (`TimeShardedControlStep`) emits exactly
  one halo `collective-permute`, one track-rate `all-to-all`, and the
  block-tail `all-reduce` — whose byte totals match the formulas
  below, giving a strong-scaling efficiency model at production shape.

Usage: python tools/scaling_model.py [--step-ms MS] [--link-gbps 450]
Prints one JSON line. Without ``--step-ms`` (a measured single-GPU step
time at the bench shape) the efficiency model is left out.
"""

import argparse
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_fl = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _fl:
    os.environ["XLA_FLAGS"] = (
        _fl + " --xla_force_host_platform_device_count=8").strip()

_DT_BYTES = {"f32": 4, "f16": 2, "bf16": 2, "f64": 8, "s32": 4,
             "u32": 4, "s8": 1, "u8": 1, "pred": 1, "c64": 8, "s64": 8,
             "u64": 8}

_COLLECTIVES = ("all-to-all", "collective-permute", "all-reduce",
                "all-gather", "reduce-scatter", "collective-broadcast")


def collective_inventory(hlo_text: str) -> list[dict]:
    """[{op, dtype, shape, bytes}] for every collective instruction in
    a partitioned HLO dump. Handles tuple-shaped results (all-to-all
    emits one tuple element per participant). ``bytes`` is the
    PER-DEVICE payload of one instruction execution (SPMD HLO is the
    per-device program)."""
    out = []
    op_re = re.compile(r"\s(" + "|".join(_COLLECTIVES) + r")\(")
    shape_re = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
    for line in hlo_text.splitlines():
        m = op_re.search(line)
        if m is None or "get-tuple-element" in line:
            continue
        op = m.group(1)
        total, shapes, dts = 0, [], set()
        for dm in shape_re.finditer(line[:m.start()]):
            dt, shape_s = dm.group(1), dm.group(2)
            if dt not in _DT_BYTES:
                continue
            dims = [int(d) for d in shape_s.split(",") if d] or [1]
            n = 1
            for d in dims:
                n *= d
            total += n * _DT_BYTES[dt]
            shapes.append(dims)
            dts.add(dt)
        if total:
            out.append({"op": op, "dtype": "+".join(sorted(dts)),
                        "shape": shapes, "bytes": total})
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--step-ms", type=float, default=None,
                    help="measured single-GPU full-step ms at the bench "
                         "shape")
    ap.add_argument("--link-gbps", type=float, default=450.0,
                    help="per-GPU link bandwidth, GB/s each way (H100 "
                         "SXM NVLink data sheet: 900 GB/s total, 450 "
                         "each way)")
    args = ap.parse_args()

    import jax
    import numpy as np
    jax.config.update("jax_platforms", "cpu")
    from jax.sharding import Mesh

    from radiocapture_tpu.frontend.pipeline import ControlPipeline
    from radiocapture_tpu.parallel.mesh import (ShardedControlStep,
                                                TimeShardedControlStep)

    devs = jax.devices()
    assert len(devs) >= 8, devs

    # compile shape: modest sources so CPU compile stays quick; the
    # formulas are then evaluated at the production bench shape.
    n_src, num_slots, samp_rate = 8, 64, 2.4e6
    pipe = ControlPipeline.p25_c4fm(num_slots=num_slots,
                                    samp_rate=samp_rate)
    # block sized for 8-way time sharding: T must divide by
    # time_shards x block_multiple (8 x 192); 2560 channel samples
    # ~= 102 ms, the same work rate as the bench's 2500.
    T = pipe.decim * 2560

    # ---- dp×tp step: prove it is collective-free
    mesh2 = Mesh(np.asarray(devs).reshape(4, 2), ("source", "slot"))
    s2 = ShardedControlStep(pipe, mesh2, n_src)
    st = jax.tree.map(lambda l: l, s2.init())
    x = np.zeros((n_src, T, 2), np.float32)
    offs = np.zeros((n_src, num_slots), np.float32)
    hlo2 = s2._step.lower(st, x, offs).compile().as_text()
    inv2 = collective_inventory(hlo2)

    # ---- time-sharded step: inventory + formula cross-check
    n_t = 8
    mesh3 = Mesh(np.asarray(devs).reshape(1, 1, 8),
                 ("source", "slot", "time"))
    s3 = TimeShardedControlStep(pipe, mesh3, n_src)
    st3 = s3.init()
    hlo3 = s3._step.lower(st3, x, offs).compile().as_text()
    inv3 = collective_inventory(hlo3)

    halo = s3.halo                            # complex64 samples/source
    n_track = T // pipe.decim // pipe.sym_decim   # track samples/slot

    def fmla(n_sources, n_time, slots, t_samples):
        """PER-DEVICE bytes per block (matches the SPMD HLO shapes):
        halo = each shard forwards n_sources x halo complex64; a2a =
        each device exchanges its 1/n_time share of the track-rate
        stream; tail all-reduce rides the halo-sized buffer."""
        nt = t_samples // pipe.decim // pipe.sym_decim
        return {
            "collective-permute": n_sources * halo * 8,
            "all-to-all": n_sources * slots * (nt // n_time) * 4,
            "all-reduce": n_sources * halo * 8,
        }

    want = fmla(n_src, n_t, num_slots, T)
    got = {}
    for e in inv3:
        got[e["op"]] = got.get(e["op"], 0) + e["bytes"]
    checks = {}
    for op, b in want.items():
        checks[op] = {"formula": b, "hlo": got.get(op, 0),
                      "match": got.get(op, 0) == b}

    # ---- production-shape model
    P_SRC, P_T = 128, T
    prod = fmla(P_SRC, n_t, num_slots, P_T)
    bw = args.link_gbps * 1e9
    # per-device strong-scaling costs at n_t-way time sharding: each
    # device sends its halo once, exchanges (n_t-1)/n_t of its a2a
    # share, contributes the tail reduce.
    halo_dev = prod["collective-permute"]
    a2a_dev = prod["all-to-all"] * (n_t - 1) / n_t
    tail_dev = prod["all-reduce"]
    comm_ms = (halo_dev + a2a_dev + tail_dev) / bw * 1e3
    comp_ms = eff_time = None
    if args.step_ms is not None:
        comp_ms = args.step_ms / n_t
        eff_time = comp_ms / (comp_ms + comm_ms)

    print(json.dumps({
        "dp_tp_collectives": inv2,          # expected: []
        "dp_tp_collective_free": not inv2,
        "time_shard_inventory": inv3,
        "time_shard_formula_check": checks,
        "halo_samples": halo,
        "track_samples_per_slot": n_track,
        "production": {
            "sources": P_SRC, "block_samples": P_T,
            "time_shards": n_t,
            "bytes_per_block": prod,
            "link_gbps": args.link_gbps,
            "measured_step_ms": args.step_ms,
            "comm_ms_per_device": comm_ms,
            "compute_ms_per_device": comp_ms,
            "strong_scaling_efficiency_time_axis": eff_time,
            "weak_scaling_efficiency_dp_axis":
                1.0 if not inv2 else None,
        },
    }))


if __name__ == "__main__":
    main()
