"""Longevity/leak check: SiteRuntime under continuous call churn.

The reference runs for days between watchdog restarts (watchdog.py:
85-107 restarts receivers after 24 h); this harness verifies the
runtime holds steady-state memory and thread counts under continuous
call lifecycle churn — open 8 calls, hold, hang-time close, repeat —
sampling VmRSS every 10 cycles.

Measured 2026-08-21 (CPU backend, 1 source × 80 slots, 2 systems):
192 cycles / 12,480 blocks (~21 stream-minutes), RSS flat at
733→735 MB, threads 6→6, zero stuck calls.

Usage: python tools/longevity.py [seconds]
"""

import gc
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def vmrss_mb() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) // 1024
    return -1


def main(duration_s: float = 420.0) -> None:
    from radiocapture_tpu.control.resp import MiniRedisServer
    from radiocapture_tpu.tools.soak import _SoakSite

    srv = MiniRedisServer()
    site = _SoakSite(0, 1, 1.0e6, 80, 2,
                     [{"host": srv.host, "port": srv.port}],
                     "/tmp/rc_longevity")
    site.publish_iden()
    site.rt.step()
    t0 = time.time()
    cycle, r_start = 0, None
    try:
        while time.time() - t0 < duration_s:
            for c in range(8):
                site.grant(c % 2, (cycle * 8 + c) % 70, 1000 + c)
            for _ in range(10):          # activity
                site.rt.step()
                for cm in site.rt.call_managers.values():
                    cm.sweep()
            for _ in range(55):          # hang-time close + drain
                site.rt.step()
                for cm in site.rt.call_managers.values():
                    cm.sweep()
            cycle += 1
            if cycle == 3:
                gc.collect()
                r_start = vmrss_mb()
            if cycle % 10 == 0:
                gc.collect()
                print(f"cycle {cycle}: rss {vmrss_mb()} MB, threads "
                      f"{threading.active_count()}, active "
                      f"{len(site.rt.recorders.active)}", flush=True)
        gc.collect()
        print(f"DONE {cycle} cycles ({cycle * 65} blocks): "
              f"rss {r_start} -> {vmrss_mb()} MB, threads "
              f"{threading.active_count()}")
    finally:
        site.close()
        srv.close()


if __name__ == "__main__":
    main(float(sys.argv[1]) if len(sys.argv) > 1 else 420.0)
