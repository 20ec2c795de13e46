"""Sustained serving soak of the FM bank at a 20 ms serving width.

Runs the serving loop for --seconds (or --blocks) and reports sustained
realtime factor, per-block latency percentiles and host RSS growth, so a
serving width is backed by a sustained run, not a short measurement.

Deployment shape: FM+PL bank at 393.216 Msps, 20 ms blocks (the
reference default cadence, main.c:113-115), device-side active-set
compaction (`process_active` — audio.c:102-113's silence suppression
lifted to the bank) with the PCM/idx/diag fetches pipelined 3-deep via
copy_to_host_async, exactly like apps/bankd.py's serving loop.

Input blocks stay device-resident (a small rotating pool), so the soak
measures the device step and the device-to-host path, not ingest; the
loop is bounded by --seconds/--blocks; per-block latency is wall clock
from dispatch to *completed fetch*, which is what serving latency means.

Usage:
  python tools/serve_soak.py --channels 5120 --seconds 600
  python tools/serve_soak.py --cpu --blocks 40        # hermetic smoke
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=5120)
    ap.add_argument("--samprate", type=float, default=393.216e6)
    ap.add_argument("--L", type=int, default=7864320)      # 20 ms block
    ap.add_argument("--M", type=int, default=8912897)      # M_dec = 1089
    ap.add_argument("--seconds", type=float, default=600.0,
                    help="stop after this much wall time")
    ap.add_argument("--blocks", type=int, default=0,
                    help="stop after N blocks (0 = by --seconds only)")
    ap.add_argument("--max-active", type=int, default=64)
    ap.add_argument("--pool", type=int, default=4,
                    help="rotating device-resident input blocks")
    ap.add_argument("--depth", type=int, default=3,
                    help="fetch pipeline depth (bankd uses 3)")
    ap.add_argument("--cpu", action="store_true",
                    help="tiny-geometry hermetic smoke run")
    args = ap.parse_args()

    import jax

    from ka9q_sdr_tpu.utils.runtime import configure_jax

    configure_jax(cpu=args.cpu)
    if args.cpu:
        args.samprate, args.L, args.M = 1.536e6, 30720, 32769
        args.channels = min(args.channels, 16)
        args.blocks = args.blocks or 40

    from ka9q_sdr_tpu.models.bank import ChannelBank, make_bank_config

    B, L = args.channels, args.L
    args.max_active = min(args.max_active, B)
    block_s = L / args.samprate
    cfg = make_bank_config(B, "FM", samprate=args.samprate, L=L, M=args.M,
                           enable_pl=True)
    usable = 0.9 * args.samprate
    freqs = list(np.linspace(-usable / 2, usable / 2, B, endpoint=False))
    print(f"# building {B}-ch FM+PL bank, {args.samprate/1e6:.3f} Msps, "
          f"{block_s*1e3:.1f} ms blocks (L_dec={cfg.L_dec})...",
          file=sys.stderr, flush=True)
    bank = ChannelBank(cfg, freqs)

    # Rotating pool of device-resident inputs: a handful of active FM
    # carriers (well above the squelch) + noise, slightly different per
    # pool entry so XLA cannot constant-fold across blocks.
    rng = np.random.default_rng(7)
    tt = np.arange(L) / args.samprate
    pool = []
    act = [3, B // 3, B // 2, (2 * B) // 3, B - 5]
    for p in range(args.pool):
        x = 0.01 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
        for ch in act:
            # FM-modulate a 1 kHz tone at 5 kHz deviation so the
            # channels are loudly non-silent for the compaction top-k
            ph = 2 * np.pi * freqs[ch] * tt + (5e3 / 1e3) * np.sin(
                2 * np.pi * 1e3 * tt + p)
            x += 0.2 * np.exp(1j * ph)
        x_i = np.empty((L, 2), np.int16)
        x_i[:, 0] = np.clip(x.real * 32767, -32768, 32767)
        x_i[:, 1] = np.clip(x.imag * 32767, -32768, 32767)
        pool.append(jax.device_put(x_i))
        del x, x_i
    del tt

    # Warmup: compile + first block, ended by a real fetch.
    t0 = time.time()
    pcm, idx, diag = bank.process_active(pool[0], max_active=args.max_active)
    np.asarray(idx)
    print(f"# warmup (compile + first block): {time.time()-t0:.1f} s",
          file=sys.stderr, flush=True)

    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss

    # Serving loop, fetches pipelined `depth` deep like bankd's.
    inflight = []            # (t_dispatch, pcm, idx, diag)
    lat_ms = []
    t_start = time.time()
    n = 0
    deadline = t_start + args.seconds

    def drain_one():
        t_d, leaves = inflight.pop(0)
        for a in leaves:
            np.asarray(a)
        lat_ms.append((time.time() - t_d) * 1e3)

    while True:
        now = time.time()
        if args.blocks and n >= args.blocks:
            break
        if not args.blocks and now >= deadline:
            break
        out = bank.process_active(
            pool[n % args.pool], max_active=args.max_active)
        leaves = jax.tree_util.tree_leaves(out)
        for a in leaves:
            a.copy_to_host_async()
        inflight.append((time.time(), leaves))
        n += 1
        if len(inflight) > args.depth:
            drain_one()
        if n % 512 == 0:
            el = time.time() - t_start
            print(f"# {n} blocks, {el:.0f} s, sustained "
                  f"{n*block_s/el:.2f}x rt", file=sys.stderr, flush=True)
    while inflight:
        drain_one()

    elapsed = time.time() - t_start
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    lat = np.sort(np.asarray(lat_ms))
    res = {
        "channels": B,
        "block_ms": round(block_s * 1e3, 2),
        "blocks": n,
        "elapsed_s": round(elapsed, 1),
        "sustained_rt": round(n * block_s / elapsed, 3),
        "p50_ms": round(float(lat[len(lat) // 2]), 1),
        "p99_ms": round(float(lat[int(len(lat) * 0.99)]), 1),
        "max_ms": round(float(lat[-1]), 1),
        "rss_growth_kb_per_blk": round((rss1 - rss0) / max(n, 1), 2),
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
    }
    print(json.dumps(res))


if __name__ == "__main__":
    main()
