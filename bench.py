"""Flagship benchmark: multichannel demodulation throughput on one card.

Metric: channels x Msamples/sec of wideband I/Q demodulated per card,
sustained (BASELINE.json).  The reference demodulates ~1 channel from a
0.192 Msps stream per CPU core (BASELINE.md); a card running the bank at
real time on its native geometry scores n_channels x samprate/1e6.  We
report the *achieved* rate: blocks/sec x L x n_channels, which exceeds
real time when the card has headroom.

The headline row is the FULL reference FM workload — PL tone detection on
(fm.c:49,201-277 always runs pltask) — plus p50/p99 block latency; a
second stderr row measures the heaviest mode, a PLL (CAM) bank.

Runs on a CUDA card only (fails when JAX finds no GPU).  Every call ends
in block_until_ready; inputs are device-resident, so the rows measure
the device step, not ingest.  Prints ONE JSON line: {"metric", "value",
"unit", "vs_baseline", "device"}; the card's name and power limit and the
extra rows go to stderr.  (BENCH_CHANNELS=0 — a probe-only mode for
measuring the other rows in isolation — skips the flagship row and with
it the stdout JSON line; the default run always prints it.)
"""

import json
import os
import sys
import time

import numpy as np


def _run_blocks(step, n):
    """Dispatch n steps back to back, wait for the last; seconds."""
    import jax

    t0 = time.perf_counter()
    for _ in range(n):
        out = step()
    jax.block_until_ready(out)
    return time.perf_counter() - t0


def _measure(mode, n_channels, samprate, L, M, warmup, iters,
             use_scan=True, measure_latency=True, **cfg_kw):
    print(f"# measuring {mode} {n_channels} ch x {samprate/1e6:.3f} Msps "
          f"L={L}...", file=sys.stderr, flush=True)
    import jax
    import jax.numpy as jnp
    from ka9q_sdr_tpu.models.bank import make_bank_config, ChannelBank

    cfg = make_bank_config(n_channels, mode, samprate=samprate, L=L, M=M,
                           **cfg_kw)
    usable = 0.9 * samprate
    freqs = list(np.linspace(-usable / 2, usable / 2, n_channels, endpoint=False))
    bank = ChannelBank(cfg, freqs)

    rng = np.random.default_rng(1)
    # wideband block with a few carriers + noise, packed real
    tt = np.arange(L) / samprate
    x = 0.01 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
    for ch in (3, n_channels // 2, n_channels - 5):
        x += 0.2 * np.exp(2j * np.pi * freqs[ch] * tt)
    x = x.astype(np.complex64)
    # production ingest format: raw int16 pairs, converted on-device
    x_i = np.empty((L, 2), np.int16)
    x_i[:, 0] = np.clip(x.real * 32767, -32768, 32767)
    x_i[:, 1] = np.clip(x.imag * 32767, -32768, 32767)

    chunk = int(os.environ.get("BENCH_CHUNK", "8"))
    x_dev = jax.device_put(x_i)

    for _ in range(warmup):
        audio, diag = bank.process_i16(x_dev)
    jax.block_until_ready(audio)

    # Throughput: `iters` dispatches back to back, ended by one wait.
    # Short (20 ms) blocks run `chunk` blocks per device program
    # (bank_scan_packed_i16) to amortise the per-block dispatch; long
    # blocks use the plain step.
    if use_scan:
        # the scan chunk is broadcast on the device from one upload
        xs_dev = jax.jit(
            lambda a: jnp.broadcast_to(a, (chunk,) + a.shape) + 0
        )(x_dev)
        jax.block_until_ready(bank.process_scan_i16(xs_dev))  # compile

        def step():
            return bank.process_scan_i16(xs_dev)
    else:
        chunk = 1

        def step():
            return bank.process_i16(x_dev)[0]

    dt_blk = _run_blocks(step, iters) / (iters * chunk)
    sps = L / dt_blk                          # wideband samples/sec achieved

    # Block round trip: one per-block program, waited for, per call
    if not measure_latency:
        return sps, float("nan"), float("nan")
    lat = []
    for _ in range(max(10, iters)):
        t1 = time.perf_counter()
        audio, diag = bank.process_i16(x_dev)
        jax.block_until_ready(audio)
        lat.append(time.perf_counter() - t1)
    lat = np.sort(lat)
    p50 = float(lat[len(lat) // 2]) * 1e3
    p99 = float(lat[min(len(lat) - 1, int(len(lat) * 0.99))]) * 1e3
    return sps, p50, p99


def _measure_mixed(groups_spec, samprate, L, M, warmup, iters):
    """Mixed-mode (MultiBank) row: several demod groups off ONE shared
    wideband FFT — the deployment shape the repo ships units for
    (mostly-FM plus some USB/CAM groups)."""
    import jax
    from ka9q_sdr_tpu.models.bank import MultiBank

    total = sum(n for _, n in groups_spec)
    print(f"# measuring MultiBank {'+'.join(f'{m}:{n}' for m, n in groups_spec)}"
          f" x {samprate/1e6:.3f} Msps L={L}...", file=sys.stderr, flush=True)
    usable = 0.9 * samprate
    all_freqs = np.linspace(-usable / 2, usable / 2, total, endpoint=False)
    groups, i = [], 0
    for mode, n in groups_spec:
        groups.append((mode, list(all_freqs[i:i + n])))
        i += n
    mb = MultiBank(groups, samprate=samprate, L=L, M=M)

    rng = np.random.default_rng(2)
    tt = np.arange(L) / samprate
    x = 0.01 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
    for g, (_, freqs) in enumerate(groups):
        x += 0.2 * np.exp(2j * np.pi * freqs[len(freqs) // 2] * tt)
    x_r = np.stack([x.real, x.imag], axis=-1).astype(np.float32)
    x_dev = jax.device_put(x_r)

    states = mb.states
    for _ in range(warmup):
        states, outs = mb._step(states, x_dev)
    jax.block_until_ready(outs)

    def step():
        nonlocal states
        states, outs = mb._step(states, x_dev)
        return outs

    dt_blk = _run_blocks(step, iters) / iters
    return L / dt_blk, total


def main():
    import jax
    from ka9q_sdr_tpu.utils.runtime import configure_jax, require_gpu

    configure_jax()   # persistent compile cache
    dev = require_gpu()
    print(f"# device: {dev['platform']} {dev['kind']} x{dev['count']}; "
          f"card: {dev['card']}; jax {jax.__version__}", file=sys.stderr,
          flush=True)
    # Geometry: the per-channel work dominates and the wideband FFT is
    # shared, so go WIDE (393.216 Msps master) and go LONG — overlap-save
    # with L = 6.5(M-1) spends 1.15 FFT points per input sample instead
    # of the reference's ~2.1, at the cost of a 148 ms block (fine for
    # monitoring-scale channelisation; the reference-cadence 20 ms rows
    # below keep the Opus-friendly latency).
    n_channels = int(os.environ.get("BENCH_CHANNELS", "8192"))
    samprate = float(os.environ.get("BENCH_SAMPRATE", str(393.216e6)))
    L = int(os.environ.get("BENCH_L", str(58195968)))    # L_dec = 7104
    M = int(os.environ.get("BENCH_M", str(8912897)))     # M_dec = 1089
    warmup = int(os.environ.get("BENCH_WARMUP", "3"))
    iters = int(os.environ.get("BENCH_ITERS", "20"))
    ref_L = int(os.environ.get("BENCH_REF_L", str(7864320)))   # 20 ms
    # Serving sweep: the 20 ms cadence measured at SEVERAL widths so the
    # widest sustained-realtime *serving* width is a measured fact, not an
    # extrapolation.  Comma list; "0" skips the sweep entirely.
    serve_channels = [
        int(s) for s in
        os.environ.get("BENCH_SERVE_CHANNELS", "4096,5120,6144").split(",")
        if int(s) > 0
    ]
    # The cadence-frontier rows (20 ms k=1 + 62.7 ms midpoint) are off
    # by default; BENCH_FRONTIER=1 runs them.
    frontier = os.environ.get("BENCH_FRONTIER", "0") != "0"
    pll_channels = int(os.environ.get("BENCH_PLL_CHANNELS", "2048"))
    pll_samprate = float(os.environ.get("BENCH_PLL_SAMPRATE", str(24.576e6)))
    pll_L = int(os.environ.get("BENCH_PLL_L", str(491520)))
    pll_M = int(os.environ.get("BENCH_PLL_M", str(557057)))

    # Headline: FM with the PL-tone chain ON (the reference's full FM
    # path), long-block geometry, plain per-block stepping (no scan:
    # dispatch is <2% of a 60 ms block)
    if n_channels > 0:        # BENCH_CHANNELS=0 -> measure other rows only
        sps, p50, p99 = _measure(
            "FM", n_channels, samprate, L, M, warmup,
            max(8, iters // 2), enable_pl=True, use_scan=False,
        )
        value = n_channels * sps / 1e6        # channels x Msps
        baseline = 0.192                      # 1 ch x 0.192 Msps per CPU core
        print(
            json.dumps(
                {
                    "metric": "channels_x_Msps_demodulated_per_chip",
                    "value": round(value, 3),
                    "unit": "ch*Msps",
                    "vs_baseline": round(value / baseline, 1),
                    "device": {"platform": dev["platform"],
                               "kind": dev["kind"], "count": dev["count"]},
                }
            )
        )
        print(
            f"# FM+PL {n_channels} ch x {samprate/1e6:.3f} Msps bank "
            f"(long blocks, L={L}): {sps/1e6:.2f} Msps achieved "
            f"({sps/samprate:.2f}x realtime), "
            f"round-trip p50 {p50:.2f} ms / p99 {p99:.2f} ms",
            file=sys.stderr,
        )

    # Serving sweep: the Opus-friendly 20 ms cadence at several widths —
    # "N simultaneous 48 kHz FM receivers from one 393 Msps stream at
    # 20 ms latency on one card", with the widest >=1.0x row being the
    # measured serving ceiling.
    if ref_L > 0 and serve_channels:
        for sc in serve_channels:
            sps_r, p50r, p99r = _measure(
                "FM", sc, samprate, ref_L, M, warmup, iters,
                enable_pl=True,
            )
            print(
                f"# FM+PL {sc} ch x {samprate/1e6:.3f} Msps bank "
                f"(20 ms blocks, serving cadence): {sps_r/1e6:.2f} Msps "
                f"({sps_r/samprate:.2f}x realtime), "
                f"{sc*sps_r/1e6:.0f} ch*Msps, "
                f"round-trip p50 {p50r:.2f} ms / p99 {p99r:.2f} ms",
                file=sys.stderr,
            )

    # Cadence/throughput/latency FRONTIER (the latency knob of
    # derive_geometry): with the 1089-tap channel impulse and
    # power-of-two N, the achievable cadences between the reference's
    # 20 ms and the long-block 148 ms are L_dec in {960, 3008, 7104}
    # (overlap-save redundancy N/L = 2.13 / 1.36 / 1.15 FFT points per
    # input sample).  The 20 ms row above amortises dispatch over
    # 8-block scan chunks; the k=1 row here isolates the per-dispatch
    # cost at the same geometry.
    if frontier and ref_L > 0 and n_channels > 0:
        sps_k1, _, _ = _measure(
            "FM", n_channels, samprate, ref_L, M, warmup, iters,
            enable_pl=True, use_scan=False, measure_latency=False,
        )
        print(
            f"# frontier 20 ms k=1 (no scan chunking): "
            f"{sps_k1/1e6:.2f} Msps ({sps_k1/samprate:.2f}x realtime), "
            f"{n_channels*sps_k1/1e6:.0f} ch*Msps  [N/L=2.13]",
            file=sys.stderr,
        )
        L_mid = 3008 * round(samprate / 48000)          # 62.7 ms, N=2^25
        sps_m, _, _ = _measure(
            "FM", n_channels, samprate, L_mid, M, warmup,
            max(6, iters // 2), enable_pl=True, use_scan=False,
            measure_latency=False,
        )
        print(
            f"# frontier 62.7 ms (L_dec=3008): "
            f"{sps_m/1e6:.2f} Msps ({sps_m/samprate:.2f}x realtime), "
            f"{n_channels*sps_m/1e6:.0f} ch*Msps  [N/L=1.36]",
            file=sys.stderr,
        )

    # Scaling row: the 2048-channel long-block point.
    if os.environ.get("BENCH_SCALING", "1") != "0":
        sps_s, _, _ = _measure(
            "FM", 2048, samprate, L, M, warmup, max(6, iters // 2),
            enable_pl=True, use_scan=False, measure_latency=False,
        )
        print(
            f"# scaling: 2048 ch long blocks: {sps_s/1e6:.2f} Msps "
            f"({sps_s/samprate:.2f}x realtime), "
            f"{2048*sps_s/1e6:.0f} ch*Msps",
            file=sys.stderr,
        )

    # Mixed-mode rows: the deployment shape (MultiBankDaemon) — mostly-FM
    # plus USB and CAM(PLL) groups sharing ONE master FFT at the 20 ms
    # serving cadence.  BENCH_MIXED=0 skips; ';'-separated list of
    # "FM:3072,USB:512,CAM:512" specs overrides the compositions.
    mixed_specs = os.environ.get(
        "BENCH_MIXED",
        "FM:3072,USB:512,CAM:512;FM:5120,USB:512,CAM:512")
    if mixed_specs not in ("", "0"):
        for mixed_spec in mixed_specs.split(";"):
            spec = [(s.split(":")[0], int(s.split(":")[1]))
                    for s in mixed_spec.split(",")]
            sps_mx, total_mx = _measure_mixed(
                spec, samprate, ref_L, M, warmup, iters
            )
            print(
                f"# MultiBank {'+'.join(f'{m} {n}' for m, n in spec)} x "
                f"{samprate/1e6:.3f} Msps (20 ms blocks, shared master FFT): "
                f"{sps_mx/1e6:.2f} Msps ({sps_mx/samprate:.2f}x realtime), "
                f"{total_mx*sps_mx/1e6:.0f} ch*Msps",
                file=sys.stderr,
            )

    # Heaviest-mode rows: PLL (CAM) banks with the decimated acquisition
    # ring (demod_linear.py), at the FM bank's 393.216 Msps master and at
    # 24.576 Msps.
    if pll_channels > 0:
        # Wide CAM row: plain per-block stepping (no scan chunk).
        wide_sr = float(os.environ.get("BENCH_PLL_WIDE_SAMPRATE",
                                       str(393.216e6)))
        wide_ch = int(os.environ.get("BENCH_PLL_WIDE_CHANNELS", "4096"))
        if wide_sr > 0 and wide_ch > 0:
            sps_w, p50w, p99w = _measure(
                "CAM", wide_ch, wide_sr, 7864320, 8912897,
                warmup, iters, use_scan=False,
            )
            print(
                f"# CAM(PLL) {wide_ch} ch x {wide_sr/1e6:.3f} Msps "
                f"bank (20 ms blocks, k=1): {sps_w/1e6:.2f} Msps "
                f"({sps_w/wide_sr:.2f}x realtime), "
                f"{wide_ch * sps_w / 1e6:.0f} ch*Msps, "
                f"round-trip p50 {p50w:.2f} ms / p99 {p99w:.2f} ms",
                file=sys.stderr,
            )
        sps2, p50b, p99b = _measure(
            "CAM", pll_channels, pll_samprate, pll_L, pll_M, warmup, iters
        )
        print(
            f"# CAM(PLL) {pll_channels} ch x {pll_samprate/1e6:.3f} Msps bank: "
            f"{sps2/1e6:.2f} Msps achieved ({sps2/pll_samprate:.2f}x realtime), "
            f"{pll_channels * sps2 / 1e6:.0f} ch*Msps, "
            f"round-trip p50 {p50b:.2f} ms / p99 {p99b:.2f} ms",
            file=sys.stderr,
        )


if __name__ == "__main__":
    main()
