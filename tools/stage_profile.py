"""Per-stage profile of the FM bank block at a given channel width.

Cumulative-prefix ablation: each prefix of the block step is compiled as
its own program and timed, and a stage's cost is the difference between
consecutive prefixes, so a width's budget is measured, not extrapolated.

Stages (cumulative prefixes of bank_step, models/bank.py:685-708):
  master      i16 ingest + gain + master FFT (ops/fftfilt master_execute)
  chan        + bank_recenter + bank_channelize (gather/tables/IFFT/NCO)
  full        + FM demod incl. PL chain (models/demod_fm.py, fm.c:72-277)

Isolated components inside the demod delta:
  fills       the two forward-fills at (B, L_dec) (fm.c:118-144 parallel
              form, ops/ffill)
  pl_ring     the PL ring shift-concat at (B, PL_FFT_SIZE) (fm.c:243-249)
  pl_fft      one PL rFFT + peak-pick at (B, PL_FFT_SIZE) (fm.c:251-277);
              amortised cost = pl_fft * (blocks it fires on), printed too

Measurement rules:
  - each call ends in block_until_ready; a stage's time is the median
    of --iters calls after --warmup calls.
  - every program is state-threaded (the carry feeds the next call) and
    ends in a full reduction of the stage's big intermediate, so XLA can
    not dead-code the stage.
  - inputs stay device-resident, so the times exclude host transfers.
  - the derived rows are differences of the rounded prefix times, so the
    printed table is self-consistent.

Usage:
  python tools/stage_profile.py --channels 8192 [--iters 10] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=7168)
    ap.add_argument("--samprate", type=float, default=393.216e6)
    ap.add_argument("--L", type=int, default=58195968)
    ap.add_argument("--M", type=int, default=8912897)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="tiny-geometry smoke run on the CPU backend")
    ap.add_argument("--stages", default="master,chan,full,fills,pl")
    args = ap.parse_args()

    import jax

    from ka9q_sdr_tpu.utils.runtime import configure_jax

    configure_jax(cpu=args.cpu)
    if args.cpu:
        args.samprate, args.L, args.M = 1.536e6, 245760, 32769
        args.channels = min(args.channels, 16)

    import jax.numpy as jnp
    from ka9q_sdr_tpu.models.bank import (
        ChannelBank, make_bank_config, bank_recenter, bank_channelize,
    )
    from ka9q_sdr_tpu.models import demod_fm
    from ka9q_sdr_tpu.ops.fftfilt import master_execute
    from ka9q_sdr_tpu.ops.ffill import forward_fill_multi
    from ka9q_sdr_tpu.ops.packing import tree_c2r, tree_r2c, r2c

    B, L = args.channels, args.L
    cfg = make_bank_config(B, "FM", samprate=args.samprate, L=L, M=args.M,
                           enable_pl=True)
    L_dec = cfg.L_dec
    usable = 0.9 * args.samprate
    freqs = list(np.linspace(-usable / 2, usable / 2, B, endpoint=False))
    print(f"# building {B}-ch FM+PL bank, L={L} (L_dec={L_dec}, "
          f"N_dec={cfg.N_dec})...", file=sys.stderr, flush=True)
    bank = ChannelBank(cfg, freqs)
    template = bank._template

    rng = np.random.default_rng(1)
    tt = np.arange(L) / args.samprate
    x = 0.01 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
    for ch in (3, B // 2, B - 5):
        x += 0.2 * np.exp(2j * np.pi * freqs[ch] * tt)
    x_i = np.empty((L, 2), np.int16)
    x_i[:, 0] = np.clip(x.real * 32767, -32768, 32767)
    x_i[:, 1] = np.clip(x.imag * 32767, -32768, 32767)
    x_dev = jax.device_put(x_i)

    def timed(fn, st, iters, warmup):
        """Median seconds per call; fn: st -> (st, out), state-threaded."""
        for _ in range(warmup):
            st, out = fn(st)
        jax.block_until_ready((st, out))
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            st, out = fn(st)
            jax.block_until_ready((st, out))
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    # --- cumulative-prefix programs over the real bank state ------------
    def _ingest(state_r, x_i16):
        xx = x_i16.astype(jnp.float32) * jnp.float32(1.0 / 32767.0)
        state = tree_r2c(state_r, template)
        return state, r2c(xx) * state.gain_factor

    def master_only(state_r, x_i16):
        state, samp = _ingest(state_r, x_i16)
        overlap, fdomain = master_execute(cfg.master, state.overlap, samp)
        ns = state._replace(overlap=overlap)
        consumed = jnp.sum(jnp.real(fdomain) ** 2 + jnp.imag(fdomain) ** 2)
        return tree_c2r(ns), consumed

    def chan_only(state_r, x_i16):
        state, samp = _ingest(state_r, x_i16)
        overlap, fdomain = master_execute(cfg.master, state.overlap, samp)
        state = bank_recenter(cfg, state)
        new_r, new_nco, baseband = bank_channelize(cfg, state, fdomain)
        ns = state._replace(overlap=overlap, r=new_r, nco=new_nco)
        consumed = jnp.sum(jnp.real(baseband) ** 2 + jnp.imag(baseband) ** 2)
        return tree_c2r(ns), consumed

    stages = args.stages.split(",")
    res = {"channels": B, "L_dec": L_dec}

    if "master" in stages:
        jm = jax.jit(master_only)
        res["master_ms"] = timed(
            lambda st: jm(st, x_dev), bank.state, args.iters, args.warmup
        ) * 1e3
        print(f"# master: {res['master_ms']:.2f} ms", file=sys.stderr,
              flush=True)
    if "chan" in stages:
        jc = jax.jit(chan_only)
        res["chan_ms"] = timed(
            lambda st: jc(st, x_dev), bank.state, args.iters, args.warmup
        ) * 1e3
        print(f"# +channelize: {res['chan_ms']:.2f} ms", file=sys.stderr,
              flush=True)
    if "full" in stages:
        def full(st):
            ns, audio, _diag = bank._step_i16(st, x_dev)
            return ns, audio
        bank.process_i16(x_dev)   # builds _step_i16
        res["full_ms"] = timed(
            full, bank.state, args.iters, args.warmup
        ) * 1e3
        print(f"# full step: {res['full_ms']:.2f} ms", file=sys.stderr,
              flush=True)

    # --- isolated demod components --------------------------------------
    if "fills" in stages:
        # the two shared-mask fills of fm_demod (fm.c:118-144): complex
        # conj-product carry + real disc carry, ~all-strong mask (clean
        # carriers; the fill's cost is mask-independent)
        strong = jax.device_put(
            rng.random((B, L_dec)) < 0.95)
        vals_r = jax.device_put(
            rng.standard_normal((B, L_dec)).astype(np.float32))
        vals_c = jax.device_put(np.stack(
            [rng.standard_normal((B, L_dec)), rng.standard_normal((B, L_dec))],
            axis=-1).astype(np.float32))

        # vals/mask ride as ARGUMENTS: a closed-over device array is
        # embedded as an HLO constant, ~465 MB at 8192 ch
        @jax.jit
        def fills(carry, vals_c, vals_r, strong):
            cc, cr = carry
            vc = jax.lax.complex(vals_c[..., 0], vals_c[..., 1])
            ffc, ffr = forward_fill_multi(
                (vc, vals_r), strong,
                (jax.lax.complex(cc[..., 0], cc[..., 1]), cr),
            )
            ncc = jnp.stack(
                [jnp.real(ffc[..., -1]), jnp.imag(ffc[..., -1])], axis=-1)
            consumed = (jnp.sum(jnp.real(ffc) ** 2 + jnp.imag(ffc) ** 2)
                        + jnp.sum(ffr ** 2))
            return (ncc, ffr[..., -1]), consumed

        carry0 = (jnp.zeros((B, 2), jnp.float32), jnp.zeros((B,), jnp.float32))
        res["fills_ms"] = timed(
            lambda st: fills(st, vals_c, vals_r, strong),
            carry0, args.iters, args.warmup
        ) * 1e3
        print(f"# fills (2x forward-fill, shared mask): "
              f"{res['fills_ms']:.2f} ms", file=sys.stderr, flush=True)

    if "pl" in stages:
        pl_n = demod_fm.PL_FFT_SIZE
        k = max(1, L_dec // demod_fm.PL_DECIMATE)
        ring0 = jax.device_put(
            rng.standard_normal((B, pl_n)).astype(np.float32))
        newsamp = jax.device_put(
            rng.standard_normal((B, k)).astype(np.float32))

        @jax.jit
        def pl_ring(ring, newsamp):
            r2 = jnp.concatenate([ring[..., k:], newsamp], axis=-1)
            return r2, jnp.sum(r2[..., :2])

        res["pl_ring_ms"] = timed(
            lambda st: pl_ring(st, newsamp), ring0, args.iters,
            args.warmup) * 1e3

        @jax.jit
        def pl_fft(ring):
            # roll keeps the input iteration-dependent without changing
            # shape; its cost is ~the ring concat, subtracted below
            r2 = jnp.roll(ring, 1, axis=-1)
            spec = jnp.fft.rfft(r2, axis=-1)
            energy = jnp.real(spec) ** 2 + jnp.imag(spec) ** 2
            energy = energy[..., 1: pl_n // 2]
            peak = jnp.argmax(energy, axis=-1).astype(jnp.float32)
            return r2, jnp.sum(peak)

        t_fftroll = timed(pl_fft, ring0, args.iters, args.warmup) * 1e3
        res["pl_fft_ms"] = t_fftroll - res["pl_ring_ms"]
        fire_frac = min(1.0, k / demod_fm.PL_FFT_INTERVAL)
        res["pl_fft_amortised_ms"] = res["pl_fft_ms"] * fire_frac
        print(f"# PL ring concat: {res['pl_ring_ms']:.2f} ms; PL rFFT+pick: "
              f"{res['pl_fft_ms']:.2f} ms x fire-fraction {fire_frac:.2f} = "
              f"{res['pl_fft_amortised_ms']:.2f} ms/blk", file=sys.stderr,
              flush=True)

    # --- derived table ---------------------------------------------------
    res = {k: (round(v, 3) if isinstance(v, float) else v)
           for k, v in res.items()}
    if {"master_ms", "chan_ms", "full_ms"} <= res.keys():
        res["d_channelize_ms"] = res["chan_ms"] - res["master_ms"]
        res["d_demod_ms"] = res["full_ms"] - res["chan_ms"]
        rt = res["full_ms"] and (L / args.samprate * 1e3) / res["full_ms"]
        res["realtime_x"] = rt
        print(f"# TABLE ch={B}: master {res['master_ms']:.1f} | "
              f"channelize {res['d_channelize_ms']:.1f} | "
              f"demod {res['d_demod_ms']:.1f} | full {res['full_ms']:.1f} ms "
              f"({rt:.2f}x rt)", file=sys.stderr, flush=True)
    dev = jax.devices()[0]
    res["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                     "count": len(jax.devices())}
    print(json.dumps(res))


if __name__ == "__main__":
    main()
