"""Bring-up smoke test: the channel bank's main path on a CUDA card.

One process drives the path a user runs, through the daemon's own entry
point (`ka9q_sdr_tpu.apps.bankd.main`), at deployment size:

  a. device: JAX must report a GPU (no CPU fallback); prints the card's
     name and power limit from nvidia-smi beside the JAX device.
  b. ops on the path at full block widths against plain references: the
     forward fill (FM threshold extension) at the 148 ms flagship block
     (8192, 7104) and the 20 ms serving block (4096, 960), exactly equal
     to a numpy loop; the complex master FFT at N = 2^24, 2^25, 2^26
     through master_execute's rule, against a float64 numpy FFT, with
     cuFFT's monolithic transform and the four-step both timed.
  c. bankd on a seeded 393.216 Msps s16 recording: the mixed-mode
     MultiBank (FM 3072 + USB 512 + CAM 512, 20 ms blocks, 12 blocks)
     and the FM 8192-channel long-block flagship (4 blocks).  Prints
     compile seconds, steady seconds per block and the block step's
     compiled.memory_analysis(), and checks the PCM that comes out.
  d. parity on the card: each signal-carrying channel's bank PCM against
     the single-channel Receiver (models/receiver.py) at the same master
     geometry, within a stated bound per mode.

    python chip_smoke.py             # one card, phases a-d
    python chip_smoke.py --cards 4   # only: channel-sharded bank,
                                     # shard_fft bank and bankd --mesh 4,
                                     # each against the unsharded bank

Every number is printed with the card beside it; the last line of
standard output is one JSON object {"ok": true, "device": {...}}.  Any
failure raises, so the exit status is non-zero and no result is printed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

#: The deployment geometry: 393.216 Msps wideband I/Q, 48 kHz channels.
SAMPRATE = 393.216e6
#: Parity bounds: rms(bank - receiver) < bound * rms(receiver), after 4
#: settling blocks, both quantised to int16 exactly as bankd's PCM is.
#: USB is the linear path with no feedback at the block level, so the two
#: programs differ only by float ordering: the bound of
#: tests/test_golden_parity.py's bank-vs-receiver test.  FM's threshold
#: extension makes per-sample blanking decisions at a float threshold
#: (fm.c:128-144), and CAM's carrier PLL and hang AGC feed their own
#: output back (PARITY.md #9), so an ulp of difference can flip a
#: decision or be amplified by the loop; those get 1e-3 (-60 dB), the
#: bound the golden-parity suite holds the noisy-FM case to.
PARITY_BOUND = {"USB": 1e-4, "FM": 1e-3, "CAM": 1e-3}


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_ms(fn, *args, iters: int = 10) -> float:
    """Median wall time of `iters` calls after two warm-up calls, each
    ended by block_until_ready."""
    import jax

    for _ in range(2):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


# ---------------------------------------------------------------- a. device

def device_phase(cards: int) -> dict:
    import jax

    from ka9q_sdr_tpu.utils.runtime import require_gpu

    dev = require_gpu()
    if dev["count"] < cards:
        raise RuntimeError(f"need {cards} cards, JAX has {dev['count']}")
    log(f"device: {dev['platform']} {dev['kind']} x{dev['count']}, "
        f"jax {jax.__version__}, XLA_FLAGS={os.environ.get('XLA_FLAGS')!r}")
    log(f"card: {dev['card']}")
    return dev


# ------------------------------------------------------------ b. ops

def fill_reference(values: np.ndarray, mask: np.ndarray,
                   init: np.ndarray) -> np.ndarray:
    """The recurrence as the C loop runs it (fm.c:128-144): walk the time
    axis, keeping the last value whose gate was true."""
    out = np.empty_like(values)
    cur = np.array(np.broadcast_to(init, values.shape[:-1]), values.dtype)
    for n in range(values.shape[-1]):
        cur = np.where(mask[..., n], values[..., n], cur)
        out[..., n] = cur
    return out


def fill_phase(B: int, T: int, seed: int = 0, iters: int = 10) -> dict:
    """FM's pair of fills (one complex, one real, one shared gate) at
    (B, T): exact equality with the loop, and the time of one call."""
    import jax
    import jax.numpy as jnp

    from ka9q_sdr_tpu.ops.ffill import forward_fill_multi

    rng = np.random.default_rng(seed)
    vc = (rng.standard_normal((B, T))
          + 1j * rng.standard_normal((B, T))).astype(np.complex64)
    vr = rng.standard_normal((B, T)).astype(np.float32)
    mask = rng.random((B, T)) < 0.7
    mask[: max(1, B // 64)] = False            # rows with no strong sample
    ic = (rng.standard_normal(B) + 1j * rng.standard_normal(B)
          ).astype(np.complex64)
    ir = rng.standard_normal(B).astype(np.float32)
    fn = jax.jit(lambda a, b, m, i, j: forward_fill_multi((a, b), m, (i, j)))
    args = [jnp.asarray(x) for x in (vc, vr, mask, ic, ir)]
    ms = timed_ms(fn, *args, iters=iters)
    got_c, got_r = (np.asarray(x) for x in fn(*args))
    exact = (np.array_equal(got_c, fill_reference(vc, mask, ic))
             and np.array_equal(got_r, fill_reference(vr, mask, ir)))
    if not exact:
        raise AssertionError(f"forward fill ({B}, {T}) differs from the loop")
    return {"shape": [B, T], "exact": exact, "ms": ms}


def fft_phase(log2n: int, seed: int = 0, iters: int = 10) -> dict:
    """The master FFT through master_execute's rule against a float64
    numpy FFT (bound 2e-5 of max|X|, tests/test_fftfilt.py), with the
    monolithic and four-step forms both timed."""
    import jax
    import jax.numpy as jnp

    from ka9q_sdr_tpu.ops.fftfilt import (
        FOURSTEP_MIN, FilterType, MasterSpec, fft_fourstep, master_execute,
    )

    N = 1 << log2n
    M = N // 8 + 1
    spec = MasterSpec(N - M + 1, M, FilterType.COMPLEX)
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal(N) + 1j * rng.standard_normal(N)
         ).astype(np.complex64)
    zd = jnp.asarray(z)
    rule = jax.jit(lambda a: master_execute(spec, a[: M - 1], a[M - 1:])[1])
    ref = np.fft.fft(z.astype(np.complex128))
    err = float(np.max(np.abs(np.asarray(rule(zd)) - ref))
                / np.max(np.abs(ref)))
    del ref
    if not err < 2e-5:
        raise AssertionError(f"master FFT 2^{log2n}: rel err {err:.2e}")
    mono = jax.jit(lambda a: jnp.fft.fft(a))
    out = {"log2n": log2n, "rel_err": err,
           "rule": "fourstep" if N >= FOURSTEP_MIN else "monolithic",
           "monolithic_ms": timed_ms(mono, zd, iters=iters),
           "fourstep_ms": timed_ms(jax.jit(fft_fourstep), zd, iters=iters)}
    return out


# --------------------------------------------------- c. recording + bankd

def channel_plan(samprate: float, n_fm: int, n_usb: int, n_cam: int,
                 block_ms: float = 20.0) -> dict:
    """The mixed-mode channel plan and where the test signals sit.

    The flagship run spreads 2*(n_fm+n_usb+n_cam) channels evenly, as
    `bankd --channels` does; mixed channel j sits on the master bin
    nearest flagship channel 2j, so every mixed channel is on an exact
    bin of the 20 ms master (and of the longer flagship master) and each
    test signal also lands within half a bin of a flagship channel."""
    from ka9q_sdr_tpu.apps.bankd import derive_geometry

    L, M = derive_geometry(samprate, block_ms)
    N = L + M - 1
    n_all = n_fm + n_usb + n_cam
    usable = 0.9 * samprate
    flag = np.linspace(-usable / 2, usable / 2, 2 * n_all, endpoint=False)
    bins = np.round(flag[::2] * N / samprate).astype(np.int64)
    modes = ["FM"] * n_fm + ["USB"] * n_usb + ["CAM"] * n_cam
    u0, c0 = n_fm, n_fm + n_usb
    signal_ch = {"FM": [n_fm // 7, n_fm // 2 + 3],
                 "USB": [u0 + n_usb // 5, u0 + n_usb // 2 + 1],
                 "CAM": [c0 + n_cam // 3, c0 + n_cam - 2]}
    return {"samprate": samprate, "L": L, "M": M, "N": N, "bins": bins,
            "freqs": bins * samprate / N, "modes": modes,
            "signal_ch": signal_ch, "counts": (n_fm, n_usb, n_cam)}


def write_channel_file(path: str, plan: dict) -> None:
    """One 'frequency mode' line per channel, the frequency in the
    unambiguous kHz form (12k345; bare small numbers are read as MHz)."""
    with open(path, "w") as f:
        for freq, mode in zip(plan["freqs"], plan["modes"]):
            f.write(repr(float(freq) / 1e3).replace(".", "k") + f" {mode}\n")


def make_recording(path: str, plan: dict, n_samples: int, seed: int = 1,
                   amplitude: float = 0.05, noise: float = 0.002,
                   chunk: int = 1 << 22) -> None:
    """Write a seeded interleaved s16 I/Q recording, synthesised on the
    default device in chunks: Gaussian noise plus, on each signal
    channel, an FM carrier (1 kHz tone, 5 kHz deviation), a USB tone
    (+1 kHz above the dial) or an AM carrier (400 Hz, 50 % depth).
    Every phase is an exact integer fraction (carrier on a master bin,
    audio periods a whole number of samples), so the recording is the
    same at any length."""
    import jax
    import jax.numpy as jnp

    fs, N = plan["samprate"], plan["N"]
    if N & (N - 1):
        raise ValueError(f"master N={N} is not a power of two")
    periods = []
    for f_audio in (1000.0, 400.0):
        p = fs / f_audio
        if p != int(p):
            raise ValueError(f"{f_audio} Hz is not a whole period at {fs}")
        periods.append(int(p))
    p1k, p400 = periods
    sigs = []
    for mode, chans in plan["signal_ch"].items():
        for ch in chans:
            sigs.append((mode, int(plan["bins"][ch] % N)))
    key = jax.random.PRNGKey(seed)

    @jax.jit
    def synth(n0, idx):
        n = n0 + jnp.arange(chunk, dtype=jnp.int32)
        nu = n.astype(jnp.uint32)
        two_pi = jnp.float32(2 * np.pi)
        a1k = (n % p1k).astype(jnp.float32) / p1k
        a400 = (n % p400).astype(jnp.float32) / p400
        z = noise * jax.lax.complex(
            *jax.random.normal(jax.random.fold_in(key, idx), (2, chunk)))
        for mode, k in sigs:
            # k*n mod N in uint32: exact because N divides 2^32
            car = ((nu * jnp.uint32(k)) & jnp.uint32(N - 1)
                   ).astype(jnp.float32) / N
            if mode == "FM":
                ph = two_pi * car + 5.0 * jnp.sin(two_pi * a1k)
                z = z + amplitude * jnp.exp(1j * ph)
            elif mode == "USB":
                ph = two_pi * jnp.mod(car + a1k, 1.0)
                z = z + amplitude * jnp.exp(1j * ph)
            else:
                env = 1.0 + 0.5 * jnp.sin(two_pi * a400)
                z = z + amplitude * env * jnp.exp(1j * two_pi * car)
        iq = jnp.stack([jnp.real(z), jnp.imag(z)], axis=-1) * 32767.0
        return jnp.clip(jnp.round(iq), -32768, 32767).astype(jnp.int16)

    with open(path, "wb") as f:
        for i, n0 in enumerate(range(0, n_samples, chunk)):
            blk = np.asarray(synth(jnp.int32(n0), i))
            f.write(blk[: min(chunk, n_samples - n0)].tobytes())


class _Tee(io.TextIOBase):
    """Pass writes through to a stream while keeping a copy."""

    def __init__(self, stream):
        self.stream, self.buf = stream, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.stream.write(s)

    def flush(self):
        self.stream.flush()


def run_bankd(argv: list[str]) -> dict:
    """bankd.main(argv) in this process; returns its run summary."""
    from ka9q_sdr_tpu.apps import bankd

    tee = _Tee(sys.stderr)
    with contextlib.redirect_stderr(tee):
        rc = bankd.main(argv)
    if rc != 0:
        raise RuntimeError(f"bankd {' '.join(argv)} exited {rc}")
    tag = "bankd: run summary "
    lines = [ln for ln in tee.buf.getvalue().splitlines()
             if ln.startswith(tag)]
    if not lines:
        raise RuntimeError("bankd printed no run summary")
    return json.loads(lines[-1][len(tag):])


def _mode_width(mode: str) -> int:
    """Interleaved PCM channels bankd writes per sample for a mode."""
    from ka9q_sdr_tpu.utils.modes import DEFAULT_MODES

    m = DEFAULT_MODES[mode]
    return m.channels if m.demod == "LINEAR" else 1


def read_mixed_pcm(path: str, plan: dict, blocks: int) -> dict:
    """bankd's --pcm-raw of the mixed run, split per group:
    {mode: (blocks, channels, L_dec[, width]) int16}."""
    L_dec = plan["L"] // round(plan["samprate"] / 48000)
    raw = np.fromfile(path, "<i2")
    groups = list(zip(("FM", "USB", "CAM"), plan["counts"]))
    per_block = sum(n * L_dec * _mode_width(m) for m, n in groups)
    if raw.size != blocks * per_block:
        raise AssertionError(
            f"mixed PCM has {raw.size} samples, expected {blocks * per_block}")
    raw = raw.reshape(blocks, per_block)
    out, at = {}, 0
    for mode, n in groups:
        w = _mode_width(mode)
        seg = raw[:, at:at + n * L_dec * w]
        shape = (blocks, n, L_dec) + ((w,) if w > 1 else ())
        out[mode] = seg.reshape(shape)
        at += n * L_dec * w
    return out


def tone_bin_error(x: np.ndarray, f_hz: float, rate: float = 48000.0) -> float:
    """Distance in bins between the strongest spectral line of x and
    f_hz."""
    x = x.astype(np.float64).ravel()
    spec = np.abs(np.fft.rfft(x - x.mean()))
    return abs(int(np.argmax(spec)) - f_hz * len(x) / rate)


def mixed_phase(tmp: str, plan: dict, rec: str, blocks: int) -> dict:
    chans = os.path.join(tmp, "channels.txt")
    pcm = os.path.join(tmp, "mixed.pcm")
    write_channel_file(chans, plan)
    summary = run_bankd([
        "--iq-file", rec, "-r", str(int(plan["samprate"])),
        "--channel-file", chans, "--block-ms", "20",
        "--blocks", str(blocks), "--pcm-raw", pcm])
    if summary["blocks"] != blocks:
        raise AssertionError(f"mixed run did {summary['blocks']} blocks")
    pcm_g = read_mixed_pcm(pcm, plan, blocks)
    expect = {"FM": 1000.0, "USB": 1000.0, "CAM": 400.0}
    n_fm, n_usb, _ = plan["counts"]
    offset = {"FM": 0, "USB": n_fm, "CAM": n_fm + n_usb}
    for mode, chs in plan["signal_ch"].items():
        for ch in chs:
            a = pcm_g[mode][2:, ch - offset[mode]]
            if a.ndim > 2:
                a = a[..., 0]
            err = tone_bin_error(a, expect[mode])
            if not (np.abs(a).max() > 300 and err <= 2):
                raise AssertionError(
                    f"{mode} channel {ch}: no {expect[mode]:.0f} Hz tone "
                    f"(peak {np.abs(a).max()}, bin error {err:.1f})")
    return {"summary": summary, "pcm": pcm_g}


def flagship_phase(tmp: str, plan: dict, rec: str, blocks: int) -> dict:
    """FM over 2*(mixed channels) evenly spread channels, long blocks;
    the FM test signals sit within half a bin of flagship channels."""
    from ka9q_sdr_tpu.apps.bankd import derive_geometry

    L, M = derive_geometry(plan["samprate"], 148.0)
    n_ch = 2 * len(plan["modes"])
    pcm = os.path.join(tmp, "flagship.pcm")
    summary = run_bankd([
        "--iq-file", rec, "-r", str(int(plan["samprate"])),
        "--channels", str(n_ch), "-m", "FM", "--L", str(L), "--M", str(M),
        "--blocks", str(blocks), "--pcm-raw", pcm])
    if summary["blocks"] != blocks:
        raise AssertionError(f"flagship run did {summary['blocks']} blocks")
    L_dec = L // round(plan["samprate"] / 48000)
    raw = np.fromfile(pcm, "<i2")
    if raw.size != blocks * n_ch * L_dec:
        raise AssertionError(f"flagship PCM has {raw.size} samples")
    raw = raw.reshape(blocks, n_ch, L_dec)
    for ch in plan["signal_ch"]["FM"]:
        a = raw[1:, 2 * ch]
        err = tone_bin_error(a, 1000.0)
        if not (np.abs(a).max() > 300 and err <= 2):
            raise AssertionError(
                f"flagship channel {2 * ch}: no 1 kHz tone "
                f"(peak {np.abs(a).max()}, bin error {err:.1f})")
    return {"summary": summary, "L": L, "M": M, "channels": n_ch}


def device_step_phase(plan: dict, rec: str, iters: int = 10) -> dict:
    """The bank's block step alone, input already on the device, for the
    two bankd shapes: how much of bankd's block time the card takes.
    Mixed: MultiBank's step on packed float32; flagship: ChannelBank's
    int16-in, PCM-out step (the network path's)."""
    import jax

    from ka9q_sdr_tpu.apps.bankd import derive_geometry
    from ka9q_sdr_tpu.models.bank import (
        ChannelBank, MultiBank, make_bank_config,
    )

    fs = plan["samprate"]
    out = {}
    groups = [(m, [float(f) for f, mm in zip(plan["freqs"], plan["modes"])
                   if mm == m]) for m in ("FM", "USB", "CAM")]
    mb = MultiBank(groups, samprate=fs, L=plan["L"], M=plan["M"])
    x = np.fromfile(rec, "<i2", count=2 * plan["L"]).reshape(-1, 2)
    xr = jax.device_put(x.astype(np.float32) / 32767)
    states = mb.states

    def mixed_step():
        nonlocal states
        states, outs = mb._step(states, xr)
        return outs

    out["mixed_ms"] = timed_ms(mixed_step, iters=iters)
    del mb, states, xr
    L, M = derive_geometry(fs, 148.0)
    n_ch = 2 * len(plan["modes"])
    usable = 0.9 * fs
    bank = ChannelBank(make_bank_config(n_ch, "FM", samprate=fs, L=L, M=M),
                       list(np.linspace(-usable / 2, usable / 2, n_ch,
                                        endpoint=False)))
    xi = jax.device_put(np.fromfile(rec, "<i2", count=2 * L).reshape(-1, 2))
    out["flagship_ms"] = timed_ms(lambda: bank.process_i16_pcm(xi)[0],
                                  iters=iters)
    return out


# ------------------------------------------------------------- d. parity

def parity_phase(plan: dict, rec: str, pcm_g: dict, blocks: int,
                 settle: int = 4) -> dict:
    """Each signal channel's bank PCM against models/receiver.py's
    Receiver at the same master geometry (the faithful time-domain LO2
    path; identical math when the channel sits on a master bin)."""
    from ka9q_sdr_tpu.io.iqfile import IQReader
    from ka9q_sdr_tpu.models.receiver import Receiver, make_receiver_config

    L, M, fs = plan["L"], plan["M"], plan["samprate"]
    iq = [b for _, b in zip(range(blocks), IQReader(rec).blocks(L))]
    n_fm, n_usb, _ = plan["counts"]
    offset = {"FM": 0, "USB": n_fm, "CAM": n_fm + n_usb}
    out = {}
    for mode, chs in plan["signal_ch"].items():
        worst = 0.0
        for ch in chs:
            f = float(plan["freqs"][ch])
            rx = Receiver(make_receiver_config(
                mode, samprate=int(fs), out_rate=48000, L=L, M=M,
                enable_pl=False))
            rx.set_freq(f)
            if rx.second_lo != -f:
                raise AssertionError(f"receiver LO2 {rx.second_lo} != {-f}")
            single = np.stack([np.asarray(rx.process(b)[0]) for b in iq])
            single = np.clip(single * 32767, -32768, 32767).astype(np.int16)
            bank = pcm_g[mode][:, ch - offset[mode]]
            a = bank[settle:].astype(np.float64) / 32767
            g = single[settle:].astype(np.float64) / 32767
            if a.shape != g.shape:
                raise AssertionError(f"{mode} shapes {a.shape} {g.shape}")
            err = float(np.sqrt(np.mean((a - g) ** 2)))
            sig = float(np.sqrt(np.mean(g ** 2)))
            ratio = err / max(sig, 1e-12)
            log(f"parity {mode} ch {ch} ({f:.1f} Hz): rms err {err:.3e}, "
                f"signal rms {sig:.3e}, ratio {ratio:.3e} "
                f"(bound {PARITY_BOUND[mode]:.0e})")
            if not (sig > 1e-3 and ratio < PARITY_BOUND[mode]):
                raise AssertionError(
                    f"{mode} channel {ch}: bank vs receiver ratio "
                    f"{ratio:.3e} (signal rms {sig:.3e})")
            worst = max(worst, ratio)
        out[mode] = worst
    return out


# ---------------------------------------------------------- --cards 4

def make_fm_comb(path: str, samprate: float, n_ch: int, N: int,
                 n_samples: int, seed: int = 3, beta: float = 2.0,
                 tone_bins: int = 43) -> None:
    """s16 recording with an FM carrier on the bin nearest each of n_ch
    evenly spread channels (bankd --channels), each modulated by a tone
    of `tone_bins` master bins (~1 kHz) at index beta.  Built as one
    inverse FFT of the Bessel-line spectrum: every line is on a bin of
    N, so one period of N samples tiles the whole recording."""
    import jax.numpy as jnp
    from scipy.special import jv

    usable = 0.9 * samprate
    freqs = np.linspace(-usable / 2, usable / 2, n_ch, endpoint=False)
    k = np.round(freqs * N / samprate).astype(np.int64)
    rng = np.random.default_rng(seed)
    ph = rng.uniform(0, 2 * np.pi, (2, n_ch))
    js = np.arange(-7, 8)
    amp = 0.15 / np.sqrt(n_ch)
    lines = (k[:, None] + js[None, :] * tone_bins) % N
    vals = (amp * jv(js, beta)[None, :]
            * np.exp(1j * (ph[0][:, None] + js[None, :] * ph[1][:, None])))
    spec = jnp.zeros(N, jnp.complex64).at[lines.ravel()].add(
        vals.ravel().astype(np.complex64))
    period = jnp.fft.ifft(spec) * N
    iq = jnp.stack([jnp.real(period), jnp.imag(period)], -1) * 32767.0
    one = np.asarray(jnp.clip(jnp.round(iq), -32768, 32767)
                     .astype(jnp.int16))
    with open(path, "wb") as f:
        for n0 in range(0, n_samples, N):
            f.write(one[: min(N, n_samples - n0)].tobytes())


def multicard_phase(tmp: str, n_dev: int, n_ch: int, samprate: float,
                    L: int, M: int, blocks: int = 3) -> dict:
    """The channel-sharded bank, the shard_fft bank and bankd --mesh,
    each against the unsharded bank on device 0, with the bounds of
    __graft_entry__.dryrun_multichip."""
    import __graft_entry__ as ge
    from ka9q_sdr_tpu.io.iqfile import IQReader

    rec = os.path.join(tmp, "comb.iq")
    make_fm_comb(rec, samprate, n_ch, L + M - 1, (blocks + 1) * L)
    sig = np.concatenate(
        [b for _, b in zip(range(blocks), IQReader(rec).blocks(L))])
    out = {}
    for shard_fft, atol, label in ((False, 1e-5, "FM"),
                                   (True, 3e-5, "shard_fft")):
        t0 = time.perf_counter()
        err = ge._check_sharded(n_dev, n_ch, "FM", samprate, L, M, blocks,
                                shard_fft=shard_fft, atol=atol, label=label,
                                sig=sig)
        out[label] = {"max_err": err, "atol": atol,
                      "seconds": time.perf_counter() - t0}
    pcms = {}
    for tag, extra in (("mesh", ["--mesh", str(n_dev)]), ("flat", [])):
        pcm = os.path.join(tmp, f"{tag}.pcm")
        run_bankd(["--iq-file", rec, "-r", str(int(samprate)),
                   "--channels", str(n_ch), "-m", "FM", "--L", str(L),
                   "--M", str(M), "--blocks", str(blocks + 1),
                   "--pcm-raw", pcm] + extra)
        pcms[tag] = np.fromfile(pcm, "<i2").astype(np.int32)
    pa, pb = pcms["mesh"], pcms["flat"]
    if not (pa.size > 0 and pa.shape == pb.shape):
        raise AssertionError(f"bankd --mesh PCM {pa.shape} vs {pb.shape}")
    max_lsb = int(np.abs(pa - pb).max())
    err = (pa - pb) / 32767.0
    rms_dbfs = 10 * np.log10(np.mean(err.astype(np.float64) ** 2) + 1e-30)
    if not (max_lsb <= 8 and rms_dbfs < -85.0):
        raise AssertionError(f"bankd --mesh {n_dev}: {max_lsb} LSB, "
                             f"rms {rms_dbfs:.1f} dBFS")
    if not np.abs(pb).max() > 300:
        raise AssertionError("bankd comb PCM is silent")
    out["bankd_mesh"] = {"max_lsb": max_lsb, "rms_dbfs": rms_dbfs}
    return out


# ------------------------------------------------------------------ main

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cards", type=int, default=1, choices=(1, 4),
                   help="4: run only the multi-card path and its reference")
    args = p.parse_args(argv)

    from ka9q_sdr_tpu.apps.bankd import derive_geometry
    from ka9q_sdr_tpu.utils.runtime import configure_jax

    configure_jax()
    dev = device_phase(args.cards)
    card = dev["card"]

    with tempfile.TemporaryDirectory() as tmp:
        if args.cards == 4:
            L, M = derive_geometry(SAMPRATE, 20.0)
            res = multicard_phase(tmp, 4, 8192, SAMPRATE, L, M)
            for label, r in res.items():
                log(f"[{card}] 4-card {label}: {json.dumps(r)}")
        else:
            for B, T in ((8192, 7104), (4096, 960)):
                r = fill_phase(B, T)
                log(f"[{card}] fill ({B}, {T}) complex+real: exact "
                    f"{r['exact']}, {r['ms']:.3f} ms")
            for log2n in (24, 25, 26):
                r = fft_phase(log2n)
                log(f"[{card}] master FFT 2^{log2n}: rule {r['rule']}, "
                    f"rel err {r['rel_err']:.2e}; monolithic "
                    f"{r['monolithic_ms']:.3f} ms, four-step "
                    f"{r['fourstep_ms']:.3f} ms")

            plan = channel_plan(SAMPRATE, 3072, 512, 512)
            rec = os.path.join(tmp, "wide.iq")
            t0 = time.perf_counter()
            make_recording(rec, plan, 4 * derive_geometry(SAMPRATE, 148.0)[0])
            log(f"[{card}] recording: {os.path.getsize(rec) / 1e6:.0f} MB "
                f"s16 at {SAMPRATE / 1e6:.3f} Msps in "
                f"{time.perf_counter() - t0:.1f} s")
            mixed = mixed_phase(tmp, plan, rec, 12)
            log(f"[{card}] bankd MultiBank FM 3072 + USB 512 + CAM 512, "
                f"20 ms: {json.dumps(mixed['summary'])}")
            flag = flagship_phase(tmp, plan, rec, 4)
            log(f"[{card}] bankd FM {flag['channels']} ch L={flag['L']} "
                f"M={flag['M']}: {json.dumps(flag['summary'])}")
            step = device_step_phase(plan, rec)
            log(f"[{card}] device step alone (input on the card): mixed "
                f"{step['mixed_ms']:.3f} ms per 20 ms block, FM "
                f"{flag['channels']} ch {step['flagship_ms']:.3f} ms per "
                f"148 ms block")
            par = parity_phase(plan, rec, mixed["pcm"], 12)
            log(f"[{card}] parity bank vs receiver (worst ratio per mode): "
                f"{json.dumps(par)}")

    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
