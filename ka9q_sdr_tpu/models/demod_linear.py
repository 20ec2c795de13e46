"""Linear demodulator — JAX equivalent of linear.c.

Handles USB/LSB/CW/IQ/ISB/coherent-AM/DSB/BPSK: everything except FM and
envelope AM.  Structure per block (linear.c:114-310):

1. Optional PLL carrier tracking (linear.c:129-246): an FFT acquisition
   search over ±300 Hz picks a coarse frequency offset when the loop is
   unlocked; a 2nd-order lag-lead loop (Gardner constants, critical
   damping) updates a fine NCO once per block from the block's mean phase;
   optional squaring regenerates the carrier of DSB/BPSK.  Lock detection
   is an SNR hysteresis counter.

   Memory redesign of the acquisition buffer: the C keeps a 64k-point
   full-rate ring (linear.c:43,131-153) — 512 MB of device memory at 1024
   channels.
   The search band is only ±300 Hz (±600 squared), so we decimate the
   (squared) baseband through a half-band cascade (the fm.c:201-228 PL
   trick) by `acq_decim` before ringing it: same 1.37 s window and the
   SAME 0.73 Hz bin size from a PLL_FFT_SIZE/acq_decim-point FFT — 32x
   less memory at the flagship geometry with bit-identical loop behavior
   once acquired.
2. Per-sample hang AGC on the instantaneous amplitude (linear.c:251-281),
   via the shared scan kernel.
3. Optional post-AGC frequency shift for CW offset (linear.c:283-289).
4. Mono output = I; stereo = (I, Q) (linear.c:291-300).

The coarse+fine NCO pair of the C (small-angle fine tweaks, linear.c:95-105)
maps to two OscStates whose block phasors multiply; the fine NCO is retuned
in-jit with set_osc_traced.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.agc import AGCParams, AGCState, agc_init, agc_block
from ..ops.decimate import cascade_init, hb_cascade
from ..ops.nco import (
    OscState,
    osc_init,
    set_osc,
    set_osc_traced,
    osc_block,
)

__all__ = ["LinearConfig", "LinearState", "linear_init", "linear_demod"]

#: Carrier search FFT size: 64k = 1.37 s @ 48 kHz (linear.c:43).
PLL_FFT_SIZE = 1 << 16
#: Loop lock threshold, dB SNR (linear.c:42).
SNR_THRESH_DB = 3.0
#: FFT search range, Hz (linear.c:53-54).
SEARCH_HIGH = 300.0


class LinearConfig(NamedTuple):
    """Static configuration derived from a mode table row (modes.txt) and
    the output sample rate."""

    samptime: float       # seconds per decimated sample (linear.c:29)
    blocktime: float      # seconds per block — the TRUE block duration.
    #                       linear.c:30 computes samptime * filter.L with
    #                       the MASTER (input-rate) L, i.e. decimate x the
    #                       block duration, tying the PLL integral gain to
    #                       the decimation ratio (x4 at the C's only real
    #                       geometry, x512 at bank geometry, where it
    #                       would destabilize the loop).  Deliberate
    #                       divergence, PARITY.md #15.
    agc: AGCParams
    pll: bool = False
    square: bool = False
    channels: int = 2     # 1 = mono (I only), 2 = stereo (I,Q)
    shift_freq: float = 0.0   # post-AGC shift, cycles/sample (CW offset)
    loop_bw: float = 1.0      # PLL natural frequency, Hz (linear.c:26)
    lock_time: float = 1.0    # lock hysteresis, seconds (linear.c:45)
    acq_decim: int = 1        # acquisition-ring decimation (power of 2)

    @classmethod
    def make(
        cls,
        dsamprate: float,
        block_len: int,
        headroom_db: float = -15.0,
        recovery_rate_db_s: float = 6.0,
        hangtime_s: float = 1.1,
        **kw,
    ) -> "LinearConfig":
        samptime = 1.0 / dsamprate
        if kw.get("pll", False) and "acq_decim" not in kw:
            # Largest power-of-2 decimation that (a) divides the block,
            # (b) keeps the (squared) search band within 40% of the
            # decimated Nyquist (half-band transition-band margin), and
            # (c) caps the ring at a sane minimum size.
            search_max = (2.0 if kw.get("square", False) else 1.0) * SEARCH_HIGH
            d = 1
            # decimated rate >= 5x the search band keeps the search window
            # within 40% of the decimated Nyquist
            while (
                d * 2 <= 64
                and block_len % (d * 2) == 0
                and dsamprate / (d * 2) >= 5.0 * search_max
            ):
                d *= 2
            kw["acq_decim"] = d
        return cls(
            samptime=samptime,
            blocktime=samptime * block_len,
            agc=AGCParams.from_mode(
                headroom_db, recovery_rate_db_s, hangtime_s, samptime
            ),
            **kw,
        )

    # 2nd-order lag-lead loop constants (linear.c:59-65)
    @property
    def integrator_gain(self) -> float:
        natfreq = self.loop_bw * 2.0 * np.pi
        tau1 = 2.0 * np.pi / (natfreq * natfreq)  # vcogain*pdgain/natfreq^2
        return 1.0 / tau1

    @property
    def prop_gain(self) -> float:
        natfreq = self.loop_bw * 2.0 * np.pi
        tau1 = 2.0 * np.pi / (natfreq * natfreq)
        tau2 = 2.0 * (1.0 / np.sqrt(2.0)) / natfreq  # critical damping
        return tau2 / tau1

    @property
    def lock_limit(self) -> int:
        return round(self.lock_time / self.samptime)

    @property
    def binsize(self) -> float:
        # Unchanged by acq_decim: ring covers the same 1.37 s window
        # (rate/acq_decim over PLL_FFT_SIZE/acq_decim points).
        return 1.0 / (PLL_FFT_SIZE * self.samptime)

    @property
    def ring_size(self) -> int:
        return PLL_FFT_SIZE // self.acq_decim

    @property
    def search_bins(self) -> int:
        mult = 2 if self.square else 1
        return round(mult * SEARCH_HIGH / self.binsize)


class LinearState(NamedTuple):
    agc: AGCState
    shift: OscState
    # PLL members (unused arrays stay tiny when pll is off)
    fine: OscState
    coarse: OscState
    integrator: jax.Array   # float32 (linear.c:107)
    delta_f: jax.Array      # float32, FFT-derived offset, Hz (linear.c:108)
    lock_count: jax.Array   # int32 (linear.c:110)
    pll_lock: jax.Array     # bool
    snr: jax.Array          # float32, previous block's PLL SNR — the C
    #                         keeps it unsmoothed too (linear.c:304-309);
    #                         the lock detector reads it next block
    fft_ring: Optional[jax.Array]   # (ring_size,) complex64, newest last,
    #                                 at the acq_decim-decimated rate
    fft_samples: jax.Array  # int32, decimated samples since last acq FFT
    foffset: jax.Array      # float32, smoothed frequency offset, Hz
    acq_hb: tuple = ()      # half-band cascade overlap states (complex)


def linear_init(cfg: LinearConfig, batch_shape=()) -> LinearState:
    if cfg.pll:
        # Guard configs built without LinearConfig.make: a bad acq_decim
        # silently breaks the ring-window math (_acquire wraps when the
        # search window outgrows the decimated ring).
        d = cfg.acq_decim
        if d < 1 or (d & (d - 1)):
            raise ValueError(f"acq_decim={d} must be a power of two")
        block_len = round(cfg.blocktime / cfg.samptime)
        if block_len % d:
            raise ValueError(
                f"acq_decim={d} does not divide block_len={block_len}"
            )
        if cfg.ring_size <= 2 * cfg.search_bins:
            raise ValueError(
                f"acq_decim={d}: ring_size={cfg.ring_size} cannot hold the "
                f"±{cfg.search_bins}-bin search window; decimate less"
            )
    shift = osc_init()
    if cfg.shift_freq != 0.0:
        shift = set_osc(shift, cfg.shift_freq)
    if batch_shape:
        shift = jax.tree_util.tree_map(
            lambda v: jnp.broadcast_to(v, batch_shape + v.shape), shift
        )
    fine = jax.tree_util.tree_map(
        lambda v: jnp.broadcast_to(v, batch_shape + v.shape), osc_init()
    )
    return LinearState(
        agc=agc_init(100.0, batch_shape),   # linear.c:39
        shift=shift,
        fine=fine,
        coarse=fine,
        integrator=jnp.zeros(batch_shape, jnp.float32),
        delta_f=jnp.zeros(batch_shape, jnp.float32),
        lock_count=jnp.zeros(batch_shape, jnp.int32),
        pll_lock=jnp.zeros(batch_shape, bool),
        snr=jnp.zeros(batch_shape, jnp.float32),
        fft_ring=(
            jnp.zeros(batch_shape + (cfg.ring_size,), jnp.complex64)
            if cfg.pll
            else None
        ),
        fft_samples=jnp.zeros(batch_shape, jnp.int32),
        foffset=jnp.full(batch_shape, jnp.nan, jnp.float32),
        acq_hb=(
            tuple(
                cascade_init(
                    int(np.log2(cfg.acq_decim)),
                    dtype=jnp.complex64,
                    batch_shape=batch_shape,
                )
            )
            if cfg.pll and cfg.acq_decim > 1
            else ()
        ),
    )


def _acquire(cfg: LinearConfig, ring: jax.Array) -> tuple[jax.Array, jax.Array]:
    """FFT carrier search (linear.c:178-200).  Returns (delta_f_hz, found).

    |FFT| is invariant under circular rotation, so the unaligned ring can be
    transformed directly (the C does the same with its circular buffer).
    """
    spec = jnp.fft.fft(ring, axis=-1)
    energy = jnp.real(spec) ** 2 + jnp.imag(spec) ** 2
    nb = cfg.search_bins
    # bins -nb..nb; negative bins wrap to the top of the spectrum
    idx = jnp.arange(-nb, nb + 1) % cfg.ring_size
    window = energy[..., idx]
    rel = jnp.argmax(window, axis=-1)
    maxbin = rel.astype(jnp.int32) - nb
    maxenergy = jnp.max(window, axis=-1)
    delta_f = cfg.binsize * maxbin.astype(jnp.float32)
    if cfg.square:
        delta_f = delta_f / 2.0   # squaring doubles frequency (linear.c:193)
    return delta_f, maxenergy > 0


def _pll_block(cfg: LinearConfig, state: LinearState, baseband: jax.Array):
    """Carrier tracking (linear.c:129-246).  Returns (state, mixed_baseband,
    cphase)."""
    n = baseband.shape[-1]

    # Acquisition buffer (linear.c:131-153), decimated by acq_decim
    # through a half-band cascade first (see module docstring): the
    # search band is tiny, so the ring runs at a fraction of the rate.
    feed = baseband * baseband if cfg.square else baseband
    acq_hb = state.acq_hb
    if cfg.acq_decim > 1:
        stages = int(np.log2(cfg.acq_decim))
        hb_states, feed = hb_cascade(list(acq_hb), feed, stages)
        feed = feed * jnp.complex64(0.5**stages)  # unity-DC-gain cascade
        acq_hb = tuple(hb_states)
    nd = feed.shape[-1]
    ring = jnp.concatenate([state.fft_ring[..., nd:], feed], axis=-1)
    fft_samples = jnp.minimum(state.fft_samples + nd, cfg.ring_size)

    # Lock detector with hysteresis (linear.c:154-170)
    lock_limit = cfg.lock_limit
    lock_count = jnp.where(
        state.snr < 10.0 ** (SNR_THRESH_DB / 10.0),
        state.lock_count - n,
        state.lock_count + n,
    )
    lock_count = jnp.clip(lock_count, -lock_limit, lock_limit)
    pll_lock = jnp.where(
        lock_count >= lock_limit,
        True,
        jnp.where(lock_count <= -lock_limit, False, state.pll_lock),
    )

    # Reacquisition (linear.c:173-201).  The search FFT is needed at most
    # 1 block in ring_size/(2n) and never once locked; gate the whole
    # (possibly batched) FFT behind a SCALAR any() cond so steady-state
    # locked banks skip it entirely.
    do_fft = (~pll_lock) & (fft_samples > cfg.ring_size // 2)

    def _run_acquire(r):
        acq_df, acq_found = _acquire(cfg, r)
        return (
            jnp.where(do_fft, acq_df, state.delta_f),
            do_fft & acq_found,
        )

    new_df, found = jax.lax.cond(
        jnp.any(do_fft),
        _run_acquire,
        lambda r: (state.delta_f, jnp.zeros_like(do_fft)),
        ring,
    )
    changed = found & (new_df != state.delta_f)
    delta_f = jnp.where(changed, new_df, state.delta_f)
    integrator = jnp.where(changed, 0.0, state.integrator)
    coarse = jax.tree_util.tree_map(
        lambda new, old: jnp.where(changed, new, old),
        set_osc_traced(state.coarse, -cfg.samptime * delta_f),
        state.coarse,
    )
    fft_samples = jnp.where(do_fft, 0, fft_samples)

    # Apply coarse+fine offsets; mean phase (linear.c:207-224)
    coarse, lo_c = osc_block(coarse, n)
    fine, lo_f = osc_block(state.fine, n)
    mixed = baseband * lo_c * lo_f
    ss = mixed * mixed if cfg.square else mixed
    accum = jnp.sum(ss, axis=-1)
    cphase = jnp.angle(accum)
    if cfg.square:
        cphase = cphase / 2.0

    # Lag-lead loop filter, once per block (linear.c:226-245)
    integrator = integrator + cphase * cfg.blocktime
    feedback = cfg.integrator_gain * integrator + cfg.prop_gain * cphase
    fine = set_osc_traced(fine, -feedback * cfg.samptime)

    foffset = jnp.where(
        jnp.isnan(state.foffset),
        feedback + delta_f,
        state.foffset + 0.001 * (feedback + delta_f - state.foffset),
    )

    new_state = state._replace(
        fine=fine,
        coarse=coarse,
        integrator=integrator,
        delta_f=delta_f,
        lock_count=lock_count,
        pll_lock=pll_lock,
        fft_ring=ring,
        fft_samples=fft_samples,
        foffset=foffset,
        acq_hb=acq_hb,
    )
    return new_state, mixed, cphase


def linear_demod(
    cfg: LinearConfig, state: LinearState, baseband: jax.Array
) -> tuple[LinearState, jax.Array, dict]:
    """One block (linear.c:114-310).

    baseband: (..., n) complex64 from the slave filter (COMPLEX or
    CROSS_CONJ per the mode's isb flag).  Returns (state, audio, diag);
    audio is (..., n) float32 for mono or (..., n, 2) float32 for stereo.
    """
    cphase = jnp.zeros(baseband.shape[:-1], jnp.float32)
    if cfg.pll:
        state, baseband, cphase = _pll_block(cfg, state, baseband)

    # Power split: signal on I, noise on Q (linear.c:251-258)
    rp = jnp.real(baseband) ** 2
    ip = jnp.imag(baseband) ** 2
    signal = jnp.sum(rp, axis=-1)
    noise = jnp.sum(ip, axis=-1)

    amplitude = jnp.sqrt(rp + ip)
    new_agc, gains = agc_block(state.agc, amplitude, cfg.agc)
    out = baseband * gains

    # Post-AGC frequency shift (linear.c:283-289).  Applied
    # unconditionally: at freq 0 the oscillator is exactly 1+0j (bit-exact
    # no-op) and a live set_shift (radio.c:304-316) can retune it at any
    # time without a recompile.
    shift, lo = osc_block(state.shift, baseband.shape[-1])
    out = out * lo

    n = baseband.shape[-1]
    bb_power = (signal + noise) / (2.0 * n)
    if cfg.pll:
        # noise == 0 is NAN in the C (linear.c:304-309); its lock
        # detector's `snr < thresh` is then false, drifting TOWARD lock.
        # +inf reproduces that branch direction for ideal (noiseless)
        # input without poisoning downstream arithmetic.
        snr = jnp.where(
            noise > 0,
            jnp.maximum(signal / jnp.maximum(noise, 1e-30) - 1.0, 0.0),
            jnp.inf,
        )
    else:
        snr = jnp.full(baseband.shape[:-1], jnp.nan, jnp.float32)

    new_state = state._replace(
        agc=new_agc,
        shift=shift,
        snr=snr if cfg.pll else state.snr,
    )

    if cfg.channels == 1:
        audio = jnp.real(out)
    else:
        audio = jnp.stack([jnp.real(out), jnp.imag(out)], axis=-1)

    diag = {
        "bb_power": bb_power,
        "snr": snr,
        "cphase": cphase,
        "foffset": new_state.foffset,
        "pll_lock": new_state.pll_lock,
        "gain": new_agc.gain,
    }
    return new_state, audio, diag
