"""FM demodulator — JAX equivalent of fm.c.

Pipeline per 20 ms block (fm.c:72-174):

1. SNR estimate from the amplitude's mean/variance (chi-squared trick,
   fm.c:91-103) driving a squelch with a one-block flush tail
   (fm.c:107-116).
2. Phase-difference discriminator ``carg(samp * conj(prev))`` with
   *threshold extension*: samples below 0.55x the average amplitude are
   blanked and replaced by the last good output (fm.c:118-144).  The C
   version is a per-sample data-dependent recurrence; here both the
   "previous strong sample" and the "last good output" are computed in
   parallel with masked forward-fills (ops.ffill) — no scan.
3. Post-detection audio chain: a REAL master filter at the output rate
   feeding a 300 Hz–6 kHz −6 dB/octave de-emphasis slave (fm.c:51-67), and
   optionally the PL-tone measurement slave (pltask, fm.c:189-285).

Diagnostics (frequency offset, peak deviation, PL tone frequency) follow
fm.c:145-153 and fm.c:251-277.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.fftfilt import (
    FilterType,
    MasterSpec,
    SlaveSpec,
    master_execute,
    slave_execute,
)
from ..ops.ffill import forward_fill
from ..ops.window import window_rfilter

__all__ = ["FMConfig", "FMState", "fm_init", "fm_demod"]

#: Squelch threshold, SNR as a power ratio (fm.c:108).
SNR_THRESH = 2.0
#: Threshold-extension blanking level relative to average amplitude (fm.c:121).
BLANK_RATIO = 0.55
#: PL slave decimation: 48 kHz -> 1.5 kHz (fm.c:201).
PL_DECIMATE = 32
#: PL analysis FFT size: (1<<19)/PL_DECIMATE = 16384 (fm.c:225).
PL_FFT_SIZE = (1 << 19) // PL_DECIMATE
#: Run the PL FFT every this many PL-rate samples (fm.c:251).
PL_FFT_INTERVAL = 512


class FMConfig(NamedTuple):
    """Static FM configuration.  Built once per (mode, rate) by `make`."""

    dsamprate: float            # decimated (output) sample rate, Hz
    gain: float                 # audio gain constant (fm.c:86)
    flat: bool                  # FLAT mode: skip de-emphasis (fm.c:55)
    audio_master: MasterSpec    # REAL master at the output rate (fm.c:43)
    audio_slave: Optional[SlaveSpec]
    audio_response: Optional[np.ndarray]  # de-emphasis response (fm.c:56-65)
    pl_slave: Optional[SlaveSpec]
    pl_response: Optional[np.ndarray]     # <300 Hz low-pass (fm.c:208-218)

    @classmethod
    def make(
        cls,
        dsamprate: float,
        low: float,
        high: float,
        L_dec: int,
        M_dec: int,
        headroom_db: float = -15.0,
        kaiser_beta: float = 3.0,
        flat: bool = False,
        enable_pl: bool = True,
    ) -> "FMConfig":
        """Derive the audio chain exactly as demod_fm does at startup.

        L_dec/M_dec are the predetection filter's L/decimate and
        (M-1)/decimate+1 (fm.c:39-40).
        """
        headroom = 10.0 ** (headroom_db / 20.0)
        gain = (headroom * (1.0 / np.pi) * dsamprate) / abs(low - high)
        am_spec = MasterSpec(L_dec, M_dec, FilterType.REAL)
        AN = am_spec.N
        audio_slave = audio_response = None
        if not flat:
            filter_gain = 10.0 / AN  # subjective volume bump (fm.c:42)
            j = np.arange(AN // 2 + 1)
            f = j * dsamprate / AN
            aresp = np.where(
                (f >= 300.0) & (f <= 6000.0),
                filter_gain * 300.0 / np.maximum(f, 1.0),
                0.0,
            ).astype(np.complex128)
            audio_response = window_rfilter(L_dec, M_dec, aresp, kaiser_beta).astype(
                np.complex64
            )
            audio_slave = SlaveSpec(am_spec, 1, FilterType.REAL)
        pl_slave = pl_response = None
        if enable_pl:
            PL_N = AN // PL_DECIMATE
            PL_L = L_dec // PL_DECIMATE
            PL_M = PL_N - PL_L + 1
            j = np.arange(PL_N // 2 + 1)
            f = j * dsamprate / AN  # relative to the input rate (fm.c:214)
            presp = np.where((f > 0) & (f < 300.0), 1.0, 0.0).astype(np.complex128)
            pl_response = window_rfilter(PL_L, PL_M, presp, 2.0).astype(np.complex64)
            pl_slave = SlaveSpec(am_spec, PL_DECIMATE, FilterType.REAL)
        return cls(
            dsamprate=float(dsamprate),
            gain=float(gain),
            flat=flat,
            audio_master=am_spec,
            audio_slave=audio_slave,
            audio_response=audio_response,
            pl_slave=pl_slave,
            pl_response=pl_response,
        )


class FMState(NamedTuple):
    disc_state: jax.Array    # complex64, conj of last strong sample (fm.c:26)
    lastaudio: jax.Array     # float32, last good discriminator output (fm.c:69)
    snr_below: jax.Array     # int32, blocks below squelch threshold (fm.c:70)
    audio_overlap: jax.Array  # audio master overlap (M_dec-1,) float32
    pl_ring: Optional[jax.Array]    # (PL_FFT_SIZE,) float32, newest last
    pl_counter: Optional[jax.Array]  # int32, PL samples since last FFT
    plfreq: Optional[jax.Array]      # float32, measured tone (NaN = none)


def fm_init(cfg: FMConfig, batch_shape=()) -> FMState:
    pl_ring = pl_counter = plfreq = None
    if cfg.pl_slave is not None:
        pl_ring = jnp.zeros(batch_shape + (PL_FFT_SIZE,), jnp.float32)
        pl_counter = jnp.zeros(batch_shape, jnp.int32)
        plfreq = jnp.full(batch_shape, jnp.nan, jnp.float32)
    return FMState(
        disc_state=jnp.full(batch_shape, 1.0, jnp.complex64),
        lastaudio=jnp.zeros(batch_shape, jnp.float32),
        snr_below=jnp.zeros(batch_shape, jnp.int32),
        audio_overlap=jnp.zeros(
            batch_shape + (cfg.audio_master.M - 1,), jnp.float32
        ),
        pl_ring=pl_ring,
        pl_counter=pl_counter,
        plfreq=plfreq,
    )


def _pl_measure(cfg: FMConfig, ring: jax.Array, prev: jax.Array) -> jax.Array:
    """Peak-pick the PL spectrum (fm.c:254-276).

    A strong peak outside 67-255 Hz leaves plfreq at its previous value
    (fm.c:270-276 only assigns inside the range check); a weak peak
    (<1% of total energy) clears it to NaN."""
    spec = jnp.fft.rfft(ring, axis=-1)
    energy = jnp.real(spec) ** 2 + jnp.imag(spec) ** 2
    energy = energy[..., 1 : PL_FFT_SIZE // 2]  # skip DC (fm.c:260)
    peakbin = jnp.argmax(energy, axis=-1) + 1
    peakenergy = jnp.max(energy, axis=-1)
    totenergy = jnp.sum(energy, axis=-1)
    pl_samprate = cfg.dsamprate / PL_DECIMATE
    f = peakbin.astype(jnp.float32) * (pl_samprate / PL_FFT_SIZE)
    strong = peakenergy > 0.01 * totenergy
    in_range = (f > 67.0) & (f < 255.0)
    return jnp.where(strong, jnp.where(in_range, f, prev), jnp.nan)


def fm_demod(
    cfg: FMConfig, state: FMState, baseband: jax.Array
) -> tuple[FMState, jax.Array, dict]:
    """One block of FM demodulation (fm.c:72-174).

    baseband: (..., n) complex64 from the predetection slave filter.
    Returns (state, mono_audio, diag).
    """
    n = baseband.shape[-1]
    sampsq = jnp.real(baseband) ** 2 + jnp.imag(baseband) ** 2
    bb_power = jnp.sum(sampsq, axis=-1) / (2.0 * n)
    amp = jnp.sqrt(sampsq)
    amp_mean = jnp.mean(amp, axis=-1)
    avg_amp = amp_mean / np.sqrt(2.0)
    # The reference computes variance as bb_power - avg_amp^2 (fm.c:101),
    # which catastrophically cancels in float32 on clean constant-envelope
    # signals (variance can go negative and close the squelch).  The
    # centered form is identical math — var/2 in the reference's per-
    # component scaling — but numerically stable.
    fm_variance = jnp.mean((amp - amp_mean[..., None]) ** 2, axis=-1) / 2.0
    snr = jnp.maximum(
        0.0,
        avg_amp * avg_amp / jnp.maximum(2.0 * fm_variance, 1e-30) - 1.0,
    )

    # Squelch counter (fm.c:108-114)
    snr_below = jnp.where(
        snr > SNR_THRESH,
        jnp.int32(0),
        jnp.minimum(state.snr_below + 1, jnp.int32(1000)),
    )
    open_ = snr_below < 2   # open, or one extra flush block (fm.c:115-116)
    fresh = snr_below < 1   # fully open: update foffset/pdeviation (fm.c:146)

    # Threshold extension + discriminator (fm.c:118-144), parallel form.
    # Two forward-fills total: the "strictly previous strong sample" each
    # position pairs with is just the fill lagged one sample, so the
    # shifted variants reuse the same scan output instead of re-scanning.
    min_ampl = (BLANK_RATIO**2) * avg_amp * avg_amp
    strong = sampsq > min_ampl[..., None]

    ff_conj = forward_fill(jnp.conj(baseband), strong, state.disc_state)
    init_c = jnp.broadcast_to(
        jnp.asarray(state.disc_state, ff_conj.dtype)[..., None],
        ff_conj.shape[:-1] + (1,),
    )
    prev_conj = jnp.concatenate([init_c, ff_conj[..., :-1]], axis=-1)
    disc = jnp.angle(baseband * prev_conj)

    ff_disc = forward_fill(disc, strong, state.lastaudio)
    init_a = jnp.broadcast_to(
        jnp.asarray(state.lastaudio, disc.dtype)[..., None],
        disc.shape[:-1] + (1,),
    )
    weak_fill = jnp.concatenate([init_a, ff_disc[..., :-1]], axis=-1)
    samples_open = jnp.where(strong, disc, weak_fill)

    # fill-at-end IS the carried state (equals the init when no strong
    # sample occurred, so no any() select is needed)
    new_disc_state = ff_conj[..., -1]
    new_lastaudio = ff_disc[..., -1]

    samples = jnp.where(open_[..., None], samples_open, 0.0)
    new_disc_state = jnp.where(open_, new_disc_state, jnp.complex64(0.0))
    new_lastaudio = jnp.where(open_, new_lastaudio, 0.0)

    avg_f = jnp.mean(samples_open, axis=-1)
    foffset = jnp.where(
        fresh, cfg.dsamprate * avg_f / (2.0 * np.pi), jnp.nan
    )
    # Peak deviation tracks STRONG samples only (fm.c:133-139): the
    # weak-filled values are in-block repeats (harmless to max/min) except
    # a leading run, which carries the PREVIOUS block's lastaudio and
    # must not be reported as this block's peak.  When the first sample
    # is weak the reference's running peaks start at 0, not at the first
    # strong value.
    any_strong = jnp.any(strong, axis=-1)
    smax = jnp.max(jnp.where(strong, disc, -jnp.inf), axis=-1)
    smin = jnp.min(jnp.where(strong, disc, jnp.inf), axis=-1)
    first_strong = strong[..., 0]
    pmax = jnp.where(first_strong, smax, jnp.maximum(smax, 0.0))
    pmin = jnp.where(first_strong, smin, jnp.minimum(smin, 0.0))
    pdev_pos = jnp.where(any_strong, pmax, 0.0) - avg_f
    pdev_neg = jnp.where(any_strong, pmin, 0.0) - avg_f
    pdeviation = jnp.where(
        fresh,
        cfg.dsamprate * jnp.maximum(pdev_pos, -pdev_neg) / (2.0 * np.pi),
        jnp.nan,
    )

    # Post-detection audio chain (fm.c:162-172).  In flat mode with PL
    # off there is no consumer of the audio-master FFT — skip the whole
    # AN-point rFFT + overlap carry on the hot path (one per channel per
    # block in a flat bank).
    if cfg.flat and cfg.pl_slave is None:
        new_overlap, afdomain = state.audio_overlap, None
        audio = samples
    else:
        new_overlap, afdomain = master_execute(
            cfg.audio_master, state.audio_overlap, samples
        )
        if cfg.flat:
            audio = samples
        else:
            audio = (
                slave_execute(cfg.audio_slave, afdomain,
                              jnp.asarray(cfg.audio_response))
                * cfg.gain
            )

    # PL tone measurement (pltask, fm.c:233-277)
    pl_ring, pl_counter, plfreq = state.pl_ring, state.pl_counter, state.plfreq
    if cfg.pl_slave is not None:
        pl_samples = slave_execute(
            cfg.pl_slave, afdomain, jnp.asarray(cfg.pl_response)
        )
        k = pl_samples.shape[-1]
        pl_ring = jnp.concatenate([pl_ring[..., k:], pl_samples], axis=-1)
        pl_counter = pl_counter + k
        do_fft = pl_counter >= PL_FFT_INTERVAL
        # The 16k FFT runs 1 block in ~17 (fm.c:251-253).  Gate it with a
        # SCALAR cond — jnp.any over the batch — so the whole batched FFT
        # is skipped on the other 16 blocks instead of computed-and-
        # discarded by a select; per-channel do_fft still picks which
        # channels take the fresh measurement.
        plfreq = jax.lax.cond(
            jnp.any(do_fft),
            lambda r: jnp.where(do_fft, _pl_measure(cfg, r, plfreq), plfreq),
            lambda r: plfreq,
            pl_ring,
        )
        pl_counter = jnp.where(do_fft, 0, pl_counter)

    new_state = FMState(
        disc_state=new_disc_state,
        lastaudio=new_lastaudio,
        snr_below=snr_below,
        audio_overlap=new_overlap,
        pl_ring=pl_ring,
        pl_counter=pl_counter,
        plfreq=plfreq,
    )
    diag = {
        "snr": snr,
        "bb_power": bb_power,
        "foffset": foffset,
        "pdeviation": pdeviation,
        "squelch_open": open_,
        "plfreq": plfreq,
    }
    return new_state, audio, diag
