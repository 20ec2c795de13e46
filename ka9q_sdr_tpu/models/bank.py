"""Wideband multichannel bank — the flagship receiver.

The reference's master/slave filter shares one forward FFT among a handful
of slave filters in one process (filter.c:22-35).  This module batches that
fan-out to hundreds of channels: ONE wideband forward FFT per 20 ms block,
then for every channel a bin *gather* (frequency conversion done in the
frequency domain), a shared frequency response multiply, a batched short
IFFT, a residual fine-tune NCO, and a batched demodulator.  All of it is a
single XLA program; the channel axis shards over a device mesh (see
parallel.mesh).

Frequency conversion in the frequency domain
--------------------------------------------
Downconverting channel c (center f_c) is, in the time domain, a multiply by
exp(-2*pi*i * nu * s) with nu = f_c/fs and absolute sample index s
(radio.c:131-136 does this per sample with the second LO).  Split
nu = k/N + delta with integer k = round(nu*N):

- the k/N part is a *bin rotation*: slave bin j reads master bin
  (base[j] + k) mod N, where base[] is the reference's slave bin mapping
  (filter.c:206,225-227);
- because overlap-save chunk m starts at absolute sample m*L-(M-1), the
  rotation is off from the true LO by a constant per-block phase
  phi_m = exp(-2*pi*i * k*(m*L-(M-1))/N).  We carry r_m = k*(m*L-(M-1))
  mod N as integer state (exact, no drift) and multiply each channel's
  block by exp(-2*pi*i*r_m/N);
- the residual delta (|delta| <= 1/(2N) cycles/sample) is applied after
  the IFFT by a per-channel phase-continuous NCO at the *decimated* rate
  (freq = -delta*decimate cycles/output-sample) — hundreds of times
  cheaper than mixing at the input rate.

This reproduces the reference's LO2 + filter semantics to within the
response interpolation error of tuning off bin centers, at a fraction of
the FLOPs of per-channel time-domain mixing.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.fftfilt import (
    FilterType,
    MasterSpec,
    SlaveSpec,
    master_execute,
    set_filter_response,
    slave_bin_indices,
)
from ..ops.nco import OscState, osc_block, split_double
from ..utils.modes import ModeDef, DEFAULT_MODES
from .demod_am import am_init, am_demod, AMConfig
from .demod_fm import fm_init, fm_demod, FMConfig
from .demod_linear import linear_init, linear_demod, LinearConfig

__all__ = [
    "BankConfig",
    "BankState",
    "ChannelBank",
    "MultiBank",
    "make_bank",
    "make_bank_config",
    "bank_init",
    "bank_step",
    "bank_step_packed",
    "bank_scan_packed_i16",
    "bank_channelize",
    "bank_demod",
    "bank_tune",
    "bank_recenter",
    "bank_set_doppler",
]

_TWO32 = float(2**32)


class BankConfig(NamedTuple):
    """Static channel-bank configuration.

    Default geometry scales the reference's L=3840, M=4353, N=8192 @192 kHz
    (main.c:113-115) up to a 2^20-point wideband FFT @24.576 Msps with the
    same 20 ms block cadence and the same 2048-bin, 48 kHz channels."""

    samprate: float
    master: MasterSpec
    decimate: int
    mode: ModeDef
    n_channels: int
    response: np.ndarray     # shared (N_dec,) channel frequency response
    base_idx: np.ndarray     # (N_dec,) master-bin gather pattern at k=0
    demod_cfg: object
    kaiser_beta: float = 3.0

    @property
    def N(self) -> int:
        return self.master.N

    @property
    def N_dec(self) -> int:
        return self.master.N // self.decimate

    @property
    def L_dec(self) -> int:
        return self.master.L // self.decimate

    @property
    def dsamprate(self) -> float:
        return self.samprate / self.decimate


class BankState(NamedTuple):
    overlap: jax.Array     # (M-1,) complex64, shared wideband overlap
    resp: jax.Array        # (N_dec,) complex64, shared channel frequency
    #                        response — state, not a trace constant, so a
    #                        filter-edge command hot-swaps it without a
    #                        recompile (set_filter, filter.c:537-543)
    k: jax.Array           # (B,) int32, per-channel integer bin shift
    r: jax.Array           # (B,) int32, per-channel block-phase residue mod N
    dr: jax.Array          # (B,) int32, per-block residue step (k*L mod N),
    #                        precomputed host-side at tune time to keep the
    #                        in-jit update overflow-free: r' = (r+dr) mod N
    nco: OscState          # batched (B,) residual fine-tune oscillators
    demod: object          # batched demod state
    gain_factor: jax.Array  # float32 scalar


def make_bank_config(
    n_channels: int,
    mode: str | ModeDef = "FM",
    samprate: float = 24.576e6,
    L: int = 491520,
    M: int = 557057,
    kaiser_beta: float = 3.0,
    headroom_db: float = -15.0,
    enable_pl: bool = False,
) -> BankConfig:
    if isinstance(mode, str):
        mode = DEFAULT_MODES[mode.upper()]
    master = MasterSpec(L, M, FilterType.COMPLEX)
    N = master.N
    # Channel geometry mirrors the reference receiver: N_dec = 2048 bins,
    # 48 kHz output from 20 ms blocks.
    decimate = round(samprate / 48000.0)
    if N % decimate:
        raise ValueError(f"N={N} not divisible by decimate={decimate}")
    out_type = (
        FilterType.CROSS_CONJ
        if (mode.demod == "LINEAR" and mode.isb)
        else FilterType.COMPLEX
    )
    slave = SlaveSpec(master, decimate, out_type)
    dsamprate = samprate / decimate
    response = set_filter_response(
        slave, mode.low / dsamprate, mode.high / dsamprate, kaiser_beta
    )
    base_idx = slave_bin_indices(slave).astype(np.int32)

    L_dec = L // decimate
    M_dec = (M - 1) // decimate + 1
    if mode.demod == "FM":
        demod_cfg = FMConfig.make(
            dsamprate, mode.low, mode.high, L_dec, M_dec,
            headroom_db=headroom_db, kaiser_beta=kaiser_beta,
            flat=mode.flat, enable_pl=enable_pl and not mode.flat,
        )
    elif mode.demod == "AM":
        demod_cfg = AMConfig.make(
            dsamprate, headroom_db=headroom_db,
            recovery_rate_db_s=mode.recovery_rate, hangtime_s=mode.hangtime,
        )
    else:
        demod_cfg = LinearConfig.make(
            dsamprate, L_dec, headroom_db=headroom_db,
            recovery_rate_db_s=mode.recovery_rate, hangtime_s=mode.hangtime,
            pll=mode.pll, square=mode.square, channels=mode.channels,
            shift_freq=mode.shift / dsamprate,
        )
    return BankConfig(
        samprate=float(samprate),
        master=master,
        decimate=decimate,
        mode=mode,
        n_channels=n_channels,
        response=response,
        base_idx=base_idx,
        demod_cfg=demod_cfg,
        kaiser_beta=kaiser_beta,
    )


def _residual_phase_cycles(cfg: BankConfig, delta: float) -> float:
    """Group-delay phase correction for off-bin tuning, in cycles.

    The bank applies the SHARED channel response to the pre-residual-mix
    spectrum, i.e. the response is sampled delta off from where the
    reference (mix-then-filter, radio.c:131-136 -> filter.c) samples it.
    The designed response is exactly linear-phase with delay
    D = (M_dec-1)/2 output samples (window design, filter.c:365-469), so
    the offset costs a CONSTANT per-channel phase 2*pi*delta*(M-1)/2 —
    up to ~48 deg at half-bin offsets — which this folds into the
    residual NCO's phase so off-bin channels match the reference's phase
    exactly in the flat passband (the residual |response| interpolation
    error at the edges remains, see module docstring)."""
    return delta * (cfg.master.M - 1) / 2.0


def bank_init(cfg: BankConfig, freqs_hz: Sequence[float]) -> BankState:
    """Initial state with every channel tuned (host-side design time)."""
    B = cfg.n_channels
    if len(freqs_hz) != B:
        raise ValueError(f"need {B} frequencies, got {len(freqs_hz)}")
    N = cfg.N
    ks, freq, phase = [], [], []
    for i, f in enumerate(freqs_hz):
        if not np.isfinite(f) or abs(f) > cfg.samprate / 2:
            # k % N would silently alias an out-of-span tune onto some
            # in-band bin (misconfig presenting as a garbled channel —
            # fail loud instead, like every other config error here)
            raise ValueError(
                f"channel {i}: frequency {f!r} Hz outside the "
                f"+-{cfg.samprate / 2:.0f} Hz span of a "
                f"{cfg.samprate:.0f} S/s bank"
            )
        nu = f / cfg.samprate
        k = int(np.round(nu * N))
        delta = nu - k / N
        ks.append(k % N)
        # residual LO at the decimated rate; negative = downconvert.
        # Initial phase = the off-bin group-delay correction, split into
        # the uint32 word + f32 residual like a frequency.  Host
        # arithmetic only, so building a wide bank costs no device ops.
        freq.append(split_double(-delta * cfg.decimate))
        phase.append(split_double(_residual_phase_cycles(cfg, delta)))
    nco = OscState(
        phase=jnp.asarray(np.array([h for h, _ in phase], np.uint32)),
        freq=jnp.asarray(np.array([h for h, _ in freq], np.uint32)),
        freq_resid=jnp.asarray(np.array([r for _, r in freq], np.float32)),
        rate=jnp.zeros((B,), jnp.float32),
        phase_resid=jnp.asarray(np.array([r for _, r in phase], np.float32)),
    )
    ks64 = np.asarray(ks, np.int64)
    k_arr = jnp.asarray(ks64.astype(np.int32))
    # r_0 = k*(0*L - (M-1)) mod N  (chunk 0 starts at sample -(M-1));
    # computed in int64 on the host to avoid overflow
    r0 = jnp.asarray(((-(cfg.master.M - 1) * ks64) % N).astype(np.int32))
    dr0 = jnp.asarray(((ks64 * cfg.master.L) % N).astype(np.int32))

    if cfg.mode.demod == "FM":
        dstate = fm_init(cfg.demod_cfg, (B,))
    elif cfg.mode.demod == "AM":
        dstate = am_init((B,))
    else:
        dstate = linear_init(cfg.demod_cfg, (B,))

    return BankState(
        overlap=jnp.zeros((cfg.master.M - 1,), jnp.complex64),
        resp=jnp.asarray(cfg.response, jnp.complex64),
        k=k_arr,
        r=r0,
        dr=dr0,
        nco=nco,
        demod=dstate,
        gain_factor=jnp.float32(1.0),
    )


def _mul_mod_n(s: jax.Array, c: int, N: int) -> jax.Array:
    """(s * c) mod N for traced int32 s of ANY sign/magnitude and host
    constant c in [0, N), without int32 overflow: reduce s mod N first,
    then accumulate 4-bit limbs with a mod after every partial product.
    Each partial is limb*(c*16^i % N) < 16*N <= 2^30 and the running
    accumulator stays < N, so every intermediate fits int32 for
    N <= 2^26 (the flagship master).  The previous 7-bit-limb version
    overflowed for |s| >= 2^31/N * 2^14 (~2^19 bins at N=2^26) — reachable
    by a one-shot doppler steer far from the current k, and by any
    cross-band bank_tune; steady-state recenter hops are +-1."""
    s = s % jnp.int32(N)          # non-negative (sign of divisor)
    acc = jnp.zeros_like(s)
    t = c % N
    for _ in range((N.bit_length() + 3) // 4):
        limb = s % 16
        acc = (acc + limb * jnp.int32(t)) % jnp.int32(N)
        s = s // 16
        t = (t * 16) % N
    return acc


def _resharded(arr_in, out):
    """Re-apply the sharding `arr_in` carried to `out`: an eager `.at[]`
    update across a sharded axis can come back replicated, which would
    silently de-shard a bank leaf on the first live retune.  Shared by
    bank_tune / bank_set_doppler / bank_reset_demod_row."""
    sh = getattr(arr_in, "sharding", None)
    if sh is not None and out.sharding != sh:
        out = jax.device_put(out, sh)
    return out


def _set_ch(arr, channel, val):
    return _resharded(arr, jnp.asarray(arr).at[channel].set(val))


def _add_ch(arr, channel, val):
    # uint32 add wraps mod 2^32 = phase mod 1 cycle (ops.nco)
    return _resharded(arr, jnp.asarray(arr).at[channel].add(val))


def bank_recenter(cfg: BankConfig, state: BankState) -> BankState:
    """Scheduled integer-k re-centering for swept (Doppler-steered)
    channels, in-jit — the bank analog of the reference's per-sample
    sweep LO (osc.c phasor_step_step applied in radio.c:132-136).

    A bank channel's downconversion is a bin rotation by k plus a
    residual NCO (module docstring).  A Doppler sweep accumulates into
    the residual NCO frequency (ops.nco osc_advance folds rate into freq
    every block); once the residual drifts past 3/4 of a master bin the
    channel's signal sits measurably off-center in the SHARED response,
    so this hops k by the whole-bin excess s, phase-continuously:

    - k += s and dr += s*L mod N; the carried residue r gets the exact
      integer adjustment r -= s*(M-1) mod N, which makes the block phase
      CONTINUOUS at the hop boundary: the chunk-relative rotation by k
      carries a -k*(M-1) alignment term inside r (bank_init's r_0), so
      switching k without re-aligning would jump the LO phase by
      s*(M-1)/N cycles;
    - the NCO frequency gives back s bins (fq += s/N_dec, split exactly
      into the fixed-point word + f32 residual);
    - the group-delay phase correction for the delta change
      (_residual_phase_cycles: ddelta = -s/N) lands on phase_resid, which
      osc_advance folds mod 1 exactly next block.

    The 0.75-bin hysteresis keeps statically-tuned channels (|delta| <=
    half a bin by construction) from ever hopping; swept channels hop at
    most once every few blocks (170 Hz/s worst-case LEO sweep x 20 ms =
    3.4 Hz/block vs 23 Hz bins at flagship geometry).  Elementwise on
    (B,) leaves — negligible next to the master FFT, and shards trivially.
    """
    N, N_dec = cfg.N, cfg.N_dec
    nco = state.nco
    fw = jax.lax.bitcast_convert_type(nco.freq, jnp.int32)
    fq = (fw.astype(jnp.float32) * jnp.float32(1.0 / _TWO32)
          + nco.freq_resid)                      # cycles/dec-sample
    x = -fq * jnp.float32(N_dec)                 # bins above k
    s = jnp.where(jnp.abs(x) > 0.75,
                  jnp.round(x).astype(jnp.int32), jnp.int32(0))
    k_new = (state.k + s) % jnp.int32(N)
    dr_new = (state.dr + _mul_mod_n(s, cfg.master.L % N, N)) % jnp.int32(N)
    r_new = (state.r - _mul_mod_n(s, (cfg.master.M - 1) % N, N)) \
        % jnp.int32(N)
    hi1, res1 = split_double(1.0 / N_dec)
    freq_new = nco.freq + s.astype(jnp.uint32) * jnp.uint32(hi1)
    resid_new = nco.freq_resid + s.astype(jnp.float32) * jnp.float32(res1)
    # dcorr = -s*Dhalf/N cycles (group-delay correction, exact int mod)
    d_half = (cfg.master.M - 1) // 2
    ph_cycles = _mul_mod_n(-s, d_half % N, N).astype(jnp.float32) \
        * jnp.float32(1.0 / N)
    return state._replace(
        k=k_new,
        dr=dr_new,
        r=r_new,
        nco=nco._replace(
            freq=freq_new,
            freq_resid=resid_new,
            phase_resid=nco.phase_resid + ph_cycles,
        ),
    )


def bank_channelize(
    cfg: BankConfig,
    state: BankState,
    fdomain: jax.Array,
    bin_perm: jax.Array | None = None,
    comb_p: int | None = None,
) -> tuple[jax.Array, OscState, jax.Array]:
    """Shared-FFT channel extraction: gather + response + block phase +
    batched IFFT + residual NCO.  Returns (new_r, new_nco, baseband) with
    baseband (B, L_dec) complex64.

    bin_perm: optional (N,) index map applied to the gather indices, for
    spectra stored in a permuted layout — e.g. the comb-major layout of the
    distributed FFT (parallel.dfft.comb_index): true bin b lives at
    fdomain[bin_perm[b]].  Served by the slow per-element gather.

    comb_p: the comb-major layout's device count P (the distributed-FFT
    output, parallel/dfft.py) — true bin b lives at position
    (b % P)*(N/P) + b//P.  Unlike the generic bin_perm this engages the
    aligned path: reshaped (P, Q=N/P), a channel's window is ONE circular
    column window across all P rows plus a row offset r = start mod P,
    so the gather chunk-aligns in column space (whole-aligned-row
    gather), the row offset is a P-way static-variant select, and the
    column misalign reuses the shifted-response-table trick at stride P.
    Serves CROSS_CONJ ISB too: the same per-sideband masked-response
    decomposition as the natural aligned path.  Falls back to bin_perm
    only for geometries it cannot serve (N_dec % P != 0, Q % 128 != 0),
    with a loud construction-time warning from make_sharded_bank_step.

    Gather strategy: each channel's bins {k..k+h} ∪ {k-h+1..k-1} (mod N)
    form ONE contiguous circular window of N_dec bins.  The natural-order
    path gathers it in ALIGNED 128-bin chunks (whole-row gathers, in
    place of a per-element take; whether the plain take is as fast on
    the card is ROADMAP Speed #4) and removes the sub-chunk misalignment
    m = start mod 128 EXACTLY:

    - multiply the (N_dec+128)-bin aligned window by the response
      zero-padded and shifted by m (a 128-row table built from static
      slices, row-gathered per channel);
    - fold the product back mod N_dec (the circular property of the
      slave frame; the overlap terms are zero where the shifted response
      is zero, so placement is exact);
    - the resulting spectrum is the true slave spectrum rolled by +m,
      i.e. the IFFT output times exp(-2*pi*i*m*n/N_dec) — a per-channel
      output phase ramp folded into the (h-1)-rotation ramp below.

    The slice order is the needed FFT order rotated by h-1; the response
    is pre-rolled to match and the rotation becomes a constant per-sample
    phase on the IFFT output (frequency-shift theorem)."""
    N, N_dec, L_dec = cfg.N, cfg.N_dec, cfg.L_dec
    isb = cfg.mode.demod == "LINEAR" and cfg.mode.isb
    phi = jnp.exp(
        (-2j * np.pi / N) * state.r.astype(jnp.float32)
    ).astype(jnp.complex64)
    new_r = (state.r + state.dr) % jnp.int32(N)
    new_nco, lo = jax.vmap(lambda s: osc_block(s, L_dec))(state.nco)

    if comb_p:
        P_ = int(comb_p)
        Q = N // P_
        CC = min(128, Q)
        if N_dec % P_ == 0 and Q % CC == 0 and N % P_ == 0:
            h = N_dec // 2
            D = N_dec // P_
            NCHc = D // CC + 2
            CHp = CC * P_              # flat shift granularity (bins)
            Wn = N_dec + CHp           # window width the fold consumes
            F = fdomain.reshape(P_, Q)
            Fd = jnp.concatenate([F, F[:, : NCHc * CC]], axis=1)
            rows = (Fd.reshape(P_, -1, CC).transpose(1, 0, 2)
                    .reshape(-1, P_ * CC))
            s = (state.k - jnp.int32(h - 1)) % jnp.int32(N)
            q = s // P_
            r_off = s % P_             # row offset within the comb
            c = q // CC
            mc = q % CC                # column misalign within a chunk
            idx = (c[:, None]
                   + jnp.arange(NCHc, dtype=jnp.int32)[None, :])
            G = jnp.take(rows, idx, axis=0)        # (B, NCHc, P_*CC)
            G = (G.reshape(-1, NCHc, P_, CC)
                 .transpose(0, 1, 3, 2))           # (B, NCHc, CC, P_)
            flat = G.reshape(G.shape[0], NCHc * CC * P_)  # bins, in order
            # row-offset shift: P_ static window variants, per-channel
            # select (flat[b, r_off+i] for i in [0, Wn))
            Wv = jnp.stack([
                jax.lax.slice(flat, (0, rr), (flat.shape[0], rr + Wn))
                for rr in range(P_)
            ])                                     # (P_, B, Wn)
            Wsel = jnp.take_along_axis(
                Wv, r_off[None, :, None].astype(jnp.int32), axis=0
            )[0]                                   # (B, Wn)
            # output ramp: undo the mc*P_ roll + the h-1 rotation (same
            # exact-integer phase reduction as the natural path)
            n_out = np.arange(N_dec - L_dec, N_dec)
            out_fix = np.exp(
                -2j * np.pi * (h - 1) * n_out / N_dec
            ).astype(np.complex64)
            nn_i = jnp.asarray(n_out.astype(np.int32))
            mn = ((mc * jnp.int32(P_))[:, None] * nn_i[None, :]) \
                % jnp.int32(N_dec)
            frac = mn.astype(jnp.float32) * jnp.float32(1.0 / N_dec)
            ang = (-2.0 * np.pi) * frac
            fix = jax.lax.complex(jnp.cos(ang), jnp.sin(ang)) \
                * jnp.asarray(out_fix)[None, :]

            def comb_ifft(resp_slave):
                """IFFT of (comb window gather x response) for one
                slave-order response vector — exactly
                ifft(f_slave)[tail] * N_dec (incl. the fix ramp)."""
                # column-misalign shift table at stride P_
                resp_rolled = jnp.roll(resp_slave, h - 1)
                Pp = jnp.concatenate([
                    jnp.zeros((CHp,), resp_rolled.dtype),
                    resp_rolled,
                    jnp.zeros((CHp,), resp_rolled.dtype),
                ])
                Rt = jnp.stack([
                    jax.lax.slice(Pp, (CHp - mm * P_,),
                                  (CHp - mm * P_ + Wn,))
                    for mm in range(CC)
                ])                                 # (CC, Wn)
                S = Wsel * jnp.take(Rt, mc, axis=0)
                # fold mod N_dec (may wrap more than once when CC*P_ >
                # N_dec); the shifted response occupies N_dec contiguous
                # positions of Wn, so every output bin receives exactly
                # one nonzero term — placement, never mixing
                n_seg = (Wn + N_dec - 1) // N_dec
                Sp = jnp.pad(S, ((0, 0), (0, n_seg * N_dec - Wn)))
                f = Sp.reshape(S.shape[0], n_seg, N_dec).sum(axis=1)
                y = jnp.fft.ifft(f * phi[:, None], axis=-1) * N_dec
                return y[..., N_dec - L_dec:] * fix

            if isb:
                # CROSS_CONJ ISB through the comb gather (r5): identical
                # decomposition to the natural aligned path below —
                # per-sideband masked responses + the unpaired DC/Nyquist
                # base bins via a tiny 2-element gather (comb-major
                # location is plain arithmetic, no table) + the
                # reference's combine (see _isb_combine).
                mask_pos = np.zeros(N_dec, np.float32)
                mask_pos[: h + 1] = 1.0            # slave bins 0..h
                resp_pos = state.resp * jnp.asarray(mask_pos)
                resp_neg = state.resp * jnp.asarray(1.0 - mask_pos)
                u = comb_ifft(resp_pos)
                l_ = comb_ifft(resp_neg)
                b2 = jnp.stack(
                    [state.k % N, (state.k + h) % N], axis=1)  # (B, 2)
                b2 = (b2 % P_) * Q + b2 // P_      # comb-major position
                g2 = jnp.take(fdomain, b2, axis=0)
                f0 = g2[:, 0] * state.resp[0] * phi
                fh = g2[:, 1] * state.resp[h] * phi
                sign = jnp.asarray(((-1.0) ** n_out).astype(np.float32))
                base = f0[:, None] + fh[:, None] * sign[None, :]
                u = (u - base) * lo
                l_ = l_ * lo
                base = base * lo
                y = base + jax.lax.complex(
                    2.0 * jnp.real(l_), 2.0 * jnp.imag(u))
                return new_r, new_nco, y
            return new_r, new_nco, comb_ifft(state.resp) * lo
        # unsupported comb geometry: serve through the generic
        # per-element path below with the comb permutation;
        # make_sharded_bank_step warns loudly at construction
        if bin_perm is None:
            kk = np.arange(N)
            bin_perm = jnp.asarray(
                ((kk % P_) * Q + kk // P_).astype(np.int32))

    CH = min(128, N_dec)               # gather chunk granularity
    aligned = N_dec % CH == 0 and (N + N_dec) % CH == 0
    if bin_perm is not None or not aligned:
        # Per-element gather for layouts the aligned chunk path can't
        # serve: the distributed-FFT comb (consecutive bins scattered
        # across devices) and slave geometries whose N_dec is not a
        # multiple of the 128-bin chunk (rare non-power-of-two configs;
        # ~30x slower, correctness unchanged).
        idx = (jnp.asarray(cfg.base_idx)[None, :] + state.k[:, None]) % N
        if bin_perm is not None:
            idx = jnp.take(jnp.asarray(bin_perm), idx, axis=0)
        gathered = jnp.take(fdomain, idx, axis=0)      # (B, N_dec)
        f_fd = gathered * state.resp[None, :] * phi[:, None]
        if isb:
            return new_r, new_nco, _isb_combine(
                f_fd, lo, N_dec, L_dec
            )
        y = jnp.fft.ifft(f_fd, axis=-1) * N_dec
        y = y[..., N_dec - L_dec:]
        return new_r, new_nco, y * lo

    # Aligned chunk-row gather (see docstring), shared by the plain and
    # the ISB paths: gather the window once, then run one IFFT per
    # (possibly sideband-masked) response through the shift-table fold.
    h = N_dec // 2
    NCH = N_dec // CH + 1
    fdbl = jnp.concatenate([fdomain, fdomain[..., :N_dec]], axis=-1)
    F2 = fdbl.reshape(-1, CH)
    starts = (state.k - jnp.int32(h - 1)) % jnp.int32(N)
    c = starts // CH
    m = starts % CH
    idx = c[:, None] + jnp.arange(NCH, dtype=jnp.int32)[None, :]
    W = jnp.take(F2, idx, axis=0).reshape(-1, NCH * CH)
    n_out = np.arange(N_dec - L_dec, N_dec)
    out_fix = np.exp(-2j * np.pi * (h - 1) * n_out / N_dec).astype(
        np.complex64
    )
    # undo the roll-by-m (shift theorem) + the h-1 rotation in one
    # per-channel output ramp.  Phase reduced with an exact integer
    # mod BEFORE the float multiply (a raw f32 m*n/N_dec reaches
    # hundreds of radians and costs ~5e-5 of phase; reduced, it is
    # exact to f32 rounding — same rule as fft_fourstep's twiddles).
    nn_i = jnp.asarray(n_out.astype(np.int32))
    mn = (m[:, None] * nn_i[None, :]) % jnp.int32(N_dec)
    frac = mn.astype(jnp.float32) * jnp.float32(1.0 / N_dec)
    ang = (-2.0 * np.pi) * frac
    fix = jax.lax.complex(jnp.cos(ang), jnp.sin(ang)) \
        * jnp.asarray(out_fix)[None, :]

    def chunked_ifft(resp_slave):
        """IFFT of (window gather x response) for one slave-order
        response vector — exactly ifft(f_slave)[tail] * N_dec."""
        resp_rolled = jnp.roll(resp_slave, h - 1)
        # shifted-response table from static slices of one padded
        # vector: Rt[mm] = [zeros(mm), resp_rolled, zeros(CH - mm)]
        P = jnp.concatenate([
            jnp.zeros((CH,), resp_rolled.dtype),
            resp_rolled,
            jnp.zeros((CH,), resp_rolled.dtype),
        ])
        Rt = jnp.stack([
            jax.lax.slice(P, (CH - mm,), (CH - mm + N_dec + CH,))
            for mm in range(CH)
        ])
        S = W * jnp.take(Rt, m, axis=0)
        # fold mod N_dec: overlap terms are exact zeros where the
        # shifted response is zero — placement, never mixing
        f = S[:, :N_dec].at[:, :CH].add(S[:, N_dec:])
        y = jnp.fft.ifft(f * phi[:, None], axis=-1) * N_dec
        return y[..., N_dec - L_dec:] * fix

    if isb:
        # CROSS_CONJ ISB (filter.c:239-249) through the chunked gather:
        # per-sideband responses (slave bins [1..h-1] pair with
        # [h+1..N_dec-1]; 0 and h are unpaired), the unpaired base bins
        # via a tiny 2-element gather, then the reference's combine —
        # see _isb_combine for the mixing-order subtlety.
        mask_pos = np.zeros(N_dec, np.float32)
        mask_pos[: h + 1] = 1.0              # slave bins 0..h
        resp_pos = state.resp * jnp.asarray(mask_pos)
        resp_neg = state.resp * jnp.asarray(1.0 - mask_pos)
        u = chunked_ifft(resp_pos)
        l_ = chunked_ifft(resp_neg)
        base_idx2 = jnp.stack(
            [state.k % N, (state.k + h) % N], axis=1)   # (B, 2), tiny
        g2 = jnp.take(fdomain, base_idx2, axis=0)
        f0 = g2[:, 0] * state.resp[0] * phi
        fh = g2[:, 1] * state.resp[h] * phi
        sign = jnp.asarray(((-1.0) ** n_out).astype(np.float32))
        base = f0[:, None] + fh[:, None] * sign[None, :]
        u = (u - base) * lo
        l_ = l_ * lo
        base = base * lo
        y = base + jax.lax.complex(2.0 * jnp.real(l_), 2.0 * jnp.imag(u))
        return new_r, new_nco, y

    y = chunked_ifft(state.resp)
    return new_r, new_nco, y * lo


def _isb_combine(f_fd, lo, N_dec: int, L_dec: int):
    """CROSS_CONJ ISB combine from a slave-order spectrum (the dfft-comb
    path).  The reference mixes the full LO before the FFT, so its
    combine sees the residual-shifted sidebands; conj does NOT commute
    with the shift, so combining first and mixing after would put an
    opposite-sign frequency error on one sideband.  Equivalent
    time-domain combine (IFFT linearity on filter.c:239-249, whose loop
    pairs p=1..h-1 with N_dec-p and leaves bins 0 and h unpaired):
    out = base + 2j*Im(USB') + 2*Re(LSB'), base = the unpaired
    DC/Nyquist bins, all applied AFTER per-sideband mixing."""
    h = N_dec // 2
    f_pos = f_fd.at[..., h + 1:].set(0)
    f_neg = f_fd.at[..., : h + 1].set(0)
    u = jnp.fft.ifft(f_pos, axis=-1)[..., N_dec - L_dec:] * N_dec
    l_ = jnp.fft.ifft(f_neg, axis=-1)[..., N_dec - L_dec:] * N_dec
    n_out = np.arange(N_dec - L_dec, N_dec)
    sign = jnp.asarray(((-1.0) ** n_out).astype(np.float32))
    base = f_fd[..., 0:1] + f_fd[..., h: h + 1] * sign[None, :]
    u = (u - base) * lo
    l_ = l_ * lo
    base = base * lo
    return base + jax.lax.complex(2.0 * jnp.real(l_), 2.0 * jnp.imag(u))


def bank_demod(
    cfg: BankConfig, dstate, baseband: jax.Array
) -> tuple[object, jax.Array, dict]:
    """Dispatch the batched demodulator for this bank's mode (the
    Demodtab[] of modes.c:25-30, resolved at trace time)."""
    if cfg.mode.demod == "FM":
        return fm_demod(cfg.demod_cfg, dstate, baseband)
    if cfg.mode.demod == "AM":
        return am_demod(cfg.demod_cfg, dstate, baseband)
    return linear_demod(cfg.demod_cfg, dstate, baseband)


def bank_step(
    cfg: BankConfig, state: BankState, iq_block: jax.Array
) -> tuple[BankState, jax.Array, dict]:
    """One wideband block through all channels.

    iq_block: (L,) complex64 at the wideband rate.  Returns
    (state, audio, diag); audio is (B, L_dec) float32 (mono modes)."""
    samp = iq_block * state.gain_factor
    overlap, fdomain = master_execute(cfg.master, state.overlap, samp)
    state = bank_recenter(cfg, state)   # k-hops for swept channels
    new_r, new_nco, baseband = bank_channelize(cfg, state, fdomain)
    dstate, audio, diag = bank_demod(cfg, state.demod, baseband)

    new_state = BankState(
        overlap=overlap,
        resp=state.resp,
        k=state.k,
        r=new_r,
        dr=state.dr,
        nco=new_nco,
        demod=dstate,
        gain_factor=state.gain_factor,
    )
    return new_state, audio, diag


def bank_step_packed(cfg: BankConfig, template):
    """bank_step with a real-dtype-only jit boundary (see ops.packing):
    state and I/Q cross as float32 (...,2) pairs and all complex math stays
    inside the program."""
    from ..ops.packing import tree_c2r, tree_r2c, r2c

    def packed(state_r, x_r):
        state = tree_r2c(state_r, template)
        new_state, audio, diag = bank_step(cfg, state, r2c(x_r))
        return tree_c2r(new_state), audio, diag

    return packed


def bank_step_packed_i16(cfg: BankConfig, template, pcm_out: bool = False):
    """Like bank_step_packed but ingesting raw (L, 2) int16 — half the
    host->device bytes with the scale conversion (radio.c:38) fused into
    the program.

    pcm_out=True additionally quantises the audio to int16 ON DEVICE
    (scaleclip, audio.c:22-28): the download halves and the host skips
    the clip/scale pass — PCM packetisation becomes a byte swap."""
    from ..ops.packing import tree_c2r, tree_r2c, r2c

    def packed(state_r, x_i16):
        x = x_i16.astype(jnp.float32) * jnp.float32(1.0 / 32767.0)
        state = tree_r2c(state_r, template)
        new_state, audio, diag = bank_step(cfg, state, r2c(x))
        if pcm_out:
            audio = jnp.clip(
                audio * 32767.0, -32768.0, 32767.0
            ).astype(jnp.int16)
        return tree_c2r(new_state), audio, diag

    return packed


def bank_scan_packed_i16(cfg: BankConfig, template, pcm_out: bool = False):
    """Process MANY wideband blocks in ONE device program via lax.scan —
    the bank analog of receiver_scan.

    Scanning k blocks amortises the per-block dispatch k-fold, for
    replay/offline demodulation and for live feeds that buffer a few
    blocks (k x 20 ms added latency).

    x: (k, L, 2) int16.  Returns (state, audio (k, B, ...))."""
    from ..ops.packing import tree_c2r, tree_r2c, r2c

    def step(st_r, x1):
        x = x1.astype(jnp.float32) * jnp.float32(1.0 / 32767.0)
        st = tree_r2c(st_r, template)
        ns, audio, _diag = bank_step(cfg, st, r2c(x))
        if pcm_out:
            audio = jnp.clip(
                audio * 32767.0, -32768.0, 32767.0
            ).astype(jnp.int16)
        return tree_c2r(ns), audio

    def packed(state_r, x_i16):
        return jax.lax.scan(step, state_r, x_i16)

    return packed


def bank_step_active(cfg: BankConfig, template, max_active: int,
                     n_valid: int | None = None):
    """bank_step with device-side ACTIVE-CHANNEL COMPACTION — the
    reference's silence suppression (audio.c:102-113) lifted to the bank:
    squelched/silent channels never cross the host boundary.

    Returns (state, pcm_i16 (max_active, L_dec), idx (max_active,) int32,
    diag): the top-max_active channels by audio peak, already scaleclipped
    to int16 on device; idx[i] = -1 marks unused slots (channel silent).
    Download shrinks from n_channels*L_dec to max_active*L_dec.

    n_valid: only the first n_valid channels compete for slots (mesh
    padding rows are excluded from the top_k, parallel.mesh.pad_channels)."""
    from ..ops.packing import tree_c2r, tree_r2c, r2c

    def packed(state_r, x_i16):
        x = x_i16.astype(jnp.float32) * jnp.float32(1.0 / 32767.0)
        state = tree_r2c(state_r, template)
        new_state, audio, diag = bank_step(cfg, state, r2c(x))
        flat = audio.reshape(audio.shape[0], -1)
        peak = jnp.max(jnp.abs(flat), axis=-1)
        if n_valid is not None and n_valid < flat.shape[0]:
            peak = jnp.where(jnp.arange(flat.shape[0]) < n_valid,
                             peak, -jnp.inf)
        score, idx = jax.lax.top_k(peak, max_active)
        sel = jnp.take(flat, idx, axis=0)
        pcm = jnp.clip(sel * 32767.0, -32768.0, 32767.0).astype(jnp.int16)
        # mark channels whose int16 audio is all-zero as inactive: this is
        # exactly the all-zero-packet criterion of audio.c:54
        active = jnp.max(jnp.abs(pcm), axis=-1) > 0
        if n_valid is not None and n_valid < flat.shape[0]:
            # mesh-padding rows can still fill slots when
            # max_active > n_valid: keep the "-1 = unused" contract
            active = active & (idx < n_valid)
        idx = jnp.where(active, idx, -1)
        return tree_c2r(new_state), pcm, idx.astype(jnp.int32), diag

    return packed


def bank_tune(
    cfg: BankConfig, state: BankState, channel: int, freq_hz: float,
    old_freq_hz: float | None = None,
) -> BankState:
    """Retune one channel of a BankState without phase discontinuity
    (osc.c:24-27 semantics): the block-phase residue r keeps its value;
    only the bin shift k, the residue step dr and the residual NCO
    frequency change (plus the group-delay phase correction difference,
    _residual_phase_cycles — the response-sampling shift the reference's
    own output exhibits at a retune).

    The continuity corrections (the r re-alignment and the group-delay
    phase step) are computed against the channel's CURRENT device state
    — its live k and NCO frequency — as small in-graph scalar ops, no
    host fetch.  This matters for Doppler-swept channels: bank_recenter
    hops k in-jit as the sweep drifts, so host bookkeeping (the last
    commanded frequency) cannot reconstruct the live k; deriving k_old
    from old_freq_hz (as this function did through r4-early) mis-aligns
    r by the hop amount and jumps the block phase by s*(M-1)/N cycles on
    the next block — a phase discontinuity on PLL/coherent channels.
    `old_freq_hz` is accepted for backward compatibility and ignored.
    The sweep rate (nco.rate) is left untouched: a retune moves a swept
    channel's center, the steer keeps steering (radio.c:204-242, where
    set_freq and the doppler thread compose the same way).

    Works on both the complex and the packed (real-dtype) state forms —
    every tuned leaf (k, dr, nco.*) is real in both — and re-applies any
    sharding the leaf carried (an eager `.at[]` update across a sharded
    axis can come back replicated), so it is the retune path for sharded
    banks too."""
    del old_freq_hz
    if not np.isfinite(freq_hz) or abs(freq_hz) > cfg.samprate / 2:
        # same loud contract as bank_init: never alias an out-of-span
        # retune onto an in-band bin (daemons catch ValueError and drop
        # the command, radio_status.c's silent-clamp has no equivalent)
        raise ValueError(
            f"retune to {freq_hz!r} Hz outside the "
            f"+-{cfg.samprate / 2:.0f} Hz span of a "
            f"{cfg.samprate:.0f} S/s bank"
        )
    N = cfg.N
    nu = freq_hz / cfg.samprate
    k = int(np.round(nu * N))
    delta = nu - k / N
    hi, resid = split_double(-delta * cfg.decimate)
    km = k % N
    nco = state.nco
    # group-delay phase correction for the delta change, from the
    # channel's CURRENT NCO frequency (device scalar, same formula as
    # bank_set_doppler): dcorr = (fq_old - fq_new)*(M-1)/(2*decimate)
    fw = jax.lax.bitcast_convert_type(jnp.asarray(nco.freq)[channel],
                                      jnp.int32)
    fq_old = (fw.astype(jnp.float32) * jnp.float32(1.0 / _TWO32)
              + jnp.asarray(nco.freq_resid)[channel])
    dcorr = (fq_old - jnp.float32(-delta * cfg.decimate)) * jnp.float32(
        (cfg.master.M - 1) / 2.0 / cfg.decimate
    )
    dcorr = dcorr - jnp.round(dcorr)           # phase is mod 1 cycle
    new_nco = nco._replace(
        freq=_set_ch(nco.freq, channel, np.uint32(hi)),
        freq_resid=_set_ch(nco.freq_resid, channel, np.float32(resid)),
        phase_resid=_add_ch(nco.phase_resid, channel, dcorr),
    )
    # LO phase continuity across the bin-shift change (osc.c:24-27
    # semantics): the carried residue r embeds a -k*(M-1) alignment term
    # (bank_init's r_0), so switching k needs the exact integer
    # adjustment r -= (k-k_live)*(M-1) mod N or the block phase jumps by
    # (k-k_live)*(M-1)/N cycles at the next block (same math as
    # bank_recenter; exact limbed int mod on device, _mul_mod_n).
    s_k = jnp.int32(km) - jnp.asarray(state.k)[channel]
    r_adj = -_mul_mod_n(s_k, (cfg.master.M - 1) % N, N)
    new_r = _resharded(
        state.r,
        (jnp.asarray(state.r).at[channel].add(r_adj)) % jnp.int32(N),
    )
    return state._replace(
        k=_set_ch(state.k, channel, km),
        dr=_set_ch(state.dr, channel, int(km * cfg.master.L % N)),
        r=new_r,
        nco=new_nco,
    )


def bank_set_doppler(
    cfg: BankConfig,
    state: BankState,
    channel: int,
    base_freq_hz: float,
    doppler_hz: float = 0.0,
    rate_hz_s: float = 0.0,
) -> BankState:
    """Doppler-steer one bank channel (set_doppler, radio.c:180-198 +
    doppler.c:63-66, at bank scale): set its instantaneous frequency to
    base + doppler and its sweep rate, phase-continuously, WITHOUT
    rewriting k — the in-jit bank_recenter hops k as the sweep drifts.

    Host math touches only small device scalars (no fetch): the new
    residual frequency is computed relative to the channel's CURRENT k
    (which recenter may have moved), the group-delay phase correction
    from the CURRENT NCO frequency.  Frequency resolution is the f32
    residual, ~2 mHz at 48 kHz output — the reference's double phasor is
    finer, but 2 mHz is far below the 0.09 Hz PL/CW analysis resolution.

    The sweep itself rides ops.nco: `rate` (cycles/dec-sample^2)
    accumulates into the NCO frequency every block (osc_advance), exactly
    the reference's phasor_step_step semantics (osc.c:39-51).

    Group-delay alignment: the reference mixes its doppler NCO BEFORE the
    filter (radio.c:132-136), so oscillator and signal share a time base;
    the bank's residual NCO runs after, where the signal is delayed by
    the filter's (M-1)/2-sample group delay.  During a sweep that lag
    shows up as a constant frequency error rate*(M-1)/(2*fs) (28 Hz at a
    20 kHz/s sweep through the default geometry — measured before this
    correction), so the steer targets f(t - delay).
    """
    doppler_hz = doppler_hz - rate_hz_s * (cfg.master.M - 1) / (
        2.0 * cfg.samprate
    )
    f_total = base_freq_hz + doppler_hz
    if not np.isfinite(f_total) or not np.isfinite(rate_hz_s) or \
            abs(f_total) > cfg.samprate / 2:
        raise ValueError(
            f"doppler steer to {f_total!r} Hz (rate {rate_hz_s!r} Hz/s) "
            f"outside the +-{cfg.samprate / 2:.0f} Hz span"
        )
    N, N_dec = cfg.N, cfg.N_dec
    dsr = cfg.dsamprate

    # target position in master bins, split exactly on the host
    b = np.float64(f_total) / cfg.samprate * N
    b_int = int(np.round(b))
    b_frac = float(b - b_int)                  # |b_frac| <= 0.5, exact f64
    # signed wrapped distance from the channel's current k (device scalar)
    k_ch = jnp.asarray(state.k)[channel]
    d = (jnp.int32(b_int % N) - k_ch) % jnp.int32(N)
    d = jnp.where(d > N // 2, d - N, d)
    excess = d.astype(jnp.float32) + jnp.float32(b_frac)   # bins above k
    fq_new = -excess * jnp.float32(1.0 / N_dec)  # cycles/dec-sample
    # group-delay phase correction for the frequency jump:
    # ddelta = -(fq_new - fq_old)/decimate, dcorr = ddelta*(M-1)/2 cycles
    nco = state.nco
    fw = jax.lax.bitcast_convert_type(jnp.asarray(nco.freq)[channel],
                                      jnp.int32)
    fq_old = (fw.astype(jnp.float32) * jnp.float32(1.0 / _TWO32)
              + jnp.asarray(nco.freq_resid)[channel])
    dcorr = (fq_old - fq_new) * jnp.float32(
        (cfg.master.M - 1) / 2.0 / cfg.decimate
    )
    dcorr = dcorr - jnp.round(dcorr)           # phase is mod 1 cycle
    rate_dec = -rate_hz_s / (dsr * dsr)        # cycles/dec-sample^2
    new_nco = nco._replace(
        freq=_set_ch(nco.freq, channel, jnp.uint32(0)),
        freq_resid=_set_ch(nco.freq_resid, channel, fq_new),
        rate=_set_ch(nco.rate, channel, np.float32(rate_dec)),
        phase_resid=_add_ch(nco.phase_resid, channel, dcorr),
    )
    return state._replace(nco=new_nco)


def bank_reset_demod_row(
    state: BankState, fresh_demod, channel: int, n_channels: int
) -> BankState:
    """Reset ONE channel's demod state row to its freshly-initialised
    value — the reference's demod-thread respawn on a mode/preset change
    (radio.c:322-374) done as a state edit instead of a restart.

    `fresh_demod` is the bank_init template's demod subtree in the SAME
    tree structure and packing (real/c2r form) as `state.demod`.  Leaves
    whose leading axis is the channel axis (shape[0] == n_channels) get
    row `channel` spliced from the template; shared leaves (windows,
    scalar gains) are untouched.  Re-applies sharding like bank_tune —
    an eager .at[] across a sharded axis can come back replicated."""

    def _splice(live, tmpl):
        t = np.asarray(tmpl)
        if (getattr(live, "ndim", 0) >= 1
                and live.shape[0] == n_channels
                and t.shape == tuple(live.shape)):
            return _set_ch(live, channel, jnp.asarray(t[channel]))
        return live

    new_demod = jax.tree_util.tree_map(_splice, state.demod, fresh_demod)
    return state._replace(demod=new_demod)


def swap_filter_response(
    cfg: BankConfig,
    state: BankState,
    low: float | None = None,
    high: float | None = None,
    kaiser_beta: float | None = None,
) -> tuple[BankConfig, BankState]:
    """Hot-swap a bank's shared frequency response (set_filter,
    filter.c:500-546): edges in Hz at the decimated rate.  The response is
    a STATE leaf, so every jitted step variant picks it up on the next
    block with NO recompile (the reference's response-swap mutex,
    filter.c:537-543, as a functional update).  Works on the packed (real)
    state form and re-applies any sharding the resp leaf carried.  Shared
    by ChannelBank.set_filter and MultiBank.set_filter."""
    from dataclasses import replace as dc_replace

    from ..ops.packing import c2r_np

    mode = cfg.mode
    low = mode.low if low is None else low
    high = mode.high if high is None else high
    beta = cfg.kaiser_beta if kaiser_beta is None else kaiser_beta
    # Validate beta HERE, not just at the wire: np.i0 overflows to
    # inf/NaN for beta beyond ~226 and make_kaiser then returns all-NaN
    # taps WITHOUT raising — which would NaN-poison the shared response
    # of every channel.  Reference betas are 0..20 (modes.txt).
    if not np.isfinite(beta) or not 0.0 <= beta <= 100.0:
        raise ValueError(f"kaiser_beta out of range: {beta!r}")
    if not (np.isfinite(low) and np.isfinite(high)):
        raise ValueError(f"non-finite filter edges: {low!r}, {high!r}")
    out_type = (
        FilterType.CROSS_CONJ
        if (mode.demod == "LINEAR" and mode.isb)
        else FilterType.COMPLEX
    )
    slave = SlaveSpec(cfg.master, cfg.decimate, out_type)
    dsr = cfg.dsamprate
    resp = set_filter_response(slave, low / dsr, high / dsr, beta)
    demod_cfg = cfg.demod_cfg
    if mode.demod == "FM" and high != low and mode.high != mode.low:
        # fm.c recomputes the audio gain from the CURRENT edges every
        # block (fm.c:85-86); rescale the baked constant by the bandwidth
        # ratio (gain ∝ 1/|high-low|, everything else unchanged)
        demod_cfg = demod_cfg._replace(
            gain=float(demod_cfg.gain * abs(mode.high - mode.low)
                       / abs(high - low))
        )
    cfg = cfg._replace(
        mode=dc_replace(mode, low=low, high=high),
        response=resp,
        kaiser_beta=beta,
        demod_cfg=demod_cfg,
    )
    old = state.resp
    if jnp.iscomplexobj(old):
        # raw bank_init/bank_step state form keeps a complex resp leaf;
        # only the packed (real) form used across jit boundaries packs
        leaf = jnp.asarray(resp, jnp.complex64)
    else:
        leaf = jnp.asarray(c2r_np(resp))
    sh = getattr(old, "sharding", None)
    if sh is not None and hasattr(old, "devices"):
        leaf = jax.device_put(leaf, sh)
    return cfg, state._replace(resp=leaf)


class ChannelBank:
    """Host wrapper: config + state + jitted step + per-channel retune.

    State is held host/device-side in packed (real) form between calls;
    the jitted step unpacks, runs, repacks (see bank_step_packed).

    mesh: a jax.sharding.Mesh to shard the channel axis over (one logical
    receiver spanning chips — the master/slave fan-out of filter.c:22-35
    at multi-chip scale, SURVEY §2.7).  cfg.n_channels must be a multiple
    of the device count (parallel.mesh.pad_channels pads a frequency
    list).  shard_fft additionally distributes the wideband master FFT
    (the >100 Msps sequence-scaling path, parallel.dfft)."""

    def __init__(
        self,
        cfg: BankConfig,
        freqs_hz: Sequence[float],
        mesh=None,
        shard_fft: bool = False,
    ):
        from ..ops.packing import tree_c2r_np

        self.cfg = cfg
        self.freqs = list(freqs_hz)
        self.mesh = mesh
        self.shard_fft = shard_fft
        # Host copies: the template only marks which leaves are complex,
        # and the packed state is uploaded by the first step.
        self._template = jax.tree_util.tree_map(
            np.asarray, bank_init(cfg, freqs_hz))
        self.state = tree_c2r_np(self._template)
        if mesh is not None:
            from ..parallel.mesh import make_sharded_bank_step

            self._step, self.state = make_sharded_bank_step(
                cfg, mesh, self._template, self.state, shard_fft=shard_fft
            )
        else:
            self._step = jax.jit(bank_step_packed(cfg, self._template))
        # Warm the retune path: a no-op self-tune compiles the six eager
        # .at[] update graphs now (a LIVE retune must be a dispatch, not a
        # compile)
        self.state = bank_tune(cfg, self.state, 0, self.freqs[0])

    def _sharded_variant(self, ingest: str, pcm_out: bool):
        """Sharded twin of the lazy single-chip step variants: same
        program, channel-axis in/out shardings (parallel.mesh)."""
        from ..parallel.mesh import make_sharded_bank_step

        step, _ = make_sharded_bank_step(
            self.cfg, self.mesh, self._template, self.state,
            shard_fft=self.shard_fft, ingest=ingest, pcm_out=pcm_out,
        )
        return step

    def process(self, iq_block):
        """iq_block: (L,) complex (numpy ok).  Returns (audio, diag)."""
        x = np.asarray(iq_block)
        x_r = np.stack([x.real, x.imag], axis=-1).astype(np.float32)
        return self.process_packed(x_r)

    def process_packed(self, x_r):
        """Zero-copy path for packed (L, 2) float32 input — the format the
        native RTP engine produces."""
        self.state, audio, diag = self._step(self.state, x_r)
        return audio, diag

    def step_memory(self):
        """compiled.memory_analysis() of the packed float32 block step
        (the program process/process_packed run)."""
        x = jax.ShapeDtypeStruct((self.cfg.master.L, 2), jnp.float32)
        return self._step.lower(self.state, x).compile().memory_analysis()

    def process_i16(self, x_i16):
        """Raw (L, 2) int16 ingest (native engine's get_block_i16): half
        the host->device bytes with the scale conversion fused on-device."""
        if not hasattr(self, "_step_i16"):
            if self.mesh is not None:
                self._step_i16 = self._sharded_variant("i16", False)
            else:
                self._step_i16 = jax.jit(
                    bank_step_packed_i16(self.cfg, self._template)
                )
        self.state, audio, diag = self._step_i16(self.state, x_i16)
        return audio, diag

    def process_i16_pcm(self, x_i16):
        """int16 in, int16 PCM out: both transfers halved, clip/scale on
        the device.  Audio comes back as int16 ready for byte-swap."""
        if not hasattr(self, "_step_i16_pcm"):
            if self.mesh is not None:
                self._step_i16_pcm = self._sharded_variant("i16", True)
            else:
                self._step_i16_pcm = jax.jit(
                    bank_step_packed_i16(self.cfg, self._template,
                                         pcm_out=True)
                )
        self.state, audio, diag = self._step_i16_pcm(self.state, x_i16)
        return audio, diag

    def process_scan_i16(self, x_i16_blocks, pcm_out: bool = False):
        """Demodulate (k, L, 2) int16 blocks in ONE device program
        (bank_scan_packed_i16): amortises the per-block dispatch cost.
        Returns audio (k, B, ...) (int16 when pcm_out)."""
        key = ("_scan_i16", pcm_out)
        if not hasattr(self, "_scans"):
            self._scans = {}
        if key not in self._scans:
            fn = bank_scan_packed_i16(self.cfg, self._template, pcm_out)
            if self.mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec
                from ..parallel.mesh import (
                    CHANNEL_AXIS, bank_state_shardings,
                )

                sh = bank_state_shardings(self.mesh, self.state)
                self._scans[key] = jax.jit(
                    fn,
                    in_shardings=(sh, NamedSharding(self.mesh,
                                                    PartitionSpec())),
                    out_shardings=(
                        sh,
                        NamedSharding(self.mesh,
                                      PartitionSpec(None, CHANNEL_AXIS)),
                    ),
                )
            else:
                self._scans[key] = jax.jit(fn)
        self.state, audio = self._scans[key](self.state, x_i16_blocks)
        return audio

    def process_active(self, x_i16, max_active: int = 64,
                       n_valid: int | None = None):
        """int16 in; compacted int16 PCM of the top-max_active non-silent
        channels out, plus their channel indices (-1 = unused slot).  The
        serving path for large banks: silent channels stay on-chip.
        n_valid excludes mesh-padding rows from the compaction."""
        if getattr(self, "_max_active", None) != (max_active, n_valid):
            self._max_active = (max_active, n_valid)
            fn = bank_step_active(self.cfg, self._template, max_active,
                                  n_valid=n_valid)
            if self.mesh is not None:
                # top_k runs over the sharded peak vector (B floats — the
                # cross-device part is tiny); pcm/idx come back replicated
                from jax.sharding import NamedSharding, PartitionSpec
                from ..parallel.mesh import bank_state_shardings

                sh = bank_state_shardings(self.mesh, self.state)
                rep = NamedSharding(self.mesh, PartitionSpec())
                self._step_active = jax.jit(
                    fn, in_shardings=(sh, rep),
                    out_shardings=(sh, rep, rep, None),
                )
            else:
                self._step_active = jax.jit(fn)
        self.state, pcm, idx, diag = self._step_active(self.state, x_i16)
        return pcm, idx, diag

    def tune(self, channel: int, freq_hz: float) -> None:
        """Retune one channel without phase discontinuity (the
        radio.c:204-242 set_freq at bank scale): bank_tune reads the
        channel's LIVE k (a doppler sweep may have re-centered it since
        the last command) and adjusts the block-phase residue r by the
        k-delta so accumulated phase is preserved — see bank_tune's
        docstring for the continuity math.  Pure dispatch; no host fetch
        of bulk state."""
        # device update FIRST: if it rejects the frequency (non-finite /
        # absurd magnitude raises in the fixed-point phase math), the
        # host-side list must not desync from the device state
        self.state = bank_tune(self.cfg, self.state, channel, freq_hz)
        self.freqs[channel] = freq_hz

    def set_filter(
        self,
        low: float | None = None,
        high: float | None = None,
        kaiser_beta: float | None = None,
    ) -> None:
        """Hot-swap the bank's shared frequency response with no recompile
        (swap_filter_response)."""
        self.cfg, self.state = swap_filter_response(
            self.cfg, self.state, low=low, high=high,
            kaiser_beta=kaiser_beta,
        )

    def set_doppler(self, channel: int, doppler_hz: float,
                    rate_hz_s: float) -> None:
        """Doppler-steer one channel (set_doppler, radio.c:180-198):
        instantaneous offset + sweep rate on top of the channel's base
        frequency (self.freqs, which retunes keep authoritative)."""
        self.state = bank_set_doppler(
            self.cfg, self.state, channel, self.freqs[channel],
            doppler_hz=doppler_hz, rate_hz_s=rate_hz_s,
        )

    def steer_adapter(self, channel: int):
        """A per-channel facade with the Receiver steering interface
        (.tune_freq / .set_doppler), so models.doppler.DopplerSteerer can
        drive one bank channel from an ephemeris command exactly like a
        reference `radio -d` instance."""
        bank = self

        class _Chan:
            @property
            def tune_freq(self):
                return bank.freqs[channel]

            def set_doppler(self, f, r):
                bank.set_doppler(channel, f, r)

        return _Chan()


class MultiBank:
    """Mixed-mode channel bank: several demod groups sharing ONE wideband
    forward FFT — the full master/slave idea (filter.c:22-35) at scale.
    The reference's single process runs one mode per receiver; here each
    group (mode, [freqs]) has its own batched demod but the 2^20-point
    input FFT happens once per block for everyone.

    groups: list of (mode_name, [freq_hz, ...]).
    mesh: shard every group's channel axis over the mesh (each group is
    padded to a device multiple; `group_real[g]` rows of group g's audio
    are real, the rest are padding and should be ignored).  The wideband
    block and master FFT stay replicated exactly as for ChannelBank.
    """

    def __init__(
        self,
        groups: Sequence[tuple[str, Sequence[float]]],
        samprate: float = 24.576e6,
        L: int = 491520,
        M: int = 557057,
        mesh=None,
        **kw,
    ):
        from ..ops.packing import tree_c2r_np, tree_c2r, tree_r2c, r2c

        self.mesh = mesh
        self.group_real = [len(freqs) for _, freqs in groups]
        if mesh is not None:
            from ..parallel.mesh import pad_channels

            groups = [
                (mode, pad_channels(freqs, mesh.devices.size))
                for mode, freqs in groups
            ]
        self.group_freqs = [list(freqs) for _, freqs in groups]
        self.cfgs = []
        templates = []
        for mode, freqs in groups:
            cfg = make_bank_config(
                len(freqs), mode, samprate=samprate, L=L, M=M, **kw
            )
            self.cfgs.append(cfg)
        master = self.cfgs[0].master
        for c in self.cfgs[1:]:
            # a real error, not an assert: under python -O a skipped
            # check would let every non-zero group channelize a spectrum
            # of the wrong FFT geometry into silently garbled audio
            if c.master != master:
                raise ValueError(
                    f"MultiBank groups must share one master: "
                    f"{c.master} != {master}"
                )

        for cfg, (mode, freqs) in zip(self.cfgs, groups):
            templates.append(jax.tree_util.tree_map(
                np.asarray, bank_init(cfg, freqs)))
        self._templates = templates
        self.states = [tree_c2r_np(t) for t in templates]
        # frozen copies of each group's freshly-initialised demod
        # subtree (real form), for live mode migration's per-row
        # respawn (init_channel / bank_reset_demod_row)
        self._fresh_demod = [
            jax.tree_util.tree_map(np.array, s.demod) for s in self.states
        ]

        cfgs = self.cfgs

        def step(states_r, x_r):
            x = r2c(x_r)
            outs = []
            new_states = []
            # ONE forward FFT, shared by every group (the master's overlap
            # is identical across groups; group 0's copy is authoritative)
            st0 = tree_r2c(states_r[0], templates[0])
            overlap, fdomain = master_execute(master, st0.overlap, x)
            for cfg, s_r, tmpl in zip(cfgs, states_r, templates):
                s = bank_recenter(cfg, tree_r2c(s_r, tmpl))
                new_r, new_nco, bb = bank_channelize(cfg, s, fdomain)
                ds, audio, diag = bank_demod(cfg, s.demod, bb)
                ns = s._replace(
                    overlap=overlap, r=new_r, nco=new_nco, demod=ds
                )
                new_states.append(tree_c2r(ns))
                outs.append((audio, diag))
            return new_states, outs

        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec
            from ..parallel.mesh import CHANNEL_AXIS, bank_state_shardings

            shs = [bank_state_shardings(mesh, s) for s in self.states]
            rep = NamedSharding(mesh, PartitionSpec())
            aud = NamedSharding(mesh, PartitionSpec(CHANNEL_AXIS))
            self._step = jax.jit(
                step,
                in_shardings=(shs, rep),
                out_shardings=(shs, [(aud, None) for _ in shs]),
            )
            self.states = [
                jax.tree_util.tree_map(jax.device_put, s, sh)
                for s, sh in zip(self.states, shs)
            ]
        else:
            self._step = jax.jit(step)
        # Warm the retune path per group: a no-op self-tune compiles the
        # eager .at[] update graphs now (a LIVE retune must be a dispatch,
        # not a compile — same rationale as
        # ChannelBank.__init__; shapes differ per group, so each group
        # needs its own warm-up)
        for g, freqs in enumerate(self.group_freqs):
            self.tune(g, 0, freqs[0])

    def process(self, iq_block) -> list:
        """Returns [(audio, diag), ...] per group."""
        x = np.asarray(iq_block)
        if x.ndim == 2:
            x_r = x.astype(np.float32)
        else:
            x_r = np.stack([x.real, x.imag], axis=-1).astype(np.float32)
        self.states, outs = self._step(self.states, x_r)
        return outs

    def step_memory(self):
        """compiled.memory_analysis() of the shared block step."""
        x = jax.ShapeDtypeStruct((self.cfgs[0].master.L, 2), jnp.float32)
        return self._step.lower(self.states, x).compile().memory_analysis()

    def tune(self, group: int, idx: int, freq_hz: float) -> None:
        """Retune one channel of one demod group, phase-continuously
        (ChannelBank.tune semantics; every channel of the mixed-mode bank
        is individually retunable like every reference receiver)."""
        # device update first, host list second (see ChannelBank.tune)
        self.states[group] = bank_tune(
            self.cfgs[group], self.states[group], idx, freq_hz,
        )
        self.group_freqs[group][idx] = freq_hz

    def set_doppler(self, group: int, idx: int, doppler_hz: float,
                    rate_hz_s: float) -> None:
        """Doppler-steer one channel of one group (ChannelBank.set_doppler
        semantics on the group's state)."""
        self.states[group] = bank_set_doppler(
            self.cfgs[group], self.states[group], idx,
            self.group_freqs[group][idx],
            doppler_hz=doppler_hz, rate_hz_s=rate_hz_s,
        )

    def init_channel(self, group: int, idx: int, freq_hz: float) -> None:
        """(Re)commission one slot of one group: fresh demod state for
        the row (the reference's respawned demod thread on a mode change,
        radio.c:322-374), a phase-continuous retune, and a cleared
        doppler sweep.  This is the receiving half of live mode
        migration; the daemon mutes the slot the channel left.  First
        use per group compiles the splice updates — MultiBankDaemon
        pre-warms this at startup whenever --spare-slots > 0 (migration
        intent declared), so a LIVE migration is a dispatch, never a
        mid-serving compile."""
        n_b = len(self.group_freqs[group])
        self.states[group] = bank_reset_demod_row(
            self.states[group], self._fresh_demod[group], idx, n_b
        )
        self.tune(group, idx, freq_hz)
        self.set_doppler(group, idx, 0.0, 0.0)

    def set_filter(
        self,
        group: int,
        low: float | None = None,
        high: float | None = None,
        kaiser_beta: float | None = None,
    ) -> None:
        """Hot-swap ONE group's shared frequency response with no
        recompile — the other groups' responses are untouched (each group
        is its own slave-filter family, swap_filter_response)."""
        self.cfgs[group], self.states[group] = swap_filter_response(
            self.cfgs[group], self.states[group], low=low, high=high,
            kaiser_beta=kaiser_beta,
        )


def make_bank(
    n_channels: int,
    mode: str = "FM",
    freqs_hz: Sequence[float] | None = None,
    **kw,
) -> ChannelBank:
    cfg = make_bank_config(n_channels, mode, **kw)
    if freqs_hz is None:
        # Spread channels over the usable band (avoid the outer 5%)
        usable = 0.9 * cfg.samprate
        freqs_hz = list(
            np.linspace(-usable / 2, usable / 2, n_channels, endpoint=False)
        )
    return ChannelBank(cfg, freqs_hz)
