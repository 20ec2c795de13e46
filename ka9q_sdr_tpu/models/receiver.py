"""Single-channel receiver — JAX equivalent of the `radio` program's
sample path (radio.c proc_samples + one demod thread).

The reference splits the hot path across four pthreads handing off through
condvars (main.c:234-236, filter.c:194-199).  Here the whole chain —
front-end gain, second LO + Doppler mix, overlap-save master FFT, slave
filter, demodulation — is ONE pure block function that jit compiles into a
single XLA program per 20 ms block.  All state (oscillator phases, filter
overlaps, AGC gains, squelch counters, noise estimates) is an explicit
pytree, so the receiver scans over long recordings and vmaps over channels.

Tuning (set_freq / LO2 / Doppler, radio.c:200-316) is control-plane: host
functions that produce a new state (retuned oscillators keep their phase,
osc.c:24-27) and, when LO1 must move, a command for the front end.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
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
    set_filter_response,
)
from ..ops.nco import OscState, osc_init, set_osc, osc_block
from ..utils.modes import ModeDef, DEFAULT_MODES
from .noise import compute_n0, passband_mask
from .demod_am import AMConfig, am_init, am_demod
from .demod_fm import FMConfig, fm_init, fm_demod
from .demod_linear import LinearConfig, linear_init, linear_demod

__all__ = ["ReceiverConfig", "ReceiverState", "Receiver", "make_receiver"]

#: SDR alias keep-out margin (radio.c:28).
IF_EXCLUDE = 0.95
#: int16 / int8 sample scaling (radio.c:38-39).
SCALE16 = 1.0 / 32767.0
SCALE8 = 1.0 / 127.0
#: Default filter dimensions (main.c:113-115): L=3840, M=4353, N=8192.
DEFAULT_L = 3840
DEFAULT_M = 4353


class ReceiverConfig(NamedTuple):
    """Static receiver configuration.  Rebuild (make_receiver) on mode or
    bandwidth change — the reference's set_mode respawns the demod thread
    (radio.c:322-374); we rebuild the jitted program."""

    samprate: int           # input sample rate, Hz
    decimate: int           # samprate / output rate (radio_status.c:264-267)
    mode: ModeDef
    master: MasterSpec
    slave: SlaveSpec
    response: np.ndarray    # slave frequency response
    n0_mask: np.ndarray     # passband mask for compute_n0
    n0_alpha: float         # n0 smoothing (fm.c:82 = .01, am/linear = .001)
    demod_cfg: object       # FMConfig | AMConfig | LinearConfig
    kaiser_beta: float = 3.0     # current window beta (display.c 'k')
    headroom_db: float = -15.0   # AGC headroom (modes.c)
    enable_pl: bool = True       # FM PL tone chain

    @property
    def dsamprate(self) -> float:
        return self.samprate / self.decimate

    @property
    def L(self) -> int:
        return self.master.L

    @property
    def blocktime(self) -> float:
        return self.master.L / self.samprate


class ReceiverState(NamedTuple):
    overlap: jax.Array       # master filter overlap
    lo2: OscState            # second (software) LO
    doppler: OscState        # Doppler sweep oscillator
    demod: object            # demod-specific state pytree
    n0: jax.Array            # float32, smoothed noise density
    if_power: jax.Array      # float32
    gain_factor: jax.Array   # float32, front-end analog gain compensation


def make_receiver_config(
    mode: str | ModeDef,
    samprate: int = 192000,
    out_rate: int = 48000,
    L: int = DEFAULT_L,
    M: int = DEFAULT_M,
    kaiser_beta: float = 3.0,
    headroom_db: float = -15.0,
    enable_pl: bool = True,
) -> ReceiverConfig:
    """Build a config the way main.c + set_mode do at startup."""
    if isinstance(mode, str):
        mode = DEFAULT_MODES[mode.upper()]
    if samprate % out_rate:
        raise ValueError(f"samprate {samprate} not divisible by {out_rate}")
    # int() so a float samprate (192000.0) can't propagate float filter
    # lengths into the window design (make_kaiser needs integral M)
    decimate = int(samprate // out_rate)
    master = MasterSpec(L, M, FilterType.COMPLEX)
    dsamprate = samprate / decimate

    if mode.demod == "LINEAR" and mode.isb:
        out_type = FilterType.CROSS_CONJ
    else:
        out_type = FilterType.COMPLEX
    slave = SlaveSpec(master, decimate, out_type)
    # set_filter edges in cycles/sample of the decimated rate
    # (fm.c:35, am.c:41, linear.c:81)
    response = set_filter_response(
        slave, mode.low / dsamprate, mode.high / dsamprate, kaiser_beta
    )
    mask = passband_mask(master.N, samprate, mode.low, mode.high)

    L_dec = L // decimate
    M_dec = (M - 1) // decimate + 1
    if mode.demod == "FM":
        demod_cfg = FMConfig.make(
            dsamprate,
            mode.low,
            mode.high,
            L_dec,
            M_dec,
            headroom_db=headroom_db,
            kaiser_beta=kaiser_beta,
            flat=mode.flat,
            enable_pl=enable_pl and not mode.flat,
        )
        n0_alpha = 0.01
    elif mode.demod == "AM":
        demod_cfg = AMConfig.make(
            dsamprate,
            headroom_db=headroom_db,
            recovery_rate_db_s=mode.recovery_rate,
            hangtime_s=mode.hangtime,
        )
        n0_alpha = 0.001
    else:
        demod_cfg = LinearConfig.make(
            dsamprate,
            L_dec,
            headroom_db=headroom_db,
            recovery_rate_db_s=mode.recovery_rate,
            hangtime_s=mode.hangtime,
            pll=mode.pll,
            square=mode.square,
            channels=mode.channels,
            shift_freq=mode.shift / dsamprate,  # set_shift, radio.c:304-311
        )
        n0_alpha = 0.001

    return ReceiverConfig(
        samprate=samprate,
        decimate=decimate,
        mode=mode,
        master=master,
        slave=slave,
        response=response,
        n0_mask=mask,
        n0_alpha=n0_alpha,
        demod_cfg=demod_cfg,
        kaiser_beta=kaiser_beta,
        headroom_db=headroom_db,
        enable_pl=enable_pl,
    )


def receiver_init(cfg: ReceiverConfig, batch_shape=()) -> ReceiverState:
    if cfg.mode.demod == "FM":
        dstate = fm_init(cfg.demod_cfg, batch_shape)
    elif cfg.mode.demod == "AM":
        dstate = am_init(batch_shape)
    else:
        dstate = linear_init(cfg.demod_cfg, batch_shape)
    osc = jax.tree_util.tree_map(
        lambda v: jnp.broadcast_to(v, batch_shape + v.shape), osc_init()
    )
    return ReceiverState(
        overlap=jnp.zeros(batch_shape + (cfg.master.M - 1,), jnp.complex64),
        lo2=osc,
        doppler=osc,
        demod=dstate,
        n0=jnp.full(batch_shape, jnp.nan, jnp.float32),
        if_power=jnp.zeros(batch_shape, jnp.float32),
        gain_factor=jnp.ones(batch_shape, jnp.float32),
    )


def receiver_step(
    cfg: ReceiverConfig,
    state: ReceiverState,
    iq_block: jax.Array,
    response: jax.Array | None = None,
    n0_mask: jax.Array | None = None,
) -> tuple[ReceiverState, jax.Array, dict]:
    """One L-sample block through the full receiver (the hot loop,
    radio.c:106-147 + the demod thread body).

    iq_block: (..., L) complex64 at the input rate, already scaled to
    +/-1.0 full scale (the int16/int8 scaling of radio.c:113-119 happens
    in the host feeder or via `scale_iq`).

    response / n0_mask override the config's baked-in filter response and
    passband mask — passed as runtime arrays so a live set_filter edit
    (display.c:161-180 / set_filter, filter.c:500-546) hot-swaps the
    response without recompiling the program, exactly as the reference
    swaps the response pointer under a mutex (filter.c:537-543).
    """
    samp = iq_block * state.gain_factor[..., None]
    # block_energy * 0.5 / in_cnt (two components per sample, radio.c:143-144)
    if_power = 0.5 * jnp.mean(
        jnp.real(samp) ** 2 + jnp.imag(samp) ** 2, axis=-1
    )

    # Second LO and Doppler (radio.c:131-136); both keep phase through gaps
    lo2, lo = osc_block(state.lo2, cfg.L)
    samp = samp * lo
    doppler, dlo = osc_block(state.doppler, cfg.L)
    samp = samp * dlo

    overlap, fdomain = master_execute(cfg.master, state.overlap, samp)

    if n0_mask is None:
        n0_mask = jnp.asarray(cfg.n0_mask)
    n0_raw = compute_n0(fdomain, n0_mask, cfg.samprate)
    n0 = jnp.where(
        jnp.isnan(state.n0),
        n0_raw,
        state.n0 + cfg.n0_alpha * (n0_raw - state.n0),
    )

    if response is None:
        response = jnp.asarray(cfg.response)
    baseband = slave_execute(cfg.slave, fdomain, response)

    if cfg.mode.demod == "FM":
        dstate, audio, diag = fm_demod(cfg.demod_cfg, state.demod, baseband)
    elif cfg.mode.demod == "AM":
        dstate, audio, diag = am_demod(cfg.demod_cfg, state.demod, baseband)
    else:
        dstate, audio, diag = linear_demod(cfg.demod_cfg, state.demod, baseband)

    diag = dict(diag)
    diag["n0"] = n0
    diag["if_power"] = if_power
    # 128-bin peak-held power spectrum of the master FFT, ordered
    # -fs/2..+fs/2, for the display's spectrum pane (costs one reshape+max
    # on data the FFT already produced)
    ps = jnp.real(fdomain) ** 2 + jnp.imag(fdomain) ** 2
    ps = jnp.fft.fftshift(ps)
    nb = 128
    trim = (ps.shape[-1] // nb) * nb
    diag["psd128"] = jnp.max(ps[..., :trim].reshape(ps.shape[:-1] + (nb, -1)),
                             axis=-1)

    new_state = ReceiverState(
        overlap=overlap,
        lo2=lo2,
        doppler=doppler,
        demod=dstate,
        n0=n0,
        if_power=if_power,
        gain_factor=state.gain_factor,
    )
    return new_state, audio, diag


def receiver_scan(cfg: ReceiverConfig, state: ReceiverState, blocks):
    """Offline batch path: lax.scan the receiver over many blocks in ONE
    device program — no per-block dispatch or transfer round trips.  The
    The equivalent of replaying a recording through `radio` faster
    than real time (iqplay -> radio, SURVEY.md §4).

    blocks: (nblocks, L) complex.  Returns (final_state, audio) with
    audio stacked (nblocks, ...).  Diagnostics are dropped in this mode
    (they exist per block; fetch the final state instead)."""

    def step(st, blk):
        st2, audio, _ = receiver_step(cfg, st, blk)
        return st2, audio

    return jax.lax.scan(step, state, blocks)


def receiver_scan_packed(cfg: ReceiverConfig, template):
    """receiver_scan with the real-dtype jit boundary: int16 (nblocks, L, 2)
    in, float32 audio out."""
    from ..ops.packing import tree_c2r, tree_r2c

    def packed(state_r, x_i16):
        x = x_i16.astype(jnp.float32) * jnp.float32(SCALE16)
        blocks = jax.lax.complex(x[..., 0], x[..., 1])
        state = tree_r2c(state_r, template)
        new_state, audio = receiver_scan(cfg, state, blocks)
        return tree_c2r(new_state), audio

    return packed


def scale_iq(raw: jax.Array, bits: int = 16) -> jax.Array:
    """int16/int8 interleaved I/Q -> complex64 full scale (radio.c:106-120).
    raw: (..., 2n) int array, I/Q interleaved."""
    scale = SCALE16 if bits == 16 else SCALE8
    x = raw.astype(jnp.float32) * scale
    return jax.lax.complex(x[..., 0::2], x[..., 1::2])


@dataclass
class SDRStatus:
    """Mirror of the front end's TLV status (struct sdr, radio.h), as used
    by the tuning math (radio.c:200-284).  Until the front end reports its
    alias keep-out, default to IF_EXCLUDE x Nyquist (radio.c:28) scaled to
    the actual sample rate (the funcube reports +/-91.2 kHz at 192 kHz)."""

    samprate: int = 192000
    frequency: float = 0.0   # LO1, Hz
    min_IF: float = float("nan")
    max_IF: float = float("nan")

    def __post_init__(self):
        if np.isnan(self.min_IF):
            self.min_IF = -IF_EXCLUDE * self.samprate / 2
        if np.isnan(self.max_IF):
            self.max_IF = IF_EXCLUDE * self.samprate / 2


def receiver_step_packed(cfg: ReceiverConfig, template):
    """receiver_step with a real-dtype-only jit boundary (see
    ops.packing).
    The filter response and n0 mask are runtime arguments so set_filter
    hot-swaps them without recompiling."""
    from ..ops.packing import tree_c2r, tree_r2c, r2c

    def packed(state_r, x_r, resp_r, n0_mask):
        state = tree_r2c(state_r, template)
        new_state, audio, diag = receiver_step(
            cfg, state, r2c(x_r), response=r2c(resp_r), n0_mask=n0_mask
        )
        return tree_c2r(new_state), audio, diag

    return packed


class Receiver:
    """Host-side receiver wrapper: owns config, state, the jitted step, and
    the control-plane tuning functions of radio.c.

    State crosses the jit boundary packed as float32 (...,2) pairs; complex
    math lives entirely inside the program (see receiver_step_packed).
    Control-plane functions edit the packed state host-side (the leaves
    they touch — oscillator frequency words, gain — are real anyway)."""

    def __init__(self, cfg: ReceiverConfig):
        from ..ops.packing import tree_c2r_np

        self.cfg = cfg
        self._template = jax.tree_util.tree_map(np.asarray, receiver_init(cfg))
        self.state = tree_c2r_np(self._template)
        self.sdr = SDRStatus(samprate=cfg.samprate)
        self.tune_freq = 0.0
        self.second_lo = 0.0   # LO2 Hz, mirrored for status emission
        self._step = jax.jit(receiver_step_packed(cfg, self._template))
        self._load_filter_args()

    def _load_filter_args(self) -> None:
        """Pack the current response/mask into the runtime filter args,
        device-resident (numpy args would re-upload ~1 MB per block)."""
        r = np.asarray(self.cfg.response)
        self._resp_r = jax.device_put(
            np.stack([r.real, r.imag], axis=-1).astype(np.float32)
        )
        self._n0_mask = jax.device_put(np.asarray(self.cfg.n0_mask))

    def process(self, iq_block):
        """Run one L-sample complex block; returns (audio, diag)."""
        x = np.asarray(iq_block)
        x_r = np.stack([x.real, x.imag], axis=-1).astype(np.float32)
        self.state, audio, diag = self._step(
            self.state, x_r, self._resp_r, self._n0_mask
        )
        return audio, diag

    # ---- control plane (radio.c:200-316) ----

    def lo2_in_range(self, f: float, avoid_alias: bool) -> bool:
        """LO2_in_range (radio.c:273-284)."""
        if avoid_alias:
            return (
                f >= self.sdr.min_IF + max(0.0, self.cfg.mode.high)
                and f <= self.sdr.max_IF + min(0.0, self.cfg.mode.low)
            )
        return abs(f) <= 0.5 * self.cfg.samprate

    def set_second_lo(self, second_lo: float) -> None:
        """set_second_LO (radio.c:290-301); phase is preserved."""
        self.second_lo = float(second_lo)
        f = 0.0 if second_lo == 0 else second_lo / self.cfg.samprate
        self.state = self.state._replace(lo2=set_osc(self.state.lo2, f))

    def set_doppler(self, freq: float, rate: float) -> None:
        """set_doppler (radio.c:180-184)."""
        fs = self.cfg.samprate
        self.state = self.state._replace(
            doppler=set_osc(self.state.doppler, -freq / fs, -rate / (fs * fs))
        )

    def set_freq(self, f: float, new_lo2: float = np.nan) -> Optional[float]:
        """set_freq (radio.c:204-242).  Tuning model: RF = LO1 - LO2.

        Returns the LO1 frequency the front end must move to, or None if
        LO2 absorbed the whole retune.  The caller sends the LO1 command
        over the control channel (net.status) when not None.
        """
        self.tune_freq = f
        lo1 = self.sdr.frequency
        if np.isnan(new_lo2) or not self.lo2_in_range(new_lo2, False):
            new_lo2 = -(f - lo1)
            if not self.lo2_in_range(new_lo2, True):
                new_lo2 = self.sdr.samprate / 4.0
        new_lo1 = f + new_lo2
        command = None
        if new_lo1 != lo1 and new_lo1 > 0:
            command = new_lo1
        if self.lo2_in_range(new_lo2, False):
            self.set_second_lo(new_lo2)
        return command

    def update_first_lo(self, actual_lo1: float) -> None:
        """Front-end status reported a (possibly quantized) LO1; retune LO2
        to compensate so RF stays put (radio_status.c:311-316)."""
        if self.sdr.frequency != actual_lo1:
            self.sdr.frequency = actual_lo1
            new_lo2 = -(self.tune_freq - actual_lo1)
            if self.lo2_in_range(new_lo2, False):
                self.set_second_lo(new_lo2)

    def set_gain_factor(self, g: float) -> None:
        self.state = self.state._replace(
            gain_factor=jnp.float32(g)
        )

    def set_filter(
        self,
        low: float | None = None,
        high: float | None = None,
        kaiser_beta: float | None = None,
    ) -> None:
        """Live filter edit (display.c:161-180 items 4/5/7 + 'k' key →
        set_filter, filter.c:500-546): redesign the slave response and the
        n0 passband mask and hot-swap them into the running program — no
        recompile, matching the reference's response-pointer swap under
        mutex (filter.c:537-543).  The FM audio gain constant IS
        recomputed from the new edges: fm.c:85-86 derives it from the
        current bandwidth every block ("We do this in the loop because
        BW can change")."""
        from dataclasses import replace as dc_replace

        mode = self.cfg.mode
        low = mode.low if low is None else float(low)
        high = mode.high if high is None else float(high)
        # Same validation as bank.swap_filter_response: np.i0 overflows
        # for beta beyond ~226 and make_kaiser returns all-NaN taps
        # WITHOUT raising, and NaN edges sail through the < swap — either
        # would NaN-poison every subsequent block's audio.
        if not (np.isfinite(low) and np.isfinite(high)):
            raise ValueError(f"non-finite filter edges: {low!r}, {high!r}")
        if high < low:
            low, high = high, low
        beta = (self.cfg.kaiser_beta if kaiser_beta is None
                else float(kaiser_beta))
        # isfinite BEFORE the clamp: max(0.0, nan) silently returns 0.0
        if not np.isfinite(beta) or beta > 100.0:
            raise ValueError(f"kaiser_beta out of range: {beta!r}")
        beta = max(0.0, beta)
        dsr = self.cfg.dsamprate
        response = set_filter_response(
            self.cfg.slave, low / dsr, high / dsr, beta
        )
        mask = passband_mask(self.cfg.master.N, self.cfg.samprate, low, high)
        demod_cfg = self.cfg.demod_cfg
        if mode.demod == "FM" and high != low:
            # fm.c recomputes the audio gain from the CURRENT edges every
            # block ("We do this in the loop because BW can change",
            # fm.c:85-86); a baked constant would leave the level ~8 dB
            # off after a live bandwidth change
            headroom = 10.0 ** (self.cfg.headroom_db / 20.0)
            demod_cfg = demod_cfg._replace(
                gain=float(headroom * (1.0 / np.pi) * self.cfg.dsamprate
                           / abs(low - high))
            )
        self.cfg = self.cfg._replace(
            mode=dc_replace(mode, low=low, high=high),
            response=response,
            n0_mask=mask,
            kaiser_beta=beta,
            demod_cfg=demod_cfg,
        )
        # the offline scan bakes the response in as a constant — retrace
        if hasattr(self, "_scan"):
            del self._scan
        self._load_filter_args()

    def set_shift(self, shift_hz: float) -> None:
        """Post-detection frequency shift (set_shift, radio.c:304-316):
        retune the linear demod's shift oscillator without phase jump.
        No-op for AM/FM (the reference's shift applies to linear only)."""
        if self.cfg.mode.demod != "LINEAR":
            return
        from dataclasses import replace as dc_replace

        new_shift = set_osc(
            self.state.demod.shift, shift_hz / self.cfg.dsamprate
        )
        self.state = self.state._replace(
            demod=self.state.demod._replace(shift=new_shift)
        )
        self.cfg = self.cfg._replace(
            mode=dc_replace(self.cfg.mode, shift=float(shift_hz))
        )

    def set_options(self, **changes) -> None:
        """Option-flag edits (display.c:958-986 'o' key: isb, pll, square,
        flat, mono/stereo; plus AGC recovery_rate/hangtime from the mode
        table).  These change program structure, so the config and jitted
        step rebuild (the reference respawns the demod thread for isb via
        the out_type copy at linear.c:116-120); tuning state carries over.

        Accepted keys: isb, pll, square, flat, channels (1/2),
        recovery_rate (dB/s), hangtime (s), headroom_db (dB)."""
        from dataclasses import replace as dc_replace

        headroom = changes.pop("headroom_db", self.cfg.headroom_db)
        if changes.get("square"):
            changes["pll"] = True   # square implies pll (display.c:966-969)
        mode = dc_replace(self.cfg.mode, **changes)
        self._rebuild(mode, headroom_db=headroom)

    def set_blocksize(self, L: int, M: int | None = None) -> None:
        """Blocksize change (display.c:866-886 'b' key): M defaults to
        L+1 as the reference does; demod restarts (set_mode semantics),
        the overlap resets (its length changed), tuning oscillators and
        gain carry over."""
        from ..ops.packing import tree_c2r_np

        old_packed = self.state
        cfg = make_receiver_config(
            self.cfg.mode,
            samprate=self.cfg.samprate,
            out_rate=int(self.cfg.dsamprate),
            L=int(L),
            M=int(M) if M is not None else int(L) + 1,
            kaiser_beta=self.cfg.kaiser_beta,
            headroom_db=self.cfg.headroom_db,
            enable_pl=self.cfg.enable_pl,
        )
        self.cfg = cfg
        self._template = jax.tree_util.tree_map(np.asarray, receiver_init(cfg))
        fresh = tree_c2r_np(self._template)
        self.state = fresh._replace(
            lo2=old_packed.lo2,
            doppler=old_packed.doppler,
            gain_factor=old_packed.gain_factor,
        )
        self._step = jax.jit(receiver_step_packed(cfg, self._template))
        if hasattr(self, "_scan"):
            del self._scan
        self._load_filter_args()

    def set_mode(self, mode: str) -> None:
        """Runtime mode change (set_mode, radio.c:322-374): the reference
        kills and respawns the demod thread; here the config and jitted
        program rebuild.  Tuning oscillators keep their phase; demod state
        resets (as a fresh thread's would)."""
        if isinstance(mode, str):
            mode = DEFAULT_MODES[mode.upper()]
        self._rebuild(mode, headroom_db=self.cfg.headroom_db)

    def _rebuild(self, mode: ModeDef, headroom_db: float) -> None:
        from ..ops.packing import tree_c2r_np

        old_packed = self.state
        cfg = make_receiver_config(
            mode,
            samprate=self.cfg.samprate,
            out_rate=int(self.cfg.dsamprate),
            L=self.cfg.master.L,
            M=self.cfg.master.M,
            kaiser_beta=self.cfg.kaiser_beta,
            headroom_db=headroom_db,
            enable_pl=self.cfg.enable_pl,
        )
        self.cfg = cfg
        self._template = jax.tree_util.tree_map(np.asarray, receiver_init(cfg))
        fresh = tree_c2r_np(self._template)
        # carry oscillator phases and the master overlap across the switch
        self.state = fresh._replace(
            overlap=old_packed.overlap,
            lo2=old_packed.lo2,
            doppler=old_packed.doppler,
            gain_factor=old_packed.gain_factor,
        )
        self._step = jax.jit(receiver_step_packed(cfg, self._template))
        if hasattr(self, "_scan"):
            del self._scan
        self._load_filter_args()

    def process_offline(self, blocks_i16: np.ndarray) -> np.ndarray:
        """Batch-demodulate (nblocks, L, 2) int16 I/Q in one device
        program (receiver_scan): the fast path for recordings."""
        if not hasattr(self, "_scan"):
            self._scan = jax.jit(receiver_scan_packed(self.cfg, self._template))
        self.state, audio = self._scan(self.state, blocks_i16)
        return np.asarray(audio)


def make_receiver(mode: str = "FM", **kw) -> Receiver:
    return Receiver(make_receiver_config(mode, **kw))
