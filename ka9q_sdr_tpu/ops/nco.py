"""Phase-continuous complex NCO as vectorised phase ramps.

Re-design of the reference oscillator (osc.c) for block-parallel devices:

The reference steps a complex-double phasor once per sample under a mutex
(osc.c:39-51), renormalising every 16384 steps.  Here we need (a) a whole
block of oscillator samples at once, (b) exact phase continuity across
blocks and retunes (osc.c:24-27 keeps phase on retune), and (c) no float64
in the hot path (float64 is slow or absent on accelerators).

Design: the phase accumulator is a **fixed-point uint32** in units of
2^-32 cycles.  Integer multiply-add wraps mod 2^32, which is exactly
"phase mod 1 cycle" — no drift, no renormalisation, bit-exact continuity
across arbitrarily many blocks inside `lax.scan`.  Converting the top 24
bits to float32 for sin/cos bounds phase error at 2^-25 cycles (~-128 dB
spurs), far below the reference's own float32 noise floor.

Frequency sweep (Doppler, osc.c phasor_step_step) is carried as a float32
residual frequency plus a float32 rate; the quadratic in-block term and the
per-block frequency update are tiny and fit comfortably in f32 (see
osc_advance).  Units follow the reference: cycles/sample and
cycles/sample^2 (set_osc, osc.c:22).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "OscState",
    "osc_init",
    "set_osc",
    "set_osc_traced",
    "split_double",
    "phase_ramp",
    "osc_block",
    "nco_mix",
    "osc_advance",
]

_TWO32 = float(2**32)


class OscState(NamedTuple):
    """Functional oscillator state (cf. struct osc, osc.h:9-17)."""

    phase: jax.Array       # uint32, phase in 2^-32 cycles
    freq: jax.Array        # uint32, frequency in 2^-32 cycles/sample
    freq_resid: jax.Array  # float32, sub-ulp frequency residual (cycles/sample)
    rate: jax.Array        # float32, sweep rate (cycles/sample^2)
    phase_resid: jax.Array  # float32, sub-ulp phase residual (cycles)


def split_double(f: float) -> tuple[int, float]:
    """Split a float64 frequency (cycles/sample) into a uint32 fixed-point
    part and a float32-safe residual.  |residual| <= 2^-33 cycles/sample."""
    fm = float(np.float64(f) % 1.0)
    hi_raw = int(np.round(fm * _TWO32))
    # residual against the UNWRAPPED rounding: fm within 2^-33 below 1.0
    # rounds to 2^32 -> hi 0, and the residual must be the tiny negative
    # remainder, not ~1.0 (which would blow the |resid| <= 2^-33 contract)
    resid = float(fm - hi_raw / _TWO32)
    return hi_raw % (2**32), resid


def osc_init() -> OscState:
    """Zero-frequency oscillator with phase 0 (phasor = 1)."""
    return OscState(
        phase=jnp.uint32(0),
        freq=jnp.uint32(0),
        freq_resid=jnp.float32(0.0),
        rate=jnp.float32(0.0),
        phase_resid=jnp.float32(0.0),
    )


def set_osc(state: OscState, f: float, r: float = 0.0) -> OscState:
    """Retune without phase jump (set_osc, osc.c:22-36).

    f in cycles/sample, r in cycles/sample^2, both host floats (retunes are
    control-plane events).  The existing phase accumulator is preserved.
    """
    hi, resid = split_double(f)
    return OscState(
        phase=state.phase,
        freq=jnp.uint32(hi),
        freq_resid=jnp.float32(resid),
        rate=jnp.float32(r),
        phase_resid=state.phase_resid,
    )


def set_osc_traced(state: OscState, f: jax.Array, r=0.0) -> OscState:
    """In-jit retune for feedback loops (the PLL's per-block set_osc calls,
    linear.c:198,234).

    `f` is a traced float32 frequency in cycles/sample.  Control-loop
    frequencies are small (|f| << 1), so the whole frequency lives in the
    float32 residual; the fixed-point word is zeroed.  Phase is preserved
    (osc.c:24-27 semantics).  osc_advance folds the residual into the exact
    accumulator every block, so long-run phase still wraps correctly.
    """
    f = jnp.asarray(f, jnp.float32)
    # zeros_like/broadcast keep the batch shape of a vmapped/sharded state —
    # a scalar here would silently collapse the (B,) leaves of a bank.
    return OscState(
        phase=state.phase,
        freq=jnp.zeros_like(state.phase),
        freq_resid=jnp.broadcast_to(f, state.phase.shape),
        rate=jnp.broadcast_to(jnp.asarray(r, jnp.float32), state.phase.shape),
        phase_resid=state.phase_resid,
    )


def phase_ramp(state: OscState, n: int) -> jax.Array:
    """Phases (in cycles, float32) of the next n oscillator samples.

    phase_k = phi0 + k*f + k(k-1)/2 * r, evaluated with the integer part in
    exact uint32 arithmetic and the residual/sweep parts in float32.
    Broadcasts over batched oscillator state: leaves of shape (...,)
    produce a (..., n) ramp.
    """
    k32 = jnp.arange(n, dtype=jnp.uint32)
    fixed = state.phase[..., None] + k32 * state.freq[..., None]
    kf = jnp.arange(n, dtype=jnp.float32)
    frac = (
        state.phase_resid[..., None]
        + kf * state.freq_resid[..., None]
        + (kf * (kf - 1.0) * 0.5) * state.rate[..., None]
    )
    out = fixed.astype(jnp.float32) * jnp.float32(1.0 / _TWO32) + frac
    return out if state.phase.ndim else out.reshape(n)


def osc_block(state: OscState, n: int) -> tuple[OscState, jax.Array]:
    """Next n oscillator samples as complex64, plus the advanced state.

    Equivalent to n calls of step_osc (osc.c:39-51), vectorised.
    """
    ph = phase_ramp(state, n)
    ang = (2.0 * np.pi) * ph
    out = jax.lax.complex(jnp.cos(ang), jnp.sin(ang))
    return osc_advance(state, n), out


def osc_advance(state: OscState, n: int) -> OscState:
    """Advance the oscillator by n samples without generating output
    (the reference keeps LOs stepping through zero-filled gaps,
    radio.c:88-99)."""
    n32 = jnp.uint32(n)
    nf = jnp.float32(n)
    # float-side phase advance from residual + sweep, folded into the
    # fixed-point accumulator
    extra = (
        state.phase_resid
        + nf * state.freq_resid
        + (nf * (nf - 1.0) * 0.5) * state.rate
    )
    # Drop whole cycles BEFORE the fixed-point conversion: set_osc_traced
    # keeps the entire PLL frequency in freq_resid, so extra can be many
    # cycles per block and round(extra*2^32) would saturate int32 at
    # |extra| >= 0.5, jumping the LO phase arbitrarily at every block
    # boundary.  Phase is modulo one cycle, so the fold is exact.
    extra = extra - jnp.round(extra)
    extra_fx = jnp.round(extra * _TWO32)
    new_phase = (
        state.phase
        + n32 * state.freq
        + extra_fx.astype(jnp.int32).astype(jnp.uint32)
    )
    new_phase_resid = extra - extra_fx * jnp.float32(1.0 / _TWO32)
    # frequency advance from sweep: f' = f + n*r, renormalising the residual
    y = state.freq_resid + nf * state.rate
    df = jnp.round(y * _TWO32)
    new_freq = state.freq + df.astype(jnp.int32).astype(jnp.uint32)
    new_resid = y - df * jnp.float32(1.0 / _TWO32)
    return OscState(new_phase, new_freq, new_resid, state.rate, new_phase_resid)


def nco_mix(state: OscState, x: jax.Array) -> tuple[OscState, jax.Array]:
    """Multiply a block by the oscillator (the per-sample
    `samp *= step_osc(...)` of radio.c:132-136, vectorised)."""
    n = x.shape[-1]
    new_state, lo = osc_block(state, n)
    return new_state, x * lo
