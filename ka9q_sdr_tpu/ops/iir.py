"""First-order recurrences as parallel (associative) scans.

The reference's per-sample IIRs — the AM carrier DC filter (am.c:62),
smoothed noise/power estimators, and the experimental complex notch
(filter.c:551-571) — are all one-pole linear recurrences
``y_n = (1-a) y_{n-1} + a x_n``.  A sequential per-sample loop serialises
the device; a linear recurrence is exactly `lax.associative_scan`, which
runs in O(log n) depth and vectorises across channels.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .nco import OscState, osc_block

__all__ = ["one_pole_lowpass", "dc_block", "NotchState", "notch_init", "notch_block"]


def one_pole_lowpass(y0: jax.Array, x: jax.Array, alpha: float, axis: int = -1):
    """y_n = y_{n-1} + alpha * (x_n - y_{n-1}), returning (y_last, y[0..n-1]).

    y_n includes the update from x_n (post-update value), matching the
    reference's ``state += alpha * (x - state)`` then read-back ordering.
    """
    a = jnp.asarray(alpha, dtype=x.real.dtype)
    decay = jnp.broadcast_to(1.0 - a, x.shape).astype(x.dtype)
    drive = a * x
    # Fold the initial condition into the first element.
    drive0 = jnp.take(drive, jnp.array(0), axis=axis) + (1.0 - a) * y0
    drive = _set_index(drive, 0, drive0, axis)

    def combine(c1, c2):
        a1, b1 = c1
        a2, b2 = c2
        return a1 * a2, a2 * b1 + b2

    _, y = jax.lax.associative_scan(combine, (decay, drive), axis=axis)
    y_last = jnp.take(y, jnp.array(y.shape[axis] - 1), axis=axis)
    return y_last, y


def _set_index(x, i, val, axis):
    idx = [slice(None)] * x.ndim
    idx[axis] = i
    return x.at[tuple(idx)].set(val)


def dc_block(dc0: jax.Array, x: jax.Array, coeff: float):
    """AM carrier removal (am.c:60-62,74): tracks the envelope DC with a
    one-pole filter and returns (dc_last, dc_trace) where dc_trace[n] is the
    post-update DC estimate used for sample n."""
    return one_pole_lowpass(dc0, x, coeff)


class NotchState(NamedTuple):
    """Experimental IIR complex notch (struct notchfilter, filter.h:96-101)."""

    osc: OscState
    dcstate: jax.Array  # complex64 smoothed signal estimate at the notch freq
    bw: jax.Array       # float32 relative bandwidth


def notch_init(f: float, bw: float) -> NotchState:
    """notch_create (filter.c:551-561); f in cycles/sample."""
    from .nco import osc_init, set_osc

    return NotchState(
        osc=set_osc(osc_init(), f),
        dcstate=jnp.complex64(0.0),
        bw=jnp.float32(bw),
    )


def notch_block(state: NotchState, x: jax.Array):
    """Vectorised notch (filter.c:563-571): spin down by the oscillator,
    subtract the running DC estimate (pre-update, as in the C), update the
    estimate, spin back up."""
    n = x.shape[-1]
    new_osc, ph = osc_block(state.osc, n)
    u = x * jnp.conj(ph)
    # dc_n used for sample n is the *pre-update* state: shift the trace.
    dc_last, dc_post = one_pole_lowpass(state.dcstate, u, state.bw)
    dc_pre = jnp.concatenate(
        [jnp.broadcast_to(state.dcstate, u.shape[:-1] + (1,)), dc_post[..., :-1]],
        axis=-1,
    )
    out = (u - dc_pre) * ph
    return NotchState(new_osc, dc_last, state.bw), out
