"""AM envelope demodulator — JAX equivalent of am.c.

The C loop (am.c:51-75) is, per decimated sample: envelope = |s|, one-pole
DC (carrier) tracker, hang-AGC gain update driven by the DC estimate, and
output (envelope - DC) * gain.  Here the envelope is one vectorised block
op, the DC tracker is an associative scan (ops.iir), and the AGC is the
shared scan kernel (ops.agc).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.agc import AGCParams, AGCState, agc_init, agc_block
from ..ops.iir import one_pole_lowpass

__all__ = ["AMConfig", "AMState", "am_init", "am_demod", "DC_FILTER_COEFF"]

#: Envelope DC tracker coefficient (am.c:34).
DC_FILTER_COEFF = 1e-4


class AMConfig(NamedTuple):
    """Static AM demod configuration (derived from the mode table row and
    the output sample rate, am.c:21-34)."""

    agc: AGCParams
    dc_coeff: float = DC_FILTER_COEFF

    @classmethod
    def make(
        cls,
        dsamprate: float,
        headroom_db: float = -15.0,
        recovery_rate_db_s: float = 50.0,
        hangtime_s: float = 0.0,
    ) -> "AMConfig":
        return cls(
            agc=AGCParams.from_mode(
                headroom_db, recovery_rate_db_s, hangtime_s, 1.0 / dsamprate
            )
        )


class AMState(NamedTuple):
    dc: jax.Array   # float32, envelope DC estimate (am.c:33)
    agc: AGCState


def am_init(batch_shape=()) -> AMState:
    """Initial state: DC 0, gain 80 dB (am.c:30,33)."""
    return AMState(
        dc=jnp.zeros(batch_shape, jnp.float32),
        agc=agc_init(80.0, batch_shape),
    )


def am_demod(
    cfg: AMConfig, state: AMState, baseband: jax.Array
) -> tuple[AMState, jax.Array, dict]:
    """One block (am.c:51-78).

    baseband: (..., n) complex64 slave-filter output.  Returns
    (state, mono_audio, diag) with diag.bb_power matching am.c:78.
    """
    sampsq = jnp.real(baseband) ** 2 + jnp.imag(baseband) ** 2
    envelope = jnp.sqrt(sampsq)
    dc_last, dc = one_pole_lowpass(state.dc, envelope, cfg.dc_coeff)
    new_agc, gain = agc_block(state.agc, dc, cfg.agc)
    audio = (envelope - dc) * gain
    n = baseband.shape[-1]
    diag = {
        "bb_power": jnp.sum(sampsq, axis=-1) / (2.0 * n),
        "gain": new_agc.gain,
    }
    return AMState(dc_last, new_agc), audio, diag
