"""Half-band decimator cascade for power-of-2 sample-rate reduction.

JAX equivalent of the reference's hand-written SSE decimators
(decimate.c) as used by the hackrf front end (hackrf.c:229-238, 295-318):
a cascade of decimate-by-2 half-band FIR stages — a cheap 3-tap (1,2,1)
stage for the early (wideband) stages and the Goodman/Carey "F8" folded
15-tap filter for the final stages (stage_threshold picks the crossover,
hackrf.c:76).

Here each stage is a strided FIR evaluated as weighted strided slices
(no matrix product); state is the carried
(ntaps-1)-sample overlap per stage, so the cascade is a pure function
suitable for lax.scan streaming.

Each stage has +6 dB DC gain (unity middle tap); the reference compensates
with Filter_atten = 0.5^stages (hackrf.c:469), which callers apply.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["hb15_coeffs", "hb15_block", "hb3_block", "hb_cascade", "cascade_init"]


def hb15_coeffs() -> np.ndarray:
    """Goodman/Carey F8 15-tap half-band taps (hackrf.c:230-238).

    coeffs[3]=490/802 is adjacent to the unity centre tap; even taps are 0.
    """
    c = np.array([-6.0, 33.0, -116.0, 490.0]) / 802.0
    taps = np.zeros(15)
    taps[7] = 1.0  # unity centre tap
    for i, cv in enumerate(c):  # i=0 at the tails (offset 7,5,3,1)
        off = 7 - 2 * i
        taps[7 - off] = cv
        taps[7 + off] = cv
    return taps


_HB3_TAPS = np.array([1.0, 2.0, 1.0])


def _fir_decim2(state: jax.Array, x: jax.Array, taps: np.ndarray):
    """Decimate-by-2 FIR: y[k] = sum_j taps[j] * xx[2k + j] with
    xx = [carried overlap | x].  Returns (new_state, y).

    Computed as weighted strided SLICES (one per nonzero tap — half-band
    filters have zero even taps, so hb15 is 9 terms, hb3 is 3): plain
    elementwise multiply-adds in the input dtype.  No matrix product, so
    no reduced-precision matmul mode (bf16 or TF32) can touch the
    cascade."""
    ntaps = len(taps)
    if x.shape[-1] % 2:
        # an odd block would silently shift the decimation grid one
        # sample for every later block (n_out drops the tail, the carried
        # state advances past it) — fail loudly instead
        raise ValueError(f"decimate-by-2 needs an even block, got "
                         f"{x.shape[-1]}")
    xx = jnp.concatenate([state, x], axis=-1)
    n_out = x.shape[-1] // 2
    y = None
    for j, tap in enumerate(taps):
        if tap == 0.0:
            continue
        sl = jax.lax.slice_in_dim(xx, j, j + 2 * n_out, stride=2, axis=-1)
        term = sl if tap == 1.0 else sl * jnp.asarray(tap, x.dtype)
        y = term if y is None else y + term
    new_state = xx[..., x.shape[-1]:]
    return new_state, y


def hb15_block(state: jax.Array, x: jax.Array):
    """15-tap half-band decimate-by-2 (hb15_block, decimate.c:111-146).
    state carries 14 samples."""
    return _fir_decim2(state, x, hb15_coeffs())


def hb3_block(state: jax.Array, x: jax.Array):
    """3-tap (1,2,1) half-band decimate-by-2 (hb3_block, decimate.c:148-161).
    state carries 2 samples."""
    return _fir_decim2(state, x, _HB3_TAPS)


def cascade_init(
    log_decimate: int, stage_threshold: int = 8, dtype=jnp.float32, batch_shape=()
) -> list[jax.Array]:
    """Zero state for a 2^log_decimate cascade.  Stages are ordered from the
    widest-band (first) to the final stage; early stages (index >=
    stage_threshold counting as in hackrf.c:295-299) use the 3-tap filter."""
    states = []
    for stage in range(log_decimate - 1, -1, -1):
        ntaps = 3 if stage >= stage_threshold else 15
        states.append(jnp.zeros(batch_shape + (ntaps - 1,), dtype=dtype))
    return states


def hb_cascade(
    states: list[jax.Array], x: jax.Array, log_decimate: int, stage_threshold: int = 8
):
    """Run a full 2^log_decimate decimation cascade (hackrf.c:295-318).

    Returns (new_states, y) with y decimated by 2^log_decimate.  Gain is
    2^log_decimate at DC; apply 0.5^log_decimate to compensate
    (Filter_atten, hackrf.c:469).
    """
    new_states = []
    i = 0
    for stage in range(log_decimate - 1, -1, -1):
        fn = hb3_block if stage >= stage_threshold else hb15_block
        s, x = fn(states[i], x)
        new_states.append(s)
        i += 1
    return new_states, x
