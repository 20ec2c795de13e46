"""Demodulators and receivers built from the DSP primitives.

JAX equivalents of the reference's demod threads and receiver:

- ``noise``        — out-of-passband noise density estimate (radio.c:383-425)
- ``demod_am``     — AM envelope detector + hang AGC (am.c)
- ``demod_fm``     — FM discriminator, squelch, de-emphasis, PL tone (fm.c)
- ``demod_linear`` — SSB/CW/IQ/ISB/coherent modes with PLL (linear.c)
- ``receiver``     — single-channel receiver pipeline (radio.c proc_samples)
- ``bank``         — wideband multichannel bank (the flagship)

Every demodulator is a pure block function ``(cfg, state, baseband) ->
(state, audio, diag)`` where cfg is static (hashable, closed over by jit),
state is a pytree of arrays, and baseband is one block of decimated complex
samples from the slave filter.  All are vmap-able over a leading channel
axis; the reference's thread-per-demod becomes a batch axis.
"""

from .noise import compute_n0, passband_mask
from .demod_am import AMConfig, AMState, am_init, am_demod
from .demod_fm import FMConfig, FMState, fm_init, fm_demod
from .demod_linear import (
    LinearConfig,
    LinearState,
    linear_init,
    linear_demod,
)
from .receiver import (
    ReceiverConfig,
    ReceiverState,
    Receiver,
    make_receiver,
)
from .bank import BankConfig, BankState, ChannelBank, MultiBank, make_bank
