"""Multi-device sharding for the channel bank.

The reference scales by adding consumer *processes* on the multicast LAN
(SURVEY.md §2.7).  Here the scaling axis is the channel dimension of the
bank sharded over a `jax.sharding.Mesh`: every device holds the replicated
wideband block, computes the (replicated) forward FFT, and gathers/IFFTs/
demodulates only its shard of channels — no collectives in the steady
state, so the interconnect stays idle and scaling is embarrassingly
linear.
"""

from .mesh import (
    make_channel_mesh,
    bank_state_shardings,
    shard_bank_state,
    make_sharded_bank_step,
    pad_channels,
)
from .dfft import make_dfft, dfft, undo_comb
