"""Device-mesh utilities: shard the channel bank's channel axis.

Design (SURVEY.md §5 "long-context"): the per-block work is one shared
wideband FFT plus per-channel gather/IFFT/demod.  The FFT is cheap relative
to HBM traffic and replicating it avoids any collective, so the sharding is:

- wideband input block + master overlap: fully replicated;
- every per-channel state leaf (bin shifts, NCO phases, demod state) and
  the audio output: sharded on the leading channel axis.

XLA then partitions the gather and the batched IFFTs/demods across devices
with zero communication.  When the wideband FFT itself dominates (north
star >100 Msps), make_sharded_bank_step's `shard_fft=True` distributes the
master FFT too (_bank_step_packed_dfft): the two-step decomposition in
parallel.dfft computes a comb-distributed spectrum with one reduce_scatter
over the interconnect (NVLink) and each device gathers its channels'
bins straight from the comb.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.bank import BankConfig, BankState, bank_step_packed

__all__ = [
    "make_channel_mesh",
    "bank_state_shardings",
    "shard_bank_state",
    "make_sharded_bank_step",
    "pad_channels",
]

CHANNEL_AXIS = "ch"


def make_channel_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (CHANNEL_AXIS,))


def bank_state_shardings(mesh: Mesh, state: BankState) -> BankState:
    """Sharding pytree matching a (packed or unpacked) BankState: channel
    leaves on the mesh axis, shared leaves replicated."""
    rep = NamedSharding(mesh, P())

    def ch_of(leaf):
        return NamedSharding(
            mesh, P(CHANNEL_AXIS, *([None] * (np.ndim(leaf) - 1)))
        )

    ch_tree = lambda t: jax.tree_util.tree_map(ch_of, t)
    return BankState(
        overlap=rep,
        resp=rep,
        k=ch_of(state.k),
        r=ch_of(state.r),
        dr=ch_of(state.dr),
        nco=ch_tree(state.nco),
        demod=ch_tree(state.demod),
        gain_factor=rep,
    )


def shard_bank_state(mesh: Mesh, state: BankState) -> BankState:
    """device_put a (packed) BankState onto the mesh."""
    sh = bank_state_shardings(mesh, state)
    return jax.tree_util.tree_map(
        lambda v, s: jax.device_put(v, s), state, sh
    )


def pad_channels(freqs, n_devices: int):
    """Pad a frequency list to a multiple of the device count (spare
    channels cost ~nothing — they ride the batched IFFT/demod).  The pads
    duplicate the last frequency; callers keep n_real = len(freqs) and
    ignore the padded audio rows."""
    freqs = list(freqs)
    rem = len(freqs) % n_devices
    if rem:
        freqs = freqs + [freqs[-1]] * (n_devices - rem)
    return freqs


def make_sharded_bank_step(
    cfg: BankConfig,
    mesh: Mesh,
    template,
    packed_state,
    shard_fft: bool = False,
    ingest: str = "f32",
    pcm_out: bool = False,
):
    """jit the packed bank step with channel-axis input shardings.

    ingest: "f32" = packed (L, 2) float32 I/Q (bank_step_packed);
    "i16" = raw (L, 2) int16 with the scale conversion fused on-device
    (bank_step_packed_i16); pcm_out additionally quantises the audio to
    int16 on device (only with ingest="i16", matching the single-chip
    variants).

    shard_fft=True additionally distributes the wideband master FFT itself
    across the mesh (the >100 Msps sequence-scaling path, SURVEY §5): the
    N-point time block is split over devices, the two-step decomposition in
    parallel.dfft computes a comb-distributed spectrum with one
    reduce_scatter over the interconnect, and each device gathers its
    channels' N_dec bins straight from the comb (bin_perm = comb_index) — XLA inserts the
    gather collective.  Numerically identical to the replicated-FFT path.

    `template` is the unpacked BankState structure (complex dtypes marked),
    `packed_state` a packed state used to derive the sharding pytree.
    Returns (step_fn, sharded_initial_state).

    The channel count must divide evenly over the mesh (XLA NamedSharding
    rejects uneven leading axes); pad the bank with spare channels (tune
    them anywhere, ignore their audio) to reach a multiple of the device
    count.
    """
    n_dev = mesh.devices.size
    if cfg.n_channels % n_dev:
        raise ValueError(
            f"n_channels={cfg.n_channels} not divisible by the "
            f"{n_dev}-device mesh; pad the bank to a multiple of "
            f"{n_dev} channels (spare channels cost ~nothing)"
        )
    if ingest not in ("f32", "i16"):
        raise ValueError(f"ingest must be 'f32' or 'i16', got {ingest!r}")
    if pcm_out and ingest != "i16":
        raise ValueError("pcm_out requires ingest='i16'")
    shardings = bank_state_shardings(mesh, packed_state)
    x_sh = NamedSharding(mesh, P())  # wideband block replicated
    if shard_fft:
        fn = _bank_step_packed_dfft(
            cfg, mesh, template, ingest=ingest, pcm_out=pcm_out
        )
    elif ingest == "i16":
        from ..models.bank import bank_step_packed_i16

        fn = bank_step_packed_i16(cfg, template, pcm_out=pcm_out)
    else:
        fn = bank_step_packed(cfg, template)
    # Pin the state's *output* shardings too: otherwise XLA may return a
    # constant-derived leaf (e.g. the PLL's set_osc_traced zeros) as
    # replicated, and feeding it back into in_shardings raises.
    step = jax.jit(
        fn,
        in_shardings=(shardings, x_sh),
        out_shardings=(
            shardings,
            NamedSharding(mesh, P(CHANNEL_AXIS)),  # audio: channel-sharded
            None,                                  # diag: let XLA place
        ),
    )
    return step, jax.tree_util.tree_map(
        lambda v, s: jax.device_put(v, s), packed_state, shardings
    )


def _bank_step_packed_dfft(
    cfg: BankConfig, mesh: Mesh, template,
    ingest: str = "f32", pcm_out: bool = False,
):
    """Packed bank step whose master FFT is the distributed two-step FFT.

    Same semantics as models.bank.bank_step_packed (radio.c:106-147 sample
    path, filter.c:146-172 overlap-save) with the N-point forward FFT
    computed across the mesh and channels reading true bin b at comb
    position comb_index[b].  ingest/pcm_out as in make_sharded_bank_step."""
    import jax.numpy as jnp

    from ..models.bank import (BankState, bank_channelize, bank_demod,
                               bank_recenter)
    from ..ops.packing import tree_c2r, tree_r2c, r2c
    from .dfft import comb_index, make_dfft_sm

    n_dev = mesh.devices.size
    if cfg.N % n_dev:
        raise ValueError(
            f"N={cfg.N} not divisible by the {n_dev}-device mesh"
        )
    dfft_fn = make_dfft_sm(mesh, cfg.N, CHANNEL_AXIS)
    # comb_p engages bank_channelize's ALIGNED comb gather (it serves
    # CROSS_CONJ ISB too); the only fallbacks are geometric, to the
    # generic per-element gather — warn LOUDLY at construction.
    _Q = cfg.N // n_dev
    if cfg.N_dec % n_dev or _Q % min(128, _Q):
        import warnings

        warnings.warn(
            f"shard_fft geometry N={cfg.N}, N_dec={cfg.N_dec} over "
            f"{n_dev} devices cannot use the aligned comb gather "
            f"(needs N_dec % n_dev == 0 and (N/n_dev) % 128 == 0): "
            f"the bank will run the generic per-element gather.  Pad the "
            f"geometry or drop shard_fft.",
            RuntimeWarning,
            stacklevel=2,
        )
    perm = jnp.asarray(comb_index(cfg.N, n_dev).astype(np.int32))
    L = cfg.master.L

    def packed(state_r, x_in):
        if ingest == "i16":
            x_r = x_in.astype(jnp.float32) * jnp.float32(1.0 / 32767.0)
        else:
            x_r = x_in
        state = tree_r2c(state_r, template)
        samp = r2c(x_r) * state.gain_factor
        buf = jnp.concatenate([state.overlap, samp], axis=-1)
        new_overlap = buf[..., L:]
        comb = dfft_fn(buf)   # (N,) comb-major, sharded over the mesh
        state = bank_recenter(cfg, state)   # k-hops for swept channels
        new_r, new_nco, baseband = bank_channelize(
            cfg, state, comb, bin_perm=perm, comb_p=n_dev
        )
        dstate, audio, diag = bank_demod(cfg, state.demod, baseband)
        if pcm_out:
            audio = jnp.clip(
                audio * 32767.0, -32768.0, 32767.0
            ).astype(jnp.int16)
        new_state = BankState(
            overlap=new_overlap,
            resp=state.resp,
            k=state.k,
            r=new_r,
            dr=state.dr,
            nco=new_nco,
            demod=dstate,
            gain_factor=state.gain_factor,
        )
        return tree_c2r(new_state), audio, diag

    return packed
