"""Distributed wideband FFT — the sequence-scaling path (SURVEY.md §5).

One device can compute the master FFT in place while the channel axis
shards with zero communication (parallel.mesh).  When the wideband FFT
itself outgrows one device, this module splits it across the mesh with
the classic two-step decomposition, using XLA collectives (NCCL over
NVLink on a multi-card host):

With N = P*Q over P devices and the block *time-sharded* (device p holds
x[p*Q:(p+1)*Q]):

1. small cross-device DFT: y_j[q] = sum_p x_p[q] * W_P^(j*p).
   Each device forms its P partial products locally and one
   `reduce_scatter` over the mesh delivers y_j to device j — the only
   communication, N complex values over the interconnect.
2. twiddle + local FFT: X[j + P*m] = FFT_q( W_N^(j*q) * y_j[q] )[m].

Device j ends owning the frequency comb {j, j+P, j+2P, ...} — the
"cyclic" distribution.  `undo_comb` reassembles a full spectrum for
verification; a production >100 Msps bank would gather each channel's
N_dec bins directly from the comb (B*N_dec values, far less than N).

Tested against numpy on the 8-virtual-device CPU mesh; on a multi-card
host the reduce_scatter rides NVLink.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.fftfilt import FOURSTEP_MIN, fft_fourstep

__all__ = ["dfft", "undo_comb", "make_dfft", "make_dfft_sm", "comb_index"]


def make_dfft_sm(mesh: Mesh, N: int, axis: str = "ch"):
    """Build the shard_map'd (unjitted) distributed FFT over `mesh` for
    length-N blocks, embeddable inside a larger jitted program (the
    sharded channel bank uses this, parallel.mesh).

    Returns fn: (N,) complex64 time-sharded -> (N,) complex64 where the
    result's element k lives... logically; physically the output is
    arranged comb-major: out[j*Q + m] = X[j + P*m] (device j's bins
    contiguous).  Use undo_comb / comb_index to address true bins.
    """
    Pn = mesh.devices.size
    if N % Pn:
        raise ValueError(f"N={N} not divisible by {Pn} devices")
    Q = N // Pn

    # cross-device DFT matrix W_P^(j*p), tiny (P x P)
    j = np.arange(Pn)
    WP = np.exp(-2j * np.pi * np.outer(j, j) / Pn).astype(np.complex64)

    WPj = jnp.asarray(WP)

    def local(x_p):
        # x_p: this device's (Q,) time slice; axis index = p
        p = jax.lax.axis_index(axis)
        # partial products for every destination j: (P, Q)
        col = jax.lax.dynamic_index_in_dim(WPj, p, axis=1, keepdims=False)
        z = col[:, None] * x_p[None, :]
        # deliver y_j to device j: reduce_scatter over the device axis
        y = jax.lax.psum_scatter(z, axis, scatter_dimension=0, tiled=True)
        y = y.reshape(-1)
        # y: (Q,) on device j = sum_p x_p * W_P^(j p)
        jj = jax.lax.axis_index(axis)
        q = jnp.arange(Q)
        tw = jnp.exp(
            (-2j * jnp.pi / N) * (jj.astype(jnp.float32) * q.astype(jnp.float32))
        ).astype(jnp.complex64)
        # same threshold as the replicated master (FOURSTEP_MIN); only
        # reachable for very large per-device slices
        if Q >= FOURSTEP_MIN:
            return fft_fourstep(y * tw)
        return jnp.fft.fft(y * tw)

    return shard_map(
        local,
        mesh=mesh,
        in_specs=P(axis),
        out_specs=P(axis),
        check_vma=False,
    )


def make_dfft(mesh: Mesh, N: int, axis: str = "ch"):
    """Jitted standalone form of make_dfft_sm (same comb-major output)."""
    return jax.jit(make_dfft_sm(mesh, N, axis))


def comb_index(N: int, n_devices: int) -> np.ndarray:
    """perm such that X_true[k] = out[perm[k]] for make_dfft's output."""
    Q = N // n_devices
    k = np.arange(N)
    j = k % n_devices
    m = k // n_devices
    return j * Q + m


def undo_comb(out: np.ndarray, n_devices: int) -> np.ndarray:
    """Reassemble the natural-order spectrum from the comb layout."""
    N = len(out)
    return np.asarray(out)[comb_index(N, n_devices)]


def dfft(mesh: Mesh, x: np.ndarray, axis: str = "ch") -> np.ndarray:
    """One-shot helper: distributed FFT, returning the natural-order
    spectrum (gathers to host — use make_dfft + comb addressing in
    production)."""
    fn = make_dfft(mesh, len(x), axis)
    xs = jax.device_put(
        np.asarray(x, np.complex64), NamedSharding(mesh, P(axis))
    )
    return undo_comb(np.asarray(jax.block_until_ready(fn(xs))), mesh.devices.size)
