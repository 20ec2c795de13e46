"""Overlap-save fast-convolution filter engine.

This is the heart of the rebuild: the reference's master/slave filter
(filter.c:54-252).  One *master* holds the forward FFT of each input block;
any number of *slaves*, each with its own frequency response and decimation
ratio, share that FFT and do only a bin-wise multiply plus a short inverse
FFT.

Differences from the reference, by design:
- No threads, mutexes or blocknum condvars (filter.c:154-157,194-199).
  The master FFT and all slave IFFTs fuse into one jitted block program;
  synchronisation is dataflow.
- State (the M-1 sample overlap) is explicit and carried by the caller,
  so the whole pipeline is `lax.scan`-able and shard_map-able.
- Slaves vectorise over a channel axis (vmap) — the reference's
  one-FFT/N-slaves fan-out becomes the batching axis of the channel bank.

Semantics (bin selection, conjugate folding, CROSS_CONJ ISB trick, FFT
scaling) match filter.c exactly; see slave_execute for the mapping.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "FilterType",
    "MasterSpec",
    "SlaveSpec",
    "master_init",
    "master_execute",
    "fft_fourstep",
    "slave_execute",
    "slave_bin_indices",
    "noise_gain",
    "set_filter_response",
]


class FilterType(enum.Enum):
    """Filter port types (filter.h:17-22)."""

    COMPLEX = "complex"
    REAL = "real"
    CROSS_CONJ = "cross_conj"  # complex with ISB cross-conjugation


class MasterSpec(NamedTuple):
    """Static description of a master (input) filter (struct filter_in,
    filter.h:54-66).  L = input block size, M = impulse length,
    N = L + M - 1 = FFT size."""

    L: int
    M: int
    in_type: FilterType

    @property
    def N(self) -> int:
        return self.L + self.M - 1

    @property
    def nbins(self) -> int:
        """Number of frequency bins the forward FFT produces."""
        return self.N // 2 + 1 if self.in_type is FilterType.REAL else self.N


class SlaveSpec(NamedTuple):
    """Static description of a slave (output) filter (struct filter_out,
    filter.h:67-80)."""

    master: MasterSpec
    decimate: int
    out_type: FilterType

    @property
    def N_dec(self) -> int:
        return self.master.N // self.decimate

    @property
    def olen(self) -> int:
        return self.master.L // self.decimate

    @property
    def nbins(self) -> int:
        """Length of the response array.  Only the real-in/real-out case
        stores half-spectrum responses; complex-in/real-out still needs the
        full response because the conjugate fold (filter.c:232-234) reads
        negative-frequency response bins."""
        if (
            self.master.in_type is FilterType.REAL
            and self.out_type is FilterType.REAL
        ):
            return self.N_dec // 2 + 1
        return self.N_dec


def master_init(spec: MasterSpec, dtype=jnp.float32) -> jax.Array:
    """Zero overlap state: the trailing M-1 samples of the previous block
    (the memset of filter.c:76,85)."""
    if spec.in_type is FilterType.REAL:
        return jnp.zeros((spec.M - 1,), dtype=dtype)
    cdtype = jnp.complex64 if dtype == jnp.float32 else jnp.complex128
    return jnp.zeros((spec.M - 1,), dtype=cdtype)


#: Use the four-step decomposition (fft_fourstep) for complex masters at
#: or above this size.  On an H100 (700 W) cuFFT's monolithic transform
#: beat the four-step at every master size the bank uses: 0.57 vs 0.87 ms
#: at 2^24, 0.95 vs 1.20 ms at 2^25, 1.71 vs 2.12 ms at 2^26 (PERF.md,
#: "Bring-up measurements").  So the threshold sits above the largest
#: master; fft_fourstep stays for the distributed FFT (parallel.dfft).
FOURSTEP_MIN = 1 << 27


def fft_fourstep(z: jax.Array) -> jax.Array:
    """Natural-order forward FFT via the four-step (Bailey) decomposition.

    N = P*Q with P,Q ~ sqrt(N): Q-point FFTs over columns, twiddle
    W_N^(k1*p), P-point FFTs over rows, transpose back to natural order.
    Twiddle phases use an exact integer mod N before the float multiply —
    a raw f32 k1*p/N phase reaches thousands of radians and would add
    ~-68 dB spurs; reduced first, the error is ~2^-23 of a cycle."""
    N = z.shape[-1]
    P = 1 << (int(np.log2(N)) // 2)
    if N % P:
        return jnp.fft.fft(z, axis=-1)
    Q = N // P
    zz = z.reshape(z.shape[:-1] + (Q, P))
    C = jnp.fft.fft(zz, axis=-2)                       # Q-pt FFT per column
    k1 = jnp.arange(Q, dtype=jnp.int32)[:, None]
    p = jnp.arange(P, dtype=jnp.int32)[None, :]
    frac = ((k1 * p) % N).astype(jnp.float32) * jnp.float32(1.0 / N)
    ang = (-2.0 * np.pi) * frac
    tw = jax.lax.complex(jnp.cos(ang), jnp.sin(ang))
    D = jnp.fft.fft(C * tw, axis=-1)                   # D[k1,k2] = X[k1+Q*k2]
    return jnp.swapaxes(D, -1, -2).reshape(z.shape[:-1] + (N,))


def master_execute(
    spec: MasterSpec, overlap: jax.Array, block: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """One overlap-save step (execute_filter_input, filter.c:146-172).

    Concatenates the carried M-1 overlap with the new L-sample block,
    forward-FFTs the N samples, and returns (new_overlap, fdomain).
    The FFT is unnormalised-forward, matching FFTW_FORWARD.  Complex
    masters at or above FOURSTEP_MIN use the four-step decomposition.
    """
    if block.shape[-1] != spec.L:
        raise ValueError(f"block length {block.shape[-1]} != L = {spec.L}")
    buf = jnp.concatenate([overlap, block], axis=-1)
    if spec.in_type is FilterType.REAL:
        fdomain = jnp.fft.rfft(buf, axis=-1)
    elif spec.N >= FOURSTEP_MIN:
        fdomain = fft_fourstep(buf)
    else:
        fdomain = jnp.fft.fft(buf, axis=-1)
    new_overlap = buf[..., spec.L:]
    return new_overlap, fdomain


def slave_bin_indices(spec: SlaveSpec) -> np.ndarray:
    """Master-spectrum bin index for each slave bin, as gathered by
    execute_filter_output (filter.c:206,225-227).

    For complex-in/complex-out: slave bin p in 0..N_dec/2 reads master bin
    p; slave bin dn in N_dec/2+1..N_dec-1 reads master bin N - N_dec + dn
    (the top of the master spectrum, i.e. the negative frequencies).

    The channel bank reuses this pattern shifted by an integer bin rotation
    per channel (frequency conversion in the frequency domain).
    """
    N, N_dec = spec.master.N, spec.N_dec
    h = N_dec // 2
    if spec.master.in_type is not FilterType.REAL and spec.out_type in (
        FilterType.COMPLEX,
        FilterType.CROSS_CONJ,
    ):
        return np.concatenate([np.arange(h + 1), np.arange(N - h + 1, N)])
    raise ValueError("bin indices only defined for complex in / complex out")


def _cross_conj(f_fd: jax.Array, N_dec: int) -> jax.Array:
    """ISB cross-conjugate trick (filter.c:239-249): for p in 1..N_dec/2-1
    paired with dn = N_dec - p, replace (pos, neg) with
    (pos + conj(neg), neg - conj(pos)).  Forces the lower sideband onto I
    and the upper onto Q."""
    h = N_dec // 2
    pos = f_fd[..., 1:h]            # p = 1 .. h-1
    neg = f_fd[..., :h:-1]          # dn = N_dec-1 .. h+1 (pairs dn = N_dec - p)
    new_pos = pos + jnp.conj(neg)
    new_neg = neg - jnp.conj(pos)
    f_fd = f_fd.at[..., 1:h].set(new_pos)
    f_fd = f_fd.at[..., :h:-1].set(new_neg)
    return f_fd


def slave_execute(
    spec: SlaveSpec, fdomain: jax.Array, response: jax.Array
) -> jax.Array:
    """One slave step (execute_filter_output, filter.c:175-252).

    Multiplies the shared master spectrum by this slave's frequency
    response with the reference's exact bin mapping and conjugate folding,
    inverse-FFTs at the decimated size, and returns the last `olen` (valid)
    output samples.  The IFFT is unnormalised (FFTW_BACKWARD), i.e.
    N_dec * ifft().
    """
    N, N_dec = spec.master.N, spec.N_dec
    h = N_dec // 2
    in_real = spec.master.in_type is FilterType.REAL
    out = spec.out_type

    if response.shape[-1] != spec.nbins:
        raise ValueError(f"response length {response.shape[-1]} != {spec.nbins}")

    if not in_real and out in (FilterType.COMPLEX, FilterType.CROSS_CONJ):
        # complex in, complex out (filter.c:206-207, 225-227)
        pos = response[..., : h + 1] * fdomain[..., : h + 1]
        neg = response[..., h + 1 :] * fdomain[..., N - h + 1 :]
        f_fd = jnp.concatenate([pos, neg], axis=-1)
        if out is FilterType.CROSS_CONJ:
            f_fd = _cross_conj(f_fd, N_dec)
        y = jnp.fft.ifft(f_fd, axis=-1) * N_dec
        return y[..., N_dec - spec.olen :]

    if not in_real and out is FilterType.REAL:
        # complex in, real out: fold conjugates of negative frequencies into
        # the positive bins (filter.c:228-235).
        pos = response[..., : h + 1] * fdomain[..., : h + 1]
        # loop: n=N-1, p=1, dn=N_dec-1; while p < h  ->  p in 1..h-1,
        # dn = N_dec-1 .. h+1, n = N-1 .. N-h+1
        fold = jnp.conj(
            response[..., : h : -1] * fdomain[..., : N - h : -1]
        )
        pos = pos.at[..., 1:h].add(fold)
        y = jnp.fft.irfft(pos, N_dec, axis=-1) * N_dec
        return y[..., N_dec - spec.olen :]

    if in_real and out is FilterType.REAL:
        # real in, real out (filter.c:206-207 only): first N_dec/2+1 bins.
        f_fd = response[..., : h + 1] * fdomain[..., : h + 1]
        y = jnp.fft.irfft(f_fd, N_dec, axis=-1) * N_dec
        return y[..., N_dec - spec.olen :]

    if in_real and out in (FilterType.COMPLEX, FilterType.CROSS_CONJ):
        # real in, complex out: F[-f] = conj(F[+f]) (filter.c:209-216).
        pos = response[..., : h + 1] * fdomain[..., : h + 1]
        # p=1, dn=N_dec-1; while dn > h  ->  dn = N_dec-1..h+1, p = 1..h-1
        neg = response[..., h + 1 :] * jnp.conj(fdomain[..., h - 1 : 0 : -1])
        f_fd = jnp.concatenate([pos, neg], axis=-1)
        if out is FilterType.CROSS_CONJ:
            f_fd = _cross_conj(f_fd, N_dec)
        y = jnp.fft.ifft(f_fd, axis=-1) * N_dec
        return y[..., N_dec - spec.olen :]

    raise ValueError(f"unsupported type combination {spec.master.in_type}/{out}")


def noise_gain(spec: SlaveSpec, response: np.ndarray) -> float:
    """Filter gain on uniform gaussian noise (filter.c:472-497).

    Sum of |response|^2 over the slave's bins, times N (undoing the 1/N
    amplitude pre-scale), times 2 for REAL / CROSS_CONJ outputs (undoing
    their sqrt(1/2) amplitude factor)."""
    N = spec.master.N
    if spec.master.in_type is FilterType.REAL and spec.out_type is FilterType.REAL:
        s = float(np.sum(np.abs(response[: spec.N_dec // 2 + 1]) ** 2))
    else:
        s = float(np.sum(np.abs(response[: spec.N_dec]) ** 2))
    if spec.out_type in (FilterType.REAL, FilterType.CROSS_CONJ):
        return 2.0 * N * s
    return float(N * s)


def set_filter_response(
    spec: SlaveSpec, low: float, high: float, beta: float
) -> np.ndarray:
    """Design a slave's response à la set_filter (filter.c:500-546).

    low/high are in cycles/sample of the *decimated* output rate.  Returns
    the complex64 response; the caller swaps it into its channel config (the
    reference's hot-swap mutex becomes a functional update here).
    """
    from .window import brickwall_response, design_bandpass, window_rfilter

    if (
        spec.master.in_type is FilterType.REAL
        and spec.out_type is FilterType.REAL
    ):
        # Half-spectrum design via window_rfilter, as the reference's
        # real/real users do directly (fm.c:56-65, packet.c).
        L_dec = spec.master.L // spec.decimate
        M_dec = (spec.master.M - 1) // spec.decimate + 1
        gain = np.sqrt(0.5) / spec.master.N
        full = brickwall_response(spec.N_dec, low, high, gain)
        resp = window_rfilter(L_dec, M_dec, full[: spec.N_dec // 2 + 1], beta)
        return resp.astype(np.complex64)

    return design_bandpass(
        spec.master.L,
        spec.master.M,
        spec.decimate,
        low,
        high,
        beta,
        real_output=spec.out_type is FilterType.REAL,
        cross_conj=spec.out_type is FilterType.CROSS_CONJ,
    )
