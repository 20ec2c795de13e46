"""Overlap-save engine parity: streaming identity, decimating bandpass vs
direct convolution, REAL folding, CROSS_CONJ sideband separation."""

import numpy as np
import jax.numpy as jnp

from ka9q_sdr_tpu.ops import fftfilt as F
from ka9q_sdr_tpu.ops import window as W


def _stream(mspec, sspec, response, x):
    """Run the engine over consecutive blocks of x; returns concatenated
    slave output."""
    L = mspec.L
    overlap = F.master_init(mspec)
    resp = jnp.asarray(response)
    outs = []
    for i in range(len(x) // L):
        blk = jnp.asarray(x[i * L : (i + 1) * L])
        overlap, fd = F.master_execute(mspec, overlap, blk)
        outs.append(np.asarray(F.slave_execute(sspec, fd, resp)))
    return np.concatenate(outs)


def test_allpass_identity():
    """Unity response (1/N per bin) with no decimation reproduces the input
    exactly — the engine's FFT scaling bookkeeping (filter.c:518) checks out."""
    L, M = 256, 257
    mspec = F.MasterSpec(L, M, F.FilterType.COMPLEX)
    sspec = F.SlaveSpec(mspec, 1, F.FilterType.COMPLEX)
    N = mspec.N
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(4 * L) + 1j * rng.standard_normal(4 * L)).astype(
        np.complex64
    )
    resp = np.full(N, 1.0 / N, np.complex64)
    y = _stream(mspec, sspec, resp, x)
    np.testing.assert_allclose(y, x, atol=1e-5)


def test_decimating_bandpass_vs_direct():
    """Stream through a decimate-by-4 Kaiser bandpass and compare to direct
    linear convolution with the designed impulse response."""
    L, M, dec = 512, 513, 4
    mspec = F.MasterSpec(L, M, F.FilterType.COMPLEX)
    sspec = F.SlaveSpec(mspec, dec, F.FilterType.COMPLEX)
    N = mspec.N
    resp = F.set_filter_response(sspec, -0.2, 0.2, 3.0)

    rng = np.random.default_rng(2)
    nblocks = 6
    x = (
        rng.standard_normal(nblocks * L) + 1j * rng.standard_normal(nblocks * L)
    ).astype(np.complex64)
    y = _stream(mspec, sspec, resp, x)

    # Ground truth: embed the N_dec response into the N-bin spectrum (zero
    # outside the retained bins), convolve directly, decimate, scale by N
    # (see the derivation in slave_execute's docstring/design notes).
    N_dec = sspec.N_dec
    h_full = np.zeros(N, np.complex128)
    sel = F.slave_bin_indices(sspec)
    assert len(sel) == N_dec
    h_full[sel] = resp
    h_t = np.fft.ifft(h_full)
    # impulse response is confined to first M taps (windowed design)
    assert np.max(np.abs(h_t[M:])) < 1e-9
    full = np.convolve(np.concatenate([np.zeros(M - 1), x]), h_t[:M])
    # engine output sample m of block b corresponds to input index
    # b*L + m*dec (the last olen of each N_dec ifft are the valid samples)
    direct = N * full[M - 1 : M - 1 + nblocks * L : dec]
    np.testing.assert_allclose(y, direct, atol=2e-4)


def test_real_output_folding():
    """Complex-in/REAL-out must equal 2*Re(complex-out) for a response with
    no DC/Nyquist content (filter.c:228-235 fold)."""
    L, M, dec = 512, 513, 4
    mspec = F.MasterSpec(L, M, F.FilterType.COMPLEX)
    s_c = F.SlaveSpec(mspec, dec, F.FilterType.COMPLEX)
    s_r = F.SlaveSpec(mspec, dec, F.FilterType.REAL)
    resp = F.set_filter_response(s_c, -0.2, -0.02, 3.0)  # one-sided band

    rng = np.random.default_rng(3)
    x = (rng.standard_normal(4 * L) + 1j * rng.standard_normal(4 * L)).astype(
        np.complex64
    )
    yc = _stream(mspec, s_c, resp, x)
    yr = _stream(mspec, s_r, resp, x)
    np.testing.assert_allclose(yr, 2 * yc.real, atol=2e-4)


def test_cross_conj_isb():
    """CROSS_CONJ (ISB): an upper-sideband tone lands on Q, a lower-sideband
    tone on I (filter.c:239-249)."""
    L, M, dec = 512, 513, 1
    mspec = F.MasterSpec(L, M, F.FilterType.COMPLEX)
    sspec = F.SlaveSpec(mspec, dec, F.FilterType.CROSS_CONJ)
    resp = F.set_filter_response(sspec, -0.25, 0.25, 3.0)

    n = np.arange(6 * L)
    for f, channel in ((0.1, "imag"), (-0.1, "real")):
        x = np.exp(2j * np.pi * f * n).astype(np.complex64)
        y = _stream(mspec, sspec, resp, x)[2 * L :]  # skip startup
        main = getattr(y, channel)
        other = y.imag if channel == "real" else y.real
        assert np.sqrt(np.mean(main**2)) > 0.5
        assert np.sqrt(np.mean(other**2)) < 1e-3


def test_real_master_real_slave():
    """REAL-in/REAL-out path (the FM audio de-emphasis chain,
    fm.c:43,66): allpass unity response reproduces a real input."""
    L, M = 240, 273
    mspec = F.MasterSpec(L, M, F.FilterType.REAL)
    sspec = F.SlaveSpec(mspec, 1, F.FilterType.REAL)
    N = mspec.N
    resp = np.full(N // 2 + 1, 1.0 / N, np.complex64)
    rng = np.random.default_rng(4)
    x = rng.standard_normal(5 * L).astype(np.float32)
    y = _stream(mspec, sspec, resp, x)
    np.testing.assert_allclose(y, x, atol=1e-5)


def test_noise_gain_matches_reference_formula():
    L, M, dec = 512, 513, 4
    mspec = F.MasterSpec(L, M, F.FilterType.COMPLEX)
    sspec = F.SlaveSpec(mspec, dec, F.FilterType.COMPLEX)
    resp = F.set_filter_response(sspec, -0.2, 0.2, 3.0)
    ng = F.noise_gain(sspec, resp)
    # unity-gain brickwall over 40% of the band at decimate=4: noise gain ~
    # bandwidth_fraction / decimate (power ratio < 1, filter.h:73 — the
    # filter passes 40% of the input band, which is 4x the output band)
    assert abs(ng - 0.4 / 4) < 0.01


class TestFourStepFFT:
    def test_matches_monolithic_fft(self):
        """fft_fourstep (Bailey P x Q decomposition: masters at or above
        FOURSTEP_MIN, and the distributed FFT's building block) == numpy's
        FFT to float32 round-off, natural order.  Correctness is
        size-independent, so test at CI-friendly sizes."""
        from ka9q_sdr_tpu.ops.fftfilt import fft_fourstep
        import jax

        rng = np.random.default_rng(5)
        for N in (1 << 16, 1 << 18):
            z = (rng.standard_normal(N) + 1j * rng.standard_normal(N)).astype(
                np.complex64
            )
            got = np.asarray(jax.jit(fft_fourstep)(z))
            ref = np.fft.fft(z)
            scale = np.max(np.abs(ref))
            np.testing.assert_allclose(got, ref, atol=2e-5 * scale)

    def test_master_execute_uses_it_transparently(self, monkeypatch):
        """A master at or above FOURSTEP_MIN produces the same spectrum as
        the monolithic FFT (overlap-save semantics unchanged).  The real
        threshold is 2^27 (too big for CI); lower it so the decomposition
        path itself runs through master_execute here."""
        import ka9q_sdr_tpu.ops.fftfilt as F
        from ka9q_sdr_tpu.ops.fftfilt import (
            FilterType, MasterSpec, master_execute, master_init,
        )
        import jax.numpy as jnp

        monkeypatch.setattr(F, "FOURSTEP_MIN", 1 << 16)
        L, M = 61440, 4097          # N = 65536 -> four-step path (patched)
        spec = MasterSpec(L, M, FilterType.COMPLEX)
        rng = np.random.default_rng(6)
        x = (rng.standard_normal(L) + 1j * rng.standard_normal(L)).astype(
            np.complex64
        )
        overlap = master_init(spec)
        _, fd = master_execute(spec, overlap, jnp.asarray(x))
        buf = np.concatenate([np.zeros(M - 1, np.complex64), x])
        ref = np.fft.fft(buf)
        np.testing.assert_allclose(
            np.asarray(fd), ref, atol=2e-5 * np.max(np.abs(ref))
        )
