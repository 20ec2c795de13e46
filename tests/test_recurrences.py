"""AGC / IIR / forward-fill / decimator parity vs naive per-sample loops."""

import numpy as np
import jax.numpy as jnp
import pytest

from ka9q_sdr_tpu.ops import agc as A
from ka9q_sdr_tpu.ops import iir as I
from ka9q_sdr_tpu.ops import ffill as FF
from ka9q_sdr_tpu.ops import decimate as D


def _agc_ref(levels, gain, hang, headroom, recovery, hangmax):
    """Literal transcription of the reference recurrence (am.c:64-74)."""
    gains = np.empty_like(levels)
    for n, lev in enumerate(levels):
        if np.isnan(gain):
            gain = headroom / lev
        elif gain * lev > headroom:
            gain = headroom / lev
            hang = hangmax
        elif hang != 0:
            hang -= 1
        else:
            gain *= recovery
        gains[n] = gain
    return gains, gain, hang


def test_agc_matches_reference_loop(rng):
    params = A.AGCParams(headroom=0.3, recovery_factor=1.0005, hangmax=50)
    levels = np.abs(rng.standard_normal(1000)).astype(np.float32) * 0.05
    levels[300] = 5.0  # spike: clamp + hang
    levels[700] = 3.0
    st = A.agc_init(80.0)
    st2, gains = A.agc_block(st, jnp.asarray(levels), params)
    ref_gains, ref_gain, ref_hang = _agc_ref(
        levels.astype(np.float64), A.db2voltage(80.0), 0,
        params.headroom, params.recovery_factor, params.hangmax,
    )
    np.testing.assert_allclose(np.asarray(gains), ref_gains, rtol=1e-4)
    assert abs(float(st2.gain) - ref_gain) / ref_gain < 1e-4
    assert int(st2.hangcount) == ref_hang


def test_agc_batched(rng):
    params = A.AGCParams(headroom=0.3, recovery_factor=1.001, hangmax=10)
    levels = np.abs(rng.standard_normal((4, 500))).astype(np.float32) * 0.1
    st = A.agc_init(80.0, batch_shape=(4,))
    _, gains = A.agc_block(st, jnp.asarray(levels), params)
    for c in range(4):
        ref, _, _ = _agc_ref(
            levels[c].astype(np.float64), A.db2voltage(80.0), 0,
            params.headroom, params.recovery_factor, params.hangmax,
        )
        np.testing.assert_allclose(np.asarray(gains[c]), ref, rtol=1e-4)


def test_one_pole_matches_loop(rng):
    x = rng.standard_normal(777).astype(np.float32)
    alpha = 1e-2
    y0 = 0.5
    last, trace = I.one_pole_lowpass(jnp.float32(y0), jnp.asarray(x), alpha)
    y = y0
    ref = np.empty_like(x)
    for n, v in enumerate(x):
        y += alpha * (v - y)
        ref[n] = y
    np.testing.assert_allclose(np.asarray(trace), ref, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(last), y, rtol=1e-4)


def test_notch_removes_tone(rng):
    f = 0.1
    n = np.arange(20000)
    tone = np.exp(2j * np.pi * f * n)
    noise = 0.1 * (rng.standard_normal(len(n)) + 1j * rng.standard_normal(len(n)))
    x = (tone + noise).astype(np.complex64)
    st = I.notch_init(f, 0.005)
    st, y = I.notch_block(st, jnp.asarray(x))
    y = np.asarray(y)[5000:]
    # tone suppressed, noise passes
    spec = np.abs(np.fft.fft(y))
    tone_bin = int(round(f * len(y)))
    assert spec[tone_bin] < 0.05 * len(y) ** 0.5 * 10


def test_forward_fill():
    vals = jnp.asarray(np.arange(10, dtype=np.float32))
    mask = jnp.asarray([0, 1, 0, 0, 1, 0, 0, 0, 1, 0], bool)
    out = FF.forward_fill(vals, mask, jnp.float32(-1))
    np.testing.assert_array_equal(
        np.asarray(out), [-1, 1, 1, 1, 4, 4, 4, 4, 8, 8]
    )


def test_hb15_is_halfband_decimator(rng):
    taps = D.hb15_coeffs()
    assert taps[7] == 1.0
    assert np.allclose(np.sum(taps), 2.0)  # +6 dB DC gain (decimate.c:3)
    x = rng.standard_normal(4096).astype(np.float32)
    st = jnp.zeros(14, jnp.float32)
    st, y = D.hb15_block(st, jnp.asarray(x))
    got = np.asarray(y)
    direct = np.convolve(np.concatenate([np.zeros(14), x]), taps)[14 : 14 + len(x) : 2]
    np.testing.assert_allclose(got, direct, rtol=1e-4, atol=1e-5)


def test_cascade_dc_gain():
    # With the hackrf defaults (stage_threshold=8 > log_decimate) every
    # stage is hb15 with +6 dB DC gain; Filter_atten = 0.5^stages
    # compensates (hackrf.c:469).
    log_d = 6
    states = D.cascade_init(log_d, stage_threshold=8)
    x = jnp.ones(64 * 128, jnp.float32)
    _, y = D.hb_cascade(states, x, log_d, stage_threshold=8)
    np.testing.assert_allclose(np.asarray(y)[-16:], 2.0**log_d, rtol=1e-4)
    # hb3 stages (taps 1,2,1) have DC gain 4
    states = D.cascade_init(log_d, stage_threshold=4)
    _, y = D.hb_cascade(states, x, log_d, stage_threshold=4)
    np.testing.assert_allclose(np.asarray(y)[-16:], 4.0**2 * 2.0**4, rtol=1e-4)


class TestDistributedFFT:
    """Sequence-scaling primitive: the wideband FFT split across the mesh
    (reduce_scatter + local FFTs; parallel/dfft.py)."""

    def test_matches_numpy(self):
        import jax
        import numpy as np
        from ka9q_sdr_tpu.parallel.mesh import make_channel_mesh
        from ka9q_sdr_tpu.parallel.dfft import dfft

        if len(jax.devices()) < 8:
            import pytest

            pytest.skip("needs the 8-virtual-device mesh")
        mesh = make_channel_mesh(8)
        rng = np.random.default_rng(0)
        for N in (1 << 12, 1 << 14):
            x = (rng.standard_normal(N) + 1j * rng.standard_normal(N)).astype(
                np.complex64
            )
            X = dfft(mesh, x)
            ref = np.fft.fft(x)
            err = np.abs(X - ref).max() / np.abs(ref).max()
            assert err < 1e-4, (N, err)

    def test_comb_addressing(self):
        import numpy as np
        from ka9q_sdr_tpu.parallel.dfft import comb_index

        perm = comb_index(16, 4)
        # device j owns bins j, j+4, j+8, j+12 at local offsets 0..3
        assert perm[0] == 0 and perm[4] == 1      # bin 4 = device 0, m=1
        assert perm[1] == 4 and perm[5] == 5      # bin 1 = device 1, m=0


class TestHalfBandCascadeJax:
    def test_64_to_1_tone_survives(self):
        """ops.decimate hb_cascade (the hackrf 64:1 path) on the device
        path: in-band tone at unity gain after 0.5^stages compensation."""
        import jax.numpy as jnp
        from ka9q_sdr_tpu.ops.decimate import cascade_init, hb_cascade

        fs = 12.288e6
        log2d = 6
        states = cascade_init(log2d, dtype=jnp.complex64)
        n = 1 << 15
        t = np.arange(n) / fs
        x = np.exp(2j * np.pi * 20e3 * t).astype(np.complex64)
        out = []
        for i in range(0, n, 4096):
            states, y = hb_cascade(states, jnp.asarray(x[i : i + 4096]), log2d)
            out.append(np.asarray(y))
        y = np.concatenate(out) * (0.5**log2d)
        seg = y[200:]
        # tone amplitude ~1, frequency preserved at the decimated rate
        assert abs(np.abs(seg).mean() - 1.0) < 0.05
        ph = np.unwrap(np.angle(seg))
        f = (ph[-1] - ph[0]) / (len(seg) - 1) / (2 * np.pi) * (fs / 64)
        assert abs(f - 20e3) < 20

    def test_matches_numpy_mirror(self):
        """ops.decimate (jax) equals models.frontend.HalfBandCascade
        (numpy host mirror) on the same stream."""
        import jax.numpy as jnp
        from ka9q_sdr_tpu.ops.decimate import cascade_init, hb_cascade
        from ka9q_sdr_tpu.models.frontend import HalfBandCascade

        rng = np.random.default_rng(4)
        x = (rng.standard_normal(8192) + 1j * rng.standard_normal(8192)).astype(
            np.complex64
        )
        states = cascade_init(4, dtype=jnp.complex64)
        jout = []
        casc = HalfBandCascade(4)
        nout = []
        for i in range(0, 8192, 2048):
            states, y = hb_cascade(states, jnp.asarray(x[i : i + 2048]), 4)
            jout.append(np.asarray(y) * 0.5**4)
            nout.append(casc.process(x[i : i + 2048]))
        assert np.allclose(np.concatenate(jout), np.concatenate(nout),
                           atol=1e-5)


class TestNotch:
    def test_notch_removes_tone(self):
        """Experimental IIR complex notch (filter.c:551-571): a tone at the
        notch frequency decays; off-frequency content passes."""
        import jax.numpy as jnp
        from ka9q_sdr_tpu.ops.iir import notch_init, notch_block

        fs = 48000.0
        st = notch_init(1000.0 / fs, 0.01)
        n = 48000
        t = np.arange(n) / fs
        x = (np.exp(2j * np.pi * 1000 * t)
             + 0.5 * np.exp(2j * np.pi * 5000 * t)).astype(np.complex64)
        out = []
        for i in range(0, n, 4800):
            st, y = notch_block(st, jnp.asarray(x[i : i + 4800]))
            out.append(np.asarray(y))
        y = np.concatenate(out)[-9600:]
        spec = np.abs(np.fft.fft(y * np.hanning(len(y))))
        f = np.fft.fftfreq(len(y), 1 / fs)
        at_notch = spec[np.argmin(np.abs(f - 1000))]
        at_pass = spec[np.argmin(np.abs(f - 5000))]
        assert at_pass > 20 * at_notch


class TestNCOSweep:
    def test_doppler_sweep_chirps_linearly(self):
        """osc sweep (phasor_step_step, osc.c): frequency ramps at `rate`
        cycles/sample^2 with phase continuity across blocks."""
        from ka9q_sdr_tpu.ops.nco import osc_init, set_osc, osc_block

        rate = 1e-9          # cycles/sample^2
        st = set_osc(osc_init(), 0.01, rate)
        chunks = []
        for _ in range(10):
            st, lo = osc_block(st, 4096)
            chunks.append(np.asarray(lo))
        lo = np.concatenate(chunks)
        ph = np.unwrap(np.angle(lo).astype(np.float64)) / (2 * np.pi)
        n = len(lo)
        # window-averaged frequency at start vs end (single-sample float32
        # phase differences are too noisy at the 1e-5 level)
        w = 2000
        f0 = (ph[w] - ph[0]) / w
        f1 = (ph[-1] - ph[-1 - w]) / w
        expect = rate * (n - w)
        assert abs((f1 - f0) - expect) < 0.05 * expect
        # phase continuity: no jumps at block boundaries
        d = np.diff(ph)
        assert np.all(np.abs(np.diff(d)) < 1e-4)


class TestForwardFillMatchesLoop:
    """ops/ffill (cummax of the gated index + gather) against the C loop's
    recurrence, walked sample by sample in numpy: exactly equal, since the
    fill only selects."""

    @pytest.mark.parametrize("case", ["ragged_T", "all_weak_rows",
                                      "complex_and_real", "batch_dims"])
    def test_equals_numpy_loop(self, case):
        import jax
        from chip_smoke import fill_reference
        from ka9q_sdr_tpu.ops.ffill import forward_fill_multi

        rng = np.random.default_rng(3)
        shape = {"ragged_T": (7, 391), "all_weak_rows": (9, 200),
                 "complex_and_real": (130, 97), "batch_dims": (3, 5, 64)
                 }[case]
        lead = shape[:-1]
        vr = rng.standard_normal(shape).astype(np.float32)
        vc = (rng.standard_normal(shape)
              + 1j * rng.standard_normal(shape)).astype(np.complex64)
        m = rng.random(shape) < 0.4
        if case == "all_weak_rows":
            m[::2] = False
        m[..., 0] = False              # every row starts on its init
        ir = rng.standard_normal(lead).astype(np.float32)
        ic = (rng.standard_normal(lead)
              + 1j * rng.standard_normal(lead)).astype(np.complex64)
        if case == "complex_and_real":
            vals, inits = (vc, vr), (ic, ir)
        else:
            vals, inits = (vr,), (ir,)
        got = jax.jit(forward_fill_multi)(vals, m, inits)
        for g, v, i in zip(got, vals, inits):
            np.testing.assert_array_equal(np.asarray(g),
                                          fill_reference(v, m, i))
