"""Golden reference executor: the C receiver's per-sample semantics in
float32 numpy.

This reproduces the reference's sample-by-sample control flow (radio.c
proc_samples, am.c/fm.c/linear.c demod loops) literally — sequential
recurrences, per-sample AGC, per-sample discriminator state — as a parity
oracle for the vectorised JAX pipeline (each step annotated with its
file:line source).

Since r5 this is a FAST PROXY, not the ground truth: the compiled
reference C itself (osc.c, dsp.c, decimate.c, and filter.c backed by a
real FFT shim) is built by tests/c_ref.py and differentially tested
against the rebuild in tests/test_c_dsp_parity.py, anchoring the
BASELINE.json "PCM RMS error vs the C reference" chain in actual C
output.  This executor remains the oracle for the demod-thread layers
(fm.c/am.c/linear.c need the full radio struct machinery to compile) and
for everything batched/banked.

Deliberately slow and literal.  Test-only code.
"""

from __future__ import annotations

import numpy as np

from ka9q_sdr_tpu.ops.fftfilt import (
    FilterType,
    MasterSpec,
    SlaveSpec,
    set_filter_response,
)
from ka9q_sdr_tpu.ops.window import window_rfilter

F32 = np.float32


class GoldenMaster:
    """execute_filter_input (filter.c:146-172): overlap-save forward FFT."""

    def __init__(self, L, M, real=False):
        self.L, self.M, self.N = L, M, L + M - 1
        self.real = real
        dt = np.float32 if real else np.complex64
        self.buf = np.zeros(self.N, dt)

    def execute(self, block):
        self.buf[: self.M - 1] = self.buf[self.L :]
        self.buf[self.M - 1 :] = block
        if self.real:
            return np.fft.rfft(self.buf).astype(np.complex64)
        return np.fft.fft(self.buf).astype(np.complex64)


class GoldenSlave:
    """execute_filter_output (filter.c:175-252) for the cases the demods
    use: complex in / complex out, and real in / real out."""

    def __init__(self, master: GoldenMaster, response, decimate, out_real=False):
        self.m = master
        self.response = np.asarray(response, np.complex64)
        self.dec = decimate
        self.N_dec = master.N // decimate
        self.olen = master.L // decimate
        self.out_real = out_real

    def execute(self, fdomain):
        h = self.N_dec // 2
        if self.m.real and self.out_real:
            f_fd = self.response[: h + 1] * fdomain[: h + 1]
            y = np.fft.irfft(f_fd, self.N_dec) * self.N_dec
            return y[self.N_dec - self.olen :].astype(np.float32)
        pos = self.response[: h + 1] * fdomain[: h + 1]
        neg = self.response[h + 1 :] * fdomain[self.m.N - h + 1 :]
        f_fd = np.concatenate([pos, neg])
        y = np.fft.ifft(f_fd) * self.N_dec
        return y[self.N_dec - self.olen :].astype(np.complex64)


class GoldenAM:
    """demod_am per-sample loop (am.c:51-75)."""

    def __init__(self, dsamprate, headroom_db=-15.0, recovery_db_s=50.0,
                 hangtime_s=0.0):
        samptime = 1.0 / dsamprate
        self.recovery = F32(10 ** (recovery_db_s * samptime / 20.0))
        self.hangmax = int(hangtime_s / samptime)
        self.headroom = F32(10 ** (headroom_db / 20.0))
        self.gain = F32(10 ** (80 / 20.0))
        self.hang = 0
        self.dc = F32(0.0)
        self.dc_coeff = F32(1e-4)

    def demod(self, bb):
        out = np.empty(len(bb), F32)
        for n, s in enumerate(bb):
            samp = F32(np.sqrt(s.real * s.real + s.imag * s.imag))
            self.dc = F32(self.dc + self.dc_coeff * (samp - self.dc))
            if self.gain * self.dc > self.headroom:          # am.c:66
                self.gain = F32(self.headroom / self.dc)
                self.hang = self.hangmax
            elif self.hang != 0:
                self.hang -= 1
            else:
                self.gain = F32(self.gain * self.recovery)
            out[n] = F32((samp - self.dc) * self.gain)
        return out


class GoldenFM:
    """demod_fm loop (fm.c:72-173): SNR squelch, blanking discriminator,
    de-emphasis audio slave."""

    def __init__(self, dsamprate, low, high, L_dec, M_dec,
                 headroom_db=-15.0, beta=3.0, flat=False):
        self.flat = flat
        self.dsamprate = dsamprate
        headroom = 10 ** (headroom_db / 20.0)
        self.gain = F32(headroom * (1 / np.pi) * dsamprate / abs(low - high))
        am = GoldenMaster(L_dec, M_dec, real=True)
        AN = am.N
        fg = 10.0 / AN
        j = np.arange(AN // 2 + 1)
        f = j * dsamprate / AN
        aresp = np.where((f >= 300) & (f <= 6000),
                         fg * 300.0 / np.maximum(f, 1.0), 0.0).astype(complex)
        resp = window_rfilter(L_dec, M_dec, aresp, beta).astype(np.complex64)
        self.audio_master = am
        self.audio_slave = GoldenSlave(am, resp, 1, out_real=True)
        self.state = np.complex64(1.0)
        self.lastaudio = F32(0.0)
        self.snr_below = 0

    def demod(self, bb):
        n = len(bb)
        sampsq = bb.real**2 + bb.imag**2
        bb_power = float(np.sum(sampsq)) / (2 * n)
        amp = np.sqrt(sampsq)
        avg_amp = float(np.sum(amp)) / (np.sqrt(2.0) * n)
        variance = bb_power - avg_amp * avg_amp           # fm.c:101
        snr = max(0.0, avg_amp * avg_amp / (2 * variance) - 1.0) \
            if variance > 0 else 0.0
        if snr > 2.0:
            self.snr_below = 0
        else:
            self.snr_below = min(self.snr_below + 1, 1000)
        samples = np.zeros(n, F32)
        if self.snr_below < 2:
            min_ampl = 0.55 * 0.55 * avg_amp * avg_amp
            for i in range(n):
                s = bb[i]
                if sampsq[i] > min_ampl:
                    v = F32(np.angle(s * self.state))
                    self.lastaudio = v
                    self.state = np.conj(s)
                    samples[i] = v
                else:
                    samples[i] = self.lastaudio
        else:
            self.state = np.complex64(0.0)
            self.lastaudio = F32(0.0)
        fd = self.audio_master.execute(samples)
        if self.flat:
            # FM flat: no audio filter, audio is already in samples[]
            # (fm.c:165-167); the master still runs (feeds pltask)
            return samples.astype(F32)
        audio = self.audio_slave.execute(fd) * self.gain
        return audio.astype(F32)


class GoldenLinear:
    """demod_linear without PLL (linear.c:247-300): per-sample AGC; mono
    sends I only, stereo sends I left / Q right (linear.c:291-300)."""

    def __init__(self, dsamprate, headroom_db=-15.0, recovery_db_s=6.0,
                 hangtime_s=1.1, mono=True):
        samptime = 1.0 / dsamprate
        self.recovery = F32(10 ** (recovery_db_s * samptime / 20.0))
        self.hangmax = int(hangtime_s / samptime)
        self.headroom = F32(10 ** (headroom_db / 20.0))
        self.gain = F32(10 ** (100 / 20.0))
        self.hang = 0
        self.mono = mono

    def demod(self, bb):
        out = np.empty(len(bb) if self.mono else (len(bb), 2), F32)
        for n, s in enumerate(bb):
            amplitude = F32(np.sqrt(s.real * s.real + s.imag * s.imag))
            if amplitude * self.gain > self.headroom:      # linear.c:271
                self.gain = F32(self.headroom / amplitude)
                self.hang = self.hangmax
            elif self.hang != 0:
                self.hang -= 1
            else:
                self.gain = F32(self.gain * self.recovery)
            if self.mono:
                out[n] = F32(s.real * self.gain)           # mono = I
            else:
                out[n, 0] = F32(s.real * self.gain)        # I on left
                out[n, 1] = F32(s.imag * self.gain)        # Q on right
        return out


class GoldenReceiver:
    """proc_samples + demod thread, single channel (radio.c:41-147)."""

    def __init__(self, mode, samprate=192000, L=3840, M=4353, freq=0.0,
                 enable_pl=False):
        from ka9q_sdr_tpu.utils.modes import DEFAULT_MODES

        md = DEFAULT_MODES[mode.upper()]
        self.master = GoldenMaster(L, M)
        decimate = samprate // 48000
        dsr = samprate / decimate
        out_type = FilterType.CROSS_CONJ if md.isb else FilterType.COMPLEX
        spec = SlaveSpec(MasterSpec(L, M, FilterType.COMPLEX), decimate,
                         out_type)
        resp = set_filter_response(spec, md.low / dsr, md.high / dsr, 3.0)
        slave_cls = GoldenSlaveCrossConj if md.isb else GoldenSlave
        self.slave = slave_cls(self.master, resp, decimate)
        self.lo2_freq = -freq / samprate    # cycles/sample
        self.lo2_phase = 0.0                # float64 phasor (osc.c)
        if md.demod == "AM":
            self.demod = GoldenAM(dsr, recovery_db_s=md.recovery_rate,
                                  hangtime_s=md.hangtime)
        elif md.demod == "FM":
            fm_cls = GoldenFMPL if enable_pl else GoldenFM
            self.demod = fm_cls(dsr, md.low, md.high, L // decimate,
                                (M - 1) // decimate + 1,
                                flat=getattr(md, "flat", False))
        elif md.pll:
            self.demod = GoldenLinearPLL(
                dsr, L // decimate, square=md.square,
                recovery_db_s=md.recovery_rate, hangtime_s=md.hangtime,
                mono=(md.channels == 1),
            )
        else:
            self.demod = GoldenLinear(dsr, recovery_db_s=md.recovery_rate,
                                      hangtime_s=md.hangtime,
                                      mono=(md.channels == 1))

    def process(self, iq):
        n = len(iq)
        k = np.arange(n)
        lo = np.exp(2j * np.pi * (self.lo2_phase + k * self.lo2_freq))
        self.lo2_phase = (self.lo2_phase + n * self.lo2_freq) % 1.0
        mixed = (iq * lo).astype(np.complex64)
        fd = self.master.execute(mixed)
        bb = self.slave.execute(fd)
        return self.demod.demod(bb)


class GoldenSlaveCrossConj(GoldenSlave):
    """CROSS_CONJ (ISB) slave: complex in, cross-conjugated out
    (filter.c:225-249)."""

    def execute(self, fdomain):
        h = self.N_dec // 2
        pos = self.response[: h + 1] * fdomain[: h + 1]
        neg = self.response[h + 1 :] * fdomain[self.m.N - h + 1 :]
        f_fd = np.concatenate([pos, neg]).astype(np.complex64)
        # ISB trick (filter.c:239-249)
        for p in range(1, h):
            dn = self.N_dec - p
            a, b = f_fd[p], f_fd[dn]
            f_fd[p] = a + np.conj(b)
            f_fd[dn] = b - np.conj(a)
        y = np.fft.ifft(f_fd) * self.N_dec
        return y[self.N_dec - self.olen :].astype(np.complex64)


class GoldenLinearShift(GoldenLinear):
    """Linear demod with the post-AGC CW shift oscillator
    (linear.c:283-289) and stereo option."""

    def __init__(self, dsamprate, shift_hz, mono=True, **kw):
        super().__init__(dsamprate, **kw)
        self.shift_freq = shift_hz / dsamprate
        self.shift_phase = 0.0
        self.mono = mono

    def demod(self, bb):
        out = np.empty(len(bb) if self.mono else (len(bb), 2), F32)
        for n, s in enumerate(bb):
            amplitude = F32(np.sqrt(s.real * s.real + s.imag * s.imag))
            if amplitude * self.gain > self.headroom:
                self.gain = F32(self.headroom / amplitude)
                self.hang = self.hangmax
            elif self.hang != 0:
                self.hang -= 1
            else:
                self.gain = F32(self.gain * self.recovery)
            v = s * self.gain
            if self.shift_freq != 0.0:
                lo = np.exp(2j * np.pi * self.shift_phase)
                self.shift_phase = (self.shift_phase + self.shift_freq) % 1.0
                v = v * lo
            if self.mono:
                out[n] = F32(v.real)
            else:
                out[n, 0] = F32(v.real)
                out[n, 1] = F32(v.imag)
        return out


class GoldenLinearPLL(GoldenLinear):
    """demod_linear WITH carrier tracking (linear.c:114-246): the full-rate
    64k circular acquisition buffer + FFT peak search (178-201), lock
    hysteresis (158-170), coarse+fine double-precision phasor NCOs stepped
    per sample (207-218, osc.c:39-51), once-per-block lag-lead loop
    (226-245), then the per-sample AGC / mono output of the base class.

    ramprate is 0 in the reference (linear.c:67 "temp disable"), so no
    acquisition sweep.
    """

    def __init__(self, dsamprate, block_len, square=False, loop_bw=1.0,
                 lock_time=1.0, **kw):
        super().__init__(dsamprate, **kw)
        self.samptime = 1.0 / dsamprate
        self.blocktime = self.samptime * block_len
        self.square = square
        self.fftsize = 1 << 16                       # linear.c:43
        self.binsize = 1.0 / (self.fftsize * self.samptime)
        mult = 2 if square else 1
        self.lowlimit = round(mult * -300.0 / self.binsize)   # linear.c:53-56
        self.highlimit = round(mult * 300.0 / self.binsize)
        natfreq = loop_bw * 2 * np.pi                # linear.c:59-65
        tau1 = 2 * np.pi / (natfreq * natfreq)
        self.integrator_gain = 1.0 / tau1
        tau2 = 2 * (1 / np.sqrt(2.0)) / natfreq
        self.prop_gain = tau2 / tau1
        self.lock_limit = round(lock_time / self.samptime)
        self.snrthresh = 10 ** (3 / 10.0)            # linear.c:42,46
        self.fftin = np.zeros(self.fftsize, np.complex64)
        self.fft_ptr = 0
        self.fft_samples = 0
        self.lock_count = 0
        self.pll_lock = False
        self.integrator = 0.0
        self.delta_f = 0.0
        self.snr = 0.0                               # linear.c:71
        # double-precision phasors (struct osc, osc.c)
        self.coarse_phasor = 1.0 + 0.0j
        self.coarse_step = 1.0 + 0.0j
        self.fine_phasor = 1.0 + 0.0j
        self.fine_step = 1.0 + 0.0j
        self.cphase = 0.0
        self.foffset = float("nan")
        self.lock_trace = []     # (delta_f, pll_lock, cphase) per block

    def _pll_block(self, bb):
        n = len(bb)
        # circular acquisition buffer (linear.c:131-153)
        feed = (bb * bb) if self.square else bb
        for v in feed.astype(np.complex64):
            self.fftin[self.fft_ptr] = v
            self.fft_ptr = (self.fft_ptr + 1) % self.fftsize
        self.fft_samples = min(self.fft_samples + n, self.fftsize)

        # lock detector w/ hysteresis on the previous block's SNR
        # (linear.c:158-170)
        if self.snr < self.snrthresh:
            self.lock_count -= n
        else:
            self.lock_count += n
        if self.lock_count >= self.lock_limit:
            self.lock_count = self.lock_limit
            self.pll_lock = True
        if self.lock_count <= -self.lock_limit:
            self.lock_count = -self.lock_limit
            self.pll_lock = False

        # reacquisition (linear.c:173-201)
        if not self.pll_lock and self.fft_samples > self.fftsize // 2:
            self.fft_samples = 0
            spec = np.fft.fft(self.fftin)
            maxbin, maxenergy = 0, 0.0
            for b in range(self.lowlimit, self.highlimit + 1):
                e = float(abs(spec[b]) ** 2)   # negative b wraps
                if e > maxenergy:
                    maxenergy, maxbin = e, b
            if maxenergy > 0:
                ndf = self.binsize * maxbin
                if self.square:
                    ndf /= 2
                if ndf != self.delta_f:
                    self.delta_f = ndf
                    self.integrator = 0.0
                    self.coarse_step = np.exp(
                        -2j * np.pi * self.samptime * self.delta_f
                    )

        # apply coarse+fine, gather mean phase (linear.c:207-224)
        out = np.empty(n, np.complex64)
        accum = 0.0 + 0.0j
        for i in range(n):
            self.coarse_phasor *= self.coarse_step
            self.fine_phasor *= self.fine_step
            v = bb[i] * self.coarse_phasor * self.fine_phasor
            out[i] = v
            accum += (v * v) if self.square else v
        # renorm (osc.c:53-59 runs every 16384 steps; per block is finer
        # but changes nothing beyond float noise)
        self.coarse_phasor /= abs(self.coarse_phasor)
        self.fine_phasor /= abs(self.fine_phasor)
        cphase = float(np.angle(accum))
        if self.square:
            cphase /= 2

        # lag-lead loop (linear.c:226-245); ramp == 0
        self.integrator += cphase * self.blocktime
        feedback = (self.integrator_gain * self.integrator
                    + self.prop_gain * cphase)
        self.fine_step = np.exp(-2j * np.pi * feedback * self.samptime)
        if np.isnan(self.foffset):
            self.foffset = feedback + self.delta_f
        else:
            self.foffset += 0.001 * (feedback + self.delta_f - self.foffset)
        self.cphase = cphase
        self.lock_trace.append((self.delta_f, self.pll_lock, cphase))
        return out

    def demod(self, bb):
        bb = self._pll_block(np.asarray(bb, np.complex64))
        # signal/noise sums feed NEXT block's lock detector
        # (linear.c:248-258, 304-309)
        signal = float(np.sum(bb.real.astype(np.float64) ** 2))
        noise = float(np.sum(bb.imag.astype(np.float64) ** 2))
        if noise != 0:
            self.snr = max(0.0, signal / noise - 1.0)
        else:
            # linear.c:309 sets NAN; `NAN < snrthresh` is false, so the
            # lock detector drifts toward lock on noiseless input
            self.snr = float("nan")
        out = super().demod(bb)
        return out


class GoldenFMPL(GoldenFM):
    """GoldenFM + the PL tone measurement thread (pltask, fm.c:189-277):
    <300 Hz REAL slave decimating the audio master by 32, a 16k-point real
    FFT over a 10.9 s window every 512 PL samples, peak bin must hold >1%
    of total energy and land in 67-255 Hz."""

    PL_DECIMATE = 32

    def __init__(self, *a, beta=3.0, **kw):
        super().__init__(*a, beta=beta, **kw)
        am = self.audio_master
        AN, AL = am.N, am.L
        PL_N = AN // self.PL_DECIMATE
        PL_L = AL // self.PL_DECIMATE
        PL_M = PL_N - PL_L + 1
        j = np.arange(PL_N // 2 + 1)
        f = j * self.dsamprate / AN            # relative to input rate
        presp = np.where((f > 0) & (f < 300.0), 1.0, 0.0).astype(complex)
        presp = window_rfilter(PL_L, PL_M, presp, 2.0).astype(np.complex64)
        self.pl_slave = GoldenSlave(am, presp, self.PL_DECIMATE,
                                    out_real=True)
        self.pl_fft_size = (1 << 19) // self.PL_DECIMATE
        self.pl_input = np.zeros(self.pl_fft_size, np.float32)
        self.pl_ptr = 0
        self.last_fft = 0
        self.plfreq = float("nan")
        self.pl_trace = []    # plfreq after each block

    def demod(self, bb):
        audio = super().demod(bb)
        # super() ran audio_master.execute; its spectrum is in buf: redo
        # the master fd for the pl slave from the same discriminator block
        fd = np.fft.rfft(self.audio_master.buf).astype(np.complex64)
        pl = self.pl_slave.execute(fd)
        # circular fill (fm.c:237-251)
        for v in pl:
            self.pl_input[self.pl_ptr] = v
            self.pl_ptr = (self.pl_ptr + 1) % self.pl_fft_size
        self.last_fft += len(pl)
        if self.last_fft >= 512:               # fm.c:251-253
            self.last_fft = 0
            spec = np.fft.rfft(self.pl_input)
            energy = np.abs(spec) ** 2
            tot = float(np.sum(energy[1 : self.pl_fft_size // 2]))
            peakbin = int(np.argmax(energy[1 : self.pl_fft_size // 2])) + 1
            peak = float(energy[peakbin])
            pl_samprate = self.dsamprate / self.PL_DECIMATE
            if peakbin > 0 and peak > 0.01 * tot:
                f = peakbin * pl_samprate / self.pl_fft_size
                if 67.0 < f < 255.0:
                    self.plfreq = f
                # out-of-range strong peak: plfreq KEEPS its old value
                # (fm.c:270-276 has no inner else)
            else:
                self.plfreq = float("nan")
        self.pl_trace.append(self.plfreq)
        return audio
