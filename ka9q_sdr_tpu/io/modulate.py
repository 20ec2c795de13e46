"""Test modulator / signal generator (modulate.c).

Takes real baseband audio (48 kHz), 4x zero-stuff upsamples it through the
same overlap-save filter engine with an analytic (SSB) or double-sideband
bandpass response, optionally adds a carrier, and upconverts with a
swept-capable NCO — producing the I/Q test vectors that close the loop on
the demodulators (modulate -> iqplay -> radio, SURVEY.md §4).

AM / USB / LSB / AME presets match modulate.c:75-95; gain bookkeeping
(4/N for the FFT round trip and 4x upsampling, modulate.c:118) matches
exactly.  Runs in JAX on the default device; the `modulate` app pins
itself to the host CPU (test-signal generation does not need the card).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.fftfilt import (
    FilterType,
    MasterSpec,
    SlaveSpec,
    master_init,
    master_execute,
    slave_execute,
)
from ..ops.nco import osc_init, set_osc, osc_block
from ..ops.window import window_filter

__all__ = ["MODULATE_PRESETS", "Modulator"]

#: (carrier, low, high) per mode (modulate.c:75-95).
MODULATE_PRESETS = {
    "am": (1.0, -5000.0, +5000.0),
    "usb": (0.0, 0.0, +3000.0),
    "lsb": (0.0, -3000.0, 0.0),
    "ame": (1.0, 0.0, +3000.0),   # enhanced AM: USB + carrier (CHU)
}

UPSAMPLE = 4
BLOCKSIZE = 960   # modulate.c BLOCKSIZE (after 4x upsample = 240 in)


class Modulator:
    """Real audio blocks in (rate samprate/4), complex I/Q blocks out
    (rate samprate).  Defaults mirror modulate.c: 192 kHz out, 48 kHz in.
    """

    def __init__(
        self,
        mode: str = "am",
        frequency: float = 48000.0,   # IF carrier, Hz (modulate.c:43)
        amplitude_db: float = -20.0,
        sweep_hz_s: float = 0.0,
        samprate: int = 192000,
        blocksize: int = BLOCKSIZE,
    ):
        carrier, low, high = MODULATE_PRESETS[mode.lower()]
        self.carrier = carrier
        self.samprate = samprate
        L = blocksize
        M = blocksize + 1
        N = L + M - 1
        self.L = L
        # brick-wall response at the *output* rate (modulate.c:115-129)
        i = np.arange(N)
        f = samprate * (i / N)
        f = np.where(f > samprate / 2, f - samprate, f)
        gain = 4.0 / N   # FFT scaling + 4x upsampling (modulate.c:118)
        resp = np.where((f >= low) & (f <= high), gain, 0.0).astype(np.complex128)
        resp = window_filter(L, M, resp, 3.0).astype(np.complex64)

        self.master = MasterSpec(L, M, FilterType.REAL)
        self.slave = SlaveSpec(self.master, 1, FilterType.COMPLEX)
        self.response = resp
        self.overlap = master_init(self.master)
        self.amplitude = 10.0 ** (amplitude_db / 20.0)
        self.osc = set_osc(
            osc_init(),
            frequency / samprate,
            sweep_hz_s / (samprate * samprate),
        )

        def step(overlap, osc, audio_up):
            ov, fd = master_execute(self.master, overlap, audio_up)
            bb = slave_execute(self.slave, fd, jnp.asarray(resp))
            bb = bb + jnp.complex64(self.carrier)
            osc, lo = osc_block(osc, L)
            return ov, osc, bb * lo * jnp.float32(self.amplitude)

        self._step = jax.jit(step)

    def process(self, audio: np.ndarray) -> np.ndarray:
        """audio: (L/4,) float in [-1,1] at samprate/4.  Returns (L,)
        complex64 I/Q at samprate."""
        if len(audio) != self.L // UPSAMPLE:
            raise ValueError(f"need {self.L // UPSAMPLE} samples")
        up = np.zeros(self.L, np.float32)
        up[::UPSAMPLE] = audio  # zero-stuff (modulate.c:140-145)
        self.overlap, self.osc, iq = self._step(self.overlap, self.osc, up)
        return np.asarray(iq)

    def to_int16(self, iq: np.ndarray) -> bytes:
        """Interleaved s16 I/Q as iqplay expects (modulate.c:159-163)."""
        out = np.empty(2 * len(iq), np.int16)
        out[0::2] = np.clip(iq.real * 32767, -32768, 32767).astype(np.int16)
        out[1::2] = np.clip(iq.imag * 32767, -32768, 32767).astype(np.int16)
        return out.tobytes()
