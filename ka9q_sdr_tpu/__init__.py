"""ka9q_sdr_tpu — a JAX rebuild of the ka9q-radio SDR suite.

The reference (OpenResearchInstitute/ka9q-sdr, Phil Karn's ka9q-radio) is a
set of C/pthreads UNIX processes connected by RTP multicast: hardware front
ends multicast raw I/Q; the `radio` program downconverts, filters
(overlap-save fast convolution) and demodulates (AM/FM/linear-SSB) into
48 kHz PCM; downstream modules transcode, play, decode and record.

This package re-designs that stack for an accelerator, in JAX:

- ``ops``      — pure-functional JAX DSP primitives (overlap-save filter
                 engine, NCO phase ramps, Kaiser filter design, half-band
                 decimators, AGC/IIR recurrences).  Equivalent of the
                 reference's filter.c / osc.c / dsp.c / decimate.c.
- ``models``   — demodulators (FM / AM / linear) and receivers built from
                 ops, including the batched multichannel bank (the
                 flagship: one wideband FFT shared by hundreds of channels).
                 Equivalent of fm.c / am.c / linear.c / radio.c.
- ``parallel`` — jax.sharding mesh utilities for sharding the channel axis
                 across devices.
- ``net``      — wire-compatible host transport: RTP/multicast, TLV
                 status/command protocol, RTCP.  Equivalent of multicast.c /
                 status.c / rtcp.c, with a C++ fast path.
- ``io``       — I/Q recording/replay with xattr metadata, PCM framing,
                 signal synthesis.  Equivalent of iqrecord.c / iqplay.c /
                 modulate.c / audio.c.
- ``audio``    — PCM/Opus playback-side modules (monitor, pcmcat, opus).
- ``decode``   — AFSK/AX.25/APRS digital decode chain.
- ``utils``    — mode tables, band plans, receiver state files.
- ``apps``     — command-line daemons mirroring the reference binaries.

All DSP state is explicit: every block processor is a pure function
``(state, x_block) -> (state, outputs)`` suitable for jit / vmap / scan /
shard_map.
"""

__version__ = "0.1.0"
