"""`python -m ka9q_sdr_tpu` — list the available daemons."""

import sys

APPS = {
    "radio": "core receiver: I/Q in, PCM + status out (main.c/radio.c)",
    "bankd": "multichannel bank: N channels, one FFT",
    "frontend": "front-end daemon/simulator with frac-N LO model",
    "iqplay": "replay recordings as RTP I/Q (iqplay.c)",
    "iqrecord": "record RTP sessions with xattr metadata (iqrecord.c)",
    "modulate": "audio -> modulated I/Q test signals (modulate.c)",
    "pcmcat": "PCM RTP -> raw s16 stdout (pcmcat.c)",
    "pcmsend": "raw s16 stdin -> PCM RTP (pcmsend.c)",
    "opusd": "PCM -> Opus transcoder (opus.c)",
    "opussend": "raw s16 stdin -> Opus RTP (opussend.c)",
    "monitor": "multi-stream jitter-buffered mixer (monitor.c)",
    "packetd": "AFSK/AX.25 packet demodulator (packet.c)",
    "aprs": "APRS position monitor with look angles (aprs.c)",
    "aprsfeed": "APRS-IS i-gate (aprsfeed.c)",
    "control": "TLV status dashboard + remote tune (control.c)",
    "display": "interactive curses tuning UI (display.c)",
}


def main() -> int:
    print("ka9q_sdr_tpu — ka9q-radio rebuilt on JAX.  Daemons:")
    for name, desc in APPS.items():
        print(f"  python -m ka9q_sdr_tpu.apps.{name:<9} {desc}")
    print("\nDocs: README.md, PARITY.md, ARCHITECTURE.md")
    return 0


if __name__ == "__main__":
    sys.exit(main())
