"""App-level tests: the minimum end-to-end slice (SURVEY.md §7 step 3)
plus the control plane, all on localhost multicast loopback — the
reference's own multi-node-without-a-cluster method (SURVEY.md §4 item 5).
"""

import os
import threading
import time

import numpy as np
import pytest

from ka9q_sdr_tpu.io.modulate import Modulator
from ka9q_sdr_tpu.io.iqfile import write_metadata
from ka9q_sdr_tpu.net import status as st
from ka9q_sdr_tpu.net.status import StatusType


@pytest.fixture(scope="module")
def am_recording(tmp_path_factory):
    """0.5 s of 400 Hz AM on a 48 kHz IF at 192 kHz, as s16le I/Q."""
    path = str(tmp_path_factory.mktemp("iq") / "am.iq")
    m = Modulator("am", frequency=48000.0, amplitude_db=-10.0)
    with open(path, "wb") as f:
        for b in range(100):
            tt = (b * 240 + np.arange(240)) / 48000
            audio = (0.8 * np.sin(2 * np.pi * 400 * tt)).astype(np.float32)
            f.write(m.to_int16(m.process(audio)))
    write_metadata(path, {"samplerate": "192000", "frequency": "0.0"})
    return path


def _tone(audio, rate=48000):
    seg = audio[len(audio) // 2:]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    f = np.fft.rfftfreq(len(seg), 1.0 / rate)
    return f[np.argmax(spec[5:]) + 5]


class TestRadioApp:
    def test_file_mode(self, am_recording, tmp_path):
        from ka9q_sdr_tpu.apps.radio import main

        pcm = str(tmp_path / "out.pcm")
        rc = main(
            ["--iq-file", am_recording, "-f", "48k", "-m", "AM",
             "--pcm-raw", pcm]
        )
        assert rc == 0
        a = np.frombuffer(open(pcm, "rb").read(), ">i2").astype(np.float32) / 32767
        assert len(a) == 24000   # 100 modulator blocks -> 25 receiver blocks
        assert abs(_tone(a) - 400.0) < 5.0

    def test_command_retune_and_fe_status(self, am_recording):
        from ka9q_sdr_tpu.apps.radio import RadioDaemon, build_parser

        args = build_parser().parse_args(
            ["--iq-file", am_recording, "-f", "48k", "-m", "AM"]
        )
        d = RadioDaemon(args)
        assert d.rx.tune_freq == 48000.0
        # TLV command: tune to 30 kHz (radio_status.c command handling)
        pkt = bytearray([1])
        st.encode_double(pkt, StatusType.RADIO_FREQUENCY, 30000.0)
        st.encode_eol(pkt)
        d.handle_command(bytes(pkt))
        assert d.rx.tune_freq == 30000.0
        assert d.commands == 1
        # front-end status: LO1 moved -> LO2 recomputed to keep RF
        fe = bytearray([0])
        st.encode_double(fe, StatusType.RADIO_FREQUENCY, 1000.0)  # LO1
        st.encode_eol(fe)
        d.handle_fe_status(bytes(fe))
        assert d.rx.sdr.frequency == 1000.0

    def test_network_slice(self, am_recording):
        """iqplay -> radio -> PCM multicast, all loopback."""
        from ka9q_sdr_tpu.apps.radio import RadioDaemon, build_parser
        from ka9q_sdr_tpu.apps.iqplay import play_stream
        from ka9q_sdr_tpu.net.multicast import setup_mcast
        from ka9q_sdr_tpu.net.rtp import RTPHeader, PCM_MONO_PT

        in_grp = "239.88.7.1:5004"
        out_grp = "239.88.7.2:5004"
        args = build_parser().parse_args(
            ["-I", in_grp, "-R", out_grp, "-f", "48k", "-m", "AM",
             "--blocks", "20"]
        )
        d = RadioDaemon(args)
        pcm_sock = setup_mcast(out_grp, output=False)
        pcm_sock.settimeout(30.0)

        t = threading.Thread(target=d.run_network, daemon=True)
        t.start()
        time.sleep(6.0)  # let the warmup compile finish

        tx = setup_mcast(in_grp, output=True, ttl=0)
        fh = open(am_recording, "rb")

        def reader():
            data = fh.read(960)
            if not data:
                fh.seek(0)
                data = fh.read(960)
            return data

        sender = threading.Thread(
            target=play_stream,
            args=(reader, tx, 192000, 0.0),
            kwargs=dict(realtime=True),
            daemon=True,
        )
        sender.start()
        chunks, total = [], 0
        while total < 10000:   # samples (the radio emits ~19200 then exits)
            data = pcm_sock.recv(9000)
            hdr, off = RTPHeader.from_bytes(data)
            if hdr.type != PCM_MONO_PT:
                continue
            chunk = np.frombuffer(data[off:], ">i2").astype(np.float32) / 32767
            chunks.append(chunk)
            total += len(chunk)
        a = np.concatenate(chunks)
        assert abs(_tone(a) - 400.0) < 5.0
        t.join(timeout=15)


class TestStateFiles:
    def test_roundtrip(self, tmp_path):
        from ka9q_sdr_tpu.utils.state import RadioState, savestate, loadstate

        p = str(tmp_path / "default")
        savestate(
            RadioState(frequency=147435000.0, mode="FM", source="a:1",
                       output="b:2", filter_low=-8000, filter_high=8000),
            p,
        )
        st2 = loadstate(p)
        assert st2.frequency == 147435000.0
        assert st2.mode == "FM"
        assert st2.filter_low == -8000.0


class TestParseFrequency:
    def test_forms(self):
        from ka9q_sdr_tpu.utils.misc import parse_frequency

        assert parse_frequency("12345") == 12345e3   # heuristic kHz
        assert parse_frequency("147m435") == 147.435e6
        assert parse_frequency("12k345") == 12345.0
        assert parse_frequency("1g2") == 1.2e9
        assert parse_frequency("120000") == 120000.0  # >= 1e5 as-is
        assert parse_frequency("48k") == 48000.0

    def test_negative_entries_keep_the_magnitude_heuristic(self):
        """Bank channels are baseband offsets: negative entries are legal
        and must parse like their positive twins with the sign kept (a
        signed comparison would turn -200000 Hz into -2e11 Hz — a
        channel-file USB channel at -200 kHz would silently alias to a
        garbled in-band bin)."""
        from ka9q_sdr_tpu.utils.misc import parse_frequency

        assert parse_frequency("-200000") == -200000.0
        assert parse_frequency("-200k") == -200000.0
        assert parse_frequency("-50") == -50e6
        assert parse_frequency("-12345") == -12345e3
        assert parse_frequency("-147m435") == -147.435e6


class TestSpectrumExtension:
    def test_psd_rides_the_status_stream(self):
        """The SPECTRUM_128 TLV extension: device-side PSD of the master
        FFT (post-LO2, so the tuned carrier sits at center bin 64) decoded
        by the control mirror."""
        import types

        from ka9q_sdr_tpu.apps.radio import RadioDaemon, build_parser
        from ka9q_sdr_tpu.apps.control import StatusMirror
        from ka9q_sdr_tpu.net.status import StatusType
        from ka9q_sdr_tpu.io.modulate import Modulator
        from ka9q_sdr_tpu.io.iqfile import write_metadata

        import tempfile, os

        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "am.iq")
            m = Modulator("am", frequency=48000.0, amplitude_db=-10.0)
            with open(path, "wb") as f:
                for b in range(20):
                    tt = (b * 240 + np.arange(240)) / 48000
                    f.write(m.to_int16(m.process(
                        (0.5 * np.sin(2 * np.pi * 400 * tt)).astype(np.float32))))
            write_metadata(path, {"samplerate": "192000"})

            args = build_parser().parse_args(
                ["--iq-file", path, "-f", "48k", "-m", "AM"])
            d = RadioDaemon(args)
            sent = []
            d.status_sock = types.SimpleNamespace(send=sent.append)
            from ka9q_sdr_tpu.io.iqfile import IQReader

            diag = None
            for i, block in enumerate(IQReader(path).blocks(3840)):
                _, diag = d.rx.process(block)
            d.emit_status({k: np.asarray(v) for k, v in diag.items()})
            mirror = StatusMirror()
            mirror.update(sent[0])
            spec = mirror.get(StatusType.SPECTRUM_128)
            assert spec is not None and len(spec) == 128
            bins = np.frombuffer(spec, np.uint8)
            # carrier downconverted to DC -> center bin; strong peak
            assert abs(int(np.argmax(bins)) - 64) <= 1
            assert bins.max() - bins.min() > 40


class TestRuntimeModeChange:
    def test_set_mode_preserves_tuning(self, am_recording):
        """set_mode (radio.c:322-374): switch AM -> USB mid-stream; the
        LO2 keeps its phase (the tone stays on frequency) and the new
        demod takes over."""
        from ka9q_sdr_tpu.models.receiver import Receiver, make_receiver_config

        rx = Receiver(make_receiver_config("AM", samprate=192000))
        rx.set_freq(30000.0)
        for b in range(5):
            tt = (b * 3840 + np.arange(3840)) / 192000
            sig = (0.2 * np.exp(2j * np.pi * 31000 * tt)).astype(np.complex64)
            rx.process(sig)
        rx.set_mode("USB")
        out = []
        for b in range(5, 30):
            tt = (b * 3840 + np.arange(3840)) / 192000
            sig = (0.2 * np.exp(2j * np.pi * 31000 * tt)).astype(np.complex64)
            audio, _ = rx.process(sig)
            out.append(np.asarray(audio))
        a = np.concatenate(out)
        assert abs(_tone(a) - 1000.0) < 10.0

    def test_mode_command_in_daemon(self, am_recording):
        from ka9q_sdr_tpu.apps.radio import RadioDaemon, build_parser
        from ka9q_sdr_tpu.net import status as st
        from ka9q_sdr_tpu.net.status import StatusType

        args = build_parser().parse_args(
            ["--iq-file", am_recording, "-f", "48k", "-m", "AM"])
        d = RadioDaemon(args)
        pkt = bytearray([1])
        st.encode_string(pkt, StatusType.RADIO_MODE, "USB")
        st.encode_eol(pkt)
        d.handle_command(bytes(pkt))
        assert d.mode == "USB"
        assert d.rx.cfg.mode.demod == "LINEAR"


class TestOfflineScan:
    def test_scan_matches_block_loop(self, am_recording):
        """The lax.scan offline path equals the per-block loop."""
        from ka9q_sdr_tpu.models.receiver import Receiver, make_receiver_config

        raw = np.fromfile(am_recording, "<i2")
        n_blocks = len(raw) // (2 * 3840)
        blocks_i16 = raw[: n_blocks * 2 * 3840].reshape(n_blocks, 3840, 2)

        rx1 = Receiver(make_receiver_config("AM", samprate=192000,
                                            enable_pl=False))
        rx1.set_freq(48000.0)
        audio_scan = rx1.process_offline(blocks_i16)

        rx2 = Receiver(make_receiver_config("AM", samprate=192000,
                                            enable_pl=False))
        rx2.set_freq(48000.0)
        loop = []
        for b in range(n_blocks):
            x = blocks_i16[b].astype(np.float32) / 32767.0
            audio, _ = rx2.process((x[:, 0] + 1j * x[:, 1]).astype(np.complex64))
            loop.append(np.asarray(audio))
        loop = np.stack(loop)
        # block 0 passes through the AGC's 80 dB startup clamp where float
        # ordering differences amplify; from block 1 the paths are exact
        assert np.allclose(audio_scan[1:], loop[1:], atol=1e-5)
        assert np.allclose(audio_scan[0], loop[0], atol=1e-3)


class TestIQRecordRoundtrip:
    def test_record_then_replay_demodulates(self, am_recording, tmp_path):
        """iqrecord captures a multicast session (sparse, xattr metadata);
        replaying the file through radio recovers the audio — the
        reference's golden-capture methodology (SURVEY.md §4)."""
        import threading

        from ka9q_sdr_tpu.apps.iqrecord import main as rec_main
        from ka9q_sdr_tpu.apps.iqplay import play_stream
        from ka9q_sdr_tpu.net.multicast import setup_mcast
        from ka9q_sdr_tpu.apps.radio import main as radio_main

        grp = "239.88.9.1:5004"
        rec_dir = str(tmp_path / "recs")
        import os

        os.makedirs(rec_dir)
        npkts = 300
        t = threading.Thread(
            target=rec_main,
            args=(["-I", grp, "-D", rec_dir, "--packets", str(npkts)],),
        )
        t.start()
        time.sleep(0.5)
        tx = setup_mcast(grp, output=True, ttl=0)
        fh = open(am_recording, "rb")

        def reader():
            return fh.read(960)   # b"" at EOF ends the pass

        # feed whole-file passes until the recorder has its packets
        for _ in range(20):
            fh.seek(0)
            play_stream(reader, tx, 192000, 146520000.0, realtime=False)
            time.sleep(0.2)
            if not t.is_alive():
                break
        t.join(timeout=10)
        assert not t.is_alive()
        recs = [f for f in os.listdir(rec_dir) if not f.endswith(".attrs")]
        assert len(recs) == 1
        rec_path = os.path.join(rec_dir, recs[0])
        assert recs[0].startswith("iqrecord-146520000")
        from ka9q_sdr_tpu.io.iqfile import read_metadata

        attrs = read_metadata(rec_path)
        assert attrs["samplerate"] == "192000"

        pcm = str(tmp_path / "replay.pcm")
        radio_main(["--iq-file", rec_path, "-f", "48k", "-m", "AM",
                    "--pcm-raw", pcm])
        a = np.frombuffer(open(pcm, "rb").read(), ">i2").astype(np.float32) / 32767
        assert len(a) > 10000
        assert abs(_tone(a) - 400.0) < 5.0


class TestIQRecorderFrameSizes:
    def test_iq8_gap_hole_uses_one_byte_components(self, tmp_path):
        """8-bit I/Q (PT 98) frames are 2 bytes, not 4: a timestamp gap
        must leave a hole of gap*2 bytes (a 16-bit-sized hole would
        double every subsequent sample's timing offset)."""
        import os

        from ka9q_sdr_tpu.io.iqfile import IQRecorder
        from ka9q_sdr_tpu.net.rtp import RTPHeader, IQ_PT8

        rec = IQRecorder(directory=str(tmp_path))
        pay = bytes(range(200))                      # 100 IQ8 samples
        rec.write_packet(RTPHeader(type=IQ_PT8, seq=0, timestamp=0,
                                   ssrc=7), pay)
        # 50-sample gap
        rec.write_packet(RTPHeader(type=IQ_PT8, seq=1, timestamp=150,
                                   ssrc=7), pay)
        rec.close()
        size = os.path.getsize(rec.path)
        assert size == (100 + 50 + 100) * 2

    def test_iq8_session_metadata_and_replay(self, tmp_path):
        """An 8-bit I/Q session must be described as what it is: s8
        sampleformat, frequency attr, iqrecord- filename (regression:
        it fell into the PCM branch and was recorded as 's16be' with a
        pcmrecord- name, so replay decoded garbage), and IQReader must
        decode it from the attr."""
        import os

        import numpy as np

        from ka9q_sdr_tpu.io.iqfile import IQRecorder, IQReader, read_metadata
        from ka9q_sdr_tpu.net.rtp import RTPHeader, IQ_PT8

        rec = IQRecorder(directory=str(tmp_path), frequency=146520000.0,
                         samprate=192000)
        # 100 samples of a known s8 ramp on I, constant on Q
        iq = np.zeros((100, 2), np.int8)
        iq[:, 0] = np.arange(-50, 50, dtype=np.int8)
        iq[:, 1] = 64
        written = rec.write_packet(
            RTPHeader(type=IQ_PT8, seq=0, timestamp=0, ssrc=9),
            iq.tobytes())
        assert written == 100
        # a duplicate writes nothing and reports 0 frames
        assert rec.write_packet(
            RTPHeader(type=IQ_PT8, seq=0, timestamp=0, ssrc=9),
            iq.tobytes()) == 0
        rec.close()
        assert os.path.basename(rec.path).startswith("iqrecord-146520000")
        attrs = read_metadata(rec.path)
        assert attrs["sampleformat"] == "s8"
        assert float(attrs["frequency"]) == 146520000.0
        blocks = list(IQReader(rec.path).blocks(100))
        assert len(blocks) == 1
        np.testing.assert_allclose(blocks[0].real, iq[:, 0] / 127.0,
                                   atol=1e-6)
        np.testing.assert_allclose(blocks[0].imag, iq[:, 1] / 127.0,
                                   atol=1e-6)


class TestIQRecordDuration:
    def test_d_stops_after_stream_seconds(self, am_recording, tmp_path):
        """iqrecord -d N stops after N seconds of RECORDED stream time
        (iqrecord.c:159,303), independent of wall clock."""
        import os

        from ka9q_sdr_tpu.apps.iqrecord import main as rec_main
        from ka9q_sdr_tpu.apps.iqplay import play_stream
        from ka9q_sdr_tpu.net.multicast import setup_mcast

        grp = "239.88.9.3:5004"
        rec_dir = str(tmp_path / "recs")
        os.makedirs(rec_dir)
        t = threading.Thread(
            target=rec_main,
            args=(["-I", grp, "-D", rec_dir, "-d", "0.05"],),
        )
        t.start()
        time.sleep(0.3)
        tx = setup_mcast(grp, output=True, ttl=0)
        fh = open(am_recording, "rb")

        def reader():
            return fh.read(960)    # 240 IQ samples = 1.25 ms at 192k

        for _ in range(20):        # 0.05 s of stream = 40 packets
            fh.seek(0)
            play_stream(reader, tx, 192000, 146520000.0, realtime=False)
            time.sleep(0.1)
            if not t.is_alive():
                break
        t.join(timeout=10)
        assert not t.is_alive()
        recs = [f for f in os.listdir(rec_dir) if not f.endswith(".attrs")]
        assert len(recs) == 1
        # 0.05 s at 192 kHz x 4 B: the recorder stopped at ~the bound,
        # not at EOF of the (up to) 10 s feed.  The upper bound is loose:
        # loopback loss under load leaves sparse holes that add file size
        # without adding recorded (-d-counted) stream time.
        size = os.path.getsize(os.path.join(rec_dir, recs[0]))
        assert 0.05 * 192000 * 4 <= size < 0.25 * 192000 * 4


class TestCustomModesFile:
    def test_radio_loads_modes_txt(self, am_recording, tmp_path):
        """radio --modes loads a reference-format modes.txt (modes.c:32)."""
        mf = tmp_path / "modes.txt"
        mf.write_text(
            "# custom table\n"
            "WIDEAM  AM  -9000  +9000  0  -50  +50  0.0\n"
        )
        from ka9q_sdr_tpu.apps.radio import RadioDaemon, build_parser

        args = build_parser().parse_args(
            ["--iq-file", am_recording, "-f", "48k", "-m", "WIDEAM",
             "--modes", str(mf)])
        d = RadioDaemon(args)
        assert d.rx.cfg.mode.high == 9000.0
        assert d.rx.cfg.mode.demod == "AM"

    def test_shipped_modes_txt_matches_default_table(self):
        """The installable data/modes.txt (reference ships modes.txt as an
        editable file) parses to exactly the built-in table, so editing a
        copy starts from the true defaults.  (Compared against a fresh
        parse of _DEFAULT_TABLE, not the DEFAULT_MODES global — radio
        --modes updates the global in place, matching the reference's
        process-global Modes table, modes.c:32.)"""
        from importlib import resources as res
        from ka9q_sdr_tpu.utils.modes import _DEFAULT_TABLE, parse_modes

        text = (res.files("ka9q_sdr_tpu") / "data" / "modes.txt").read_text()
        assert parse_modes(text) == parse_modes(_DEFAULT_TABLE)


class TestFaultTolerance:
    def test_gap_preserves_lo_phase_and_timing(self, am_recording):
        """Packet loss -> zero-fill keeps the sample count AND the LO
        phase advancing (radio.c:81-99): after the gap the recovered tone
        must come back at the same frequency AND phase as an unbroken
        stream (coherence through the outage)."""
        from ka9q_sdr_tpu.io.assembler import BlockAssembler
        from ka9q_sdr_tpu.net.rtp import RTPHeader, IQ_PT
        from ka9q_sdr_tpu.models.receiver import Receiver, make_receiver_config

        FS, Lb = 192000, 3840

        def make_packets(drop: set):
            """tone at +31 kHz, 240-sample packets, some dropped."""
            pkts = []
            for i in range(80):
                if i in drop:
                    continue
                tt = (i * 240 + np.arange(240)) / FS
                sig = 0.2 * np.exp(2j * np.pi * 31000 * tt)
                pay = np.empty(480, np.int16)
                pay[0::2] = np.clip(sig.real * 32767, -32768, 32767)
                pay[1::2] = np.clip(sig.imag * 32767, -32768, 32767)
                hdr = RTPHeader(type=IQ_PT, seq=i, timestamp=i * 240, ssrc=1)
                pkts.append(hdr.to_bytes() + b"\x00" * 24 + pay.tobytes())
            return pkts

        def run(drop):
            asm = BlockAssembler(Lb)
            rx = Receiver(make_receiver_config("USB", samprate=FS,
                                               enable_pl=False))
            rx.set_freq(30000.0)
            audio = []
            for p in make_packets(drop):
                asm.push(p)
                for blk in asm.blocks():
                    a, _ = rx.process(blk)
                    audio.append(np.asarray(a))
            return np.concatenate(audio)

        clean = run(set())
        gappy = run({20, 21, 22})   # 720-sample outage mid-stream
        assert len(clean) == len(gappy)   # timing preserved exactly
        # after the gap's transient, the streams must re-align coherently
        tail_c, tail_g = clean[-3000:], gappy[-3000:]
        corr = np.dot(tail_c, tail_g) / np.sqrt(
            np.dot(tail_c, tail_c) * np.dot(tail_g, tail_g)
        )
        # phase-coherent (a phase slip would drive this toward 0); the
        # residual difference is the AGC still re-settling after the gap
        assert corr > 0.95, corr

    def test_reorder_and_dupes_survive(self, am_recording):
        from ka9q_sdr_tpu.io.assembler import BlockAssembler
        from ka9q_sdr_tpu.net.rtp import RTPHeader, IQ_PT

        asm = BlockAssembler(960)
        pay = np.full(480, 5000, np.int16).astype("<i2").tobytes()

        def pkt(seq, ts):
            return (RTPHeader(type=IQ_PT, seq=seq, timestamp=ts, ssrc=9)
                    .to_bytes() + b"\x00" * 24 + pay)

        asm.push(pkt(0, 0))
        asm.push(pkt(1, 240))
        asm.push(pkt(1, 240))   # dupe
        asm.push(pkt(3, 720))   # 2 skipped (arrives early)
        asm.push(pkt(2, 480))   # late: old timestamp -> dropped
        blocks = list(asm.blocks())
        assert len(blocks) == 1
        b = blocks[0]
        assert np.all(b[:480] != 0)        # packets 0,1
        assert np.all(b[480:720] == 0)     # packet 2's slot zero-filled
        assert np.all(b[720:] != 0)        # packet 3
        # the true dupe AND the late packet both count as dupes
        # (negative seq step, multicast.c:326-329)
        assert asm.rtp_state.dupes == 2
        assert asm.rtp_state.drops == 1


class TestLiveParameterEditing:
    """Every parameter the reference edits live in display.c (adjust_item
    128-180, key dispatch 860-986) is editable over the TLV protocol
    (VERDICT r1 item 7)."""

    def _daemon(self, am_recording, mode="USB"):
        from ka9q_sdr_tpu.apps.radio import RadioDaemon, build_parser

        args = build_parser().parse_args(
            ["--iq-file", am_recording, "-f", "30k", "-m", mode]
        )
        return RadioDaemon(args)

    @staticmethod
    def _cmd(d, *triples):
        pkt = bytearray([1])
        for key, kind, val in triples:
            getattr(st, f"encode_{kind}")(pkt, key, val)
        st.encode_eol(pkt)
        d.handle_command(bytes(pkt))

    def test_filter_edges_and_beta_over_tlv(self, am_recording):
        d = self._daemon(am_recording)
        step0 = d.rx._step   # jitted program object
        self._cmd(d,
                  (StatusType.LOW_EDGE, "float", 200.0),
                  (StatusType.HIGH_EDGE, "float", 1500.0),
                  (StatusType.KAISER_BETA, "float", 5.0))
        assert d.rx.cfg.mode.low == 200.0
        assert d.rx.cfg.mode.high == 1500.0
        assert d.rx.cfg.kaiser_beta == 5.0
        # hot swap: the jitted program was NOT rebuilt (filter.c:537-543
        # pointer-swap semantics)
        assert d.rx._step is step0
        # and the new response really narrows the passband: a 2.5 kHz
        # audio tone (in the old 3 kHz USB band) is now attenuated
        fs, Lb = 192000, 3840
        d.rx.set_freq(30000.0)
        outs = []
        for b in range(8):
            tt = (b * Lb + np.arange(Lb)) / fs
            iq = (0.2 * np.exp(2j * np.pi * (30000 + 1000) * tt)
                  + 0.2 * np.exp(2j * np.pi * (30000 + 2500) * tt))
            audio, _ = d.rx.process(iq.astype(np.complex64))
            outs.append(np.asarray(audio))
        a = np.concatenate(outs)[4 * 960:]
        spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
        f = np.fft.rfftfreq(len(a), 1 / 48000)
        p1k = spec[np.argmin(np.abs(f - 1000))]
        p25 = spec[np.argmin(np.abs(f - 2500))]
        assert p1k > 30 * p25, (p1k, p25)   # >30 dB down

    def test_shift_over_tlv(self, am_recording):
        d = self._daemon(am_recording)
        d.rx.set_freq(30000.0)
        self._cmd(d, (StatusType.SHIFT_FREQUENCY, "double", 400.0))
        assert d.rx.cfg.mode.shift == 400.0
        fs, Lb = 192000, 3840
        outs = []
        for b in range(8):
            tt = (b * Lb + np.arange(Lb)) / fs
            iq = 0.2 * np.exp(2j * np.pi * (30000 + 1000) * tt)
            audio, _ = d.rx.process(iq.astype(np.complex64))
            outs.append(np.asarray(audio))
        a = np.concatenate(outs)[4 * 960:]
        spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
        f = np.fft.rfftfreq(len(a), 1 / 48000)
        # 1 kHz audio shifted +400 Hz -> 1.4 kHz
        peak = f[np.argmax(spec[5:]) + 5]
        assert abs(peak - 1400.0) < 15.0, peak

    def test_option_flags_over_tlv(self, am_recording):
        from ka9q_sdr_tpu.ops.fftfilt import FilterType

        d = self._daemon(am_recording)
        self._cmd(d, (StatusType.INDEPENDENT_SIDEBAND, "int", 1))
        assert d.rx.cfg.mode.isb
        assert d.rx.cfg.slave.out_type is FilterType.CROSS_CONJ
        self._cmd(d, (StatusType.PLL_SQUARE, "int", 1))
        assert d.rx.cfg.mode.square and d.rx.cfg.mode.pll  # square => pll
        self._cmd(d, (StatusType.OUTPUT_CHANNELS, "int", 1))
        assert d.rx.cfg.mode.channels == 1
        self._cmd(d, (StatusType.AGC_RECOVERY_RATE, "float", 20.0),
                  (StatusType.AGC_HANGTIME, "float", 0.5))
        assert d.rx.cfg.mode.recovery_rate == 20.0
        assert d.rx.cfg.mode.hangtime == 0.5

    def test_second_lo_command_moves_if(self, am_recording):
        d = self._daemon(am_recording)
        d.rx.set_freq(30000.0)
        lo2_before = d.rx.second_lo
        self._cmd(d, (StatusType.SECOND_LO_FREQUENCY, "double", 48000.0))
        assert d.rx.second_lo == 48000.0
        assert d.rx.tune_freq == 30000.0   # RF preserved ('i' recenter)
        assert d.rx.second_lo != lo2_before

    def test_if_item_keeps_lo1(self, am_recording):
        # display.c:152-159 IF item: RADIO_FREQUENCY and SECOND_LO_FREQUENCY
        # in ONE packet are applied as one set_freq — RF and LO2 move
        # together and LO1 stays put (no command to the front end)
        d = self._daemon(am_recording)
        d.rx.set_freq(30000.0)
        lo1_before = d.rx.sdr.frequency
        f, lo2 = d.rx.tune_freq, d.rx.second_lo
        sent = []
        d._send_lo1_command = lambda lo1: sent.append(lo1)
        self._cmd(d,
                  (StatusType.RADIO_FREQUENCY, "double", f + 100.0),
                  (StatusType.SECOND_LO_FREQUENCY, "double", lo2 - 100.0))
        assert d.rx.tune_freq == f + 100.0
        assert d.rx.second_lo == lo2 - 100.0
        assert d.rx.sdr.frequency == lo1_before
        assert sent == []   # LO1 unchanged => no front-end command

    def test_status_reports_live_values(self, am_recording):
        d = self._daemon(am_recording)
        self._cmd(d,
                  (StatusType.LOW_EDGE, "float", 150.0),
                  (StatusType.KAISER_BETA, "float", 7.0))
        # emit_status encodes from the live config
        sent = []
        d.status_sock = type("S", (), {"send": lambda self, b: sent.append(b)})()
        d.emit_status({})
        items = dict(st.decode_packet(sent[0][1:]))
        assert st.decode_float(items[StatusType.LOW_EDGE]) == 150.0
        assert st.decode_float(items[StatusType.KAISER_BETA]) == 7.0


class TestDisplayAdjust:
    def test_adjust_command_maps_items(self):
        from ka9q_sdr_tpu.apps.display import TuningState, adjust_command
        from ka9q_sdr_tpu.apps.control import StatusMirror

        pkt = bytearray([0])
        st.encode_double(pkt, StatusType.RADIO_FREQUENCY, 147435000.0)
        st.encode_double(pkt, StatusType.SECOND_LO_FREQUENCY, -48000.0)
        st.encode_float(pkt, StatusType.LOW_EDGE, -5000.0)
        st.encode_float(pkt, StatusType.HIGH_EDGE, 5000.0)
        st.encode_float(pkt, StatusType.KAISER_BETA, 3.0)
        st.encode_eol(pkt)
        m = StatusMirror()
        m.update(bytes(pkt))
        t = TuningState(step_log10=2)   # 100 Hz step
        # freq item
        [(key, kind, val)] = adjust_command(m, t, +1)
        assert key == StatusType.RADIO_FREQUENCY and val == 147435100.0
        t.next_item()   # "if"
        # display.c:152-159: vary RF and LO2 together, LO1 fixed — both
        # keys in one packet
        pairs = adjust_command(m, t, +1)
        assert pairs == [
            (StatusType.RADIO_FREQUENCY, "double", 147435100.0),
            (StatusType.SECOND_LO_FREQUENCY, "double", -48100.0),
        ]
        t.next_item()   # "low"
        [(key, _, val)] = adjust_command(m, t, -1)
        assert key == StatusType.LOW_EDGE and val == -5100.0
        t.next_item()   # "high"
        t.next_item()   # "shift"
        [(key, _, val)] = adjust_command(m, t, +1)
        assert key == StatusType.SHIFT_FREQUENCY and val == 100.0
        t.next_item()   # "beta"
        t.step_log10 = 0
        [(key, _, val)] = adjust_command(m, t, +1)
        assert key == StatusType.KAISER_BETA and val == 4.0


class TestBlocksizeAndSaveState:
    def test_blocksize_command_rebuilds_receiver(self, am_recording):
        from ka9q_sdr_tpu.apps.radio import RadioDaemon, build_parser

        args = build_parser().parse_args(
            ["--iq-file", am_recording, "-f", "30k", "-m", "AM"]
        )
        d = RadioDaemon(args)
        pkt = bytearray([1])
        st.encode_int(pkt, StatusType.FILTER_BLOCKSIZE, 1920)
        st.encode_eol(pkt)
        d.handle_command(bytes(pkt))
        assert d.rx.cfg.master.L == 1920
        assert d.rx.cfg.master.M == 1921   # M = L+1 (display.c:880-886)
        # receiver still runs at the new geometry
        iq = 0.2 * np.exp(
            2j * np.pi * 31000 * np.arange(1920) / 192000
        ).astype(np.complex64)
        audio, _ = d.rx.process(iq)
        assert np.all(np.isfinite(np.asarray(audio)))

    def test_save_state_command_writes_file(self, am_recording, tmp_path):
        from ka9q_sdr_tpu.apps.radio import RadioDaemon, build_parser
        from ka9q_sdr_tpu.utils.state import loadstate

        sfile = str(tmp_path / "teststate")
        args = build_parser().parse_args(
            ["--iq-file", am_recording, "-f", "30k", "-m", "AM",
             "--state", sfile]
        )
        d = RadioDaemon(args)
        d.rx.set_freq(31000.0)
        d.freq = 31000.0
        pkt = bytearray([1])
        st.encode_int(pkt, StatusType.SAVE_STATE, 1)
        st.encode_eol(pkt)
        d.handle_command(bytes(pkt))
        rs = loadstate(sfile)
        assert rs.frequency == 31000.0
        assert rs.mode == "AM"


class TestBankGeometry:
    def test_block_ms_geometry(self):
        """--block-ms picks the closest power-of-two N_dec cadence and
        keeps the reference 20 ms default exactly (N=2^20 @24.576 Msps)."""
        from ka9q_sdr_tpu.apps.bankd import derive_geometry

        L, M = derive_geometry(24.576e6, 20.0)
        assert (L, M) == (491520, 557057)           # reference geometry
        L, M = derive_geometry(393.216e6, 148.0)
        assert (L, M) == (58195968, 8912897)        # bench long-block
        assert (L + M - 1) == 1 << 26
        for sr in (1.536e6, 24.576e6, 393.216e6):
            for ms in (20.0, 60.0, 150.0):
                L, M = derive_geometry(sr, ms)
                decim = round(sr / 48000)
                N = L + M - 1
                assert N % decim == 0
                n_dec = N // decim
                assert n_dec & (n_dec - 1) == 0     # power of two


def test_tuning_prev_item_cycles_backwards():
    """Shift-TAB moves to the previous field (README 'User Interface');
    prev_item is next_item's inverse and wraps."""
    from ka9q_sdr_tpu.apps.display import TuningState, ITEMS

    t = TuningState()
    first = t.item
    t.prev_item()
    assert t.item == (first - 1) % len(ITEMS)
    t.next_item()
    assert t.item == first


def test_reference_cli_flags_s_S_q(am_recording):
    """main.c's -s (startup shift), -S (fixed output SSRC) and -q
    (quiet, a no-op here) are accepted with the same letters, so
    reference launch scripts port unchanged."""
    from ka9q_sdr_tpu.apps.radio import RadioDaemon, build_parser

    args = build_parser().parse_args(
        ["--iq-file", am_recording, "-f", "48k", "-m", "CWU",
         "-s", "700", "-S", "12345", "-q"]
    )
    d = RadioDaemon(args)
    assert d.pcm.ssrc == 12345
    assert d.rx.cfg.mode.shift == 700.0
    assert args.quiet is True


def test_pcmcat_ssrc_selection(tmp_path):
    """pcmcat -s plays only the requested SSRC (pcmcat.c -s) instead of
    first-SSRC-wins."""
    import threading
    from ka9q_sdr_tpu.apps import pcmcat
    from ka9q_sdr_tpu.net.multicast import setup_mcast
    from ka9q_sdr_tpu.net.rtp import RTPHeader, PCM_MONO_PT
    import io as _io
    import sys as _sys

    G = "239.88.7.9:5204"
    out = _io.BytesIO()
    out.buffer = out            # pcmcat writes to sys.stdout.buffer

    class FakeStdout:
        buffer = out

    old = _sys.stdout
    _sys.stdout = FakeStdout()
    try:
        res = {}

        def run():
            res["rc"] = pcmcat.main(["-s", "7", "--packets", "3", G])

        th = threading.Thread(target=run, daemon=True)
        th.start()
        tx = setup_mcast(G, output=True)
        pay9 = np.full(240, 1111, ">i2").tobytes()
        pay7 = np.full(240, 2222, ">i2").tobytes()
        deadline = time.time() + 10.0
        seq = 0
        while th.is_alive() and time.time() < deadline:
            # the wrong SSRC arrives FIRST every round: -s must skip it
            tx.send(RTPHeader(type=PCM_MONO_PT, seq=seq, timestamp=seq * 240,
                              ssrc=9).to_bytes() + pay9)
            tx.send(RTPHeader(type=PCM_MONO_PT, seq=seq, timestamp=seq * 240,
                              ssrc=7).to_bytes() + pay7)
            seq += 1
            time.sleep(0.02)
        th.join(timeout=5.0)
        assert not th.is_alive() and res.get("rc") == 0
    finally:
        _sys.stdout = old
    got = np.frombuffer(out.getvalue(), np.int16)
    assert len(got) == 3 * 240
    assert np.all(got == 2222)      # only SSRC 7's payload


def test_radio_hostile_numeric_commands(am_recording):
    """Review-found: NaN SHIFT_FREQUENCY raised through set_shift's
    fixed-point math; a 2^40 FILTER_BLOCKSIZE died in allocation
    (MemoryError, not the ValueError the old guard caught).  All must be
    dropped with the daemon alive and state sane."""
    import math

    from ka9q_sdr_tpu.apps.radio import RadioDaemon, build_parser

    args = build_parser().parse_args(
        ["--iq-file", am_recording, "-f", "48k", "-m", "CWU"]
    )
    d = RadioDaemon(args)
    L0 = d.rx.cfg.master.L
    shift0 = d.rx.cfg.mode.shift
    for key, enc, bad in (
        (StatusType.SHIFT_FREQUENCY, "double", math.nan),
        (StatusType.SHIFT_FREQUENCY, "double", math.inf),
        (StatusType.RADIO_FREQUENCY, "double", math.nan),
        (StatusType.SECOND_LO_FREQUENCY, "double", -math.inf),
        (StatusType.FILTER_BLOCKSIZE, "int", 1 << 40),
    ):
        pkt = bytearray([1])
        if enc == "double":
            st.encode_double(pkt, key, bad)
        else:
            st.encode_int(pkt, key, bad)
        st.encode_eol(pkt)
        d.handle_command(bytes(pkt))          # must not raise
    assert d.rx.cfg.master.L == L0
    assert d.rx.cfg.mode.shift == shift0
    # the daemon still demodulates after the abuse
    import numpy as np
    a, _ = d.rx.process(np.zeros(L0, np.complex64))
    assert np.all(np.isfinite(np.asarray(a)))


def test_radio_hostile_filter_commands(am_recording):
    """Review-found: NaN edges passed set_filter's high<low swap and a
    kaiser_beta of 1e9 made np.i0 overflow to all-NaN taps WITHOUT
    raising — either NaN-poisoned every later block's audio with the
    daemon's except ValueError never firing."""
    import math

    from ka9q_sdr_tpu.apps.radio import RadioDaemon, build_parser

    args = build_parser().parse_args(
        ["--iq-file", am_recording, "-f", "48k", "-m", "USB"]
    )
    d = RadioDaemon(args)
    L0 = d.rx.cfg.master.L
    for key, bad in (
        (StatusType.LOW_EDGE, math.nan),
        (StatusType.HIGH_EDGE, math.inf),
        (StatusType.KAISER_BETA, 1e9),
        (StatusType.KAISER_BETA, math.nan),
    ):
        pkt = bytearray([1])
        st.encode_float(pkt, key, bad)
        st.encode_eol(pkt)
        d.handle_command(bytes(pkt))          # must not raise
    import numpy as np
    a, _ = d.rx.process(
        (0.1 * np.exp(2j * np.pi * 1000 / 48000
                      * np.arange(L0))).astype(np.complex64))
    assert np.all(np.isfinite(np.asarray(a)))   # response not NaN-poisoned


def test_frontend_hostile_numeric_commands():
    """The frontend simulator daemon must survive crafted TLV commands:
    round(nan) raised in _tune_hw; CALIBRATE=-1 divided by zero."""
    import math

    from ka9q_sdr_tpu.apps.frontend import FrontEndDaemon, build_args

    d = FrontEndDaemon(build_args(["-R", "239.88.12.1:5004"]))
    f0 = d.actual
    for key, bad in (
        (StatusType.RADIO_FREQUENCY, math.nan),
        (StatusType.RADIO_FREQUENCY, math.inf),
        (StatusType.RADIO_FREQUENCY, -1e12),
        (StatusType.CALIBRATE, math.nan),
        (StatusType.CALIBRATE, -1.0),
    ):
        pkt = bytearray([1])
        st.encode_double(pkt, key, bad)
        st.encode_eol(pkt)
        d.handle_command(bytes(pkt))          # must not raise
    assert d.actual == f0 and d.calibration == 0.0


class TestReferenceFlagSurface:
    """Every short flag in the reference daemons' getopt strings is
    accepted by the drop-in CLI (main.c:131, monitor.c, opus.c,
    iqrecord.c, iqplay.c, packet.c, aprsfeed.c).  --help must still work
    everywhere (aprsfeed repurposes -h as the APRS-IS host, like the C)."""

    def test_help_works_everywhere(self, capsys):
        import importlib
        for app in ("radio", "monitor", "opusd", "iqrecord", "iqplay",
                    "packetd", "aprsfeed", "pcmcat", "pcmsend", "opussend",
                    "frontend", "modulate", "control", "bankd"):
            mod = importlib.import_module(f"ka9q_sdr_tpu.apps.{app}")
            with pytest.raises(SystemExit) as e:
                mod.main(["--help"])
            assert e.value.code == 0, app
            assert "usage" in capsys.readouterr().out.lower(), app

    def test_reference_short_flags_parse(self):
        """Short flags with reference semantics parse without eating
        positionals (regression: iqplay -l was a bool, so `-l en_US`
        swallowed the file; iqrecord -d was the directory, not the
        duration)."""
        from ka9q_sdr_tpu.apps.radio import build_parser

        a = build_parser().parse_args(
            ["-f", "147m435", "-l", "C", "-t", "4", "-u", "100",
             "--iq-file", "x.iq"])
        assert a.locale == "C" and a.fft_threads == 4

    def test_opus_fec_takes_loss_percentage(self):
        """Reference -f is numeric: the expected packet-loss percentage
        (opus.c:95-96 'Fec = strtol(optarg)'), not a boolean (regression:
        store_true made 'opusd -f 20' an argparse error).  The value must
        reach the encoder and enable inband FEC."""
        import argparse

        from ka9q_sdr_tpu.apps import opusd, opussend

        for mod, flags in ((opusd, ["-I", "g:1", "-R", "g:2"]),
                           (opussend, ["-R", "g:2"])):
            captured = {}
            real_parse = argparse.ArgumentParser.parse_args

            def spy(self, argv=None, ns=None):
                a = real_parse(self, argv, ns)
                captured.update(vars(a))
                raise SystemExit(0)

            argparse.ArgumentParser.parse_args = spy
            try:
                with pytest.raises(SystemExit):
                    mod.main(flags + ["-f", "20"])
            finally:
                argparse.ArgumentParser.parse_args = real_parse
            assert captured["fec"] == 20, mod.__name__

        from ka9q_sdr_tpu.audio.opus_codec import OPUS_AVAILABLE, OpusEncoder
        if OPUS_AVAILABLE:
            OpusEncoder(48000, 2, 32000, fec=20)   # ctl path must not raise

    def test_iqplay_pkt_samples_clamped(self, tmp_path, monkeypatch):
        """-b is clamped to [1, 2048]: a negative value must not slurp the
        whole file into one unsendable datagram (read(-4)), and 0 must not
        spin sending nothing."""
        from ka9q_sdr_tpu.apps import iqplay

        rec = tmp_path / "x.iq"
        rec.write_bytes(bytes(4 * 3000))           # 3000 s16 IQ samples

        sent = []

        class FakeSock:
            def send(self, d):
                sent.append(len(d))

        monkeypatch.setattr(iqplay, "setup_mcast",
                            lambda *a, **k: FakeSock())
        rc = iqplay.main(["-R", "g:1", "-b", "-1", "--fast", str(rec)])
        assert rc == 0
        assert sent and all(n <= 12 + 2048 * 4 for n in sent)

    def test_iqplay_locale_vs_loop(self):
        """-l takes the locale VALUE (iqplay.c:143); the file stays
        positional and does not get eaten as the locale."""
        import argparse

        from ka9q_sdr_tpu.apps import iqplay

        # rebuild the parser exactly as main() does, but stop at parsing
        captured = {}
        real_parse = argparse.ArgumentParser.parse_args

        def spy(self, argv=None, ns=None):
            a = real_parse(self, argv, ns)
            captured.update(vars(a))
            raise SystemExit(0)       # stop main() before socket setup

        argparse.ArgumentParser.parse_args = spy
        try:
            with pytest.raises(SystemExit):
                iqplay.main(["-R", "239.9.9.9:5004", "-l", "C",
                             "-b", "480", "file.iq"])
        finally:
            argparse.ArgumentParser.parse_args = real_parse
        assert captured["locale"] == "C"
        assert captured["files"] == ["file.iq"]
        assert captured["pkt_samples"] == 480

    def test_aprsfeed_h_is_host(self):
        # main() parses -h as host then tries the multicast socket; use a
        # loopback group so setup succeeds, dry-run so no TCP, and feed
        # no packets by running parse-only via --help fallback: instead
        # assert the parser wiring directly.
        import inspect
        from ka9q_sdr_tpu.apps import aprsfeed

        src = inspect.getsource(aprsfeed.main)
        assert '"-h", "-H", "--host"' in src
        assert "add_help=False" in src
