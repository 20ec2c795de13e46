"""bankd command plane: the flagship bank is remotely commandable over
TLV exactly like every reference receiver (radio.c:248-268 retune;
radio_status.c:217-318 command ingest loop), keyed by OUTPUT_SSRC
(SSRC = channel index + 1).

All wire tests run over real multicast loopback — the reference's own
multi-node-without-a-cluster method (SURVEY.md §4 item 5).
"""

import time

import numpy as np
import pytest

from ka9q_sdr_tpu.net import status as st
from ka9q_sdr_tpu.net.status import StatusType

SAMPRATE = 1.536e6
L, M = 3840, 4353          # N=8192, decim 32 -> N_dec=256, L_dec=120
N_CH = 8
GROUP = "239.88.7.1:5204"  # unique to this module


def _freqs(n=N_CH):
    usable = 0.9 * SAMPRATE
    return list(np.linspace(-usable / 2, usable / 2, n, endpoint=False))


def _am(freq, t):
    """AM carrier: 400 Hz tone, 80% modulation."""
    return (0.1 * (1.0 + 0.8 * np.sin(2 * np.pi * 400.0 * t))
            * np.exp(2j * np.pi * freq * t))


def _blocks(n_blocks, extra_freq):
    """Wideband blocks: AM signals on channel 5's frequency and on
    extra_freq (initially between channels)."""
    freqs = _freqs()
    out = []
    for b in range(n_blocks):
        t = (b * L + np.arange(L)) / SAMPRATE
        x = _am(freqs[5], t) + _am(extra_freq, t)
        out.append(x.astype(np.complex64))
    return out


def _daemon(tmp_path, tag, output=None, mesh=0, n_ch=N_CH, shard_fft=False):
    from ka9q_sdr_tpu.apps.bankd import BankDaemon, build_parser

    argv = ["--iq-file", "unused", "-r", str(SAMPRATE), "-m", "AM",
            "--L", str(L), "--M", str(M),
            "--pcm-raw", str(tmp_path / f"{tag}.pcm"), "--no-native"]
    if output:
        argv += ["-R", output]
    if mesh:
        argv += ["--mesh", str(mesh)]
    if shard_fft:
        argv += ["--shard-fft"]
    args = build_parser().parse_args(argv)
    return BankDaemon(args, _freqs(n_ch))


def _read_pcm(path, n_ch=N_CH):
    """pcm-raw file -> (blocks, n_ch, L_dec) int16."""
    a = np.frombuffer(open(path, "rb").read(), "<i2")
    l_dec = L // 32
    return a.reshape(-1, n_ch, l_dec)


class TestBankdCommandPlane:
    def test_retune_over_wire_mid_run(self, tmp_path):
        """control --ssrc N --tune retunes bank channel N-1 mid-run over
        the wire; that channel's PCM follows the new frequency while every
        other channel's audio is bit-unchanged (vs an uncommanded run)."""
        from ka9q_sdr_tpu.apps import control

        f_new = 310_000.0   # off-grid: no channel starts here
        blocks = _blocks(12, f_new)

        a = _daemon(tmp_path, "a", output=GROUP)   # commanded
        b = _daemon(tmp_path, "b")                 # reference run
        for blk in blocks[:4]:
            a.process_block(blk)
            b.process_block(blk)

        # the real wire: control builds the TLV packet and multicasts it
        rc = control.main(
            [GROUP, "--ssrc", "4", "--tune", str(int(f_new))]
        )
        assert rc == 0
        time.sleep(0.2)
        a.poll_commands()
        assert a.commands == 1
        assert a.bank.freqs[3] == f_new

        for blk in blocks[4:]:
            a.process_block(blk)
            b.process_block(blk)
        a.flush()
        b.flush()
        a.raw.close()
        b.raw.close()

        pa = _read_pcm(tmp_path / "a.pcm")
        pb = _read_pcm(tmp_path / "b.pcm")
        assert pa.shape == pb.shape == (12, N_CH, 120)

        # neighbors: bit-identical through the whole run
        others = [c for c in range(N_CH) if c != 3]
        np.testing.assert_array_equal(pa[:, others], pb[:, others])

        # channel 3: silent before the retune in both runs ...
        assert np.abs(pa[:4, 3]).max() == np.abs(pb[:4, 3]).max()
        # ... and the commanded run's PCM follows the new signal: the
        # 400 Hz AM tone appears (uncommanded stays near-silent)
        tail_a = pa[8:, 3].ravel().astype(np.float32)
        tail_b = pb[8:, 3].ravel().astype(np.float32)
        rms_a = np.sqrt(np.mean(tail_a**2))
        rms_b = np.sqrt(np.mean(tail_b**2))
        assert rms_a > 10.0 * max(rms_b, 1.0)
        spec = np.abs(np.fft.rfft(tail_a * np.hanning(len(tail_a))))
        f = np.fft.rfftfreq(len(tail_a), 1.0 / 48000.0)
        assert abs(f[np.argmax(spec[3:]) + 3] - 400.0) < 30.0

    def test_command_answered_with_channel_status(self, tmp_path):
        """Each addressed command is answered with that channel's status
        (the reference answers every command poll, radio_status.c)."""
        d = _daemon(tmp_path, "s", output=GROUP)
        sent = []
        d.status_sock = type("S", (), {"send": lambda s, b: sent.append(b)})()
        pkt = bytearray([1])
        st.encode_int(pkt, StatusType.OUTPUT_SSRC, 2)
        st.encode_double(pkt, StatusType.RADIO_FREQUENCY, 123_456.0)
        st.encode_eol(pkt)
        d.handle_command(bytes(pkt))
        assert d.bank.freqs[1] == 123_456.0
        assert len(sent) == 1 and sent[0][0] == 0
        items = dict(st.decode_packet(sent[0][1:]))
        assert st.decode_int(items[StatusType.OUTPUT_SSRC]) == 2
        assert st.decode_double(items[StatusType.RADIO_FREQUENCY]) == 123_456.0
        assert items[StatusType.RADIO_MODE].decode() == "AM"

    def test_out_of_range_ssrc_ignored(self, tmp_path):
        d = _daemon(tmp_path, "x", output=GROUP)
        pkt = bytearray([1])
        st.encode_int(pkt, StatusType.OUTPUT_SSRC, 99)
        st.encode_double(pkt, StatusType.RADIO_FREQUENCY, 1.0)
        st.encode_eol(pkt)
        d.handle_command(bytes(pkt))
        assert all(f != 1.0 for f in d.bank.freqs)

    def test_filter_edge_command_swaps_shared_response(self, tmp_path):
        """LOW/HIGH_EDGE commands hot-swap the bank's SHARED response
        (set_filter, filter.c:500-546) with no recompile: narrowing the
        passband to exclude the 2 kHz audio tone kills it on every
        channel.  USB bank: a carrier 2 kHz above channel 5's frequency
        demodulates to a 2 kHz tone inside the default 100-3000 Hz
        passband."""
        from ka9q_sdr_tpu.apps.bankd import BankDaemon, build_parser

        argv = ["--iq-file", "unused", "-r", str(SAMPRATE), "-m", "USB",
                "--L", str(L), "--M", str(M),
                "--pcm-raw", str(tmp_path / "f.pcm"), "--no-native",
                "-R", GROUP]
        d = BankDaemon(build_parser().parse_args(argv), _freqs())
        step0 = d.bank._step
        freqs = _freqs()
        blocks = []
        for b in range(10):
            t = (b * L + np.arange(L)) / SAMPRATE
            blocks.append(
                (0.1 * np.exp(2j * np.pi * (freqs[5] + 2000.0) * t))
                .astype(np.complex64))
        for blk in blocks[:5]:
            d.process_block(blk)
        pkt = bytearray([1])
        st.encode_float(pkt, StatusType.LOW_EDGE, 100.0)
        st.encode_float(pkt, StatusType.HIGH_EDGE, 250.0)
        st.encode_eol(pkt)
        d.handle_command(bytes(pkt))
        assert d.bank.cfg.mode.low == 100.0
        assert d.bank.cfg.mode.high == 250.0
        assert d.bank._step is step0            # NO recompile
        for blk in blocks[5:]:
            d.process_block(blk)
        d.flush()
        d.raw.close()
        pcm = _read_pcm(tmp_path / "f.pcm").astype(np.float32)
        before = pcm[3:5, 5].ravel()
        after = pcm[8:, 5].ravel()
        rms = lambda x: np.sqrt(np.mean(x**2))
        # 2 kHz tone present before, crushed by the narrowed response
        assert rms(before) > 100.0
        assert rms(after) < 0.05 * rms(before)


class TestBankdMesh:
    """bankd --mesh D: one logical bank spanning D chips (SURVEY §2.7,
    filter.c:22-35 fan-out across devices), tested on the 8-virtual-device CPU
    mesh.  The sharded daemon must be operationally identical to the
    single-device one: same PCM bytes, working command plane."""

    def _run(self, d, blocks, retune_at=None, retune=(3, 310_000.0)):
        for i, blk in enumerate(blocks):
            if retune_at is not None and i == retune_at:
                pkt = bytearray([1])
                st.encode_int(pkt, StatusType.OUTPUT_SSRC, retune[0] + 1)
                st.encode_double(pkt, StatusType.RADIO_FREQUENCY, retune[1])
                st.encode_eol(pkt)
                d.handle_command(bytes(pkt))
            d.process_block(blk)
        d.flush()
        d.raw.close()

    def test_mesh_daemon_pcm_matches_with_midrun_retune(self, tmp_path):
        """8 channels over 8 devices: PCM within 1 LSB of the unmeshed
        daemon through a mid-run TLV retune (the command plane works on
        sharded state — bank_tune re-applies shardings).  Partitioned
        XLA programs fuse differently, so float results are ulp-level
        equivalent, not bit-identical (PARITY.md)."""
        blocks = _blocks(8, 310_000.0)
        a = _daemon(tmp_path, "mesh", mesh=8)
        b = _daemon(tmp_path, "flat")
        assert a.cfg.n_channels == N_CH and a.n_real == N_CH
        self._run(a, blocks, retune_at=3)
        self._run(b, blocks, retune_at=3)
        pa = _read_pcm(tmp_path / "mesh.pcm").astype(np.int32)
        pb = _read_pcm(tmp_path / "flat.pcm").astype(np.int32)
        assert pa.size > 0 and pa.shape == pb.shape
        # hang-AGC feedback amplifies ulp divergence to a few LSB
        assert np.abs(pa - pb).max() <= 8
        err = (pa - pb).astype(np.float64) / 32767.0
        assert 10 * np.log10(np.mean(err**2) + 1e-30) < -85.0
        # the retuned channel actually hears the off-grid signal
        assert np.abs(pa[6:, 3]).max() > 100

    def test_mesh_pads_channels_to_device_multiple(self, tmp_path):
        """10 channels on 8 devices: padded to 16 internally, but the
        daemon's wire surface (PCM rows, status, SSRC range) stays 10 and
        the emitted PCM matches the unmeshed 10-channel daemon."""
        freqs = _freqs(10)
        blocks = []
        for b in range(6):
            t = (b * L + np.arange(L)) / SAMPRATE
            blocks.append(_am(freqs[5], t).astype(np.complex64))
        a = _daemon(tmp_path, "pad", mesh=8, n_ch=10)
        b = _daemon(tmp_path, "ref10", n_ch=10)
        assert a.cfg.n_channels == 16 and a.n_real == 10
        assert len(a.pcm) == 10
        self._run(a, blocks)
        self._run(b, blocks)
        pa = _read_pcm(tmp_path / "pad.pcm", n_ch=10)
        pb = _read_pcm(tmp_path / "ref10.pcm", n_ch=10)
        np.testing.assert_array_equal(pa, pb)
        # out-of-range SSRC (a padding row) is rejected
        pkt = bytearray([1])
        st.encode_int(pkt, StatusType.OUTPUT_SSRC, 11)
        st.encode_double(pkt, StatusType.RADIO_FREQUENCY, 1.0)
        st.encode_eol(pkt)
        a.handle_command(bytes(pkt))
        assert all(f != 1.0 for f in a.bank.freqs)

    def test_mesh_shard_fft_daemon(self, tmp_path):
        """--shard-fft (distributed master FFT) through the daemon path:
        PCM within 1 LSB of the unmeshed run (the comb-gather path is
        float-equivalent, not bit-equal)."""
        blocks = _blocks(5, 310_000.0)
        a = _daemon(tmp_path, "dfft", mesh=8, shard_fft=True)
        b = _daemon(tmp_path, "flat2")
        self._run(a, blocks)
        self._run(b, blocks)
        pa = _read_pcm(tmp_path / "dfft.pcm").astype(np.int32)
        pb = _read_pcm(tmp_path / "flat2.pcm").astype(np.int32)
        err = (pa - pb).astype(np.float64) / 32767.0
        rms_dbfs = 10 * np.log10(np.mean(err**2) + 1e-30)
        assert rms_dbfs < -80.0        # the BASELINE parity bar
        assert np.abs(pa - pb).max() <= 8   # few-LSB float noise only


class TestBankdStatusAddressing:
    def test_mirror_follows_one_channel(self, tmp_path):
        """display/control --ssrc: the StatusMirror keeps only the
        addressed channel's per-channel status packets."""
        from ka9q_sdr_tpu.apps.control import StatusMirror

        d = _daemon(tmp_path, "m", output=GROUP)
        d._last_diag = {}
        m = StatusMirror(ssrc=4)
        m.update(d._channel_status_pkt(3))   # ssrc 4 -> kept
        assert m.get(StatusType.OUTPUT_SSRC) == 4
        f3 = m.get(StatusType.RADIO_FREQUENCY)
        m.update(d._channel_status_pkt(5))   # ssrc 6 -> ignored
        assert m.get(StatusType.RADIO_FREQUENCY) == f3

    def test_display_send_cmd_stamps_ssrc(self):
        from ka9q_sdr_tpu.apps.display import _send_cmd

        sent = []
        sock = type("S", (), {"send": lambda s, b: sent.append(b)})()
        _send_cmd(sock, (StatusType.RADIO_FREQUENCY, "double", 7e6), ssrc=4)
        assert sent[0][0] == 1
        pairs = list(st.decode_packet(sent[0][1:]))
        assert pairs[0][0] == StatusType.OUTPUT_SSRC
        assert st.decode_int(pairs[0][1]) == 4


def test_filter_command_with_foreign_ssrc_dropped_whole(tmp_path):
    """A command packet addressed to an out-of-range SSRC belongs to some
    other instance: its filter edits must be dropped along with its tune
    (previously the tune was rejected but the shared response was still
    narrowed bank-wide)."""
    d = _daemon(tmp_path, "fz", output=GROUP)
    low0, high0 = d.bank.cfg.mode.low, d.bank.cfg.mode.high
    pkt = bytearray([1])
    st.encode_int(pkt, StatusType.OUTPUT_SSRC, 99)
    st.encode_double(pkt, StatusType.RADIO_FREQUENCY, 1.0)
    st.encode_float(pkt, StatusType.LOW_EDGE, -200.0)
    st.encode_float(pkt, StatusType.HIGH_EDGE, 200.0)
    st.encode_eol(pkt)
    d.handle_command(bytes(pkt))
    assert d.bank.cfg.mode.low == low0 and d.bank.cfg.mode.high == high0
    # unaddressed filter edits still apply bank-wide (shared response)
    pkt2 = bytearray([1])
    st.encode_float(pkt2, StatusType.LOW_EDGE, -200.0)
    st.encode_float(pkt2, StatusType.HIGH_EDGE, 200.0)
    st.encode_eol(pkt2)
    d.handle_command(bytes(pkt2))
    assert d.bank.cfg.mode.low == -200.0 and d.bank.cfg.mode.high == 200.0


class TestMultiBankCommandPlane:
    """The mixed-mode daemon is as commandable as the single-mode one:
    every channel of every group addressable by OUTPUT_SSRC (sequential
    over real channels in group order)."""

    def _daemon(self, tmp_path, tag="mb"):
        from ka9q_sdr_tpu.apps.bankd import MultiBankDaemon, build_parser

        argv = ["--iq-file", "unused", "-r", str(SAMPRATE),
                "--L", str(L), "--M", str(M), "--no-native",
                "--pcm-raw", str(tmp_path / f"{tag}.pcm"), "-R", GROUP]
        args = build_parser().parse_args(argv)
        groups = [("AM", _freqs(3)), ("USB", [100e3, 200e3])]
        return MultiBankDaemon(args, groups)

    def test_ssrc_maps_across_groups(self, tmp_path):
        d = self._daemon(tmp_path)
        assert d.ssrc_map[1] == (0, 0)
        assert d.ssrc_map[3] == (0, 2)
        assert d.ssrc_map[4] == (1, 0)   # first USB channel
        assert d.ssrc_map[5] == (1, 1)

    def test_wire_retune_addresses_the_right_group(self, tmp_path):
        d = self._daemon(tmp_path)
        pkt = bytearray([1])
        st.encode_int(pkt, StatusType.OUTPUT_SSRC, 5)   # USB group, ch 1
        st.encode_double(pkt, StatusType.RADIO_FREQUENCY, 222e3)
        st.encode_eol(pkt)
        sent = []
        d.status_sock = type("S", (), {"send": lambda s, b: sent.append(b)})()
        d.handle_command(bytes(pkt))
        assert d.mb.group_freqs[1][1] == 222e3
        assert d.mb.group_freqs[0] == _freqs(3)          # AM group untouched
        # answered with the addressed channel's status
        items = dict(st.decode_packet(sent[0][1:]))
        assert st.decode_int(items[StatusType.OUTPUT_SSRC]) == 5
        assert st.decode_double(items[StatusType.RADIO_FREQUENCY]) == 222e3
        assert items[StatusType.RADIO_MODE].decode() == "USB"

    def test_filter_command_swaps_only_the_addressed_group(self, tmp_path):
        d = self._daemon(tmp_path)
        resp_am_0 = np.asarray(d.mb.cfgs[0].response).copy()
        pkt = bytearray([1])
        st.encode_int(pkt, StatusType.OUTPUT_SSRC, 4)   # USB group
        st.encode_float(pkt, StatusType.LOW_EDGE, 150.0)
        st.encode_float(pkt, StatusType.HIGH_EDGE, 1500.0)
        st.encode_eol(pkt)
        d.handle_command(bytes(pkt))
        assert d.mb.cfgs[1].mode.low == 150.0
        assert d.mb.cfgs[1].mode.high == 1500.0
        np.testing.assert_array_equal(
            np.asarray(d.mb.cfgs[0].response), resp_am_0)
        # foreign SSRC: dropped whole
        pkt2 = bytearray([1])
        st.encode_int(pkt2, StatusType.OUTPUT_SSRC, 99)
        st.encode_float(pkt2, StatusType.LOW_EDGE, -1.0)
        st.encode_eol(pkt2)
        d.handle_command(bytes(pkt2))
        assert d.mb.cfgs[1].mode.low == 150.0

    def test_retuned_channel_audio_follows(self, tmp_path):
        """End to end: retune a USB channel onto a live carrier mid-run;
        its PCM grows a tone while the AM group's PCM is unchanged vs an
        uncommanded run."""
        a = self._daemon(tmp_path, "cmd")
        b = self._daemon(tmp_path, "ref")
        f_sig = 222e3 + 1000.0          # 1 kHz above the retune target
        freqs_am = _freqs(3)
        def block(n):
            t = (n * L + np.arange(L)) / SAMPRATE
            return (0.2 * np.exp(2j * np.pi * f_sig * t)
                    + _am(freqs_am[1], t)).astype(np.complex64)
        for n in range(4):
            a.process_block(block(n))
            b.process_block(block(n))
        pkt = bytearray([1])
        st.encode_int(pkt, StatusType.OUTPUT_SSRC, 5)
        st.encode_double(pkt, StatusType.RADIO_FREQUENCY, 222e3)
        st.encode_eol(pkt)
        a.handle_command(bytes(pkt))
        for n in range(4, 12):
            a.process_block(block(n))
            b.process_block(block(n))
        a.close(); b.close()
        l_dec = L // 32
        ra = np.frombuffer(open(tmp_path / "cmd.pcm", "rb").read(), "<i2")
        rb = np.frombuffer(open(tmp_path / "ref.pcm", "rb").read(), "<i2")
        # layout per block: AM group (3, l_dec) then USB group (2, l_dec)
        ra = ra.reshape(-1, 5, l_dec)
        rb = rb.reshape(-1, 5, l_dec)
        np.testing.assert_array_equal(ra[:, :3], rb[:, :3])   # AM untouched
        tail = ra[8:, 4].ravel().astype(np.float64)           # USB ch 1
        assert np.sqrt((tail**2).mean()) > 20 * max(
            np.sqrt((rb[8:, 4].ravel().astype(np.float64)**2).mean()), 1.0)


def test_multibank_network_ingest_and_status(tmp_path):
    """Mixed-mode daemon over REAL wideband RTP multicast (-I): the
    Python assembler path reorders/scales packets into dense blocks, the
    AM and USB groups demodulate their carriers, and bank + per-channel
    status ride the status group — operational parity with the
    single-mode daemon's network mode."""
    import threading

    from ka9q_sdr_tpu.apps.bankd import run_multibank, build_parser
    from ka9q_sdr_tpu.net.multicast import setup_mcast
    from ka9q_sdr_tpu.net.rtp import RTPHeader, IQ_PT

    IN_GROUP = "239.88.7.3:5204"
    OUT_GROUP = "239.88.7.4:5204"
    n_blocks = 12
    argv = ["-I", IN_GROUP, "-R", OUT_GROUP, "-r", str(SAMPRATE),
            "--L", str(L), "--M", str(M), "--no-native",
            "--pcm-raw", str(tmp_path / "mb_net.pcm"),
            "--blocks", str(n_blocks)]
    args = build_parser().parse_args(argv)
    f_am, f_usb = 100e3, -200e3
    groups = [("AM", [f_am]), ("USB", [f_usb])]

    rc = {}

    def daemon():
        rc["rc"] = run_multibank(args, groups)

    th = threading.Thread(target=daemon, daemon=True)
    th.start()

    # status listener joins before the daemon emits
    stat_rx = setup_mcast(OUT_GROUP, output=False, offset=2)
    stat_rx.settimeout(0.2)

    # paced sender: 240-sample packets, AM carrier + USB tone, keeps
    # streaming until the daemon has its n_blocks (it joins the group
    # only after the warm-up compile, so early packets just vanish)
    tx = setup_mcast(IN_GROUP, output=True)
    t_sig = lambda s0, n: (s0 + np.arange(n)) / SAMPRATE
    statuses = []
    seq = 0
    deadline = time.time() + 120.0
    while th.is_alive() and time.time() < deadline:
        tt = t_sig(seq * 240, 240)
        sig = _am(f_am, tt) + 0.2 * np.exp(2j * np.pi * (f_usb + 1e3) * tt)
        pay = np.empty(480, np.int16)
        pay[0::2] = np.clip(sig.real * 32767, -32768, 32767)
        pay[1::2] = np.clip(sig.imag * 32767, -32768, 32767)
        hdr = RTPHeader(type=IQ_PT, seq=seq & 0xFFFF, timestamp=seq * 240,
                        ssrc=7)
        # 24-byte legacy status header precedes the samples in every I/Q
        # packet (main.c:338-341) — the assembler strips it
        tx.send(hdr.to_bytes() + b"\x00" * 24 + pay.tobytes())
        seq += 1
        if seq % 16 == 0:          # one block's worth
            time.sleep(0.01)
        try:
            statuses.append(stat_rx.recv(9000))
        except OSError:
            pass
        th.join(timeout=0.0)
    th.join(timeout=10.0)
    assert not th.is_alive(), "daemon did not finish"
    assert rc.get("rc") == 0

    l_dec = L // 32
    r = np.frombuffer(open(tmp_path / "mb_net.pcm", "rb").read(), "<i2")
    r = r.reshape(-1, 2, l_dec)     # per block: AM ch, then USB ch
    assert r.shape[0] == n_blocks
    # steady-state tail: AM channel carries 400 Hz, USB carries 1 kHz
    half = n_blocks // 2
    am = r[half:, 0].ravel().astype(np.float64)
    usb = r[half:, 1].ravel().astype(np.float64)
    am -= am.mean()
    for x, f0, name in ((am, 400.0, "AM"), (usb, 1000.0, "USB")):
        assert np.sqrt((x**2).mean()) > 200, f"{name} silent"
        X = np.abs(np.fft.rfft(x)) ** 2
        k = int(round(f0 * len(x) / 48000))
        frac = X[max(0, k - 2):k + 3].sum() / X.sum()
        assert frac > 0.5, f"{name} tone at {f0} Hz missing ({frac:.2f})"
    # status stream: a bank packet (OUTPUT_CHANNELS=2) and at least one
    # per-channel packet (OUTPUT_SSRC) arrived
    got_bank = got_chan = False
    for s in statuses:
        if not s or s[0] != 0:
            continue
        items = dict(st.decode_packet(s[1:]))
        if StatusType.OUTPUT_CHANNELS in items and \
                st.decode_int(items[StatusType.OUTPUT_CHANNELS]) == 2:
            got_bank = True
        if StatusType.OUTPUT_SSRC in items:
            got_chan = True
    assert got_bank and got_chan, (got_bank, got_chan, len(statuses))


def test_hostile_filter_edges_do_not_kill_the_daemon(tmp_path):
    """Fuzz-found crash: a command whose LOW/HIGH_EDGE floats are nonsense
    (random bytes decoded as float) used to raise through set_filter ->
    design_bandpass and kill the daemon.  Must drop the command and keep
    the previous response."""
    from ka9q_sdr_tpu.apps.bankd import BankDaemon, build_parser

    argv = ["--iq-file", "unused", "-r", str(SAMPRATE), "--L", str(L),
            "--M", str(M), "--no-native", "--channels", str(N_CH)]
    args = build_parser().parse_args(argv)
    d = BankDaemon(args, _freqs())
    low0, high0 = d.cfg.mode.low, d.cfg.mode.high
    pkt = bytearray([1])
    st.encode_int(pkt, StatusType.OUTPUT_SSRC, 1)
    st.encode_float(pkt, StatusType.LOW_EDGE, -8.5e12)   # way past Nyquist
    st.encode_float(pkt, StatusType.HIGH_EDGE, 3.2e14)
    st.encode_eol(pkt)
    d.handle_command(bytes(pkt))                         # must not raise
    assert d.cfg.mode.low == low0 and d.cfg.mode.high == high0
    # and a sane command afterwards still works
    pkt2 = bytearray([1])
    st.encode_int(pkt2, StatusType.OUTPUT_SSRC, 1)
    st.encode_float(pkt2, StatusType.LOW_EDGE, -200.0)
    st.encode_float(pkt2, StatusType.HIGH_EDGE, 200.0)
    st.encode_eol(pkt2)
    d.handle_command(bytes(pkt2))
    assert d.cfg.mode.low == -200.0 and d.cfg.mode.high == 200.0


def test_hostile_numerics_do_not_kill_or_poison(tmp_path):
    """Review-found crash classes: NaN/inf RADIO_FREQUENCY raised inside
    bank_tune's int(np.round(...)); NaN/oversized KAISER_BETA silently
    produced an all-NaN shared response (np.i0 overflow) without raising.
    The daemon must drop all of these and keep its state clean."""
    import math

    from ka9q_sdr_tpu.apps.bankd import BankDaemon, build_parser

    argv = ["--iq-file", "unused", "-r", str(SAMPRATE), "--L", str(L),
            "--M", str(M), "--no-native", "--channels", str(N_CH)]
    args = build_parser().parse_args(argv)
    d = BankDaemon(args, _freqs())
    f0 = d.bank.freqs[0]
    resp0 = np.asarray(d.bank.cfg.response).copy()

    for bad in (math.nan, math.inf, -math.inf):
        pkt = bytearray([1])
        st.encode_int(pkt, StatusType.OUTPUT_SSRC, 1)
        st.encode_double(pkt, StatusType.RADIO_FREQUENCY, bad)
        st.encode_eol(pkt)
        d.handle_command(bytes(pkt))          # must not raise
    assert d.bank.freqs[0] == f0              # NaN/inf dropped whole
    # absurd-but-finite frequency: defined behavior (wraps mod N like the
    # C's phase arithmetic) and must not raise either
    pkt = bytearray([1])
    st.encode_int(pkt, StatusType.OUTPUT_SSRC, 1)
    st.encode_double(pkt, StatusType.RADIO_FREQUENCY, 1e300)
    st.encode_eol(pkt)
    d.handle_command(bytes(pkt))
    for bad_beta in (math.nan, 1e10, -5.0):
        pkt = bytearray([1])
        st.encode_int(pkt, StatusType.OUTPUT_SSRC, 1)
        st.encode_float(pkt, StatusType.KAISER_BETA, bad_beta)
        st.encode_eol(pkt)
        d.handle_command(bytes(pkt))          # must not raise
    r = np.asarray(d.bank.cfg.response)
    assert np.all(np.isfinite(r.view(np.float64) if r.dtype.kind == 'c'
                              else r))
    np.testing.assert_array_equal(r, resp0)   # response untouched


def test_rejected_commands_are_counted_and_logged(tmp_path, capsys):
    """VERDICT r3 weak #5: a hostile/absurd command used to be swallowed
    by `except ValueError: pass` after commands += 1 — the one
    observability channel implied acceptance.  Now every rejection ticks
    COMMAND_REJECTS (on the status stream) and logs a line."""
    import math

    from ka9q_sdr_tpu.apps.bankd import BankDaemon, build_parser

    argv = ["--iq-file", "unused", "-r", str(SAMPRATE), "--L", str(L),
            "--M", str(M), "--no-native", "--channels", str(N_CH)]
    args = build_parser().parse_args(argv)
    d = BankDaemon(args, _freqs())
    assert d.rejects == 0

    # NaN retune: dropped at parse, must still be counted
    pkt = bytearray([1])
    st.encode_int(pkt, StatusType.OUTPUT_SSRC, 1)
    st.encode_double(pkt, StatusType.RADIO_FREQUENCY, math.nan)
    st.encode_eol(pkt)
    d.handle_command(bytes(pkt))
    assert d.rejects == 1

    # out-of-span retune: bank.tune raises ValueError (PARITY #18)
    pkt = bytearray([1])
    st.encode_int(pkt, StatusType.OUTPUT_SSRC, 1)
    st.encode_double(pkt, StatusType.RADIO_FREQUENCY, 10 * SAMPRATE)
    st.encode_eol(pkt)
    d.handle_command(bytes(pkt))
    assert d.rejects == 2

    # nonsense filter edges
    pkt = bytearray([1])
    st.encode_int(pkt, StatusType.OUTPUT_SSRC, 1)
    st.encode_float(pkt, StatusType.LOW_EDGE, -8.5e12)
    st.encode_float(pkt, StatusType.HIGH_EDGE, 3.2e14)
    st.encode_eol(pkt)
    d.handle_command(bytes(pkt))
    assert d.rejects == 3
    assert d.commands == 3

    err = capsys.readouterr().err
    assert err.count("rejected command") == 3

    # the reject count rides the per-channel status packet
    items = dict(st.decode_packet(d._channel_status_pkt(0)[1:]))
    assert int(st.decode_int(items[StatusType.COMMAND_REJECTS])) == 3
    assert int(st.decode_int(items[StatusType.COMMANDS])) == 3

    # a valid retune afterwards still works and does not tick rejects
    f_new = float(_freqs()[0] + 1000.0)
    pkt = bytearray([1])
    st.encode_int(pkt, StatusType.OUTPUT_SSRC, 1)
    st.encode_double(pkt, StatusType.RADIO_FREQUENCY, f_new)
    st.encode_eol(pkt)
    d.handle_command(bytes(pkt))
    assert d.rejects == 3 and d.bank.freqs[0] == f_new


def test_doppler_command_hardening_and_partial_keys(tmp_path, capsys):
    """(r4 review) Three doppler command-plane contracts:
    - a crafted non-finite doppler value must not kill the daemon
      (parse_command used to insert None, which TypeError'd inside
      bank_set_doppler's arithmetic — uncaught);
    - a packet carrying only ONE of the two doppler keys preserves the
      channel's other commanded component instead of zeroing it;
    - a command addressed to an out-of-range SSRC (someone else's
      daemon) must not tick this daemon's reject counter."""
    import math

    from ka9q_sdr_tpu.apps.bankd import BankDaemon, build_parser

    argv = ["--iq-file", "unused", "-r", str(SAMPRATE), "--L", str(L),
            "--M", str(M), "--no-native", "--channels", str(N_CH)]
    args = build_parser().parse_args(argv)
    d = BankDaemon(args, _freqs())

    # full steer: both keys
    pkt = bytearray([1])
    st.encode_int(pkt, StatusType.OUTPUT_SSRC, 1)
    st.encode_double(pkt, StatusType.DOPPLER_FREQUENCY, 500.0)
    st.encode_double(pkt, StatusType.DOPPLER_FREQUENCY_RATE, -100.0)
    st.encode_eol(pkt)
    d.handle_command(bytes(pkt))
    assert d.rejects == 0 and d._dop[0] == (500.0, -100.0)

    # rate-only adjustment mid-pass: the 500 Hz offset must survive
    pkt = bytearray([1])
    st.encode_int(pkt, StatusType.OUTPUT_SSRC, 1)
    st.encode_double(pkt, StatusType.DOPPLER_FREQUENCY_RATE, -50.0)
    st.encode_eol(pkt)
    d.handle_command(bytes(pkt))
    assert d.rejects == 0 and d._dop[0] == (500.0, -50.0)

    # hostile: inf doppler — daemon survives, reject ticks, state intact
    pkt = bytearray([1])
    st.encode_int(pkt, StatusType.OUTPUT_SSRC, 1)
    st.encode_double(pkt, StatusType.DOPPLER_FREQUENCY, math.inf)
    st.encode_eol(pkt)
    d.handle_command(bytes(pkt))
    assert d.rejects == 1 and d._dop[0] == (500.0, -50.0)

    # foreign SSRC with a garbage payload: dropped whole, no reject tick
    pkt = bytearray([1])
    st.encode_int(pkt, StatusType.OUTPUT_SSRC, 5000)
    st.encode_double(pkt, StatusType.RADIO_FREQUENCY, math.nan)
    st.encode_string(pkt, StatusType.RADIO_MODE, b"USB")
    st.encode_eol(pkt)
    d.handle_command(bytes(pkt))
    assert d.rejects == 1
    err = capsys.readouterr().err
    assert err.count("rejected command") == 1


def test_multibank_rejects_counted(tmp_path, capsys):
    import math

    from ka9q_sdr_tpu.apps.bankd import (MultiBankDaemon, build_parser,
                                         read_channel_file)

    chf = tmp_path / "ch.txt"
    chf.write_text(
        "\n".join(f"{f} AM" for f in _freqs(4))
        + "\n" + "\n".join(f"{f} FM" for f in _freqs(4))
        + "\n"
    )
    argv = ["--iq-file", "unused", "-r", str(SAMPRATE), "--L", str(L),
            "--M", str(M), "--no-native", "--channel-file", str(chf)]
    args = build_parser().parse_args(argv)
    groups = read_channel_file(str(chf))
    d = MultiBankDaemon(args, groups)

    pkt = bytearray([1])
    st.encode_int(pkt, StatusType.OUTPUT_SSRC, 1)
    st.encode_double(pkt, StatusType.RADIO_FREQUENCY, math.inf)
    st.encode_eol(pkt)
    d.handle_command(bytes(pkt))
    assert d.rejects == 1
    assert "rejected command" in capsys.readouterr().err
    items = dict(st.decode_packet(d._channel_status_pkt(1)[1:]))
    assert int(st.decode_int(items[StatusType.COMMAND_REJECTS])) == 1


def test_unaddressed_per_channel_commands_reject(tmp_path, capsys):
    """(r4 review) Per-channel keys with no OUTPUT_SSRC apply to nothing —
    both daemons must tick the reject counter + log instead of silently
    swallowing them after commands += 1 (the 'counter implies acceptance'
    failure mode the reject plumbing exists to prevent)."""
    import math

    from ka9q_sdr_tpu.apps.bankd import (BankDaemon, MultiBankDaemon,
                                         build_parser, read_channel_file)

    argv = ["--iq-file", "unused", "-r", str(SAMPRATE), "--L", str(L),
            "--M", str(M), "--no-native", "--channels", str(N_CH)]
    d = BankDaemon(build_parser().parse_args(argv), _freqs())

    # frequency + doppler, no OUTPUT_SSRC: two rejects, state untouched
    pkt = bytearray([1])
    st.encode_double(pkt, StatusType.RADIO_FREQUENCY, 1e6)
    st.encode_double(pkt, StatusType.DOPPLER_FREQUENCY, 500.0)
    st.encode_eol(pkt)
    d.handle_command(bytes(pkt))
    assert d.rejects == 2 and d._dop == {}
    assert capsys.readouterr().err.count("without OUTPUT_SSRC") == 2

    # mixed-mode daemon: same contract (filter swaps are per-GROUP there,
    # so an unaddressed filter command is also a reject, not bank-wide)
    chf = tmp_path / "ch.txt"
    chf.write_text(
        "\n".join(f"{f} AM" for f in _freqs(4))
        + "\n" + "\n".join(f"{f} FM" for f in _freqs(4)) + "\n"
    )
    argv = ["--iq-file", "unused", "-r", str(SAMPRATE), "--L", str(L),
            "--M", str(M), "--no-native", "--channel-file", str(chf)]
    args = build_parser().parse_args(argv)
    dm = MultiBankDaemon(args, read_channel_file(str(chf)))
    pkt = bytearray([1])
    st.encode_string(pkt, StatusType.RADIO_MODE, b"USB")
    st.encode_double(pkt, StatusType.RADIO_FREQUENCY, 1e6)
    st.encode_float(pkt, StatusType.LOW_EDGE, -3000.0)
    st.encode_float(pkt, StatusType.HIGH_EDGE, 3000.0)
    st.encode_eol(pkt)
    dm.handle_command(bytes(pkt))
    assert dm.rejects == 3   # mode + frequency + filter
    assert capsys.readouterr().err.count("without OUTPUT_SSRC") == 3


class TestChannelFileEdges:
    """Per-line filter edges in the channel file: every distinct
    (mode, low, high) becomes its own demod group, giving the bank the
    reference's per-receiver filter granularity (PARITY.md #8)."""

    def test_grouping_and_default_folding(self, tmp_path):
        from ka9q_sdr_tpu.apps.bankd import read_channel_file
        from ka9q_sdr_tpu.utils.modes import ModeDef

        p = tmp_path / "ch.txt"
        p.write_text(
            "100k FM\n"
            "200k FM\n"
            "300k FM -4000 4000\n"       # custom edges -> own group
            "400k USB\n"
            "500k USB 100 3000\n"        # equals USB defaults -> folds in
            "250k FM 4000 -4000\n"       # reversed edges normalise (modes.c:58)
        )
        groups = read_channel_file(str(p))
        assert len(groups) == 3
        m0, f0 = groups[0]
        assert m0 == "FM" and f0 == [100e3, 200e3]
        m1, f1 = groups[1]
        assert isinstance(m1, ModeDef)
        assert (m1.low, m1.high) == (-4000.0, 4000.0)
        assert m1.demod == "FM" and f1 == [300e3, 250e3]
        m2, f2 = groups[2]
        assert m2 == "USB" and f2 == [400e3, 500e3]

    def test_malformed_lines_fail_loud(self, tmp_path):
        from ka9q_sdr_tpu.apps.bankd import read_channel_file

        for bad in ("100k FM -4000\n",            # 3 tokens
                    "100k FM low high\n",         # non-numeric edges
                    "100k FM -inf 4000\n",        # non-finite
                    "100k NOSUCH -4000 4000\n"):  # unknown base mode
            p = tmp_path / "bad.txt"
            p.write_text(bad)
            with pytest.raises(ValueError):
                read_channel_file(str(p))

    def test_same_mode_groups_have_independent_responses(self, tmp_path):
        """Two USB groups, wide (100-3000) and narrow (100-300): a 2.5 kHz
        audio tone passes the wide channel and is stopped by the narrow
        one (the 137-tap channel filter's transition is ~700 Hz wide at
        this geometry, so the tone sits well into the stopband) —
        per-channel bandwidth inside one bank."""
        from ka9q_sdr_tpu.apps.bankd import read_channel_file
        from ka9q_sdr_tpu.models.bank import MultiBank

        p = tmp_path / "ch.txt"
        f_wide, f_narrow = 100e3, 300e3
        p.write_text(
            f"{f_wide:.0f} USB\n"
            f"{f_narrow:.0f} USB 100 300\n"
        )
        groups = read_channel_file(str(p))
        assert len(groups) == 2
        mb = MultiBank(groups, samprate=SAMPRATE, L=L, M=M)
        outs = None
        for b in range(8):
            t = (b * L + np.arange(L)) / SAMPRATE
            iq = (0.3 * np.exp(2j * np.pi * (f_wide + 2500.0) * t)
                  + 0.3 * np.exp(2j * np.pi * (f_narrow + 2500.0) * t)
                  ).astype(np.complex64)
            outs = mb.process(iq)
        wide = np.asarray(outs[0][0])[0].ravel()
        narrow = np.asarray(outs[1][0])[0].ravel()
        rms_w = np.sqrt(np.mean(wide**2))
        rms_n = np.sqrt(np.mean(narrow**2))
        assert rms_w > 0.03                      # tone present
        assert rms_n < rms_w / 30                # >29 dB down in the stopband


@pytest.mark.skipif(
    not __import__("ka9q_sdr_tpu.native", fromlist=["NATIVE_AVAILABLE"]
                   ).NATIVE_AVAILABLE,
    reason="no C++ toolchain",
)
def test_multibank_native_ingest(tmp_path):
    """Mixed-mode daemon over the NATIVE RTP engine (-I without
    --no-native): the C++ recvmmsg/resequencing path feeds packed float
    blocks straight into MultiBank — same demod result as the Python
    assembler path."""
    import threading

    from ka9q_sdr_tpu.apps.bankd import run_multibank, build_parser
    from ka9q_sdr_tpu.net.multicast import setup_mcast
    from ka9q_sdr_tpu.net.rtp import RTPHeader, IQ_PT

    IN_GROUP = "239.88.7.5:5204"
    OUT_GROUP = "239.88.7.6:5204"
    n_blocks = 10
    argv = ["-I", IN_GROUP, "-R", OUT_GROUP, "-r", str(SAMPRATE),
            "--L", str(L), "--M", str(M),
            "--pcm-raw", str(tmp_path / "mb_nat.pcm"),
            "--blocks", str(n_blocks)]
    args = build_parser().parse_args(argv)
    f_am, f_usb = 100e3, -200e3
    groups = [("AM", [f_am]), ("USB", [f_usb])]

    rc = {}

    def daemon():
        rc["rc"] = run_multibank(args, groups)

    th = threading.Thread(target=daemon, daemon=True)
    th.start()

    # wire PCM listener: the native per-group fan-out must emit RTP PCM
    # with the same sequential SSRC numbering as the Python PCMOutput path
    pcm_rx = setup_mcast(OUT_GROUP, output=False)
    pcm_rx.settimeout(0.0)
    seen_ssrcs = {}

    tx = setup_mcast(IN_GROUP, output=True)
    seq = 0
    deadline = time.time() + 120.0
    while th.is_alive() and time.time() < deadline:
        tt = (seq * 240 + np.arange(240)) / SAMPRATE
        sig = _am(f_am, tt) + 0.2 * np.exp(2j * np.pi * (f_usb + 1e3) * tt)
        pay = np.empty(480, np.int16)
        pay[0::2] = np.clip(sig.real * 32767, -32768, 32767)
        pay[1::2] = np.clip(sig.imag * 32767, -32768, 32767)
        hdr = RTPHeader(type=IQ_PT, seq=seq & 0xFFFF, timestamp=seq * 240,
                        ssrc=7)
        tx.send(hdr.to_bytes() + b"\x00" * 24 + pay.tobytes())
        seq += 1
        if seq % 16 == 0:
            time.sleep(0.01)
        try:
            while True:
                h, _ = RTPHeader.from_bytes(pcm_rx.recv(9000))
                seen_ssrcs[h.ssrc] = h.type
        except OSError:
            pass
        th.join(timeout=0.0)
    th.join(timeout=10.0)
    assert not th.is_alive(), "daemon did not finish"
    assert rc.get("rc") == 0

    l_dec = L // 32
    r = np.frombuffer(open(tmp_path / "mb_nat.pcm", "rb").read(), "<i2")
    r = r.reshape(-1, 2, l_dec)
    assert r.shape[0] == n_blocks
    half = n_blocks // 2
    am = r[half:, 0].ravel().astype(np.float64)
    usb = r[half:, 1].ravel().astype(np.float64)
    am -= am.mean()
    for x, f0, name in ((am, 400.0, "AM"), (usb, 1000.0, "USB")):
        assert np.sqrt((x**2).mean()) > 200, f"{name} silent"
        X = np.abs(np.fft.rfft(x)) ** 2
        k = int(round(f0 * len(x) / 48000))
        band = X[max(0, k - 3): k + 4].sum()
        assert band > 0.5 * X.sum(), f"{name} tone not dominant"
    # fan-out wire check: AM channel is SSRC 1, USB channel SSRC 2, both
    # mono PCM (PT 11, multicast.h:19-24)
    assert seen_ssrcs.get(1) == 11, seen_ssrcs
    assert seen_ssrcs.get(2) == 11, seen_ssrcs


class TestLiveModeMigration:
    """FM->USB mode change on a RUNNING mixed-mode daemon (VERDICT r3 #6):
    the reference's set_mode-respawns-demod-thread (radio.c:322-374) as a
    state edit.  The migrated channel keeps its SSRC, demodulates USB at
    its new home, and every OTHER channel's PCM is bit-untouched
    (compared against a control daemon that never migrates)."""

    F_FM0, F_FM1, F_USB0 = -300e3, 150e3, 400e3
    NBLK = 14
    MIGRATE_AT = 7          # command lands between blocks 6 and 7

    def _make_daemon(self, tmp_path, tag, out_group=None):
        from ka9q_sdr_tpu.apps.bankd import MultiBankDaemon, build_parser

        argv = ["-r", str(SAMPRATE), "--L", str(L), "--M", str(M),
                "--spare-slots", "1",
                "--pcm-raw", str(tmp_path / f"{tag}.pcm")]
        if out_group:
            argv += ["-R", out_group]
        args = build_parser().parse_args(argv)
        # run_multibank's spare extension, mirrored for direct construction
        groups = [("FM", [self.F_FM0, self.F_FM1, 0.0]),
                  ("USB", [self.F_USB0, 0.0])]
        return MultiBankDaemon(args, groups)

    def _block(self, b):
        t = (b * L + np.arange(L)) / SAMPRATE
        # FM slot 0: tone-modulated NBFM; FM slot 1 (the migrator): a
        # carrier + 1 kHz upper-sideband tone — boring under FM, a clean
        # 1 kHz tone once demodulated as USB; USB slot 0: +700 Hz tone
        x = (0.3 * np.exp(1j * (2 * np.pi * self.F_FM0 * t
                                + 3.0 * np.sin(2 * np.pi * 400.0 * t)))
             + 0.3 * np.exp(2j * np.pi * (self.F_FM1 + 1e3) * t)
             + 0.3 * np.exp(2j * np.pi * (self.F_USB0 + 700.0) * t))
        return x.astype(np.complex64)

    def _mode_cmd(self, ssrc, mode):
        import ka9q_sdr_tpu.net.status as st
        from ka9q_sdr_tpu.net.status import StatusType

        pkt = bytearray([1])
        st.encode_int(pkt, StatusType.OUTPUT_SSRC, ssrc)
        st.encode_string(pkt, StatusType.RADIO_MODE, mode)
        st.encode_eol(pkt)
        return bytes(pkt)

    def _rows(self, tmp_path, tag):
        l_dec = L // 32
        raw = np.frombuffer(open(tmp_path / f"{tag}.pcm", "rb").read(),
                            "<i2")
        # per block: FM group rows (3) then USB group rows (2)
        return raw.reshape(self.NBLK, 5, l_dec)

    def test_migration_semantics(self, tmp_path):
        import select as _select

        from ka9q_sdr_tpu.net.multicast import setup_mcast
        from ka9q_sdr_tpu.net.rtp import RTPHeader

        OUT = "239.88.9.1:5240"
        pcm_rx = setup_mcast(OUT, output=False)
        pcm_rx.settimeout(0.0)

        d = self._make_daemon(tmp_path, "live", out_group=OUT)
        c = self._make_daemon(tmp_path, "ctrl")

        # SSRC layout: FM slots 1,2,(3=spare, unmapped); USB 4,(5=spare)
        assert d.ssrc_map == {1: (0, 0), 2: (0, 1), 4: (1, 0)}
        assert d.slot_ssrc == [[1, 2, None], [4, None]]

        wire = {"pre": set(), "post": set()}
        phase = "pre"
        for b in range(self.NBLK):
            if b == self.MIGRATE_AT:
                d.handle_command(self._mode_cmd(2, "USB"))
                assert d.rejects == 0
                assert d.ssrc_map[2] == (1, 1)
                assert d.slot_ssrc == [[1, None, None], [4, 2]]
                phase = "post"
            blk = self._block(b)
            d.process_block(blk)
            c.process_block(blk)
            # drain the wire; classify by phase (the daemon double-buffers
            # one block, so the boundary is approximate — the sets below
            # are only checked for membership, not exact timing)
            try:
                while True:
                    h, _ = RTPHeader.from_bytes(pcm_rx.recv(9000))
                    wire[phase].add(h.ssrc)
            except OSError:
                pass
        d.flush(); c.flush()
        try:
            while True:
                h, _ = RTPHeader.from_bytes(pcm_rx.recv(9000))
                wire["post"].add(h.ssrc)
        except OSError:
            pass
        d.close(); c.close()
        pcm_rx.close()

        live = self._rows(tmp_path, "live").astype(np.float64)
        ctrl = self._rows(tmp_path, "ctrl").astype(np.float64)

        # 1. untouched bystanders: FM slot 0 and USB slot 0 identical to
        # the control run, before AND after the migration
        np.testing.assert_array_equal(live[:, 0], ctrl[:, 0])   # FM ch 1
        np.testing.assert_array_equal(live[:, 3], ctrl[:, 3])   # USB ch 4
        # 2. the USB spare slot (row 4) carries the migrated channel's
        # 1 kHz tone after the migration and not before (before, it is
        # parked at DC demodulating AGC-amplified floor — loud in the
        # raw capture but muted on the wire, which assertion 4 checks)
        def tone_frac(x, f0):
            X = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
            if X.sum() == 0.0:      # squelch-closed silence: no tone
                return 0.0
            k = int(round(f0 * len(x) / 48000))
            return X[max(0, k - 3): k + 4].sum() / X.sum()

        pre = live[2: self.MIGRATE_AT, 4].ravel()
        post = live[self.MIGRATE_AT + 2:, 4].ravel()
        assert tone_frac(pre, 1000.0) < 0.3, "tone already there before"
        assert np.sqrt((post**2).mean()) > 200.0, "migrated channel silent"
        assert tone_frac(post, 1000.0) > 0.5, \
            "migrated channel's USB tone not dominant"
        # 3. status: ssrc 2 now reports USB at its original frequency
        pkt = d._channel_status_pkt(2)
        assert b"USB" in pkt
        g, i = d.ssrc_map[2]
        assert d.mb.cfgs[g].mode.name == "USB"
        assert d.mb.group_freqs[g][i] == self.F_FM1
        # 4. wire SSRC continuity: ssrc 2 present after migration; the
        # spare slot's default ssrc (5) NEVER appears
        assert 2 in wire["post"], wire
        assert 5 not in wire["pre"] | wire["post"], wire

    def test_migrate_flushes_pending_block(self, tmp_path):
        """(r4 review) migrate() must emit the in-flight double-buffered
        block BEFORE rebooking the slot map: that block was computed
        while the target slot was a parked spare (AGC-amplified floor),
        and emitting it under the new map would transmit that noise as
        the migrated SSRC's first packets — and drop the source
        channel's last real block."""
        d = self._make_daemon(tmp_path, "flush")
        d.process_block(self._block(0))
        assert d._pending is not None      # double-buffered in flight
        assert d.migrate(2, "USB")
        assert d._pending is None          # flushed under the OLD map
        d.close()

    def test_migrate_clears_doppler_memory(self, tmp_path):
        """(ADVICE r4) migrate() resets the device-side sweep via
        init_channel's set_doppler(0,0); the per-SSRC command memory
        must be dropped too, or a later single-key doppler command
        (e.g. rate-only) re-applies the stale pre-migration hz."""
        import ka9q_sdr_tpu.net.status as st
        from ka9q_sdr_tpu.net.status import StatusType

        d = self._make_daemon(tmp_path, "dopmem")

        def dop_cmd(ssrc, **keys):
            pkt = bytearray([1])
            st.encode_int(pkt, StatusType.OUTPUT_SSRC, ssrc)
            if "hz" in keys:
                st.encode_double(pkt, StatusType.DOPPLER_FREQUENCY,
                                 keys["hz"])
            if "rate" in keys:
                st.encode_double(pkt, StatusType.DOPPLER_FREQUENCY_RATE,
                                 keys["rate"])
            st.encode_eol(pkt)
            return bytes(pkt)

        d.handle_command(dop_cmd(2, hz=500.0, rate=3.0))
        assert d._dop[2] == (500.0, 3.0)
        assert d.migrate(2, "USB")
        assert 2 not in d._dop          # memory follows the device reset
        # a rate-only command after migration must NOT resurrect 500 Hz
        d.handle_command(dop_cmd(2, rate=1.0))
        assert d._dop[2] == (0.0, 1.0)
        d.close()

    def test_migration_rejections(self, tmp_path):
        d = self._make_daemon(tmp_path, "rej")
        # unknown mode / no such group
        assert not d.migrate(2, "CW")
        # group full: USB group has 1 spare; fill it, then try another
        assert d.migrate(2, "USB")
        assert not d.migrate(1, "USB")
        r0 = d.rejects
        # same-preset set_mode is a no-op success (reference semantics)
        assert d.migrate(2, "USB")
        assert d.rejects == r0
        # migrating BACK reuses the slot freed by the first migration
        assert d.migrate(2, "FM")
        assert d.ssrc_map[2] == (0, 1)
        assert d.slot_ssrc == [[1, 2, None], [4, None]]
        d.close()

    def test_live_migration_is_compile_free(self, tmp_path):
        """--spare-slots declares migration intent, so MultiBankDaemon
        pre-warms the per-group splice/tune graphs at build time; a FIRST
        live MODE command mid-stream — and the blocks that follow it —
        must dispatch already-compiled programs only: a mid-serving
        compile stalls the stream and drops 20 ms blocks."""
        import jax

        d = self._make_daemon(tmp_path, "warm")
        for b in range(2):
            d.process_block(self._block(b))

        events = []
        jax.monitoring.register_event_listener(
            lambda name, *a, **k: events.append(name)
        )
        try:
            assert d.migrate(2, "USB")
            for b in range(2, 4):
                d.process_block(self._block(b))
        finally:
            d.close()
        compiles = [e for e in events if "compil" in e]
        assert not compiles, (
            f"live migration triggered {len(compiles)} compiles: "
            f"{sorted(set(compiles))}"
        )
