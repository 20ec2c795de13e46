"""Sharded channel-bank correctness on the 8-virtual-device CPU mesh.

The multi-chip design (parallel/mesh.py) shards the bank's channel axis
with a replicated wideband block; these tests assert the sharded program
is numerically identical to the single-device `bank_step_packed` over
multiple blocks, through a mid-run retune, for FM and for a PLL linear
mode — so a sharding-induced numerical bug fails CI, not just the
driver's dryrun.  Reference semantics: one logical receiver spanning
chips == the master/slave fan-out of filter.c:22-35 at scale.
"""

import jax
import numpy as np
import pytest

from ka9q_sdr_tpu.models.bank import (
    bank_init,
    bank_step_packed,
    bank_tune,
    make_bank_config,
)
from ka9q_sdr_tpu.ops.packing import tree_c2r_np
from ka9q_sdr_tpu.parallel.mesh import (
    make_channel_mesh,
    make_sharded_bank_step,
)

SAMPRATE = 1.536e6
L, M = 3840, 4353


def _mk(n_ch, mode, **kw):
    cfg = make_bank_config(n_ch, mode, samprate=SAMPRATE, L=L, M=M, **kw)
    usable = 0.9 * SAMPRATE
    freqs = list(np.linspace(-usable / 2, usable / 2, n_ch, endpoint=False))
    template = bank_init(cfg, freqs)
    packed = tree_c2r_np(jax.tree_util.tree_map(np.asarray, template))
    return cfg, template, packed, freqs


def _blocks(cfg, freqs, n_blocks, seed=7):
    """Noise + a couple of strong carriers so demods/AGC/PLL do real work."""
    rng = np.random.default_rng(seed)
    tt = np.arange(n_blocks * L) / SAMPRATE
    x = 0.01 * (rng.standard_normal(len(tt)) + 1j * rng.standard_normal(len(tt)))
    for ch in (1, len(freqs) // 2):
        x += 0.3 * np.exp(2j * np.pi * freqs[ch] * tt)
    x = x.astype(np.complex64)
    xr = np.stack([x.real, x.imag], axis=-1).astype(np.float32)
    return [xr[i * L : (i + 1) * L] for i in range(n_blocks)]


@pytest.mark.parametrize("mode", ["FM", "CAM"])
def test_sharded_bank_matches_unsharded(mode):
    """5 blocks, mid-run tune at block 2; FM and a PLL linear mode (CAM)."""
    n_ch = 16
    cfg, template, packed, freqs = _mk(n_ch, mode)
    mesh = make_channel_mesh(8)
    step, state = make_sharded_bank_step(cfg, mesh, template, packed)
    ref_step = jax.jit(bank_step_packed(cfg, template))
    ref_state = jax.tree_util.tree_map(np.copy, packed)

    for blk, xr in enumerate(_blocks(cfg, freqs, 5)):
        if blk == 2:  # retune channel 3 mid-run, both sides identically
            state = bank_tune(cfg, state, 3, freqs[1] + 1000.0)
            ref_state = bank_tune(cfg, ref_state, 3, freqs[1] + 1000.0)
        state, audio, diag = step(state, xr)
        ref_state, ref_audio, ref_diag = ref_step(ref_state, xr)
        np.testing.assert_allclose(
            np.asarray(audio), np.asarray(ref_audio), atol=2e-5, rtol=1e-5,
            err_msg=f"audio diverged at block {blk}",
        )
    # carried state (overlap, NCO phase words, AGC gains, PLL loop) agrees
    for a, b in zip(
        jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(ref_state)
    ):
        np.testing.assert_allclose(
            np.asarray(a, dtype=np.float64),
            np.asarray(b, dtype=np.float64),
            atol=2e-5,
            rtol=1e-4,
        )


def test_sharded_fft_bank_matches_single_fft_bank():
    """shard_fft=True (distributed master FFT + comb-gather channelizer)
    is numerically identical to the replicated-FFT bank over 4 blocks."""
    n_ch = 16
    cfg, template, packed, freqs = _mk(n_ch, "FM")
    mesh = make_channel_mesh(8)
    step, state = make_sharded_bank_step(
        cfg, mesh, template, packed, shard_fft=True
    )
    ref_step = jax.jit(bank_step_packed(cfg, template))
    ref_state = jax.tree_util.tree_map(np.copy, packed)

    for blk, xr in enumerate(_blocks(cfg, freqs, 4)):
        state, audio, _ = step(state, xr)
        ref_state, ref_audio, _ = ref_step(ref_state, xr)
        np.testing.assert_allclose(
            np.asarray(audio), np.asarray(ref_audio), atol=3e-5, rtol=1e-4,
            err_msg=f"shard_fft audio diverged at block {blk}",
        )
    for a, b in zip(
        jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(ref_state)
    ):
        np.testing.assert_allclose(
            np.asarray(a, dtype=np.float64),
            np.asarray(b, dtype=np.float64),
            atol=3e-5,
            rtol=1e-3,
        )


def test_sharded_audio_layout():
    """Output audio is sharded on the channel axis (no implicit gather)."""
    cfg, template, packed, freqs = _mk(16, "FM")
    mesh = make_channel_mesh(8)
    step, state = make_sharded_bank_step(cfg, mesh, template, packed)
    state, audio, _ = step(state, _blocks(cfg, freqs, 1)[0])
    shard_shapes = {s.data.shape for s in audio.addressable_shards}
    assert shard_shapes == {(2, cfg.L_dec)}  # 16 ch / 8 devices


def test_non_divisible_channel_count_is_an_explicit_error():
    """B=12 on 8 devices: documented ValueError, not a silent wrong answer."""
    cfg, template, packed, _ = _mk(12, "FM")
    mesh = make_channel_mesh(8)
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_bank_step(cfg, mesh, template, packed)


def test_multibank_shards_each_group():
    """Mixed-mode flagship on a mesh (the realistic deployment: FM + CAM
    sharing ONE wideband FFT): every group's channel axis shards, groups
    pad independently (5 and 3 channels -> 8 each on 8 devices), and the
    real channels' audio is identical to the unmeshed MultiBank."""
    from ka9q_sdr_tpu.models.bank import MultiBank

    usable = 0.9 * SAMPRATE
    fm_freqs = list(np.linspace(-usable / 2, 0, 5, endpoint=False))
    cam_freqs = list(np.linspace(1e4, usable / 2, 3, endpoint=False))
    groups = [("FM", fm_freqs), ("CAM", cam_freqs)]

    mesh = make_channel_mesh(8)
    a = MultiBank(groups, samprate=SAMPRATE, L=L, M=M, mesh=mesh)
    b = MultiBank(groups, samprate=SAMPRATE, L=L, M=M)
    assert a.cfgs[0].n_channels == 8 and a.cfgs[1].n_channels == 8
    assert a.group_real == [5, 3]

    rng = np.random.default_rng(3)
    tt = np.arange(4 * L) / SAMPRATE
    x = 0.01 * (rng.standard_normal(len(tt))
                + 1j * rng.standard_normal(len(tt)))
    x += 0.3 * np.exp(2j * np.pi * fm_freqs[2] * tt)
    x += 0.3 * np.exp(2j * np.pi * cam_freqs[1] * tt)
    x = x.astype(np.complex64)
    for blk in range(4):
        s = x[blk * L:(blk + 1) * L]
        outs_a = a.process(s)
        outs_b = b.process(s)
        for g, ((aud_a, _), (aud_b, _)) in enumerate(zip(outs_a, outs_b)):
            n = a.group_real[g]
            # partitioned programs fuse differently (ulp-level float
            # divergence, amplified through the CAM group's PLL/AGC
            # feedback): tolerance, not bit-equality (PARITY.md)
            np.testing.assert_allclose(
                np.asarray(aud_a)[:n], np.asarray(aud_b)[:n],
                atol=3e-4, rtol=1e-3,
                err_msg=f"group {g} diverged at block {blk}",
            )
    # the sharded audio really is distributed over the mesh
    aud = a.process(x[:L])[0][0]
    assert len({s.device for s in aud.addressable_shards}) == 8


def test_multibank_tune_and_filter_swap_on_sharded_state():
    """MultiBank.tune / set_filter on MESH-sharded states (the daemon's
    command-plane path with bankd --mesh): bank_tune's .at[] update and
    the response swap must re-apply the channel-axis sharding, and the
    result must track an unmeshed MultiBank given the same commands."""
    from ka9q_sdr_tpu.models.bank import MultiBank

    usable = 0.9 * SAMPRATE
    am_freqs = list(np.linspace(-usable / 2, 0, 3, endpoint=False))
    usb_freqs = [1e4, 1e5]
    groups = [("AM", am_freqs), ("USB", usb_freqs)]
    mesh = make_channel_mesh(8)
    a = MultiBank(groups, samprate=SAMPRATE, L=L, M=M, mesh=mesh)
    b = MultiBank(groups, samprate=SAMPRATE, L=L, M=M)

    f_new = 2.2e5
    tt_of = lambda blk: (blk * L + np.arange(L)) / SAMPRATE
    def block(blk):
        t = tt_of(blk)
        return (0.2 * np.exp(2j * np.pi * (f_new + 1000.0) * t)
                + 0.3 * (1 + 0.5 * np.sin(2 * np.pi * 400 * t))
                * np.exp(2j * np.pi * am_freqs[1] * t)).astype(np.complex64)

    for blk in range(2):
        a.process(block(blk)); b.process(block(blk))
    # retune USB ch 1 onto the carrier, narrow the USB group's filter
    for mb in (a, b):
        mb.tune(1, 1, f_new)
        mb.set_filter(1, low=50.0, high=2800.0)
    # tuned leaves keep their sharding after the eager updates
    from ka9q_sdr_tpu.parallel.mesh import CHANNEL_AXIS
    spec = a.states[1].k.sharding.spec
    assert spec and spec[0] == CHANNEL_AXIS, spec
    assert a.states[1].resp.sharding.is_fully_replicated
    for blk in range(2, 5):
        outs_a = a.process(block(blk))
        outs_b = b.process(block(blk))
    for g in range(2):
        n = a.group_real[g]
        np.testing.assert_allclose(
            np.asarray(outs_a[g][0])[:n], np.asarray(outs_b[g][0])[:n],
            atol=3e-4, rtol=1e-3, err_msg=f"group {g} diverged post-tune")
    # and the retuned channel actually carries the tone now
    aud = np.asarray(outs_a[1][0])[1]
    assert np.sqrt((aud.astype(np.float64) ** 2).mean()) > 1e-3


def test_active_compaction_never_reports_padding_rows():
    """process_active with n_valid and max_active > n_valid: padding rows
    must come back as idx = -1 (the documented unused-slot contract),
    never as a pad channel index duplicating a real channel's audio."""
    from ka9q_sdr_tpu.models.bank import make_bank_config, ChannelBank
    from ka9q_sdr_tpu.parallel.mesh import pad_channels

    n_real = 5
    freqs = pad_channels(
        list(np.linspace(-0.4 * SAMPRATE, 0.4 * SAMPRATE, n_real,
                         endpoint=False)), 8)
    cfg = make_bank_config(8, "AM", samprate=SAMPRATE, L=L, M=M)
    mesh = make_channel_mesh(8)
    bank = ChannelBank(cfg, freqs, mesh=mesh)
    tt = np.arange(L) / SAMPRATE
    x = sum(0.2 * (1 + 0.5 * np.sin(2 * np.pi * 400 * tt))
            * np.exp(2j * np.pi * f * tt) for f in freqs[:n_real])
    xi = np.empty((L, 2), np.int16)
    xi[:, 0] = np.clip(x.real * 32767, -32768, 32767)
    xi[:, 1] = np.clip(x.imag * 32767, -32768, 32767)
    for _ in range(3):
        pcm, idx, _ = bank.process_active(xi, max_active=8, n_valid=n_real)
    idx = np.asarray(idx)
    assert set(idx[idx >= 0]) <= set(range(n_real))
    assert np.sum(idx >= 0) <= n_real


def test_comb_fast_gather_matches_natural_all_p():
    """bank_channelize's aligned comb path (comb_p) must match the
    natural-layout path bit-closely for every mesh width, including
    P where CC*P > N_dec (multi-wrap fold) — the aligned path that
    serves the distributed-FFT layout in place of the per-element comb
    gather."""
    import jax.numpy as jnp

    from ka9q_sdr_tpu.models.bank import (bank_channelize, bank_init,
                                          make_bank_config)
    from ka9q_sdr_tpu.parallel.dfft import comb_index

    cfg = make_bank_config(24, "FM", samprate=SAMPRATE, L=L, M=M)
    N = cfg.N
    rng = np.random.default_rng(1)
    freqs = list(np.linspace(-0.45 * SAMPRATE, 0.45 * SAMPRATE, 24,
                             endpoint=False)
                 + rng.uniform(-2000, 2000, 24))
    st = bank_init(cfg, freqs)
    fd = (rng.standard_normal(N)
          + 1j * rng.standard_normal(N)).astype(np.complex64)
    _, _, bb_nat = bank_channelize(cfg, st, jnp.asarray(fd))
    scale = float(jnp.max(jnp.abs(bb_nat)))
    for P in (2, 4, 8, 16):
        perm = comb_index(N, P).astype(np.int32)
        fd_comb = np.asarray(fd)[np.argsort(perm)]
        _, _, bb_comb = bank_channelize(
            cfg, st, jnp.asarray(fd_comb), comb_p=P)
        err = float(jnp.max(jnp.abs(bb_comb - bb_nat))) / scale
        assert err < 1e-5, f"P={P}: {err}"


def test_comb_fast_gather_isb_matches_natural():
    """r5 (VERDICT r4 ask #6): the aligned comb path serves CROSS_CONJ
    ISB too — per-sideband masked responses + the 2-element base-bin
    gather compose with the comb fold.  Before this, an ISB bank under
    shard_fft silently rode the ~79x per-element cliff."""
    import jax.numpy as jnp

    from ka9q_sdr_tpu.models.bank import (bank_channelize, bank_init,
                                          make_bank_config)
    from ka9q_sdr_tpu.parallel.dfft import comb_index

    cfg = make_bank_config(24, "ISB", samprate=SAMPRATE, L=L, M=M)
    N = cfg.N
    rng = np.random.default_rng(3)
    freqs = list(np.linspace(-0.45 * SAMPRATE, 0.45 * SAMPRATE, 24,
                             endpoint=False)
                 + rng.uniform(-2000, 2000, 24))
    st = bank_init(cfg, freqs)
    fd = (rng.standard_normal(N)
          + 1j * rng.standard_normal(N)).astype(np.complex64)
    _, _, bb_nat = bank_channelize(cfg, st, jnp.asarray(fd))
    scale = float(jnp.max(jnp.abs(bb_nat)))
    for P in (2, 4, 8, 16):
        perm = comb_index(N, P).astype(np.int32)
        fd_comb = np.asarray(fd)[np.argsort(perm)]
        _, _, bb_comb = bank_channelize(
            cfg, st, jnp.asarray(fd_comb), comb_p=P)
        err = float(jnp.max(jnp.abs(bb_comb - bb_nat))) / scale
        assert err < 1e-5, f"P={P}: {err}"


def test_sharded_fft_isb_bank_matches_single_fft_bank():
    """shard_fft + ISB end-to-end on the 8-device mesh vs the
    single-device replicated-FFT bank (the geometry r4 left on the
    per-element fallback)."""
    n_ch = 16
    cfg, template, packed, freqs = _mk(n_ch, "ISB")
    mesh = make_channel_mesh(8)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)  # must NOT warn
        step, state = make_sharded_bank_step(
            cfg, mesh, template, packed, shard_fft=True
        )
    ref_step = jax.jit(bank_step_packed(cfg, template))
    ref_state = jax.tree_util.tree_map(np.copy, packed)
    for blk, xr in enumerate(_blocks(cfg, freqs, 3)):
        state, audio, _ = step(state, xr)
        ref_state, ref_audio, _ = ref_step(ref_state, xr)
        # block 0: the hang-AGC attack on the strong-carrier channel
        # amplifies ulp-level fusion differences to ~9 int16 LSB for a
        # few samples (the PARITY #9 sharded float-equivalence bound);
        # from block 1 the trajectories are identical to <2e-6.
        atol = 1e-3 if blk == 0 else 3e-5
        np.testing.assert_allclose(
            np.asarray(audio), np.asarray(ref_audio), atol=atol, rtol=1e-4,
            err_msg=f"shard_fft ISB audio diverged at block {blk}",
        )


def test_shard_fft_fallback_geometry_warns_loudly():
    """A shard_fft geometry the aligned comb gather cannot serve must
    warn at CONSTRUCTION (the fallback is a measured ~30-80x cliff) —
    VERDICT r4 weak #4."""
    # N = L + M - 1 = 2304 = 2^8 * 9: Q = N/8 = 288, 288 % 128 != 0, so
    # the aligned comb gather cannot chunk-align its rows
    cfg = make_bank_config(8, "FM", samprate=SAMPRATE, L=2000, M=305)
    assert (cfg.N // 8) % 128 != 0
    mesh = make_channel_mesh(8)
    template = bank_init(cfg, [0.0] * 8)
    packed = tree_c2r_np(jax.tree_util.tree_map(np.asarray, template))
    with pytest.warns(RuntimeWarning, match="aligned comb gather"):
        make_sharded_bank_step(cfg, mesh, template, packed, shard_fft=True)
