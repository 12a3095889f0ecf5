"""UL phase: PRACH, PUSCH, PUCCH loopbacks."""

import numpy as np
import jax.numpy as jnp

from lteax.phy.channels import prach, pusch, pucch
from lteax.phy.channels.pdsch import pdsch_prepare_cbs


def test_prach_roundtrip():
    rng = np.random.default_rng(0)
    u, ncs = 129, 119
    ncp = prach.PRACH_FORMATS[0][0]
    for v, delay in ((0, 0), (3, 60), (6, 200)):
        burst = prach.generate_prach(u, v, ncs)
        rx = np.concatenate([np.zeros(delay, np.complex64), burst])
        rx = rx + 0.05 * (rng.standard_normal(len(rx))
                          + 1j * rng.standard_normal(len(rx)))
        dets = prach.detect_prach(rx[ncp:].astype(np.complex64), u, ncs)
        assert dets, (v, delay)
        best = max(dets, key=lambda t: t[2])
        assert best[0] == v
        assert abs(best[1] - delay) <= 30   # one ZC-sample granularity


def test_prach_no_false_alarm():
    rng = np.random.default_rng(1)
    noise = (rng.standard_normal(30000)
             + 1j * rng.standard_normal(30000)).astype(np.complex64)
    dets = prach.detect_prach(noise, 129, 119, threshold=13.0)
    assert dets == []


def test_pusch_loopback():
    rng = np.random.default_rng(2)
    cid, sf, rnti = 301, 4, 0x5DEF
    alloc = pusch.PuschAlloc(n_prb=6, rb_start=0, mcs_tbs=1032, qm=4)
    tb = rng.integers(0, 2, size=alloc.mcs_tbs).astype(np.int32)
    cbs = jnp.asarray(pdsch_prepare_cbs(tb, alloc.geom))
    grid = pusch.pusch_encode_cbs(cbs, alloc, rnti, sf, cid)
    grid = pusch.pusch_add_dmrs(np.asarray(grid), alloc, cid, sf)
    # flat channel + noise
    h = np.complex64(0.9 * np.exp(1j * 0.4))
    nv = 1e-3
    rx = grid * h + (rng.standard_normal(grid.shape)
                     + 1j * rng.standard_normal(grid.shape)) * np.sqrt(nv / 2)
    tb_hat, ok, cb_oks = pusch.pusch_decode(jnp.asarray(rx.astype(np.complex64)),
                                            alloc, rnti, sf, cid,
                                            noise_var=nv, n_iter=5)
    assert bool(ok)
    np.testing.assert_array_equal(np.asarray(tb_hat), tb)


def test_pusch_papr_reduced():
    """Transform precoding must lower PAPR vs plain OFDM mapping."""
    rng = np.random.default_rng(3)
    cid, sf, rnti = 10, 2, 0x100
    alloc = pusch.PuschAlloc(n_prb=6, rb_start=0, mcs_tbs=504, qm=2)
    tb = rng.integers(0, 2, size=alloc.mcs_tbs).astype(np.int32)
    cbs = jnp.asarray(pdsch_prepare_cbs(tb, alloc.geom))
    grid = np.asarray(pusch.pusch_encode_cbs(cbs, alloc, rnti, sf, cid))
    t = np.fft.ifft(grid[0])
    papr_scfdma = np.max(np.abs(t) ** 2) / np.mean(np.abs(t) ** 2)
    # plain OFDM comparison: same QPSK symbols without DFT precoding
    q = (1 - 2 * rng.integers(0, 2, 72) + 1j * (1 - 2 * rng.integers(0, 2, 72))) / np.sqrt(2)
    t2 = np.fft.ifft(q)
    papr_ofdm = np.max(np.abs(t2) ** 2) / np.mean(np.abs(t2) ** 2)
    assert papr_scfdma < papr_ofdm


def test_pucch_format1():
    cid, sf = 77, 3
    for bits in ((), (0,), (1,), (0, 1), (1, 1)):
        g = pucch.pucch_format1_encode(bits, cid, sf, alpha_idx=5, oc_idx=1)
        rng = np.random.default_rng(4)
        rx = g * np.complex64(0.8 * np.exp(1j * 1.1)) \
            + 0.05 * (rng.standard_normal(g.shape)
                      + 1j * rng.standard_normal(g.shape))
        got, metric = pucch.pucch_format1_decode(rx.astype(np.complex64), cid,
                                                 sf, alpha_idx=5, oc_idx=1,
                                                 n_bits=len(bits))
        assert got == bits
        assert metric > 0


def test_pucch_format1_code_multiplexing():
    """Two UEs on different cyclic shifts decode independently."""
    cid, sf = 123, 6
    g1 = pucch.pucch_format1_encode((1,), cid, sf, alpha_idx=0, oc_idx=0)
    g2 = pucch.pucch_format1_encode((0,), cid, sf, alpha_idx=6, oc_idx=1)
    rx = (g1 + g2).astype(np.complex64)
    b1, _ = pucch.pucch_format1_decode(rx, cid, sf, 0, 0, n_bits=1)
    b2, _ = pucch.pucch_format1_decode(rx, cid, sf, 6, 1, n_bits=1)
    assert b1 == (1,) and b2 == (0,)


def test_pucch_format2():
    rng = np.random.default_rng(5)
    cid, sf, rnti = 200, 1, 0x41
    for a in (4, 8, 11):
        bits = rng.integers(0, 2, size=a).astype(np.int32)
        g = pucch.pucch_format2_encode(bits, cid, sf, rnti, alpha_idx=2)
        rx = g * np.complex64(1.1 * np.exp(-1j * 0.3)) \
            + 0.05 * (rng.standard_normal(g.shape)
                      + 1j * rng.standard_normal(g.shape))
        got, _ = pucch.pucch_format2_decode(rx.astype(np.complex64), cid, sf,
                                            rnti, a, alpha_idx=2)
        np.testing.assert_array_equal(got, bits)


def test_rm20_roundtrip():
    rng = np.random.default_rng(6)
    for a in (1, 6, 13):
        bits = rng.integers(0, 2, size=a).astype(np.int64)
        cw = pucch.rm20_encode(bits)
        llr = (1.0 - 2.0 * cw).astype(np.float32)
        got, _ = pucch.rm20_decode(llr, a)
        np.testing.assert_array_equal(got, bits)


def test_group_hopping_pattern():
    """Group hopping: u varies per slot, deterministic, in [0, 30)."""
    from lteax.phy.channels.pusch import group_hopping_pattern, dmrs_pusch
    us = [group_hopping_pattern(301, ns) for ns in range(20)]
    assert all(0 <= u < 30 for u in us)
    assert len(set(us)) > 3                       # actually hops
    assert us == [group_hopping_pattern(301, ns) for ns in range(20)]
    d1 = dmrs_pusch(301, 4, 72, group_hopping=True)
    d2 = dmrs_pusch(301, 4, 72, group_hopping=False)
    assert not np.allclose(d1, d2)


def test_factored_dft_matches_fft_reference():
    import numpy as np
    import jax.numpy as jnp
    from lteax.phy.dft import dft_factored, _split
    rng = np.random.default_rng(3)
    for n in (12, 300, 600, 1200, 13):      # 13 exercises the prime fallback
        n1, n2 = _split(n)
        assert n1 * n2 == n
        x = (rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))
             ).astype(np.complex64)
        got = np.asarray(dft_factored(jnp.asarray(x)))
        np.testing.assert_allclose(got, np.fft.fft(x, axis=-1),
                                   rtol=0, atol=2e-4 * np.sqrt(n))
        gi = np.asarray(dft_factored(jnp.asarray(x), inverse=True))
        np.testing.assert_allclose(gi, np.fft.ifft(x, axis=-1),
                                   rtol=0, atol=2e-4)
        gu = np.asarray(dft_factored(jnp.asarray(x), unitary=True))
        np.testing.assert_allclose(gu, np.fft.fft(x, axis=-1) / np.sqrt(n),
                                   rtol=0, atol=2e-4)


def test_uci_on_pusch_ack_ri():
    """HARQ-ACK + RI multiplexed with UL-SCH data: UCI recovered, data
    decodes despite ACK puncturing; layout degenerates to the plain
    channel interleaver with no UCI."""
    import numpy as np
    import jax.numpy as jnp
    from lteax.phy.channels import pusch
    from lteax.phy.channels.pdsch import pdsch_prepare_cbs

    # layout consistency: q_ri = q_ack = 0 equals channel_interleaver_idx
    read_idx, data_grp, ri_grp, ack_grp = pusch.uci_layout(72, 2, 0, 0)
    np.testing.assert_array_equal(read_idx,
                                  pusch.channel_interleaver_idx(72 * 24, 2))
    assert len(ri_grp) == 0 and len(ack_grp) == 0
    np.testing.assert_array_equal(data_grp, np.arange(72 * 12))

    rng = np.random.default_rng(4)
    cid, sf, rnti = 150, 2, 0x77
    alloc = pusch.PuschAlloc(n_prb=6, rb_start=0, mcs_tbs=936, qm=2)
    uci = pusch.PuschUci(n_ack=2, n_ri=1)
    geom = pusch.alloc_geom_uci(alloc, uci)
    assert geom.g < alloc.n_re * alloc.qm     # RI reserved symbols removed
    tb = rng.integers(0, 2, size=alloc.mcs_tbs).astype(np.int32)
    cbs = jnp.asarray(pdsch_prepare_cbs(tb, geom))
    for ack, ri in (((1, 0), (1,)), ((0, 1), (0,)), ((1, 1), (1,))):
        g = pusch.pusch_encode_cbs_uci(cbs, alloc, rnti, sf, cid, uci,
                                       ack=ack, ri=ri)
        g = pusch.pusch_add_dmrs(np.asarray(g), alloc, cid, sf)
        nv = 10 ** (-12 / 10)
        g = g + (rng.standard_normal(g.shape)
                 + 1j * rng.standard_normal(g.shape)) * np.sqrt(nv / 2)
        tb_hat, ok, cb_oks, ack_hat, ri_hat = pusch.pusch_decode_uci(
            jnp.asarray(g.astype(np.complex64)), alloc, rnti, sf, cid, uci,
            noise_var=nv)
        assert bool(ok), (ack, ri)
        np.testing.assert_array_equal(np.asarray(tb_hat), tb)
        assert ack_hat == ack and ri_hat == ri


def test_srs_generation_and_detection():
    """SRS comb-2 sounding: two UEs on the same comb separated by cyclic
    shift; the delay-domain detector finds both, rejects empty shifts,
    reports each UE's delay, and the per-UE LS estimate matches the
    applied channel."""
    import numpy as np
    import jax.numpy as jnp
    from lteax.phy.channels import srs

    rng = np.random.default_rng(8)
    n_rb, m_srs, u = 25, 24, 7
    grid = np.zeros((14, n_rb * 12), np.complex64)
    # UE A: shift 0, flat channel 0.9e^{j0.3}; UE B: shift 4, delayed
    h_a = 0.9 * np.exp(0.3j)
    grid = srs.srs_add(grid, n_rb, u, m_srs, n_cs=0, amp=abs(h_a))
    grid[srs.SRS_SYM] *= np.exp(0.3j)   # common phase (flat channel A ref)
    sc = srs.srs_subcarriers(n_rb, m_srs)
    delay_b = 3
    phase = np.exp(-2j * np.pi * delay_b * np.arange(m_srs * 6) / (m_srs * 6))
    grid[srs.SRS_SYM, sc] += srs.srs_sequence(u, m_srs, n_cs=4) * phase
    nv = 1e-3
    grid = grid + (rng.standard_normal(grid.shape)
                   + 1j * rng.standard_normal(grid.shape)) * np.sqrt(nv / 2)

    powers, peaks = srs.srs_detect(jnp.asarray(grid), n_rb, u, m_srs)
    powers = np.asarray(powers)
    assert powers[0] > 0.3 and powers[4] > 0.3          # both UEs present
    for s in (1, 2, 3, 5, 6, 7):
        assert powers[s] < 0.1, (s, powers)              # empty shifts
    assert int(peaks[0]) == 0
    assert int(peaks[4]) == delay_b                      # UE B's delay

    h = np.asarray(srs.srs_estimate_channel(jnp.asarray(grid), n_rb, u,
                                            m_srs, n_cs=0))
    assert abs(np.mean(h) - h_a) < 0.05

    # comb separation: k_tc=1 sees nothing from k_tc=0 sounders
    p1, _ = srs.srs_detect(jnp.asarray(grid), n_rb, u, m_srs, k_tc=1)
    assert float(np.max(np.asarray(p1))) < 0.2


def test_pucch_format2ab():
    """Formats 2a/2b: CQI + 1-2 HARQ-ACK bits on the second RS symbol."""
    rng = np.random.default_rng(9)
    cid, sf, rnti, a = 150, 4, 0x52, 6
    for ack in ((0,), (1,), (0, 0), (0, 1), (1, 0), (1, 1)):
        bits = rng.integers(0, 2, size=a).astype(np.int32)
        g = pucch.pucch_format2ab_encode(bits, ack, cid, sf, rnti,
                                         alpha_idx=3)
        rx = g * np.complex64(0.9 * np.exp(1j * 0.7)) \
            + 0.05 * (rng.standard_normal(g.shape)
                      + 1j * rng.standard_normal(g.shape))
        cqi, got_ack, _, _ = pucch.pucch_format2ab_decode(
            rx.astype(np.complex64), cid, sf, rnti, a, n_ack=len(ack),
            alpha_idx=3)
        assert got_ack == ack
        np.testing.assert_array_equal(cqi, bits)
    # plain format 2 stays decodable by the 2a/2b receiver with ack=(0,)
    bits = rng.integers(0, 2, size=a).astype(np.int32)
    g = pucch.pucch_format2_encode(bits, cid, sf, rnti)
    cqi, got_ack, _, _ = pucch.pucch_format2ab_decode(g, cid, sf, rnti, a, 1)
    assert got_ack == (0,)
    np.testing.assert_array_equal(cqi, bits)


def test_pusch_decoder_estimated_noise_snr_sweep():
    """the production UL decoder's per-subframe DM-RS
    noise estimator must hold across operating points WITHOUT retuning —
    exact decode at three SNRs spanning 20+ dB with noise_var=None."""
    import jax.numpy as jnp
    from lteax.phy.channels.pdsch import pdsch_prepare_cbs
    from lteax.shard.pipeline import make_pusch_batch_decoder

    rng = np.random.default_rng(7)
    cid, sf, rnti = 214, 4, 0x3D
    alloc = pusch.PuschAlloc(n_prb=6, rb_start=0, mcs_tbs=504, qm=2)
    dec = make_pusch_batch_decoder(alloc, rnti, sf, cid, n_iter=4,
                                   noise_var=None, interpret=True)
    b = 2
    for snr_db in (4.0, 12.0, 28.0):
        nv = 10 ** (-snr_db / 10.0)
        tbs_bits = rng.integers(0, 2, size=(b, alloc.mcs_tbs)).astype(np.int32)
        grids = []
        for i in range(b):
            cbs = jnp.asarray(pdsch_prepare_cbs(tbs_bits[i], alloc.geom))
            g = pusch.pusch_encode_cbs(cbs, alloc, rnti, sf, cid)
            grids.append(pusch.pusch_add_dmrs(np.asarray(g), alloc, cid, sf))
        x = np.stack(grids)
        x = x + (rng.standard_normal(x.shape)
                 + 1j * rng.standard_normal(x.shape)) * np.sqrt(nv / 2)
        x_iq = np.stack([x.real, x.imag], -1).astype(np.float32)
        tb, ok = dec(jnp.asarray(x_iq))
        assert np.asarray(ok).all(), f"CRC fail at {snr_db} dB"
        assert np.array_equal(np.asarray(tb), tbs_bits), f"bits at {snr_db} dB"
