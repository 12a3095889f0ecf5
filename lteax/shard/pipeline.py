"""Sharded bulk-decode pipelines (configs #4/#5 of BASELINE.json).

The full per-subframe PDSCH receive chain — OFDM demod, channel estimation,
equalization, LLR demapping, descrambling, rate de-matching, turbo decode,
CRC — as ONE jitted function, vmapped over a subframe batch and sharded over
a (chan, time) device mesh with ``shard_map``.  The reference processes
subframes serially on one core (SURVEY.md §3.5); here the batch IS the
parallelism.

Production decoders (DL / UL / 2x2 MIMO) are built as a two-program
front/turbo split feeding the max-log-MAP half-iteration kernel; the sharded
variants (``make_sharded_*``) wrap the SAME stage functions in ``shard_map``
with the batch axis on the ``time`` mesh axis, so the thing that scales IS
the production path — early stop, compacted straggler retry (shard-local:
the retry's argsort/gather runs inside the shard_map body) and all.

All tuning knobs come from :class:`lteax.phy.tuning.DecoderTuning`
(env vars are overrides, not the source of truth).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from lteax.phy.config import PhyConfig
from lteax.phy import chest
from lteax.phy.ofdm import samples_to_subframe
from lteax.phy.grid import pdsch_flat_idx, make_flat_extractor
from lteax.phy.mod import demodulate_maxlog
from lteax.phy.channels import pdsch as pdsch_mod
from lteax.phy.tuning import DecoderTuning
from lteax.shard.mesh import TIME_AXIS, CHAN_AXIS


def make_subframe_decoder(cfg: PhyConfig, n_cell_id: int, cfi: int,
                          prbs: tuple[int, ...], subframe: int, rnti: int,
                          geom, scheme: str, n_iter: int = 6):
    """Returns jittable fn: samples (n_samps_subframe, 2) float32 IQ ->
    (tb_bits (TBS,), tb_ok scalar bool).

    IO is float32 IQ pairs (see io.iq.to_iq_f32); complex forms inside
    the jit."""
    re_idx = pdsch_flat_idx(cfg, n_cell_id, cfi, prbs, subframe)
    extract, _, _ = make_flat_extractor(re_idx, cfg.n_sym_subframe, cfg.n_sc)

    def decode_one(samples_iq: jnp.ndarray):
        samples = (samples_iq[..., 0] + 1j * samples_iq[..., 1]
                   ).astype(jnp.complex64)
        grid = samples_to_subframe(samples, cfg)
        h = chest.estimate_channel(grid, cfg, n_cell_id, subframe, port=0)
        nv = chest.estimate_noise_var(grid, cfg, n_cell_id, subframe)
        x_eq, eff_nv = chest.equalize_siso(grid.reshape(-1), h.reshape(-1), nv)
        llr = demodulate_maxlog(extract(x_eq), scheme, extract(eff_nv))
        tb, ok, _ = pdsch_mod.pdsch_decode_device(llr, geom, rnti, subframe,
                                                  n_cell_id, n_iter=n_iter)
        return tb, ok

    return decode_one


def make_batch_decoder(cfg, n_cell_id, cfi, prbs, subframe, rnti, geom,
                       scheme, n_iter: int = 6):
    """(B, n_samps, 2) f32 -> ((B, TBS), (B,)) — single-device batched decoder."""
    one = make_subframe_decoder(cfg, n_cell_id, cfi, prbs, subframe, rnti,
                                geom, scheme, n_iter)
    return jax.jit(jax.vmap(one))


def _crc_stage(bits, geom, print_iters, n_it):
    """Shared CRC/desegment tail of every turbo stage.

    ``bits`` is the kernel's flat (B*C, K) output; regroup per TB."""
    from lteax.phy.fec.crc import check_crc
    bsz = bits.shape[0] // geom.info.c
    bits = bits.reshape(bsz, geom.info.c, geom.k)
    if geom.info.cb_crc:
        payload, cb_ok = check_crc(bits, "24B")
    else:
        payload, cb_ok = bits, jnp.ones((bsz, geom.info.c), bool)
    tb_full = pdsch_mod.desegment_device(payload, geom.info)
    tb_bits, ok = check_crc(tb_full, "24A")
    ok = ok & jnp.all(cb_ok, axis=-1)
    return (tb_bits, ok, n_it) if print_iters else (tb_bits, ok)


def _make_turbo_stage(geom, n_iter, t: DecoderTuning, interpret,
                      planar_spec=None):
    """De-matched LLRs -> (tb_bits, ok[, n_it]) via the turbo kernel with
    early stop + compacted retry (batch-local, so shard-local under
    shard_map).

    Input is (B*, C, 3, D) natural LLRs, or — when ``planar_spec``
    = (rm_inv np.int32, n_cb, sentinel) is given — the raw (B, flat)
    PLANAR demap output: the rate de-match then rides the decode's static
    layout gathers and the (B, C, 3, D) intermediate never materializes."""
    from lteax.kernels.turbo_mlm import turbo_decode_batch_pallas

    d_len = geom.k + 4
    early_crc = t.early_crc(geom.info.cb_crc)
    print_iters = t.print_iters

    def stage_turbo(x):
        if planar_spec is not None:
            flat, planar = None, (x, *planar_spec)
        else:
            flat = x.reshape(x.shape[0] * geom.info.c, 3, d_len)
            planar = None
        out = turbo_decode_batch_pallas(
            flat, geom.k, n_iter=n_iter, win=t.win, acq=t.acq,
            early_crc=early_crc, mdtype=t.mdtype, ext_scale=t.ext_scale,
            retry_m=t.retry_m, retry_levels=t.retry_levels,
            layout=t.layout_glue, planar=planar, planar_int8=t.planar_int8,
            return_n_iter=print_iters, impl=t.turbo_impl,
            interpret=interpret)
        bits, n_it = out if print_iters else (out, None)
        return _crc_stage(bits, geom, print_iters, n_it)

    return stage_turbo, print_iters


def _two_program(stage_front, stage_turbo, interpret):
    """The production two-program split: front (OFDM demod .. demap) and
    turbo stage as two jitted programs, chained asynchronously (no host
    round-trip between them).  Keeps the compile units small and lets the
    benches time each stage on its own.  ``interpret`` (tests) composes
    both into one program."""
    if interpret:
        return jax.jit(lambda s: stage_turbo(stage_front(s)))
    f1, f2 = jax.jit(stage_front), jax.jit(stage_turbo)
    dec = lambda samples_iq: f2(f1(samples_iq))
    dec.stage_front, dec.stage_turbo = f1, f2   # for bench breakdowns
    return dec


def _pdsch_stages(cfg, n_cell_id, cfi, prbs, subframe, rnti, geom, scheme,
                  n_iter, t: DecoderTuning, interpret,
                  planar_boundary: bool = True):
    """Build the DL production (stage_front, stage_turbo) pair.

    ``planar_boundary=False`` forces the (B, C, 3, D) de-matched stage
    boundary even on the planar-demap front — required by consumers that
    COMBINE front outputs in the d domain (HARQ soft combining)."""
    from lteax.phy import seq
    from lteax.phy.channels.pdsch import _global_rm_inv

    t = t.for_pipeline("dl")

    re_idx = pdsch_flat_idx(cfg, n_cell_id, cfi, prbs, subframe)
    extract, _, _ = make_flat_extractor(re_idx, cfg.n_sym_subframe, cfg.n_sc)

    c_init = int(rnti) * 2 ** 14 + int(subframe) * 512 + int(n_cell_id)
    # planar demap + descramble (mod.demap_planar), de-match gather
    # remapped host-side; needs an injective rate match (no HARQ
    # circular-buffer wrap)
    use_planar = (scheme in ("qpsk", "16qam", "64qam")
                  and _global_rm_inv(geom)[1])
    ldt = jnp.bfloat16 if t.mdtype == "bf16" else jnp.float32

    def eq_front(samples_iq):
        # device-boundary IQ may be f32, bf16 or int8 pairs (bf16/int8 halve/
        # quarter the input read; the decode chain is scale-invariant, so
        # int8's /128 needs no correction)
        samples = (samples_iq[..., 0].astype(jnp.float32)
                   + 1j * samples_iq[..., 1].astype(jnp.float32)
                   ).astype(jnp.complex64)
        grid = samples_to_subframe(samples, cfg)
        h = chest.estimate_channel(grid, cfg, n_cell_id, subframe, port=0)
        nv = chest.estimate_noise_var(grid, cfg, n_cell_id, subframe)
        return grid, h, nv

    if use_planar:
        import numpy as np
        from lteax.phy.mod import demap_planar
        qm = geom.qm
        # demap the FULL grid and fold the RE extraction into the de-match
        # gather: planar column s' = re_idx[s] — no extracted (B, n_re)
        # materializations
        n_grid = cfg.n_sym_subframe * cfg.n_sc
        npad_g = -(-n_grid // 128) * 128
        if npad_g == n_grid:      # always keep >=1 pad column (zero slot)
            npad_g += 128
        sgn_np = seq.scrambling_symbols_np(c_init, geom.g)
        # zeros-init: every column NOT carrying PDSCH gets sign 0, so the
        # demap emits exact 0.0 there — in particular planar
        # flat slot qm*npad_g - 1 (last pad column), which the de-match
        # maps' zero-fold (turbo_mlm._planar_maps) points dead/sentinel
        # positions at instead of multiplying a mask after the gather
        sgnp_g = np.zeros((qm, npad_g), dtype=np.float32)
        sgnp_g[:, np.asarray(re_idx)] = sgn_np.reshape(-1, qm).T
        sgnp_g = jnp.asarray(sgnp_g)
        # remap: interleaved g at (s, j) -> plane j, grid column re_idx[s]
        inv_g, _ = _global_rm_inv(geom)
        g_idx = inv_g.astype(np.int64)
        s_sym = g_idx // qm
        j_bit = g_idx % qm
        re_np = np.asarray(re_idx, dtype=np.int64)
        grid_inv = (j_bit * npad_g + re_np[np.minimum(
            s_sym, len(re_np) - 1)]).astype(np.int64)
        grid_inv[inv_g == geom.g] = qm * npad_g       # zero sentinel
        grid_inv_np = grid_inv.astype(np.int32)

        def front(samples_iq):
            grid, h, nv = eq_front(samples_iq)
            hf = h.reshape(-1)
            p = jnp.abs(hf) ** 2
            x = grid.reshape(-1) * jnp.conj(hf) / (p + nv)
            x = x / jnp.maximum(p / (p + nv), 1e-12)
            return jnp.real(x), jnp.imag(x), p / nv   # full grid, no extract

        # input staging dtype (DecoderTuning.demap_in); the demap computes
        # in f32 whatever it is
        ddt = jnp.bfloat16 if t.demap_in == "bf16" else jnp.float32

        def demap_grid(samples_iq):
            xr, xi, invnv = jax.vmap(front)(samples_iq)
            if ddt != jnp.float32:
                xr, xi, invnv = (xr.astype(ddt), xi.astype(ddt),
                                 invnv.astype(ddt))
            llr = demap_planar(xr, xi, invnv, sgnp_g, scheme, out_dtype=ldt)
            return llr.reshape(llr.shape[0], -1)

        if planar_boundary:
            # stage boundary carries the RAW planar demap output: the
            # de-match (grid_inv, which already composes the RE extraction)
            # moves into the decode's static layout gathers, and the
            # (B, C, 3, D) intermediate never materializes
            stage_front = demap_grid
            stage_front.mid_rank = 2    # planar (B, flat) stage boundary
            stage_turbo, _ = _make_turbo_stage(
                geom, n_iter, t, interpret,
                planar_spec=(grid_inv_np, geom.info.c, qm * npad_g))
            return stage_front, stage_turbo

        grid_inv_j = jnp.asarray(grid_inv_np)
        d_len_ = geom.k + 4

        def stage_front(samples_iq):
            flat = demap_grid(samples_iq)
            ext = jnp.concatenate(
                [flat, jnp.zeros((flat.shape[0], 1), flat.dtype)], axis=-1)
            return ext[..., grid_inv_j].reshape(
                flat.shape[0], geom.info.c, 3, d_len_)

        stage_turbo, _ = _make_turbo_stage(geom, n_iter, t, interpret)
        return stage_front, stage_turbo

    # batch-invariant scrambling signs, precomputed on host
    sgn = jnp.asarray(seq.scrambling_symbols_np(c_init, geom.g))

    def front(samples_iq):
        grid, h, nv = eq_front(samples_iq)
        x_eq, eff_nv = chest.equalize_siso(grid.reshape(-1), h.reshape(-1), nv)
        llr = demodulate_maxlog(extract(x_eq), scheme, extract(eff_nv))
        return llr * sgn

    def stage_front(samples_iq):
        llr = jax.vmap(front)(samples_iq)              # (B, G)
        if t.mdtype == "bf16":
            # carry LLRs in the trellis dtype: halves de-match + turbo-input
            # traffic (the kernel computes in bf16 anyway)
            llr = llr.astype(jnp.bfloat16)
        # de-match at batch level (natively batched)
        return pdsch_mod.soft_dematch(llr, geom, t.struct_dematch)

    stage_turbo, _ = _make_turbo_stage(geom, n_iter, t, interpret)
    return stage_front, stage_turbo


def make_batch_decoder_pallas(cfg, n_cell_id, cfi, prbs, subframe, rnti,
                              geom, scheme, n_iter: int = 6,
                              tuning: DecoderTuning | None = None,
                              interpret: bool = False):
    """Like make_batch_decoder but the turbo stage runs as ONE flat kernel
    batch over all (subframe x codeblock) blocks — the production path."""
    t = tuning if tuning is not None else DecoderTuning.from_env()
    f1, f2 = _pdsch_stages(cfg, n_cell_id, cfi, prbs, subframe, rnti, geom,
                           scheme, n_iter, t, interpret)
    return _two_program(f1, f2, interpret)


def make_batch_harq_decoder_pallas(cfg, n_cell_id, cfi, prbs, subframes,
                                   rnti, geoms, scheme, n_iter: int = 6,
                                   tuning: DecoderTuning | None = None,
                                   interpret: bool = False):
    """Production HARQ incremental-redundancy decoder: soft-combine >= 2
    (re)transmissions of the same transport block, then ONE turbo kernel
    batch on the combined d-domain LLRs (the batch counterpart of :func:`lteax.phy.channels.pdsch.soft_dematch_harq`).

    ``subframes``/``geoms``: one entry per (re)transmission — the subframe
    it was sent in (scrambling + CRS positions differ) and its
    :class:`PdschGeometry` (same TBS/n_re/Qm, differing ``rv``; each single
    transmission is gather-injective, so combining is a SUM of per-tx
    de-match gathers — no scatter).  Input: (n_tx, B, n_samps, 2) f32 IQ,
    slot i holding transmission i of every subframe in the batch.  Returns
    ((B, TBS), (B,) ok) like :func:`make_batch_decoder_pallas`.

    (reference capability: ``liblte/src/liblte_phy.cc :: rate_unmatch_turbo``
    — the circular-buffer soft-combine accumulates retransmissions into
    one d buffer; here each rv contributes one batched gather and the adds
    run at batch level.)"""
    ks = {g.k for g in geoms}
    assert len(ks) == 1 and len(subframes) == len(geoms) >= 2, \
        "HARQ combining needs >=2 transmissions of one TB geometry"
    t = tuning if tuning is not None else DecoderTuning.from_env()
    fronts = [
        _pdsch_stages(cfg, n_cell_id, cfi, prbs, sf_i, rnti, g_i, scheme,
                      n_iter, t, interpret, planar_boundary=False)[0]
        for sf_i, g_i in zip(subframes, geoms)]

    def stage_front(batch_iq):               # (n_tx, B, n_samps, 2)
        d = fronts[0](batch_iq[0])
        for i in range(1, len(fronts)):
            d = d + fronts[i](batch_iq[i])
        return d

    stage_turbo, _ = _make_turbo_stage(geoms[0], n_iter, t.for_pipeline("dl"),
                                       interpret)
    return _two_program(stage_front, stage_turbo, interpret)


def _ul_rm_inv_planar(geom, qm: int, m_sc: int, npad: int):
    """UL de-match gather indices reading DIRECTLY from the planar demap
    output: composes (planar layout) ∘ (36.212 §5.2.2.8 data-only channel
    de-interleave, a (12, m_sc, qm)->(m_sc, 12, qm) transpose) ∘ (rate
    de-match inverse) into one host-precomputed index array."""
    import numpy as np
    from lteax.phy.channels.pdsch import _global_rm_inv
    inv, injective = _global_rm_inv(geom)
    assert injective
    p = inv.astype(np.int64)
    k = p // (12 * qm)
    sym = (p % (12 * qm)) // qm
    j = p % qm
    out = (j * npad + sym * m_sc + k).astype(np.int64)
    out[inv == geom.g] = qm * npad                   # zero sentinel
    return out.astype(np.int32)


def _pusch_stages(alloc, rnti, subframe, n_cell_id, n_iter, noise_var,
                  t: DecoderTuning, interpret):
    """Build the UL production (stage_front, stage_turbo) pair.

    ``noise_var=None`` (default): per-subframe DM-RS-residual noise
    estimation — the difference of the two DM-RS symbols' raw LS estimates
    is pure noise for channels static over a subframe (same estimator
    family as the DL's ``chest.estimate_noise_var``); a float pins a
    static prior (correct only at a known SNR)."""
    import numpy as np
    from lteax.phy import seq
    from lteax.phy.channels import pusch as pu

    geom = alloc.geom
    m_sc = alloc.m_sc
    data_syms = [s for s in range(14) if s not in pu.DMRS_SYMS]
    ref0 = np.conj(pu.dmrs_pusch(n_cell_id, 2 * subframe, m_sc))
    ref1 = np.conj(pu.dmrs_pusch(n_cell_id, 2 * subframe + 1, m_sc))
    w = np.clip(np.asarray(
        [(s - pu.DMRS_SYMS[0]) / (pu.DMRS_SYMS[1] - pu.DMRS_SYMS[0])
         for s in data_syms], dtype=np.float32), 0.0, 1.0)[:, None]
    c_init = int(rnti) * 2 ** 14 + int(subframe) * 512 + int(n_cell_id)
    sgn = jnp.asarray(seq.scrambling_symbols_np(c_init, geom.g))
    r_mux = geom.g // (12 * alloc.qm)
    assert geom.g == 12 * r_mux * alloc.qm, "data-only PUSCH interleaver"
    from lteax.phy.channels.pdsch import _global_rm_inv
    use_planar = (alloc.scheme in ("qpsk", "16qam", "64qam")
                  and _global_rm_inv(geom)[1])
    if use_planar:
        from lteax.phy.mod import demap_planar, planar_sgn_np
        qm = alloc.qm
        npad = -(-(12 * m_sc) // 128) * 128
        sgnp = jnp.asarray(planar_sgn_np(c_init, geom.g, qm, npad))
        ldt = jnp.bfloat16 if t.mdtype == "bf16" else jnp.float32

    def front(g_iq):                         # (14, m_sc, 2) f32|bf16
        grid = (g_iq[..., 0].astype(jnp.float32)
                + 1j * g_iq[..., 1].astype(jnp.float32)
                ).astype(jnp.complex64)
        ls0 = grid[pu.DMRS_SYMS[0]] * ref0   # raw LS at the two pilots
        ls1 = grid[pu.DMRS_SYMS[1]] * ref1
        if noise_var is None:
            # per-subframe noise estimate from the DM-RS residual: the LS
            # difference is noise-only under a subframe-static channel
            nv = jnp.maximum(
                jnp.mean(jnp.abs(ls0 - ls1) ** 2) / 2.0, 1e-6)
        else:
            nv = noise_var
        # delay-domain denoised LS chest (see pusch.chest_taps: the raw
        # per-subcarrier estimate costs ~3 dB effective SNR)
        h0 = pu.chest_denoise(ls0)
        h1 = pu.chest_denoise(ls1)
        h = (1 - w) * h0[None] + w * h1[None]
        y = grid[jnp.asarray(data_syms)]
        p = jnp.abs(h) ** 2
        xf = y * jnp.conj(h) / (p + nv)
        xf = xf / jnp.maximum(p / (p + nv), 1e-12)
        xt = pu._ul_dft(xf, inverse=True)
        eff = jnp.mean(nv / jnp.maximum(p, 1e-12), axis=-1,
                       keepdims=True) * jnp.ones_like(p)
        if use_planar:
            return (jnp.real(xt).reshape(-1), jnp.imag(xt).reshape(-1),
                    (1.0 / eff).reshape(-1))
        llr = demodulate_maxlog(xt.reshape(-1), alloc.scheme, eff.reshape(-1))
        llr = llr * sgn
        if t.mdtype == "bf16":
            llr = llr.astype(jnp.bfloat16)
        # channel DE-interleaver (36.212 §5.2.2.8, data-only) is a pure
        # rectangular transpose: (C_mux=12, R_mux, Qm) -> row-major
        return llr.reshape(12, r_mux, alloc.qm).transpose(1, 0, 2).reshape(-1)

    if use_planar:
        # DecoderTuning.ul_planar_boundary picks between the DL-style
        # planar stage boundary and one composed gather at the boundary
        ul_inv_np = _ul_rm_inv_planar(geom, alloc.qm, m_sc, npad)
        ul_inv = jnp.asarray(ul_inv_np)
        ddt = jnp.bfloat16 if t.demap_in == "bf16" else jnp.float32

        def demap_planar_ul(batch_iq):
            xr, xi, invnv = jax.vmap(front)(batch_iq)  # (B, 12*m_sc)
            if ddt != jnp.float32:
                xr, xi, invnv = (xr.astype(ddt), xi.astype(ddt),
                                 invnv.astype(ddt))
            return demap_planar(xr, xi, invnv, sgnp, alloc.scheme,
                                out_dtype=ldt)

        if t.ul_planar_boundary and npad > 12 * m_sc:
            # planar boundary: the de-match (ul_inv, which already
            # composes the channel de-interleave) moves into the decode's
            # static layout gathers.  The zero-fold target slot
            # qm*npad - 1 is a pad column whose LLR is EXACT 0.0 (the
            # demap zero-pads inv_nv, so pad columns emit (d1-d0)*0); the
            # npad > 12*m_sc guard keeps that invariant
            # (full-PRB allocations always pad: 14400 -> 14464)
            def stage_front(batch_iq):
                llr = demap_planar_ul(batch_iq)
                return llr.reshape(llr.shape[0], -1)

            stage_front.mid_rank = 2
            stage_turbo, _ = _make_turbo_stage(
                geom, n_iter, t, interpret,
                planar_spec=(ul_inv_np, geom.info.c, alloc.qm * npad))
            return stage_front, stage_turbo

        def stage_front(batch_iq):
            llr = demap_planar_ul(batch_iq)
            lead = llr.shape[:-2]
            flat = llr.reshape(*lead, -1)
            ext = jnp.concatenate(
                [flat, jnp.zeros((*lead, 1), flat.dtype)], axis=-1)
            # one gather: planar demap -> channel de-interleave -> de-match
            return ext[..., ul_inv].reshape(*lead, geom.info.c, 3,
                                            geom.k + 4)
    else:
        def stage_front(batch_iq):
            llr = jax.vmap(front)(batch_iq)            # (B, G)
            return pdsch_mod.soft_dematch(llr, geom,
                                          t.struct_dematch)

    stage_turbo, _ = _make_turbo_stage(geom, n_iter, t, interpret)
    return stage_front, stage_turbo


def make_pusch_batch_decoder(alloc, rnti: int, subframe: int, n_cell_id: int,
                             n_iter: int = 6, noise_var: float | None = None,
                             tuning: DecoderTuning | None = None,
                             interpret: bool = False):
    """Batched UL-SCH (PUSCH) production decoder with the DL levers applied.

    (B, 14, m_sc, 2) float32 IQ grids -> ((B, TBS), (B,) ok).

    Same receive chain as :func:`lteax.phy.channels.pusch.pusch_decode`
    (DM-RS LS chest + linear time interp, unbiased MMSE eq, IDFT
    de-precoding, max-log demap, descramble, channel de-interleave,
    de-match, turbo, CRC) restructured for throughput exactly like the
    PDSCH path: scrambling signs precomputed on host, the channel
    de-interleaver as a pure reshape/transpose, de-match applied once at
    batch level, and a two-program front/turbo split feeding the turbo
    kernel (early-stop + compacted straggler retry).  Noise is estimated
    per subframe from the DM-RS residual unless a static prior is passed.

    (reference capability: ``liblte/src/liblte_phy.cc ::
    liblte_phy_pusch_channel_decode`` — serial per-subframe C++.)"""
    t = tuning if tuning is not None else DecoderTuning.from_env()
    f1, f2 = _pusch_stages(alloc, rnti, subframe, n_cell_id, n_iter,
                           noise_var, t, interpret)
    return _two_program(f1, f2, interpret)


def _mimo_stages(cfg, n_cell_id, cfi, prbs, subframe, rnti, geom, scheme,
                 n_iter, t: DecoderTuning, interpret, tm: int = 3,
                 cb_index: int = 0):
    """Build the 2x2 TM3 production (stage_front, stage_turbo) pair."""
    import numpy as np
    from lteax.phy import mimo, seq

    t = t.for_pipeline("mimo")
    from lteax.phy.channels.pdsch import _global_rm_inv

    re_idx = jnp.asarray(pdsch_flat_idx(cfg, n_cell_id, cfi, prbs, subframe))
    cinits = [int(rnti) * 2 ** 14 + q * 2 ** 13 + int(subframe) * 512
              + int(n_cell_id) for q in range(2)]
    sgn = jnp.asarray(np.stack(
        [seq.scrambling_symbols_np(c, geom.g) for c in cinits]))
    use_planar = (scheme in ("qpsk", "16qam", "64qam")
                  and _global_rm_inv(geom)[1])
    if use_planar:
        from lteax.phy.mod import demap_planar, planar_sgn_np
        qm = geom.qm
        npad = -(-(geom.g // qm) // 128) * 128
        sgnp = jnp.asarray(np.stack(
            [planar_sgn_np(c, geom.g, qm, npad) for c in cinits]))
        ldt = jnp.bfloat16 if t.mdtype == "bf16" else jnp.float32

    def front(sub_iq):                       # (2 rx, n_samps, 2)
        s = (sub_iq[..., 0].astype(jnp.float32)
             + 1j * sub_iq[..., 1].astype(jnp.float32)
             ).astype(jnp.complex64)
        grids = jax.vmap(lambda ss: samples_to_subframe(ss, cfg))(s)
        if t.mimo_chest == "mmse":
            # STATIC noise prior -> host-precomputed Wiener matrix
            est = lambda r, tx: chest.estimate_channel_mmse(
                grids[r], cfg, n_cell_id, subframe, port=tx,
                noise_var=t.mimo_chest_nv)
        else:
            # pilot-level delay-domain denoise (the UL lever applied to the
            # CRS chest)
            est = lambda r, tx: chest.estimate_channel(
                grids[r], cfg, n_cell_id, subframe, port=tx,
                denoise=t.mimo_denoise)
        h = jnp.stack([jnp.stack([est(r, tx).reshape(-1)[re_idx]
                                  for tx in range(2)]) for r in range(2)])
        nvar = chest.estimate_noise_var(grids[0], cfg, n_cell_id, subframe)
        y = jnp.stack([grids[r].reshape(-1)[re_idx] for r in range(2)])
        heff = (mimo.heff_tm3(h) if tm == 3
                else mimo.heff_tm4(h, cb_index))
        x_hat, eff = mimo.mmse_demix_2layers(y, heff, nvar)
        if use_planar:
            return jnp.real(x_hat), jnp.imag(x_hat), 1.0 / eff   # (2, M) each
        outs = []
        for q in range(2):
            llr = demodulate_maxlog(x_hat[q], scheme, eff[q])
            llr = llr * sgn[q]
            if t.mdtype == "bf16":
                llr = llr.astype(jnp.bfloat16)
            outs.append(llr)
        return jnp.stack(outs)               # (2 cw, G)

    if use_planar:
        ddt = jnp.bfloat16 if t.demap_in == "bf16" else jnp.float32

        def demap_planar_mimo(batch_iq):     # (2rx, B, n_samps, 2)
            xr, xi, invnv = jax.vmap(front, in_axes=1)(batch_iq)  # (B,2,M)
            if ddt != jnp.float32:
                xr, xi, invnv = (xr.astype(ddt), xi.astype(ddt),
                                 invnv.astype(ddt))
            return jnp.stack(
                [demap_planar(xr[:, q], xi[:, q], invnv[:, q], sgnp[q],
                              scheme, out_dtype=ldt)
                 for q in range(2)], axis=1)             # (B, 2, m, npad)

        if t.mimo_planar_boundary and npad > geom.g // qm:
            # planar boundary (mirrors the UL one): each
            # codeword-subframe is one planar row (B_sf = B*2, matching
            # the composed path's reshape(-1, qm, npad) order), and the
            # per-codeword-subframe de-match map moves into the decode's
            # static layout gathers.  Zero-fold slot qm*npad - 1 is exact
            # 0.0 (demap zero-pads inv_nv); guard keeps a pad column.
            from lteax.phy.channels.pdsch import _global_rm_inv_planar
            mp_inv = np.asarray(_global_rm_inv_planar(geom, npad))

            def stage_front(batch_iq):
                llr = demap_planar_mimo(batch_iq)
                return llr.reshape(llr.shape[0] * 2, -1)

            stage_front.mid_rank = 2
            stage_turbo, _ = _make_turbo_stage(
                geom, n_iter, t, interpret,
                planar_spec=(mp_inv, geom.info.c, qm * npad))
            return stage_front, stage_turbo

        def stage_front(batch_iq):           # (2rx, B, n_samps, 2)
            llr = demap_planar_mimo(batch_iq)
            return pdsch_mod.soft_dematch_planar(
                llr.reshape(-1, geom.qm, npad), geom, npad)
    else:
        def stage_front(batch_iq):           # (2rx, B, n_samps, 2)
            llr = jax.vmap(front, in_axes=1)(batch_iq)   # (B, 2, G)
            return pdsch_mod.soft_dematch(llr.reshape(-1, geom.g), geom,
                                          t.struct_dematch)

    stage_turbo, _ = _make_turbo_stage(geom, n_iter, t, interpret)
    return stage_front, stage_turbo


def _mimo_sic_programs(cfg, n_cell_id, cfi, prbs, subframe, rnti, geom,
                       scheme, n_iter, t: DecoderTuning, interpret,
                       tm: int = 3, cb_index: int = 0):
    """2x2 TM3 successive-interference-cancellation decoder: decode CW0 at
    MMSE-demix SINR, RE-ENCODE it (fec.reencode GF(2) matmul), cancel its contribution from the received
    REs, then decode CW1 from a clean 1-layer MRC channel (no noise
    enhancement).  Subframes whose CW0 transport block failed CRC fall back
    to the plain MMSE LLRs for CW1, so SIC never performs worse than the
    linear demix at threshold.

    Four chained programs: front -> turbo(CW0) -> cancel/demap ->
    turbo(CW1).
    Returns fn: (2rx, B, n_samps, 2) f32 IQ -> ((2B, TBS) b-major (sf, cw)
    rows, (2B,) ok) — same contract as the fused MMSE decoder."""
    import numpy as np
    t = t.for_pipeline("mimo")
    from lteax.phy import mimo, seq
    from lteax.phy.fec.crc import check_crc
    from lteax.phy.fec.reencode import turbo_reencode_batch
    from lteax.phy.channels.pdsch import _global_rm_idx
    from lteax.phy.mod import modulate_arith
    from lteax.kernels.turbo_mlm import turbo_decode_batch_pallas

    re_idx = jnp.asarray(pdsch_flat_idx(cfg, n_cell_id, cfi, prbs, subframe))
    d_len = geom.k + 4
    cinits = [int(rnti) * 2 ** 14 + q * 2 ** 13 + int(subframe) * 512
              + int(n_cell_id) for q in range(2)]
    sgn = jnp.asarray(np.stack(
        [seq.scrambling_symbols_np(c, geom.g) for c in cinits]))
    scr0 = jnp.asarray(seq.gold_sequence_np(cinits[0], geom.g)
                       .astype(np.int32))          # CW0 scrambling bits
    rm_idx = jnp.asarray(_global_rm_idx(geom))
    early_crc = t.early_crc(geom.info.cb_crc)

    def front(sub_iq):                        # (2 rx, n_samps, 2)
        s = (sub_iq[..., 0].astype(jnp.float32)
             + 1j * sub_iq[..., 1].astype(jnp.float32)
             ).astype(jnp.complex64)
        grids = jax.vmap(lambda ss: samples_to_subframe(ss, cfg))(s)
        est = lambda r, tx: chest.estimate_channel(
            grids[r], cfg, n_cell_id, subframe, port=tx,
            denoise=t.mimo_denoise)
        h = jnp.stack([jnp.stack([est(r, tx).reshape(-1)[re_idx]
                                  for tx in range(2)]) for r in range(2)])
        nvar = chest.estimate_noise_var(grids[0], cfg, n_cell_id, subframe)
        y = jnp.stack([grids[r].reshape(-1)[re_idx] for r in range(2)])
        heff = (mimo.heff_tm3(h) if tm == 3
                else mimo.heff_tm4(h, cb_index))   # (2rx, 2layer, M)
        x_hat, eff = mimo.mmse_demix_2layers(y, heff, nvar)
        llr0 = demodulate_maxlog(x_hat[0], scheme, eff[0]) * sgn[0]
        llr1 = demodulate_maxlog(x_hat[1], scheme, eff[1]) * sgn[1]
        if t.mdtype == "bf16":
            llr0, llr1 = llr0.astype(jnp.bfloat16), llr1.astype(jnp.bfloat16)
        return llr0, llr1, y, heff, nvar

    def stage_front(batch_iq):                # (2rx, B, n_samps, 2)
        llr0, llr1, y, heff, nvar = jax.vmap(front, in_axes=1)(batch_iq)
        return (pdsch_mod.soft_dematch(llr0, geom, t.struct_dematch),
                llr1, y, heff, nvar)

    def stage_turbo0(d_llr):
        bsz = d_llr.shape[0]
        flat = d_llr.reshape(bsz * geom.info.c, 3, d_len)
        bits = turbo_decode_batch_pallas(
            flat, geom.k, n_iter=n_iter, win=t.win, acq=t.acq,
            early_crc=early_crc, mdtype=t.mdtype, ext_scale=t.ext_scale,
            retry_m=t.retry_m, retry_levels=t.retry_levels,
            layout=t.layout_glue, impl=t.turbo_impl, interpret=interpret)
        tb_bits, ok = _crc_stage(bits, geom, False, None)
        return bits, tb_bits, ok               # bits: raw (B*C, K) for SIC

    def stage_cancel(bits0, ok0, llr1_mmse, y, heff, nvar):
        bsz = llr1_mmse.shape[0]
        d0 = turbo_reencode_batch(bits0, geom.k)      # (B*C, 3, D)
        e = jnp.take(d0.reshape(bsz, -1), rm_idx, axis=-1)   # (B, G)
        s0 = modulate_arith((e + scr0) % 2, scheme)   # (B, M) CW0 symbols
        y2 = y - heff[..., 0, :] * s0[:, None, :]
        x1, eff1 = chest.equalize_mrc(y2, heff[..., 1, :], nvar[:, None])
        llr1 = demodulate_maxlog(x1, scheme, eff1) * sgn[1]
        llr1 = llr1.astype(llr1_mmse.dtype)
        # CW0-failed subframes keep the plain MMSE LLRs (never worse)
        llr1 = jnp.where(ok0[:, None], llr1, llr1_mmse)
        return pdsch_mod.soft_dematch(llr1, geom, t.struct_dematch)

    stage_turbo1, _ = _make_turbo_stage(geom, n_iter, t, interpret)
    return stage_front, stage_turbo0, stage_cancel, stage_turbo1


def make_mimo_sic_batch_decoder(cfg, n_cell_id, cfi, prbs, subframe, rnti,
                                geom, scheme, n_iter: int = 6,
                                tuning: DecoderTuning | None = None,
                                tm: int = 3, cb_index: int = 0,
                                interpret: bool = False):
    """SIC variant of :func:`make_mimo_batch_decoder` (same IO contract)."""
    t = tuning if tuning is not None else DecoderTuning.from_env()
    f1, f2, f3, f4 = _mimo_sic_programs(cfg, n_cell_id, cfi, prbs, subframe,
                                        rnti, geom, scheme, n_iter, t,
                                        interpret, tm=tm, cb_index=cb_index)

    def assemble(tb0, ok0, tb1, ok1):
        bsz = tb0.shape[0]
        bits = jnp.stack([tb0, tb1], axis=1).reshape(2 * bsz, -1)
        ok = jnp.stack([ok0, ok1], axis=1).reshape(2 * bsz)
        return bits, ok

    if interpret:
        def dec(batch_iq):
            d0, llr1m, y, heff, nvar = f1(batch_iq)
            bits0, tb0, ok0 = f2(d0)
            d1 = f3(bits0, ok0, llr1m, y, heff, nvar)
            tb1, ok1 = f4(d1)
            return assemble(tb0, ok0, tb1, ok1)
        return jax.jit(dec)
    j1, j2, j3, j4 = map(jax.jit, (f1, f2, f3, f4))
    j5 = jax.jit(assemble)

    def dec(batch_iq):
        d0, llr1m, y, heff, nvar = j1(batch_iq)
        bits0, tb0, ok0 = j2(d0)
        d1 = j3(bits0, ok0, llr1m, y, heff, nvar)
        tb1, ok1 = j4(d1)
        return j5(tb0, ok0, tb1, ok1)

    dec.stages = (j1, j2, j3, j4)   # for bench breakdowns
    return dec


def make_mimo_batch_decoder(cfg, n_cell_id, cfi, prbs, subframe, rnti, geom,
                            scheme, n_iter: int = 6,
                            tuning: DecoderTuning | None = None,
                            tm: int = 3, cb_index: int = 0,
                            interpret: bool = False):
    """Batched 2x2 dual-codeword production decoder (TM3 CDD default;
    ``tm=4`` + ``cb_index`` select closed-loop codebook precoding).

    (2 rx, B, n_samps, 2) float32 IQ -> ((2B, TBS), (2B,) ok): OFDM demod on
    both RX antennas, CRS chest per (rx, port), per-RE unbiased MMSE demix,
    both layers demapped in one call, host-precomputed per-codeword
    scrambling, batch-level de-match, and the two-program front/turbo split
    with ONE turbo kernel batch over both codewords.

    ``tuning.mimo_detector="sic"`` dispatches to the SIC decoder
    (:func:`make_mimo_sic_batch_decoder`), same IO contract.

    (reference capability: beyond ``liblte_phy``'s single-codeword
    ceiling — SURVEY.md §2.2 layer map / precoding row.)"""
    t = tuning if tuning is not None else DecoderTuning.from_env()
    if t.mimo_detector == "sic":
        return make_mimo_sic_batch_decoder(cfg, n_cell_id, cfi, prbs,
                                           subframe, rnti, geom, scheme,
                                           n_iter=n_iter, tuning=t, tm=tm,
                                           cb_index=cb_index,
                                           interpret=interpret)
    f1, f2 = _mimo_stages(cfg, n_cell_id, cfi, prbs, subframe, rnti, geom,
                          scheme, n_iter, t, interpret, tm=tm,
                          cb_index=cb_index)
    return _two_program(f1, f2, interpret)


# ---------------------------------------------------------------------------
# Sharded production decoders: the SAME stage functions under shard_map.
# ---------------------------------------------------------------------------


def _no_print_iters(t: DecoderTuning) -> DecoderTuning:
    """Sharded out_specs carry no slot for the diagnostic third output."""
    from dataclasses import replace
    return replace(t, print_iters=False) if t.print_iters else t


def _shard_two_stage(mesh, stage_front, stage_turbo, in_spec, batch_axis=0):
    """Wrap a production (front, turbo) stage pair in shard_map over
    ``mesh`` with the subframe batch on the ``time`` mesh axis.

    Keeps the two-program split of the single-device decoders; the
    intermediate de-matched LLR array stays device-resident with its
    P(time) sharding between the programs.  The compacted retry inside the
    turbo stage is shard-local: its argsort/gather and early-stop while_loop
    see only the local subbatch, so each shard stops independently — exactly
    the behavior that maximizes throughput when stragglers cluster.

    Returns fn: sharded_batch -> (tb_bits P(time), ok P(time),
    n_ok replicated int32 — the psum'd CRC-pass metric)."""
    # (B, C, 3, D) natural boundary, or (B, flat) when the front is planar
    mid_rank = getattr(stage_front, "mid_rank", 4)
    mid_spec = P(TIME_AXIS, *([None] * (mid_rank - 1)))

    def local_turbo(d_llr):
        tb_bits, ok = stage_turbo(d_llr)
        n_ok = jax.lax.psum(jnp.sum(ok.astype(jnp.int32)), TIME_AXIS)
        # in_specs replicate over chan; pmean keeps n_ok equal to the number
        # of distinct decoded TBs on any mesh shape
        n_ok = jax.lax.pmean(n_ok, CHAN_AXIS)
        return tb_bits, ok, n_ok

    # check_vma=False: pallas_call's out_shape ShapeDtypeStructs carry no
    # varying-mesh-axes annotation, which the default vma check rejects
    f1 = jax.jit(shard_map(stage_front, mesh=mesh, in_specs=(in_spec,),
                           out_specs=mid_spec, check_vma=False))
    f2 = jax.jit(shard_map(local_turbo, mesh=mesh, in_specs=(mid_spec,),
                           out_specs=(P(TIME_AXIS, None), P(TIME_AXIS), P()),
                           check_vma=False))
    dec = lambda batch: f2(f1(batch))
    dec.stage_front, dec.stage_turbo = f1, f2
    return dec


def make_sharded_decoder_pallas(mesh, cfg, n_cell_id, cfi, prbs, subframe,
                                rnti, geom, scheme, n_iter: int = 6,
                                tuning: DecoderTuning | None = None,
                                interpret: bool = False):
    """Time-sharded PRODUCTION DL decoder: (B, n_samps, 2) f32 IQ sharded on
    axis 0 over the ``time`` mesh axis -> (bits, ok, n_ok).  B must divide
    by the time-axis size.  The multi-device path is the production
    path."""
    t = _no_print_iters(tuning if tuning is not None else DecoderTuning.from_env())
    f1, f2 = _pdsch_stages(cfg, n_cell_id, cfi, prbs, subframe, rnti, geom,
                           scheme, n_iter, t, interpret)
    return _shard_two_stage(mesh, f1, f2, P(TIME_AXIS, None, None))


def make_sharded_harq_decoder_pallas(mesh, cfg, n_cell_id, cfi, prbs,
                                     subframes, rnti, geoms, scheme,
                                     n_iter: int = 6,
                                     tuning: DecoderTuning | None = None,
                                     interpret: bool = False):
    """Time-sharded PRODUCTION HARQ IR decoder: the per-transmission
    fronts + d-domain soft-combine + turbo kernel of
    :func:`make_batch_harq_decoder_pallas`, sharded over the subframe
    batch.  Input (n_tx, B, n_samps, 2) f32 IQ with axis 1 sharded ->
    (bits, ok, n_ok)."""
    ks = {g.k for g in geoms}
    assert len(ks) == 1 and len(subframes) == len(geoms) >= 2, \
        "HARQ combining needs >=2 transmissions of one TB geometry"
    t = _no_print_iters(tuning if tuning is not None else DecoderTuning.from_env())
    fronts = [
        _pdsch_stages(cfg, n_cell_id, cfi, prbs, sf_i, rnti, g_i, scheme,
                      n_iter, t, interpret, planar_boundary=False)[0]
        for sf_i, g_i in zip(subframes, geoms)]

    def stage_front(batch_iq):               # (n_tx, B_local, n_samps, 2)
        d = fronts[0](batch_iq[0])
        for i in range(1, len(fronts)):
            d = d + fronts[i](batch_iq[i])
        return d

    stage_turbo, _ = _make_turbo_stage(geoms[0], n_iter, t.for_pipeline("dl"),
                                       interpret)
    return _shard_two_stage(mesh, stage_front, stage_turbo,
                            P(None, TIME_AXIS, None, None))


def make_sharded_pusch_decoder(mesh, alloc, rnti, subframe, n_cell_id,
                               n_iter: int = 6, noise_var: float | None = None,
                               tuning: DecoderTuning | None = None,
                               interpret: bool = False):
    """Time-sharded PRODUCTION UL decoder: (B, 14, m_sc, 2) f32 IQ grids
    sharded on axis 0 -> (bits, ok, n_ok)."""
    t = _no_print_iters(tuning if tuning is not None else DecoderTuning.from_env())
    f1, f2 = _pusch_stages(alloc, rnti, subframe, n_cell_id, n_iter,
                           noise_var, t, interpret)
    return _shard_two_stage(mesh, f1, f2, P(TIME_AXIS, None, None, None))


def make_sharded_mimo_sic_decoder(mesh, cfg, n_cell_id, cfi, prbs, subframe,
                                  rnti, geom, scheme, n_iter: int = 6,
                                  tuning: DecoderTuning | None = None,
                                  tm: int = 3, cb_index: int = 0,
                                  interpret: bool = False):
    """Time-sharded SIC variant of :func:`make_sharded_mimo_decoder` (same
    IO contract).  Every SIC stage is batch-local (front, CW0 turbo,
    re-encode + cancel, CW1 turbo), so each of the four chained programs
    wraps in shard_map with the subframe batch on the ``time`` axis — the
    compacted retry and the CW0-fail MMSE fallback are shard-local."""
    t = _no_print_iters(tuning if tuning is not None else DecoderTuning.from_env())
    f1, f2, f3, f4 = _mimo_sic_programs(cfg, n_cell_id, cfi, prbs, subframe,
                                        rnti, geom, scheme, n_iter, t,
                                        interpret, tm=tm, cb_index=cb_index)

    tN = lambda n: P(TIME_AXIS, *([None] * n))
    d_spec, b_spec = tN(3), tN(1)
    f1_out = (d_spec, b_spec, tN(2), tN(3), P(TIME_AXIS))

    def local_tail(tb0, ok0, tb1, ok1):
        bits = jnp.stack([tb0, tb1], axis=1).reshape(2 * tb0.shape[0], -1)
        ok = jnp.stack([ok0, ok1], axis=1).reshape(-1)
        n_ok = jax.lax.psum(jnp.sum(ok.astype(jnp.int32)), TIME_AXIS)
        n_ok = jax.lax.pmean(n_ok, CHAN_AXIS)
        return bits, ok, n_ok

    sm = lambda fn, ins, outs: jax.jit(shard_map(
        fn, mesh=mesh, in_specs=ins, out_specs=outs, check_vma=False))
    g1 = sm(f1, (P(None, TIME_AXIS, None, None),), f1_out)
    g2 = sm(f2, (d_spec,), (b_spec, b_spec, P(TIME_AXIS)))
    g3 = sm(f3, (b_spec, P(TIME_AXIS), b_spec, tN(2), tN(3), P(TIME_AXIS)),
            d_spec)
    g4 = sm(f4, (d_spec,), (b_spec, P(TIME_AXIS)))
    g5 = sm(local_tail, (b_spec, P(TIME_AXIS), b_spec, P(TIME_AXIS)),
            (b_spec, P(TIME_AXIS), P()))

    def dec(batch_iq):
        d0, llr1m, y, heff, nvar = g1(batch_iq)
        bits0, tb0, ok0 = g2(d0)
        d1 = g3(bits0, ok0, llr1m, y, heff, nvar)
        tb1, ok1 = g4(d1)
        return g5(tb0, ok0, tb1, ok1)

    dec.stages = (g1, g2, g3, g4, g5)
    return dec


def make_sharded_mimo_decoder(mesh, cfg, n_cell_id, cfi, prbs, subframe,
                              rnti, geom, scheme, n_iter: int = 6,
                              tuning: DecoderTuning | None = None,
                              tm: int = 3, cb_index: int = 0,
                              interpret: bool = False):
    """Time-sharded PRODUCTION 2x2 MIMO decoder: (2rx, B, n_samps, 2) f32 IQ
    with the subframe batch (axis 1) sharded -> (bits (2B,TBS), ok, n_ok).

    Honors ``tuning.mimo_detector="sic"`` by dispatching to
    :func:`make_sharded_mimo_sic_decoder` — same contract as the
    single-device factory (a profile selecting SIC must never silently
    decode with MMSE)."""
    t = _no_print_iters(tuning if tuning is not None else DecoderTuning.from_env())
    if t.mimo_detector == "sic":
        return make_sharded_mimo_sic_decoder(
            mesh, cfg, n_cell_id, cfi, prbs, subframe, rnti, geom, scheme,
            n_iter=n_iter, tuning=t, tm=tm, cb_index=cb_index,
            interpret=interpret)
    f1, f2 = _mimo_stages(cfg, n_cell_id, cfi, prbs, subframe, rnti, geom,
                          scheme, n_iter, t, interpret, tm=tm,
                          cb_index=cb_index)
    return _shard_two_stage(mesh, f1, f2, P(None, TIME_AXIS, None, None))


def make_sharded_acquire_decoder_pallas(mesh, cfg, n_cell_id, cfi, prbs,
                                        subframe, rnti, geom, scheme,
                                        n_iter: int = 6,
                                        tuning: DecoderTuning | None = None,
                                        interpret: bool = False):
    """Halo-exchange PSS acquisition + the production decode front composed
    in ONE sharded program (SURVEY §7 step 7), with the turbo stage as
    program 2 (the two-program split of ``_two_program``).

    Input: (B, n_samps, 2) f32 IQ, batch on the ``time`` mesh axis, treated
    additionally as a contiguous capture for the acquisition correlator
    (shard boundaries get ppermute halos from the neighbouring device).
    Returns (bits, ok, n_ok, pss_peak) — pss_peak is the replicated global
    max of the |PSS matched filter| over the whole capture."""
    from lteax.phy.sync import pss_time_filters
    from lteax.shard.halo import overlap_save_correlate

    t = _no_print_iters(tuning if tuning is not None else DecoderTuning.from_env())
    f1, f2 = _pdsch_stages(cfg, n_cell_id, cfi, prbs, subframe, rnti, geom,
                           scheme, n_iter, t, interpret)
    taps = jnp.asarray(pss_time_filters(cfg)[n_cell_id % 3])
    mid_rank = getattr(f1, "mid_rank", 4)
    mid_spec = P(TIME_AXIS, *([None] * (mid_rank - 1)))

    def front_acq(samples_iq):               # local (b_loc, n_samps, 2)
        xc = (samples_iq[..., 0] + 1j * samples_iq[..., 1]
              ).astype(jnp.complex64)
        corr = overlap_save_correlate(xc.reshape(-1), taps, TIME_AXIS)
        peak = jax.lax.pmax(jnp.max(jnp.abs(corr)), TIME_AXIS)
        return f1(samples_iq), peak

    def local_turbo(d_llr):
        tb_bits, ok = f2(d_llr)
        n_ok = jax.lax.psum(jnp.sum(ok.astype(jnp.int32)), TIME_AXIS)
        n_ok = jax.lax.pmean(n_ok, CHAN_AXIS)
        return tb_bits, ok, n_ok

    g1 = jax.jit(shard_map(front_acq, mesh=mesh,
                           in_specs=(P(TIME_AXIS, None, None),),
                           out_specs=(mid_spec, P()), check_vma=False))
    g2 = jax.jit(shard_map(local_turbo, mesh=mesh, in_specs=(mid_spec,),
                           out_specs=(P(TIME_AXIS, None), P(TIME_AXIS), P()),
                           check_vma=False))

    def dec(batch):
        d_llr, peak = g1(batch)
        bits, ok, n_ok = g2(d_llr)
        return bits, ok, n_ok, peak

    return dec


def make_sharded_decoder(mesh, cfg, n_cell_id, cfi, prbs, subframe, rnti,
                         geom, scheme, n_iter: int = 6):
    """Time-sharded bulk decoder over the XLA-turbo reference path:
    (B_total, n_samps) sharded on axis 0 over the ``time`` mesh axis ->
    (bits, ok, n_ok_psum).  Kept as the slow-path oracle;
    ``make_sharded_decoder_pallas`` is the production sharded decoder.
    """
    one = make_subframe_decoder(cfg, n_cell_id, cfi, prbs, subframe, rnti,
                                geom, scheme, n_iter)

    def local(samples):
        bits, ok = jax.vmap(one)(samples)
        n_ok = jax.lax.psum(jnp.sum(ok.astype(jnp.int32)), TIME_AXIS)
        # the in_specs replicate the batch over the chan axis, so chan
        # replicas all hold the same count — pmean (not psum) keeps n_ok
        # equal to the number of distinct decoded TBs on any mesh shape
        n_ok = jax.lax.pmean(n_ok, CHAN_AXIS)
        return bits, ok, n_ok

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(TIME_AXIS, None, None),),
                   out_specs=(P(TIME_AXIS, None), P(TIME_AXIS), P()))
    return jax.jit(fn)
