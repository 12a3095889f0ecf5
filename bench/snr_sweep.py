"""Config #2: DL-SCH turbo BER/BLER vs SNR sweep (AWGN), 5 MHz class.

(reference capability: the octave/ golden-model BER studies — the reference
itself ships no sweep harness; SURVEY.md §4 makes this a first-class test.)

Run:  python bench/snr_sweep.py [--n-rb 25] [--mcs 10] [--blocks 20]
Prints one line per SNR point: esn0_db, ber, bler.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

import jax
import jax.numpy as jnp


def sweep(n_rb: int = 25, mcs: int = 10, n_blocks: int = 20,
          esn0_points=None, n_iter: int = 6, seed: int = 0,
          decoder: str = "device"):
    """``decoder="device"`` uses the XLA-scan reference turbo;
    ``decoder="pallas"`` uses the PRODUCTION turbo stage (the turbo
    kernel on the GPU, its plain scan elsewhere, with the shipped
    DecoderTuning: bf16 trellis, early stop, compacted retry) — the curve
    the BLER regression gate pins."""
    from lteax.phy.tables.tbs import get_tbs_for_mcs
    from lteax.phy.channels import pdsch as pdsch_mod
    from lteax.phy.mod import modulate, demodulate_maxlog, BITS_PER_SYM

    tbs, scheme = get_tbs_for_mcs(mcs, n_rb)
    qm = BITS_PER_SYM[scheme]
    n_re = 12 * n_rb * 11  # ~PDSCH REs of a subframe (cfi 2, minus CRS-ish)
    geom = pdsch_mod.pdsch_geometry(tbs, n_re, qm, 0)
    rng = np.random.default_rng(seed)
    cid, sf, rnti = 100, 1, 0x1234

    if esn0_points is None:
        # center the sweep near the code rate's Shannon-ish threshold
        rate = tbs / (n_re * qm)
        base = 10 * np.log10(2 ** (rate * qm) - 1)
        esn0_points = [base - 1 + 0.5 * i for i in range(7)]

    enc = jax.jit(jax.vmap(lambda cb: pdsch_mod.pdsch_encode_cbs(
        cb, geom, rnti, sf, cid, scheme)))
    if decoder == "pallas":
        from lteax.phy import seq
        from lteax.phy.tuning import DecoderTuning
        from lteax.shard.pipeline import _make_turbo_stage
        t = DecoderTuning()    # shipped profile, NOT from_env: the gate
        sgn = jnp.asarray(seq.scrambling_symbols_np(
            rnti * 2 ** 14 + sf * 512 + cid, geom.g))
        turbo = _make_turbo_stage(geom, n_iter, t, False)[0]   # pins defaults

        def decode_batch(llr_b):          # (B, G) f32 channel LLRs
            llr = llr_b * sgn
            if t.mdtype == "bf16":
                llr = llr.astype(jnp.bfloat16)
            return turbo(pdsch_mod.soft_dematch(llr, geom))
        dec_pl = jax.jit(decode_batch)
    else:
        dec = jax.jit(jax.vmap(lambda llr: pdsch_mod.pdsch_decode_device(
            llr, geom, rnti, sf, cid, n_iter=n_iter)))

    tb_bits = rng.integers(0, 2, size=(n_blocks, tbs)).astype(np.int32)
    cbs = np.stack([pdsch_mod.pdsch_prepare_cbs(tb_bits[i], geom)
                    for i in range(n_blocks)])
    syms = np.asarray(enc(jnp.asarray(cbs)))

    results = []
    for esn0_db in esn0_points:
        nv = 10 ** (-esn0_db / 10)
        noise = (rng.standard_normal(syms.shape)
                 + 1j * rng.standard_normal(syms.shape)) * np.sqrt(nv / 2)
        rx = (syms + noise).astype(np.complex64)
        llr = demodulate_maxlog(jnp.asarray(rx), scheme, nv)
        if decoder == "pallas":
            bits, oks = dec_pl(llr.reshape(n_blocks, -1))
        else:
            bits, oks, _ = dec(llr)
        bits, oks = np.asarray(bits), np.asarray(oks)
        ber = float(np.mean(bits != tb_bits))
        bler = float(1.0 - np.mean(oks))
        results.append((float(esn0_db), ber, bler))
    return tbs, scheme, results


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n-rb", type=int, default=25)
    p.add_argument("--mcs", type=int, default=10)
    p.add_argument("--blocks", type=int, default=20)
    p.add_argument("--iters", type=int, default=6)
    a = p.parse_args(argv)
    tbs, scheme, res = sweep(a.n_rb, a.mcs, a.blocks, n_iter=a.iters)
    print(f"# TBS={tbs} {scheme} n_rb={a.n_rb} mcs={a.mcs}", file=sys.stderr)
    print("esn0_db,ber,bler")
    for e, ber, bler in res:
        print(f"{e:.2f},{ber:.5f},{bler:.3f}")


if __name__ == "__main__":
    main()
