"""App path == production path on the same capture.

``file_scan`` decodes SI PDSCH through the XLA ``pdsch_decode_llrs`` path
(defensible: per-SI-window geometry varies).  This gate generates a capture
with ``file_gen``, records every SI transport block the app decoded (with
its exact geometry), then decodes the SAME subframe samples through the
shipped PRODUCTION decoder (``make_batch_decoder_pallas`` — Pallas demap +
turbo, early stop, compacted retry) and pins the bits equal — so a
numerics drift between the user-facing app and the flagship decoder
fails CI.

(reference capability: the LTE_fdd_dl_file_gen -> LTE_fdd_dl_file_scan
loopback is the reference's only end-to-end check — SURVEY.md §4.)"""

import numpy as np
import pytest
import jax.numpy as jnp

from lteax.apps.file_gen import GenConfig, generate
from lteax.apps.file_scan import scan, SI_RNTI
from lteax.io.iq import to_iq_f32
from lteax.phy.channels import pdsch as pdsch_mod
from lteax.phy.config import PhyConfig
from lteax.phy.grid import pdsch_flat_idx
from lteax.shard.pipeline import make_batch_decoder_pallas


@pytest.mark.mid
def test_file_scan_si_bits_match_production_decoder():
    gc = GenConfig(n_rb_dl=6, n_cell_id=214, n_frames=4, tac=0x1234)
    x = generate(gc)
    cfg = gc.phy
    r = scan(x, cfg)
    assert r.n_cell_id == 214 and r.sib1 is not None
    assert r.si_decodes, "scan recorded no SI decodes"

    n_ant_cfg = PhyConfig(n_rb_dl=cfg.n_rb_dl, n_ant=r.n_ant,
                          extended_cp=cfg.extended_cp)
    checked = 0
    for rec in r.si_decodes[:3]:
        sf_abs = r.frame_start + rec["sf_index"] * cfg.n_samps_subframe
        sams = x[sf_abs:sf_abs + cfg.n_samps_subframe]
        re_idx = pdsch_flat_idx(n_ant_cfg, r.n_cell_id, rec["ctrl"],
                                rec["prbs"], rec["sf"])
        geom = pdsch_mod.pdsch_geometry(rec["tbs"], len(re_idx), 2,
                                        rec["rv"])
        dec = make_batch_decoder_pallas(
            n_ant_cfg, r.n_cell_id, rec["ctrl"], rec["prbs"], rec["sf"],
            SI_RNTI, geom, "qpsk", n_iter=6, interpret=True)
        bits, ok = dec(jnp.asarray(to_iq_f32(sams[None])))
        assert bool(np.asarray(ok)[0]), \
            f"production decoder failed CRC on app-decoded SI at sf " \
            f"{rec['sf']} (rv={rec['rv']}, tbs={rec['tbs']})"
        np.testing.assert_array_equal(np.asarray(bits)[0], rec["tb"])
        checked += 1
    assert checked >= 1
