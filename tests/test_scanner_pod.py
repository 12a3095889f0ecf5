"""Config #5 end-to-end on the virtual mesh.

Exercises `configs/config5_scanner_pod.yaml` shapes on the 8-device CPU
mesh: N carriers as a sharded channel axis (batched PSS prescan), the
polyphase resampler front-end for an off-rate capture, per-channel decode,
and checkpoint kill/resume mid-run (idempotent work units, SURVEY.md §5).
"""

import json

import numpy as np
import pytest

from lteax.apps.file_gen import GenConfig, generate
from lteax.apps.scanner import Channel, scan_channels
from lteax.phy.config import PhyConfig


@pytest.fixture(scope="module")
def pod_setup(tmp_path_factory):
    import yaml
    with open("configs/config5_scanner_pod.yaml") as f:
        c5 = yaml.safe_load(f)
    assert c5["mesh"]["chan"] == 8
    cfg = PhyConfig(n_rb_dl=c5["n_rb_dl"])
    tmp = tmp_path_factory.mktemp("pod")
    rng = np.random.default_rng(9)

    def write(path, x):
        out = np.empty(2 * x.size, np.float32)
        out[0::2], out[1::2] = np.real(x), np.imag(x)
        out.tofile(path)

    chans = []
    live = {"100": 77, "200": 201, "300": 449}
    for label, cid in live.items():
        x = generate(GenConfig(n_rb_dl=6, n_cell_id=cid, n_frames=4))
        rate = None
        if label == "300":
            # capture at 1.5x the native rate: the scanner's polyphase
            # front-end must resample it back down (config #5 resampler row)
            from lteax.kernels.polyphase import resample_poly
            import jax.numpy as jnp
            x = np.asarray(resample_poly(jnp.asarray(x), 3, 2))
            rate = cfg.fs * 1.5
        p = tmp / f"ch{label}.bin"
        write(p, x.astype(np.complex64))
        chans.append(Channel(label=label, path=str(p), rate_hz=rate))
    n_live = len(chans)
    l_dead = 4 * 10 * cfg.n_samps_subframe
    for label in ("910", "911", "912", "913", "914"):
        x = 0.01 * (rng.standard_normal(l_dead)
                    + 1j * rng.standard_normal(l_dead)).astype(np.complex64)
        p = tmp / f"ch{label}.bin"
        write(p, x)
        chans.append(Channel(label=label, path=str(p)))
    return cfg, chans, live, tmp


@pytest.mark.heavy
def test_pod_scan_with_prescan_and_resume(pod_setup):
    cfg, chans, live, tmp = pod_setup
    ckpt = tmp / "pod.ckpt"

    # -- first run killed mid-way: the 2nd live channel raises mid-decode
    import lteax.apps.scanner as scanner_mod
    orig = scanner_mod.scan_channel
    state = {"n": 0}

    def dying(ch, cfg_):
        state["n"] += 1
        if state["n"] == 2:
            raise KeyboardInterrupt     # simulated kill (not an Exception)
        return orig(ch, cfg_)

    scanner_mod.scan_channel = dying
    try:
        with pytest.raises(KeyboardInterrupt):
            scan_channels(chans, cfg, checkpoint_path=str(ckpt),
                          prescan=True)
    finally:
        scanner_mod.scan_channel = orig

    # -- resume: finished channels skipped, rest completed
    calls = {"n": 0}

    def counting(ch, cfg_):
        calls["n"] += 1
        return orig(ch, cfg_)

    scanner_mod.scan_channel = counting
    try:
        reports = scan_channels(chans, cfg, checkpoint_path=str(ckpt),
                                prescan=True)
    finally:
        scanner_mod.scan_channel = orig
    # first run finished exactly one live channel before the kill; the
    # resume must re-decode only the remaining live ones (dead channels
    # are prescan-flagged, never decoded)
    assert calls["n"] == len(live) - 1

    by_label = {r["channel"]: r for r in reports}
    assert len(reports) == len(chans)
    for label, cid in live.items():
        assert by_label[label]["n_cell_id"] == cid, by_label[label]
        assert by_label[label]["mib"]["n_rb_dl"] == 6
    for label in ("910", "911", "912", "913", "914"):
        r = by_label[label]
        assert r["n_cell_id"] == -1 and not r["prescan"]["detected"]

    # -- a third run is fully checkpointed: zero re-decodes, same reports
    scanner_mod.scan_channel = counting
    calls["n"] = 0
    try:
        again = scan_channels(chans, cfg, checkpoint_path=str(ckpt),
                              prescan=True)
    finally:
        scanner_mod.scan_channel = orig
    assert calls["n"] == 0
    assert json.dumps(again, sort_keys=True) == \
        json.dumps(reports, sort_keys=True)


def test_pod_prescan_uses_chan_mesh(pod_setup):
    """The prescan really runs over the config-#5 chan-axis mesh shape."""
    import jax
    from lteax.shard.mesh import make_mesh
    from lteax.shard.scanner import batched_prescan

    cfg, chans, live, tmp = pod_setup
    n_dev = len(jax.devices())
    assert n_dev == 8                      # conftest virtual mesh
    mesh = make_mesh(n_chan=8, n_time=1)
    l = 2 * 10 * cfg.n_samps_subframe
    caps = []
    for ch in chans:
        from lteax.io.iq import read_iq
        x = read_iq(ch.path, ch.fmt)
        caps.append(x[:l])
    out = batched_prescan(np.stack(caps), cfg, mesh)
    det = [o["detected"] for o in out]
    assert det[0] and det[1]           # native-rate live cells detected
    assert not any(det[3:])            # noise channels rejected
    assert [o["n_id_2"] for o in out[:2]] == [77 % 3, 201 % 3]
