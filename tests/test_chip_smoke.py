"""chip_smoke.py's phases at toy size on the CPU (the kernel in the Pallas
interpreter), its refusal to run without a GPU, and the DL phase on the
card (``gpu`` marker)."""

import os
import subprocess
import sys

import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_main_refuses_the_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("phase", ["turbo", "dl", "others", "cell_search",
                                   "mesh"])
def test_phase_at_toy_size(phase):
    run = {
        "turbo": lambda: chip_smoke.phase_turbo(c=8, k=40, kernel="interpret",
                                                reps=1),
        "dl": lambda: chip_smoke.phase_dl(b=2, n_rb=6, mcs=9, n_unique=2,
                                          interpret=True),
        "others": lambda: chip_smoke.phase_others(
            b=2, n_rb=6, mcs=9, ul_tbs=504, ul_qm=2, interpret=True,
            n_unique=2),
        "cell_search": lambda: chip_smoke.phase_cell_search(n_carriers=4),
        "mesh": lambda: chip_smoke.phase_mesh(n=4, b=4, n_rb=6, mcs=9,
                                              n_unique=2, interpret=True),
    }[phase]
    run()


@pytest.mark.gpu
def test_dl_phase_on_gpu():
    chip_smoke.phase_dl(b=16)
