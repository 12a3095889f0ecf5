"""Static PHY configuration.

The reference keeps a big mutable ``LIBLTE_PHY_STRUCT`` allocated by
``liblte_phy_init`` (reference: ``liblte/src/liblte_phy.cc :: liblte_phy_init``,
``liblte_phy_update_n_rb_dl``) holding FFTW plans and scratch buffers.  The
equivalent here is an immutable, hashable dataclass whose derived fields
are *shapes* — captured statically at ``jit`` trace time.  No buffers, no
plans: XLA owns those.

Numerology per 3GPP TS 36.211 §6.12 / §6.2.3.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

# N_rb_dl -> FFT size.  fs = N_fft * 15 kHz.
# (reference: liblte_phy.h :: LIBLTE_PHY_FS_1_92MHZ .. LIBLTE_PHY_FS_30_72MHZ)
_NRB_TO_NFFT = {6: 128, 15: 256, 25: 512, 50: 1024, 75: 1536, 100: 2048}

N_SC_RB = 12          # subcarriers per resource block (36.211 §6.2.3)
N_SYM_SLOT_NORM = 7   # OFDM symbols per slot, normal CP
N_SYM_SLOT_EXT = 6    # OFDM symbols per slot, extended CP
N_SLOTS_SUBFRAME = 2
N_SUBFRAMES_FRAME = 10
SC_SPACING_HZ = 15_000


@dataclasses.dataclass(frozen=True)
class PhyConfig:
    """Immutable static PHY configuration — hashable, usable as a jit static arg.

    Everything shape-determining lives here; everything value-like (cell id,
    RNTI, ...) is a runtime array argument to the jitted functions.
    """

    n_rb_dl: int = 6
    n_ant: int = 1              # cell-specific reference signal ports (1, 2, 4)
    extended_cp: bool = False

    def __post_init__(self):
        if self.n_rb_dl not in _NRB_TO_NFFT:
            raise ValueError(f"n_rb_dl must be one of {sorted(_NRB_TO_NFFT)}")
        if self.n_ant not in (1, 2, 4):
            raise ValueError("n_ant must be 1, 2 or 4")

    # ---- derived numerology -------------------------------------------------

    @property
    def n_fft(self) -> int:
        return _NRB_TO_NFFT[self.n_rb_dl]

    @property
    def fs(self) -> int:
        """Sample rate in Hz."""
        return self.n_fft * SC_SPACING_HZ

    @property
    def n_sc(self) -> int:
        """Occupied subcarriers (excluding DC)."""
        return self.n_rb_dl * N_SC_RB

    @property
    def n_sym_slot(self) -> int:
        return N_SYM_SLOT_EXT if self.extended_cp else N_SYM_SLOT_NORM

    @property
    def n_sym_subframe(self) -> int:
        return self.n_sym_slot * N_SLOTS_SUBFRAME

    @cached_property
    def cp_lengths_slot(self) -> tuple[int, ...]:
        """CP length (samples) per OFDM symbol in one slot (36.211 Table 6.12-1)."""
        scale = self.n_fft  # lengths specified for 2048 then scaled by N/2048
        if self.extended_cp:
            return tuple([512 * scale // 2048] * N_SYM_SLOT_EXT)
        return tuple([160 * scale // 2048] + [144 * scale // 2048] * 6)

    @property
    def n_samps_slot(self) -> int:
        return sum(cp + self.n_fft for cp in self.cp_lengths_slot)

    @property
    def n_samps_subframe(self) -> int:
        """Samples per 1 ms subframe ( == fs / 1000 )."""
        return self.n_samps_slot * N_SLOTS_SUBFRAME

    @property
    def n_samps_frame(self) -> int:
        return self.n_samps_subframe * N_SUBFRAMES_FRAME

    @cached_property
    def symbol_starts_subframe(self) -> tuple[int, ...]:
        """Sample offset of each OFDM symbol's *data* part within a subframe."""
        starts = []
        off = 0
        for _slot in range(N_SLOTS_SUBFRAME):
            for cp in self.cp_lengths_slot:
                off += cp
                starts.append(off)
                off += self.n_fft
        return tuple(starts)

    @cached_property
    def sc_to_fft_bin(self) -> np.ndarray:
        """Map occupied-subcarrier index (0..n_sc-1, low→high freq) to FFT bin.

        Subcarrier ``n_sc/2 - 1`` is just below DC, ``n_sc/2`` just above; DC
        itself is unused (36.211 §6.12).  Negative frequencies are bins
        N-n_sc/2 .. N-1.
        """
        half = self.n_sc // 2
        neg = np.arange(self.n_fft - half, self.n_fft)
        pos = np.arange(1, half + 1)
        return np.concatenate([neg, pos]).astype(np.int32)


def subframe_grid_shape(cfg: PhyConfig) -> tuple[int, int]:
    """(n_symbols, n_subcarriers) of one subframe's resource grid."""
    return (cfg.n_sym_subframe, cfg.n_sc)
