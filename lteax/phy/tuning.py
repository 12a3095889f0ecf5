"""Frozen decoder tuning profile.

Every production-decoder numerics/behavior knob lives here as a versioned
dataclass field.  The shipped defaults are the composition of record; env
vars are *overrides* via
:meth:`DecoderTuning.from_env`, which every factory calls when no explicit
profile is passed — so existing ``LTEAX_*`` A/B workflows keep working, but
the composition of record is code+YAML, not ambient process state.

(reference capability: ``LTE_fdd_enb_cnfg_db`` is the reference's analogous
typed parameter store — SURVEY.md §2.3.)
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields, replace


@dataclass(frozen=True)
class DecoderTuning:
    """Production decode-pipeline tuning.  Defaults = shipped profile.

    Turbo decode (kernels/turbo_mlm.py):

    - ``win``/``acq``: max-log-MAP window / acquisition length (NII seeds
      the window boundaries after iteration 1, so a short acquisition
      suffices).
    - ``mdtype``: trellis metric dtype — "bf16" or "f32".
    - ``turbo_impl``: half-iteration implementation — "auto" (the Pallas
      kernel on CUDA, the plain scan elsewhere), "kernel" or "plain".
    - ``earlystop``: CRC-based half-iteration early termination.
    - ``ext_scale``: extrinsic damping (max-log standard 0.75).
    - ``retry_m``: compacted-retry subbatch size (stragglers re-iterated in
      a gathered retry_m-block batch); 0 disables.  Per-pipeline overrides
      ``retry_m_dl``/``retry_m_mimo`` (None = inherit): the optimum tracks
      the failure profile at the operating point.
    - ``retry_levels``: full-batch iterations checked for compaction before
      falling back to the full-batch early-stop loop (2x2 MIMO near its
      operating point fails most blocks after iteration 1 but few after
      iteration 2).
    - ``layout_glue``: keep the full-batch turbo iterations in the kernel's
      step-major layout (QPP interleave composed into gathers, layout-domain
      CRC matmul) instead of relayouting around every half-iteration.
    - ``planar_int8``: int8-quantized planar layout statics (one per-batch
      scale) — halves the bytes of the four static gathers.

    Front-end / chest:

    - ``mimo_chest``: "ls" (LS + linear interp) or "mmse" (host-Wiener).
    - ``mimo_denoise``: pilot-level delay-domain CRS denoise.
    - ``mimo_chest_nv``: static noise prior for the "mmse" Wiener matrix.
    - ``mimo_detector``: "mmse" (per-RE linear demix, both codewords in one
      turbo batch) or "sic" (decode CW0 -> re-encode -> cancel -> CW1 on a
      clean MRC channel; falls back to MMSE LLRs per subframe when CW0
      fails).
    - ``struct_dematch``: structured (reshape-based) de-match instead of
      the gather.
    - ``demap_in``: planar demap input staging dtype ("f32"/"bf16"); the
      demap computes in f32 either way.
    - ``ul_planar_boundary`` / ``mimo_planar_boundary``: defer the composed
      de-match gather into the decode's static layout gathers, like DL's
      planar boundary (MIMO: each codeword-subframe is one planar row).
    - ``ul_dft``: SC-FDMA transform (de)precoding (phy/channels/pusch.py
      ``_ul_dft``): "fft", "factored" or "matmul" (dense unitary DFT —
      comparison only).

    Diagnostics:

    - ``print_iters``: turbo stages return the iteration count as a third
      output (benches read it per the PERF.md iteration-count lesson).
    """

    win: int = 128
    acq: int = 16
    mdtype: str = "bf16"
    turbo_impl: str = "auto"
    earlystop: bool = True
    ext_scale: float = 0.75
    retry_m: int = 128
    retry_m_dl: int | None = 64
    retry_m_mimo: int | None = 192
    retry_levels: int = 2
    layout_glue: bool = True
    mimo_chest: str = "ls"
    mimo_denoise: bool = False
    mimo_chest_nv: float = 3e-3
    mimo_detector: str = "mmse"
    struct_dematch: bool = False
    print_iters: bool = False
    demap_in: str = "bf16"
    ul_planar_boundary: bool = True
    mimo_planar_boundary: bool = True
    planar_int8: bool = False
    ul_dft: str = "fft"

    # env var name -> (field, parser).
    _ENV = {
        "LTEAX_PALLAS_WIN": ("win", int),
        "LTEAX_PALLAS_ACQ": ("acq", int),
        "LTEAX_PALLAS_DTYPE": ("mdtype", str),
        "LTEAX_TURBO_IMPL": ("turbo_impl", str),
        "LTEAX_PALLAS_EARLYSTOP": ("earlystop", lambda s: s == "1"),
        "LTEAX_EXT_SCALE": ("ext_scale", float),
        "LTEAX_RETRY_M": ("retry_m", int),
        "LTEAX_RETRY_M_DL": ("retry_m_dl", int),
        "LTEAX_RETRY_M_MIMO": ("retry_m_mimo", int),
        "LTEAX_RETRY_LEVELS": ("retry_levels", int),
        "LTEAX_LAYOUT_GLUE": ("layout_glue", lambda s: s == "1"),
        "LTEAX_MIMO_CHEST": ("mimo_chest", str),
        "LTEAX_MIMO_DENOISE": ("mimo_denoise", lambda s: s == "1"),
        "LTEAX_MIMO_CHEST_NV": ("mimo_chest_nv", float),
        "LTEAX_MIMO_DETECTOR": ("mimo_detector", str),
        "LTEAX_STRUCT_DEMATCH": ("struct_dematch", lambda s: s == "1"),
        "LTEAX_PRINT_ITERS": ("print_iters", lambda s: s == "1"),
        "LTEAX_UL_DFT": ("ul_dft", str),
        "LTEAX_UL_PLANAR_BOUNDARY": ("ul_planar_boundary", lambda s: s == "1"),
        "LTEAX_MIMO_PLANAR_BOUNDARY": ("mimo_planar_boundary",
                                       lambda s: s == "1"),
        "LTEAX_DEMAP_IN": ("demap_in", str),
        "LTEAX_PLANAR_INT8": ("planar_int8", lambda s: s == "1"),
    }

    @classmethod
    def from_env(cls, base: "DecoderTuning | None" = None) -> "DecoderTuning":
        """Shipped profile with any set ``LTEAX_*`` env vars applied on top."""
        t = base if base is not None else cls()
        ov = {}
        for var, (field, parse) in cls._ENV.items():
            val = os.environ.get(var)
            if val is not None:
                ov[field] = parse(val)
        return replace(t, **ov) if ov else t

    @classmethod
    def from_dict(cls, d: dict) -> "DecoderTuning":
        known = {f.name for f in fields(cls)}
        bad = set(d) - known
        if bad:
            raise ValueError(f"unknown tuning keys: {sorted(bad)}")
        return cls(**d)

    @classmethod
    def from_yaml(cls, path: str) -> "DecoderTuning":
        """Load a profile from a YAML file (a ``tuning:`` section or a flat
        mapping)."""
        import yaml
        with open(path) as f:
            doc = yaml.safe_load(f) or {}
        return cls.from_dict(doc.get("tuning", doc))

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    def for_pipeline(self, kind: str) -> "DecoderTuning":
        """Resolve per-pipeline overrides ("dl" / "ul" / "mimo"):
        retry_m_{dl,mimo} onto the base field."""
        ov = {"dl": self.retry_m_dl, "mimo": self.retry_m_mimo}.get(kind)
        return replace(self, retry_m=ov) if ov is not None else self

    def early_crc(self, cb_crc: bool) -> str | None:
        """CRC flavor for the kernel's early stop (None when disabled)."""
        if not self.earlystop:
            return None
        return "24B" if cb_crc else "24A"
