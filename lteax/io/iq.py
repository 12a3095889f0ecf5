"""IQ file readers/writers.

(reference capability: the GNU Radio ``file_source``/``file_sink`` blocks and
the int8→complex conversion path of ``LTE_fdd_dl_file_scan`` — SURVEY.md C2:
"gnuradio file-scanner frontends become jax.numpy stream readers".)

Formats:
  fc32 — interleaved float32 I/Q (GNU Radio gr_complex)
  sc8  — interleaved int8 I/Q (rtl-sdr style, scaled by 1/128)
"""

from __future__ import annotations

import numpy as np


def to_iq_f32(x: np.ndarray) -> np.ndarray:
    """complex (...,) -> float32 (..., 2).  Device-boundary layout: all
    jitted entry points take/return IQ float pairs and form complex inside
    jit (float pairs also stage as bf16 or int8)."""
    x = np.asarray(x)
    return np.stack([x.real, x.imag], axis=-1).astype(np.float32)


def to_iq_bf16(x: np.ndarray) -> np.ndarray:
    """complex (...,) -> bfloat16 (..., 2): halves the device-boundary
    transfer and the front-end's input read (quantization ~-45 dBc, well
    below the decode operating point)."""
    import ml_dtypes
    x = np.asarray(x)
    return np.stack([x.real, x.imag], axis=-1).astype(ml_dtypes.bfloat16)


def to_iq_sc8(x: np.ndarray, scale: float = 127.0) -> np.ndarray:
    """complex (...,) -> int8 (..., 2) rtl-sdr-style pairs (quarter-width
    device boundary; the decode chain is scale-invariant)."""
    x = np.asarray(x)
    inter = np.stack([x.real, x.imag], axis=-1) * scale
    return np.clip(np.round(inter), -128, 127).astype(np.int8)


def from_iq_f32(x: np.ndarray) -> np.ndarray:
    """float32 (..., 2) -> complex64 (...,)."""
    x = np.asarray(x)
    return (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)


def write_iq(path: str, samples: np.ndarray, fmt: str = "fc32") -> None:
    x = np.asarray(samples).astype(np.complex64)
    inter = np.empty(2 * len(x), dtype=np.float32)
    inter[0::2] = x.real
    inter[1::2] = x.imag
    if fmt == "fc32":
        inter.tofile(path)
    elif fmt == "sc8":
        np.clip(np.round(inter * 127.0), -128, 127).astype(np.int8).tofile(path)
    else:
        raise ValueError(f"unknown IQ format {fmt}")


def read_iq(path: str, fmt: str = "fc32", count: int = -1,
            offset_samples: int = 0) -> np.ndarray:
    itemsize = 8 if fmt == "fc32" else 2
    if fmt == "fc32":
        raw = np.fromfile(path, dtype=np.float32, count=-1 if count < 0 else 2 * count,
                          offset=offset_samples * itemsize)
    elif fmt == "sc8":
        raw = np.fromfile(path, dtype=np.int8, count=-1 if count < 0 else 2 * count,
                          offset=offset_samples * itemsize).astype(np.float32) / 128.0
    else:
        raise ValueError(f"unknown IQ format {fmt}")
    raw = raw[: (len(raw) // 2) * 2]
    return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)


def chunk_subframes(x: np.ndarray, n_samps_subframe: int,
                    start: int = 0) -> np.ndarray:
    """Trim+reshape a capture into whole subframes from ``start``:
    (n_subframes, n_samps_subframe)."""
    x = x[start:]
    n = len(x) // n_samps_subframe
    return x[: n * n_samps_subframe].reshape(n, n_samps_subframe)


def prefetch_to_device(batches, depth: int = 2):
    """Double-buffered device feed: yields device arrays while the next
    host batch is already in flight (jax.device_put is async).

    ``batches``: iterable of numpy arrays (float32 IQ-pair layout).
    SURVEY.md §7 hard-part #5: keep chips fed without host stalls."""
    import collections
    import jax

    q = collections.deque()
    it = iter(batches)
    try:
        for _ in range(depth):
            q.append(jax.device_put(next(it)))
    except StopIteration:
        pass
    while q:
        try:
            q.append(jax.device_put(next(it)))
        except StopIteration:
            pass
        yield q.popleft()
