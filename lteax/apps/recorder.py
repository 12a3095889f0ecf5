"""IQ recorder: capture a sample stream to file with ctrl-socket control.

(reference capability: ``LTE_file_recorder/src/LTE_file_recorder_main.cc`` +
``_flowgraph.cc`` + ``_interface.cc`` — osmosdr source -> file sink with a
ctrl socket.  No SDR hardware exists in this environment (BASELINE scope),
so the source is a file/pipe stream; the recording path — chunked streaming,
format conversion, ctrl start/stop, EARFCN bookkeeping — is the capability.)

    python -m lteax.apps.recorder --in-path /dev/stdin --out /tmp/rec.fc32 \
        --in-fmt sc8 --samples 1920000 [--ctrl-port 20001]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from lteax.io.iq import write_iq, from_iq_f32
from lteax.io import native


def record(in_path: str, out_path: str, in_fmt: str = "fc32",
           out_fmt: str = "fc32", n_samples: int = -1,
           chunk: int = 1 << 18, earfcn: int | None = None,
           progress=None) -> int:
    """Stream-convert ``n_samples`` (-1 = all) from in_path to out_path.

    Uses the native double-buffered reader when available.  Returns the
    number of complex samples recorded."""
    total = 0
    out_chunks = []
    if native.available():
        stream = native.IqStream(in_path, in_fmt, chunk_samples=chunk)
        try:
            for block in stream:
                if n_samples >= 0 and total + len(block) > n_samples:
                    block = block[: n_samples - total]
                out_chunks.append(from_iq_f32(block))
                total += len(block)
                if progress:
                    progress(total)
                if n_samples >= 0 and total >= n_samples:
                    break
        finally:
            stream.close()
    else:  # pragma: no cover - fallback
        from lteax.io.iq import read_iq
        x = read_iq(in_path, in_fmt, count=n_samples)
        out_chunks = [x]
        total = len(x)
    x = np.concatenate(out_chunks) if out_chunks else np.zeros(0, np.complex64)
    write_iq(out_path, x, out_fmt)
    return total


def record_tcp(src, out_path: str, n_samples: int, out_fmt: str = "fc32",
               chunk: int = 1 << 18, timeout_ms: int = 5000,
               progress=None) -> tuple[int, int]:
    """Record ``n_samples`` from a live ``native.IqTcpSource`` into a
    file.  Returns (samples_recorded, overrun_drop_count) — the drop
    counter is the reference's radio-overrun accounting equivalent."""
    out_chunks = []
    total = 0
    while total < n_samples:
        block = src.read(min(chunk, n_samples - total),
                         timeout_ms=timeout_ms)
        if not len(block):
            break
        out_chunks.append(block)
        total += len(block)
        if progress:
            progress(total)
    x = (np.concatenate(out_chunks) if out_chunks
         else np.zeros(0, np.complex64))
    write_iq(out_path, x, out_fmt)
    return total, src.dropped


def main(argv=None):
    p = argparse.ArgumentParser(description="IQ stream recorder")
    p.add_argument("--in-path", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--in-fmt", choices=("fc32", "sc8", "sc16"), default="fc32")
    p.add_argument("--out-fmt", choices=("fc32", "sc8"), default="fc32")
    p.add_argument("--samples", type=int, default=-1)
    p.add_argument("--earfcn", type=int, default=None)
    p.add_argument("--ctrl-port", type=int, default=None,
                   help="expose read/write/record ctrl socket and wait")
    a = p.parse_args(argv)
    if a.ctrl_port is not None:
        from lteax.apps.ctrl import CtrlServer
        import threading
        params = {"earfcn": a.earfcn or 0, "samples": a.samples,
                  "recording": False}
        done = threading.Event()

        def do_record(_args):
            params["recording"] = True
            n = record(a.in_path, a.out, a.in_fmt, a.out_fmt,
                       params["samples"])
            params["recording"] = False
            done.set()
            return f"recorded {n}"

        srv = CtrlServer(params, {"record": do_record}, port=a.ctrl_port)
        print(f"ctrl on port {srv.port}; send 'record' to start",
              file=sys.stderr)
        done.wait()
        srv.stop()
    else:
        n = record(a.in_path, a.out, a.in_fmt, a.out_fmt, a.samples,
                   earfcn=a.earfcn)
        print(f"recorded {n} samples to {a.out}")


if __name__ == "__main__":
    main()
