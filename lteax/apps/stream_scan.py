"""Streaming long-capture scanner service.

(reference capability: ``LTE_fdd_dl_scan`` run as a continuously-running
service — the GNU Radio flowgraph feeding ``LTE_fdd_dl_scan_state_machine``
block by block, with status reported over the ctrl socket.  SURVEY.md C2/C3:
stream frontends become chunked jax pipelines; the ctrl/status socket pair
maps to one `CtrlServer`.)

The capture is consumed in fixed windows of subframes.  Each window runs the
full batched `file_scan.scan` pipeline (cell search -> MIB -> SI), results are
recorded in a `ScanCheckpoint` keyed by window index, so a killed service
resumes where it stopped.  A `CtrlServer` exposes `status` / `results` /
`shutdown` while the scan runs.

No SDR hardware is in scope (BASELINE.md) — the source is a file, read with
the native double-buffered reader when the C extension is built.
"""

from __future__ import annotations

import argparse
import json
import threading

import numpy as np

from lteax.phy.config import PhyConfig
from lteax.apps.file_scan import scan
from lteax.apps.ctrl import CtrlServer
from lteax.io import iq as iqio
from lteax.io import native
from lteax.utils.checkpoint import ScanCheckpoint
from lteax.utils.metrics import EVENTS, METRICS, ctrl_debug_verbs


class StreamScanService:
    def __init__(self, path: str | None, cfg: PhyConfig, fmt: str = "fc32",
                 window_sf: int = 60, ckpt_path: str | None = None,
                 port: int = 0, tcp_source=None, live_idle_s: float = 5.0):
        """path is the capture file; alternatively pass a live
        ``native.IqTcpSource`` as tcp_source (rtl_tcp-style ingest) and
        windows are scanned as samples arrive."""
        self.path = path
        self.cfg = cfg
        self.fmt = fmt
        self.tcp = tcp_source
        self.live_idle_s = live_idle_s
        self.window_sf = window_sf
        self.ckpt = ScanCheckpoint(ckpt_path) if ckpt_path else None
        self.results: dict[int, dict] = {}
        self.windows_done = 0
        self._stop = threading.Event()
        self.ctrl = CtrlServer({}, {
            "status": lambda a: json.dumps(self.status()),
            "results": lambda a: json.dumps(self.results.get(int(a[0]), {})
                                            if a else self.results),
            "metrics": lambda a: json.dumps(METRICS.snapshot()),
            # NB: not "shutdown" — that is a CtrlServer built-in which only
            # stops the socket; "stop" also ends the scan loop.
            "stop": lambda a: (self._stop.set(), "stopping")[1],
            **ctrl_debug_verbs(),
        }, port=port)

    def status(self) -> dict:
        last = self.results.get(self.windows_done - 1, {})
        d = {"windows_done": self.windows_done,
             "window_sf": self.window_sf,
             "last_cell_id": last.get("n_cell_id"),
             "running": not self._stop.is_set()}
        if self.tcp is not None:
            d["live"] = True
            d["overruns_dropped"] = self.tcp.dropped
        return d

    def _read_window(self, w: int) -> np.ndarray:
        n = self.window_sf * self.cfg.n_samps_subframe
        if self.tcp is not None:
            chunks, got, idle = [], 0, 0.0
            while got < n and not self._stop.is_set():
                b = self.tcp.read(n - got, timeout_ms=500)
                if len(b):
                    chunks.append(b)
                    got += len(b)
                    idle = 0.0
                else:
                    idle += 0.5
                    if idle >= self.live_idle_s:
                        break              # sender idle/gone: partial window
            return (np.concatenate(chunks) if chunks
                    else np.zeros(0, np.complex64))
        off = w * n
        if native.available():
            # native reader returns (n, 2) float32 IQ pairs
            return iqio.from_iq_f32(
                native.read_iq_native(self.path, self.fmt, count=n,
                                      offset_samples=off))
        return iqio.read_iq(self.path, self.fmt, count=n, offset_samples=off)

    def run(self, max_windows: int | None = None) -> dict[int, dict]:
        w = 0
        while not self._stop.is_set():
            if max_windows is not None and w >= max_windows:
                break
            key = f"w{w}"
            if self.ckpt is not None and self.ckpt.done(key):
                self.results[w] = self.ckpt.result(key)
                self.windows_done = w + 1
                w += 1
                continue
            x = self._read_window(w)
            # need headroom past the last frame boundary for MIB/SI decode
            if len(x) < 12 * self.cfg.n_samps_subframe:
                break
            res = scan(x, self.cfg)
            rec = json.loads(res.to_json())
            rec["window"] = w
            self.results[w] = rec
            METRICS.inc("stream_scan.windows")
            METRICS.inc("stream_scan.samples", len(x))
            if rec.get("n_cell_id", -1) >= 0:
                METRICS.inc("stream_scan.cells_found")
                EVENTS.emit("scan.cell", window=w,
                            n_cell_id=rec.get("n_cell_id"),
                            sfn=(rec.get("mib") or {}).get("sfn"))
            else:
                EVENTS.emit("scan.window_empty", level="debug", window=w)
            if self.ckpt is not None:
                self.ckpt.record(key, rec)
            self.windows_done = w + 1
            w += 1
        return self.results

    def stop(self):
        self._stop.set()
        self.ctrl.stop()


def main(argv=None):
    ap = argparse.ArgumentParser(description="streaming LTE capture scanner")
    ap.add_argument("path", nargs="?", default=None)
    ap.add_argument("--tcp-port", type=int, default=None,
                    help="listen for live IQ on this TCP port instead of "
                         "reading a file (0 = ephemeral; rtl_tcp-style)")
    ap.add_argument("--fmt", default="fc32", choices=("fc32", "sc8", "sc16"))
    ap.add_argument("--eventlog", default=None,
                    help="JSON-lines event log path ('-' = stdout)")
    ap.add_argument("--n-rb", type=int, default=6)
    ap.add_argument("--window-sf", type=int, default=60)
    ap.add_argument("--max-windows", type=int, default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args(argv)
    if args.eventlog:
        EVENTS.open(args.eventlog)

    src = None
    if args.tcp_port is not None:
        src = native.IqTcpSource(port=args.tcp_port, fmt=args.fmt)
        print(f"iq port {src.port}", flush=True)
    elif args.path is None:
        ap.error("either a capture path or --tcp-port is required")
    svc = StreamScanService(args.path, PhyConfig(n_rb_dl=args.n_rb),
                            fmt=args.fmt, window_sf=args.window_sf,
                            ckpt_path=args.checkpoint, port=args.port,
                            tcp_source=src)
    print(f"ctrl port {svc.ctrl.port}", flush=True)
    try:
        results = svc.run(max_windows=args.max_windows)
    finally:
        svc.stop()
        if src is not None:
            src.close()
    for w in sorted(results):
        print(json.dumps(results[w]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
