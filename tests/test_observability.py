"""Observability layer: EventLog masks, debug-stream server fan-out,
ctrl-socket debug verbs, scanner event wiring (SURVEY.md §5 — reference
``send_debug_msg`` type/level masks + debug TCP port parity)."""

import json
import socket
import time

import numpy as np

from lteax.apps.ctrl import CtrlServer, DebugStreamServer
from lteax.utils.metrics import EventLog, Metrics, ctrl_debug_verbs


def _cmd(port, line):
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.sendall(line.encode() + b"\n")
        return s.makefile().readline().strip()


def test_eventlog_file_sink_and_masks(tmp_path):
    p = tmp_path / "ev.jsonl"
    ev = EventLog(str(p), level="info")
    ev.emit("scan.cell", n_cell_id=7)
    ev.emit("scan.noise", level="debug", x=1)       # masked (debug > info)
    ev.set_level("debug")
    ev.emit("scan.noise", level="debug", x=2)
    ev.set_types({"enb"})
    ev.emit("scan.cell", n_cell_id=8)               # masked by type
    ev.emit("enb.start", n_rb=6)
    ev.close()
    recs = [json.loads(l) for l in p.read_text().splitlines()]
    assert [r["event"] for r in recs] == ["scan.cell", "scan.noise",
                                          "enb.start"]
    assert recs[0]["n_cell_id"] == 7 and recs[1]["x"] == 2


def test_eventlog_noop_without_sink():
    ev = EventLog()                                 # no sink, no subscribers
    ev.emit("anything", n=1)                        # must not raise


def test_metrics_counters():
    m = Metrics()
    m.inc("a")
    m.inc("a", 2)
    m.gauge("g", 7.5)
    snap = m.snapshot()
    assert snap["counters"]["a"] == 3 and snap["gauges"]["g"] == 7.5
    assert m.rate("a") > 0


def test_ctrl_debug_verbs_toggle_masks():
    ev = EventLog(level="info")
    srv = CtrlServer({}, ctrl_debug_verbs(ev), port=0)
    try:
        assert _cmd(srv.port, "debug_level") == "ok debug_level = info"
        assert _cmd(srv.port, "debug_level debug").endswith("= debug")
        assert ev.level == "debug"
        assert _cmd(srv.port, "debug_level bogus").startswith("error")
        assert _cmd(srv.port, "debug_types scan,enb").endswith("= enb,scan")
        assert ev.types == {"scan", "enb"}
        assert _cmd(srv.port, "debug_types all").endswith("= all")
        assert ev.types is None
    finally:
        srv.stop()


def test_debug_stream_server_pushes_events():
    ev = EventLog(level="debug")
    dbg = DebugStreamServer(events=ev, port=0)
    try:
        with socket.create_connection(("127.0.0.1", dbg.port),
                                      timeout=5) as c:
            time.sleep(0.3)                     # accept loop registration
            ev.emit("scan.cell", n_cell_id=321)
            line = c.makefile().readline()
            rec = json.loads(line)
            assert rec["event"] == "scan.cell" and rec["n_cell_id"] == 321
    finally:
        dbg.stop()


def test_scanner_emits_cell_events(tmp_path):
    """A scanner run produces a JSON-lines event log with the decoded
    cell."""
    from lteax.apps.file_gen import GenConfig, generate
    from lteax.apps.scanner import main as scanner_main
    from lteax.utils.metrics import EVENTS, METRICS

    x = generate(GenConfig(n_rb_dl=6, n_cell_id=77, n_frames=8))
    cap = tmp_path / "cap.bin"
    out = np.empty(2 * x.size, np.float32)
    out[0::2], out[1::2] = x.real, x.imag
    out.tofile(cap)
    ev_path = tmp_path / "events.jsonl"
    scanner_main(["ch77=" + str(cap), "--eventlog", str(ev_path),
                  "--debug-level", "debug"])
    EVENTS.close()
    recs = [json.loads(l) for l in ev_path.read_text().splitlines()]
    cells = [r for r in recs if r["event"] == "scan.cell"]
    assert len(cells) == 1 and cells[0]["n_cell_id"] == 77
    assert any(r["event"] == "scan.start" for r in recs)
    assert METRICS.snapshot()["counters"]["scanner.cells_found"] >= 1
