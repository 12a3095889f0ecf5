"""eNodeB service: ctrl-socket operator surface around the TTI loop.

(reference capability: ``LTE_fdd_enodeb`` — ``LTE_fdd_enb_main.cc`` starts
``LTE_fdd_enb_interface`` on ctrl port 20000; the operator `write`s cnfg_db
params, `add_user`s HSS entries, then `start`s the stack.  Here the same
command language drives the lteax TTI loop: simulated UEs attach through
the live scheduler via the RRC/NAS engines, and the DL waveform can be
streamed to an IQ file (the no-RF radio mode) that `file_scan` decodes.)

Run:  python -m lteax.apps.enb_service [--port 20000]
Then: echo "help" | nc 127.0.0.1 20000
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np
import jax.numpy as jnp

from lteax.apps.ctrl import CtrlServer, DebugStreamServer
from lteax.apps.enb_sim import EnbSim, UeSim
from lteax.apps.file_gen import GenConfig
from lteax.phy.ofdm import subframe_to_samples
from lteax.stack.cnfg_db import CnfgDb
from lteax.stack.rrc_proc import EnbRrc, UeRrc
from lteax.stack.users import Hss, UserManager
from lteax.utils.metrics import EVENTS, METRICS, ctrl_debug_verbs


class _SimUe:
    def __init__(self, imsi: str, ue: UeSim):
        self.imsi = imsi
        self.ue = ue


class EnbService:
    """Operator-facing eNodeB: cnfg_db params + ctrl verbs + TTI engine."""

    def __init__(self, port: int = 0, cnfg_path: str | None = None,
                 hss_path: str | None = None):
        self.cnfg = (CnfgDb(cnfg_path)
                     .define("bandwidth", 6, choices=(6, 15, 25, 50, 75, 100))
                     .define("n_id_cell", 0, lo=0, hi=503)
                     .define("n_ant", 1, choices=(1, 2, 4))
                     .define("band", 1, lo=1, hi=31)
                     .define("mcc", "001")
                     .define("mnc", "01")
                     .define("tac", 0x1234, lo=0, hi=0xFFFF)
                     .define("cell_id", 0x0050800, lo=0, hi=(1 << 28) - 1)
                     .define("network_name", "lteax")
                     .define("enable_pcap", False)
                     .define("pcap_path", "/tmp/lteax_enb.pcap")
                     .define("iq_out", "")
                     .define("gw_enable", False)
                     .define("gw_ifname", "lteax_gw")
                     .define("gw_ip", "10.0.0.1"))
        self.hss = Hss(hss_path)
        self.enb: EnbSim | None = None
        self.ues: dict[int, _SimUe] = {}
        self._tti = 0
        self._run = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._iq_file = None
        self.gw = None
        self._gw_routed: set = set()
        cmds = {
            "start": self._cmd_start,
            "stop": self._cmd_stop,
            "step": self._cmd_step,
            "add_ue": self._cmd_add_ue,
            "detach_ue": self._cmd_detach_ue,
            "ping": self._cmd_ping,
            "status": self._cmd_status,
            "metrics": lambda a: json.dumps(METRICS.snapshot()),
        }
        cmds.update(self.hss.ctrl_commands())
        cmds.update(ctrl_debug_verbs())
        self.ctrl = CtrlServer(self.cnfg.as_ctrl_params(), cmds, port=port)
        self.port = self.ctrl.port
        # second socket: debug message stream (reference port-20001 parity)
        self.debug_stream = DebugStreamServer(
            port=port + 1 if port else 0)

    # -- construction --------------------------------------------------------
    def _gen_config(self) -> GenConfig:
        mcc = tuple(int(d) for d in self.cnfg.get("mcc"))
        mnc = tuple(int(d) for d in self.cnfg.get("mnc"))
        return GenConfig(n_rb_dl=self.cnfg.get("bandwidth"),
                         n_cell_id=self.cnfg.get("n_id_cell"),
                         n_ant=self.cnfg.get("n_ant"),
                         band=self.cnfg.get("band"),
                         mcc=mcc, mnc=mnc,
                         tac=self.cnfg.get("tac"),
                         cell_identity=self.cnfg.get("cell_id"))

    def _cmd_start(self, args) -> str:
        if self.enb is None:
            gc = self._gen_config()
            rrc = EnbRrc(self.hss, UserManager(), mcc=gc.mcc, mnc=gc.mnc,
                         tac=gc.tac,
                         network_name=self.cnfg.get("network_name"))
            pcap = self.cnfg.get("pcap_path") \
                if self.cnfg.get("enable_pcap") else None
            self.enb = EnbSim(gc, pcap_path=pcap, rrc=rrc)
            iq = self.cnfg.get("iq_out")
            if iq:
                self._iq_file = open(iq, "wb")
            if self.cnfg.get("gw_enable") and self.gw is None:
                # reference LTE_fdd_enb_gw parity: TUN device bridging the
                # kernel IP stack to the UEs' default bearers
                from lteax.stack.gw import GwTun
                try:
                    self.gw = GwTun(ifname=self.cnfg.get("gw_ifname"),
                                    ip=self.cnfg.get("gw_ip"))
                except Exception as e:
                    EVENTS.emit("gw.error", level="error", error=str(e))
                    self.gw = None
        EVENTS.emit("enb.start", n_rb=self.cnfg.get("bandwidth"),
                    n_id_cell=self.cnfg.get("n_id_cell"))
        if args and args[0] == "freerun":
            self._run.set()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
            return "started (freerun)"
        return "started (use 'step <n>' to advance TTIs)"

    def _cmd_stop(self, args) -> str:
        self._run.clear()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        if self._iq_file is not None:
            self._iq_file.close()
            self._iq_file = None
        return "stopped"

    # -- TTI engine ----------------------------------------------------------
    def _one_tti(self) -> None:
        enb = self.enb
        sfn, sf = divmod(self._tti % 10240, 10)
        for rnti, su in list(self.ues.items()):
            g_ul = su.ue.ul_tti_grid(sf)
            if g_ul is not None:
                enb.handle_pusch(rnti, g_ul, sf)
        grid = enb.tti_grid(sfn % 1024, sf)
        if self._iq_file is not None:
            samp = np.asarray(subframe_to_samples(jnp.asarray(grid),
                                                  enb.cfg))
            out = np.empty(2 * samp.size, np.float32)
            out[0::2], out[1::2] = samp.real, samp.imag
            out.tofile(self._iq_file)
        for rnti, su in list(self.ues.items()):
            status = su.ue.handle_grid(grid, sf)
            if status is not None:
                enb.handle_status(rnti, status)
        self._tti += 1
        METRICS.inc("enb.ttis")
        if self.gw is not None:
            self._gw_tti()

    def _gw_tti(self) -> None:
        """Register routes for newly-addressed UEs; flush UE uplink IP
        packets into the kernel."""
        for rnti, su in list(self.ues.items()):
            ip = su.ue.rrc_ue.ip if su.ue.rrc_ue is not None else None
            if ip and rnti not in self._gw_routed:
                self._gw_routed.add(rnti)
                self.gw.add_route(tuple(ip), lambda pkt, r=rnti:
                                  self._gw_dl(r, pkt))
        for rnti, eu in list(self.enb.ues.items()):
            while eu.ul_sdus:
                self.gw.send_ul(eu.ul_sdus.pop(0))

    def _gw_dl(self, rnti: int, pkt: bytes) -> None:
        """TUN read thread -> DL bearer queue (lock: the TTI loop owns
        the scheduler)."""
        with self._lock:
            if self.enb is not None and rnti in self.enb.ues:
                self.enb.send_data(rnti, pkt)

    def _loop(self) -> None:
        while self._run.is_set():
            with self._lock:
                self._one_tti()
            time.sleep(0)         # yield; batch mode, not real-time

    def _cmd_step(self, args) -> str:
        if self.enb is None:
            return "error: not started"
        n = int(args[0]) if args else 1
        with self._lock:
            for _ in range(n):
                self._one_tti()
        return f"tti={self._tti}"

    # -- UE management -------------------------------------------------------
    def _cmd_add_ue(self, args) -> str:
        """add_ue <imsi> — simulated UE using this IMSI's HSS credentials
        performs PRACH + RRC attach through the TTI loop."""
        if self.enb is None:
            return "error: not started"
        imsi = args[0]
        creds = self.hss.get_user(imsi)
        if creds is None:
            return f"error: imsi {imsi} not in HSS (add_user first)"
        k, opc = creds
        gc = self.enb.gc
        with self._lock:
            rnti = self.enb.handle_prach(rapid=len(self.ues) % 64)
            ue = UeSim(gc, rnti,
                       rrc_ue=UeRrc(tuple(int(d) for d in imsi), k, opc,
                                    mcc=gc.mcc, mnc=gc.mnc))
            ue.start_attach()
            self.ues[rnti] = _SimUe(imsi, ue)
        EVENTS.emit("enb.ue_attach", imsi=imsi, rnti=rnti)
        METRICS.inc("enb.attaches")
        return f"ue {imsi} rnti=0x{rnti:04X} attaching"

    def _cmd_detach_ue(self, args) -> str:
        su, rnti = self._find_ue(args[0])
        if su is None:
            return f"error: unknown imsi {args[0]}"
        with self._lock:
            su.ue._rrc_reply(su.ue.rrc_ue.detach())
        EVENTS.emit("enb.ue_detach", imsi=args[0])
        return f"ue {args[0]} detaching"

    def _cmd_ping(self, args) -> str:
        """ping <imsi> — one DL SDU through the ciphered DRB; reports
        delivery count after the next steps."""
        su, rnti = self._find_ue(args[0])
        if su is None:
            return f"error: unknown imsi {args[0]}"
        if not su.ue.sec_on:
            return "error: ue not attached yet"
        with self._lock:
            self.enb.send_data(rnti, b"ping-" + args[0].encode())
        return "queued"

    def _find_ue(self, imsi: str):
        for rnti, su in self.ues.items():
            if su.imsi == imsi:
                return su, rnti
        return None, None

    def _cmd_status(self, args) -> str:
        if self.enb is None:
            return "not started"
        rows = [f"tti={self._tti}"]
        for rnti, su in self.ues.items():
            r = su.ue.rrc_ue
            rows.append(f"0x{rnti:04X} imsi={su.imsi} state={r.state}"
                        + (f" ip={'.'.join(map(str, r.ip))}" if r.ip else "")
                        + f" rx={len(su.ue.data_sdus)}")
        return " | ".join(rows)

    def close(self) -> None:
        self._cmd_stop([])
        if self.gw is not None:
            self.gw.close()
            self.gw = None
        EVENTS.emit("enb.stop", level="debug", tti=self._tti)
        self.debug_stream.stop()
        self.ctrl.stop()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=20000)
    ap.add_argument("--cnfg", default="/tmp/lteax_enb.cnfg")
    ap.add_argument("--hss", default="/tmp/lteax_enb.hss")
    args = ap.parse_args(argv)
    svc = EnbService(port=args.port, cnfg_path=args.cnfg, hss_path=args.hss)
    print(f"eNB service ctrl on 127.0.0.1:{svc.port}; "
          "verbs: start/stop/step/add_ue/detach_ue/ping/status/"
          "add_user/del_user/print_users")
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        svc.close()


if __name__ == "__main__":
    main()
