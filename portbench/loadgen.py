"""The load generator: Envoy's side of ext_proc, in a process of its own.

Run by ``portbench/run.py`` as ``python3 -m portbench.loadgen`` with one JSON
job on standard input. It opens ``connections`` HTTP/2 connections to the
sidecar's ext_proc listener and carries many concurrent streams on each, as
Envoy does: one stream per proxied request, the request headers as one
message, the buffered body as a second one after the headers' answer.

- closed loop: each connection keeps ``streams`` requests in flight and
  opens the next stream when a verdict arrives;
- open loop: request ``i`` is due at the ``i``-th arrival of a Poisson
  stream at ``rate``; it is sent when due and timed from its due time.

Once ``warm`` verdicts have come it prints ``warm <t>`` and waits for
``go`` on standard input, measures for ``seconds``, prints ``end``,
lets every request of the window finish (up to ``drain_s``), and prints one
JSON line: per request ``[index, due, sent, done, status, action, rule id]``
(times on this process's monotonic clock; ``done`` null when no verdict
came) and how late the open loop ran.

It imports nothing of the program, and nothing of torch.
"""

from __future__ import annotations

import json
import selectors
import socket
import sys
import time

from . import wire
from .generator import Mix, arrivals

_WAIT_HEADERS, _WAIT_VERDICT = 1, 2


class Conn:
    def __init__(self, host: str, port: int):
        self.sock = socket.create_connection((host, port), timeout=30)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock.setblocking(False)
        self.out = bytearray(wire.connection_preface())
        self.inbuf = bytearray()
        self.next_sid = 1
        self.streams: dict[int, list] = {}  # sid -> [index, state, grpc buffer, body]
        self.inflight = 0
        self.closed = False
        self.events = selectors.EVENT_READ
        self.headers_block = wire.stream_headers(b"localhost")


class Driver:
    def __init__(self, job: dict):
        self.job = job
        self.mix = Mix(job["mix"], job["seed"])
        self.loop = job["load"]
        self.conns = [Conn("127.0.0.1", job["port"]) for _ in range(self.loop["connections"])]
        self.sel = selectors.DefaultSelector()
        for c in self.conns:
            self.sel.register(c.sock, selectors.EVENT_READ, c)
        self.records: dict[int, list] = {}  # index -> [due, sent, done, status, action, rule]
        self.next_index = 0
        self.done_count = 0

    # -- sending

    def send(self, conn: Conn, index: int, due: float) -> None:
        if conn.closed:  # the request is due but has no connection: no verdict
            self.records[index] = [due, time.monotonic(), None, None, None, None]
            return
        req = self.mix.request(index)
        sid = conn.next_sid
        conn.next_sid += 2
        host = req.headers[0][1] if req.headers and req.headers[0][0] == "host" else ""
        headers = [(":method", req.method), (":scheme", "http"), (":authority", host),
                   (":path", req.uri)] + [h for h in req.headers if h[0] != "host"]
        conn.out += wire.frame(wire.F_HEADERS, wire.FLAG_END_HEADERS, sid, conn.headers_block)
        conn.out += wire.data_frames(sid, wire.encode_request_headers(headers, not req.body), False)
        conn.streams[sid] = [index, _WAIT_HEADERS if req.body else _WAIT_VERDICT, bytearray(), req.body]
        conn.inflight += 1
        self.records[index] = [due, time.monotonic(), None, None, None, None]

    # -- receiving

    def on_frames(self, conn: Conn) -> None:
        buf = conn.inbuf
        while len(buf) >= 9:
            n = int.from_bytes(buf[0:3], "big")
            if len(buf) < 9 + n:
                break
            ftype, flags = buf[3], buf[4]
            sid = int.from_bytes(buf[5:9], "big") & 0x7FFFFFFF
            payload = bytes(buf[9:9 + n])
            del buf[:9 + n]
            if ftype == wire.F_SETTINGS and not flags & wire.FLAG_ACK:
                conn.out += wire.frame(wire.F_SETTINGS, wire.FLAG_ACK, 0)
            elif ftype == wire.F_PING and not flags & wire.FLAG_ACK:
                conn.out += wire.frame(wire.F_PING, wire.FLAG_ACK, 0, payload)
            elif ftype == wire.F_DATA:
                self.on_data(conn, sid, flags, payload)
            elif ftype == wire.F_HEADERS and flags & wire.FLAG_END_STREAM:
                self.finish(conn, sid)  # trailers: the stream is over
            elif ftype == wire.F_RST_STREAM:
                self.finish(conn, sid)
            elif ftype == wire.F_GOAWAY:
                raise ConnectionError("the sidecar sent GOAWAY")

    def on_data(self, conn: Conn, sid: int, flags: int, payload: bytes) -> None:
        st = conn.streams.get(sid)
        if st is None:
            return
        if flags & wire.FLAG_PADDED:
            payload = payload[1:len(payload) - payload[0]]
        st[2] += payload
        while len(st[2]) >= 5:
            mlen = int.from_bytes(st[2][1:5], "big")
            if len(st[2]) < 5 + mlen:
                break
            msg = bytes(st[2][5:5 + mlen])
            del st[2][:5 + mlen]
            resp = wire.decode_response(msg)
            if resp["kind"] == "continue" and resp["phase"] == "request_headers" and st[1] == _WAIT_HEADERS:
                st[1] = _WAIT_VERDICT
                conn.out += wire.data_frames(sid, wire.encode_request_body(st[3]), True)
            elif resp["kind"] in ("continue", "immediate") and st[1] == _WAIT_VERDICT:
                status = resp["status"] if resp["kind"] == "immediate" else 200
                self.verdict(conn, st, status, resp["headers"])

    def verdict(self, conn: Conn, st: list, status: int, headers: dict) -> None:
        rec = self.records[st[0]]
        if rec[2] is None:
            rec[2] = time.monotonic()
            rec[3], rec[4], rec[5] = status, headers.get("x-waf-action"), headers.get("x-waf-rule-id")
            self.done_count += 1
            conn.inflight -= 1
        st[1] = 0

    def finish(self, conn: Conn, sid: int) -> None:
        st = conn.streams.pop(sid, None)
        if st is not None and st[1] != 0:
            conn.inflight -= 1  # ended without a verdict: counted as failed

    # -- the loop

    def pump(self, timeout: float) -> None:
        for c in self.conns:
            self.flush(c)
        for key, mask in self.sel.select(timeout):
            conn = key.data
            if mask & selectors.EVENT_READ:
                try:
                    data = conn.sock.recv(1 << 20)
                except BlockingIOError:
                    data = None
                if data == b"":
                    self.lost(conn)
                    continue
                if data:
                    conn.inbuf += data
                    self.on_frames(conn)
            if mask & selectors.EVENT_WRITE:
                self.flush(conn)

    def lost(self, conn: Conn) -> None:
        """The sidecar closed ``conn``: its streams without a verdict keep
        none (they count as failed), and it carries no more requests."""
        self.sel.unregister(conn.sock)
        conn.closed, conn.inflight, conn.out = True, 0, bytearray()
        conn.streams.clear()
        sys.stderr.write(f"loadgen: the sidecar closed a connection at {time.monotonic()}\n")

    def flush(self, conn: Conn) -> None:
        if conn.closed:
            return
        if conn.out:
            try:
                del conn.out[:conn.sock.send(conn.out)]
            except BlockingIOError:
                pass
        want = selectors.EVENT_READ | (selectors.EVENT_WRITE if conn.out else 0)
        if want != conn.events:
            self.sel.modify(conn.sock, want, conn)
            conn.events = want

    def run(self, warm: int, seconds: float, drain_s: float, wait_go) -> dict:
        closed = self.loop["loop"] == "closed"
        t_start = time.monotonic()
        due_offsets: list = []
        if not closed:
            rate = float(self.loop["rate"])
            due_offsets = arrivals(rate, self.job["seed"], 0, int(rate * (seconds + 60.0)) + warm)
        phase, t_window, t_end, t_drain_end = "warm", None, None, None
        while True:
            now = time.monotonic()
            if phase == "warm" and self.done_count >= warm:
                sys.stdout.write(f"warm {now}\n")
                sys.stdout.flush()
                wait_go()
                t_window = time.monotonic()
                t_end = t_window + seconds
                phase = "window"
            elif phase == "window" and now >= t_end:
                sys.stdout.write(f"end {now}\n")
                sys.stdout.flush()
                phase = "drain"
                t_drain_end = now + drain_s
            elif phase == "drain":
                behind = not closed and t_start + due_offsets[self.next_index] <= t_end
                if now >= t_drain_end or (not behind and all(c.inflight == 0 for c in self.conns)):
                    break
            if closed:
                if phase != "drain":
                    for c in self.conns:
                        while not c.closed and c.inflight < self.loop["streams"]:
                            self.send(c, self.next_index, time.monotonic())
                            self.next_index += 1
            else:
                cap = t_end if phase == "drain" else now
                while self.next_index < len(due_offsets):
                    due = t_start + due_offsets[self.next_index]
                    if due > cap or due > now:
                        break
                    c = self.conns[self.next_index % len(self.conns)]
                    self.send(c, self.next_index, due)
                    self.next_index += 1
            self.pump(0.0005 if not closed else 0.005)
        late = sorted(r[1] - r[0] for r in self.records.values()
                      if t_window is not None and t_window <= r[0] < t_end)
        return {
            "window": [t_window, t_end],
            "records": [[i, *r] for i, r in self.records.items()],
            "late_p50_ms": late[len(late) // 2] * 1e3 if late else 0.0,
            "late_max_ms": late[-1] * 1e3 if late else 0.0,
        }


def main() -> int:
    job = json.loads(sys.stdin.readline())
    driver = Driver(job)

    def wait_go():
        line = sys.stdin.readline()
        if line.strip() != "go":
            raise SystemExit(f"loadgen: expected go, read {line!r}")

    out = driver.run(job["warm"], job["seconds"], job["drain_s"], wait_go)
    for c in driver.conns:
        c.sock.close()
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
