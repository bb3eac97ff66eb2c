"""RTK-GPS reading — the port's copy of ``gs_tpu/io_live/gps.py``, the
framework's equivalent of the reference's ``gps_pub.py`` (ref:
submodules/ros_workspace/src/gs_slam_msgs/scripts/gps_pub.py:1-56): read
Swift Piksi SBP ``MsgBaselineNED`` frames, convert NED millimeters to the ENU
meters point the fusion node consumes (x = e*1e-3, y = n*1e-3, z = -d*1e-3),
publish stamped points on the ``/rtk_gps_pos``-equivalent channel, and log
``baseline_ned.csv``.

The Swift Binary Protocol layer (preamble 0x55, LE type/sender/length,
CRC16-CCITT over everything after the preamble) is implemented directly and
reads from ANY binary stream — a serial device node (baud configured with
stdlib ``termios``, imported only for a tty), a recorded capture file, or a
socket. Only the RTK receiver hardware itself is out of scope.
"""
from __future__ import annotations

import csv
import os
import struct
import time
from typing import Callable, Iterator, NamedTuple, Optional

SBP_PREAMBLE = 0x55
SBP_MSG_BASELINE_NED = 0x020C
SBP_MSG_VEL_NED = 0x020E


def crc16_ccitt(data: bytes, crc: int = 0) -> int:
    """CRC-16/XMODEM (poly 0x1021, init 0) — the SBP frame checksum."""
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) if crc & 0x8000 else (crc << 1)
        crc &= 0xFFFF
    return crc


class BaselineNED(NamedTuple):
    """SBP MsgBaselineNED payload (all integers; n/e/d in millimeters)."""
    tow: int
    n: int
    e: int
    d: int
    h_accuracy: int
    v_accuracy: int
    n_sats: int
    flags: int

    def enu_meters(self) -> tuple:
        """The reference's published point (gps_pub.py:41-44):
        x = east, y = north, z = up, meters."""
        return (self.e * 1e-3, self.n * 1e-3, -self.d * 1e-3)


def parse_baseline_ned(payload: bytes) -> BaselineNED:
    return BaselineNED(*struct.unpack("<IiiiHHBB", payload[:22]))


def encode_sbp(msg_type: int, payload: bytes, sender: int = 0x42) -> bytes:
    """Build one SBP frame (used by tests and capture replay tooling)."""
    head = struct.pack("<BHHB", SBP_PREAMBLE, msg_type, sender, len(payload))
    crc = crc16_ccitt(head[1:] + payload)
    return head + payload + struct.pack("<H", crc)


def encode_baseline_ned(tow: int, n_mm: int, e_mm: int, d_mm: int,
                        n_sats: int = 10, flags: int = 1) -> bytes:
    payload = struct.pack("<IiiiHHBB", tow, n_mm, e_mm, d_mm, 0, 0,
                          n_sats, flags)
    return encode_sbp(SBP_MSG_BASELINE_NED, payload)


def iter_sbp(stream) -> Iterator[tuple]:
    """Yield ``(msg_type, sender, payload)`` from a binary stream.

    Buffered framer: a stray 0x55 inside garbage (or a corrupted frame) must
    not let a bogus length byte swallow the real frames behind it, so frames
    are parsed out of a rolling buffer and a CRC failure resynchronizes ONE
    byte past the failed preamble (serial links corrupt bytes; the sbp
    library's Framer behaves the same). Stops at EOF (read() returning b'').
    """
    buf = bytearray()
    eof = False
    while True:
        i = buf.find(SBP_PREAMBLE)
        if i < 0:
            del buf[:]
            if eof:
                return
        elif i:
            del buf[:i]
        # frame = preamble(1) + head(5, incl. length byte at [5]) + payload
        # + crc(2); refill until the whole candidate frame is buffered
        while not eof and (len(buf) < 6 or len(buf) < 8 + buf[5]):
            chunk = stream.read(4096)
            if not chunk:
                eof = True
            buf += chunk
        if len(buf) < 6 or len(buf) < 8 + buf[5]:
            # EOF: this candidate can never complete — a garbage length byte
            # behind a stray preamble must not hide real frames before EOF
            if not buf:
                return
            del buf[:1]
            continue
        length = buf[5]
        head, payload = bytes(buf[1:6]), bytes(buf[6:6 + length])
        crc = struct.unpack("<H", buf[6 + length:8 + length])[0]
        if crc16_ccitt(head + payload) != crc:
            del buf[:1]   # resync: scan for the next preamble
            continue
        del buf[:8 + length]
        msg_type, sender = struct.unpack("<HH", head[:4])
        yield msg_type, sender, payload


def open_source(path: str, baud: int = 115200):
    """Open a capture file or a serial device node for reading.

    For a tty the baud rate is configured with stdlib termios in raw mode —
    the whole role pyserial plays for a read-only SBP stream."""
    f = open(path, "rb", buffering=0)
    if os.isatty(f.fileno()):
        import termios
        import tty
        tty.setraw(f.fileno())
        attrs = termios.tcgetattr(f.fileno())
        speed = getattr(termios, f"B{baud}")
        attrs[4] = attrs[5] = speed   # ispeed, ospeed
        termios.tcsetattr(f.fileno(), termios.TCSANOW, attrs)
    return f


def publish_stream(stream, on_point: Callable,
                   csv_path: Optional[str] = "baseline_ned.csv",
                   clock: Callable = time.time) -> int:
    """Drain ``stream``; for every valid MsgBaselineNED call
    ``on_point(stamp, x, y, z)`` and append a CSV row (TS,X,Y,Z — the
    reference's log schema, gps_pub.py:29). Returns the point count."""
    count = 0
    writer = ctx = None
    if csv_path:
        ctx = open(csv_path, "w", newline="")
        writer = csv.writer(ctx)
        writer.writerow(["TS", "X", "Y", "Z"])
    try:
        for msg_type, _sender, payload in iter_sbp(stream):
            if msg_type != SBP_MSG_BASELINE_NED:
                continue
            msg = parse_baseline_ned(payload)
            x, y, z = msg.enu_meters()
            stamp = clock()
            on_point(stamp, x, y, z)
            if writer is not None:
                writer.writerow([int(stamp * 1e9), x, y, z])
            count += 1
    finally:
        if ctx is not None:
            ctx.close()
    return count
