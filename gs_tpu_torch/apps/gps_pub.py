"""RTK-GPS publisher CLI — port of ``gs_tpu/apps/gps_pub.py``, the
reference's ``gps_pub.py`` (ref: submodules/ros_workspace/src/gs_slam_msgs/
scripts/gps_pub.py:11-56).

Reads Swift SBP ``MsgBaselineNED`` from a serial device (or a recorded
capture file — same bytes), logs ``baseline_ned.csv``, prints each fix in
the reference's log format, and optionally publishes length-prefixed msgpack
points over TCP (the framework's ``/rtk_gps_pos`` channel, consumed by the
fusion pairing in ``io_live/fusion.py``). The points are packed by the
port's standard-library codec, byte for byte what the JAX CLI sends.

    python -m gs_tpu_torch.apps.gps_pub -p /dev/ttyUSB0              # hardware
    python -m gs_tpu_torch.apps.gps_pub -p capture.sbp --publish host:6012
"""
from __future__ import annotations

import argparse
import socket
import struct

from ..io_live.gps import open_source, publish_stream
from ..utils.msgpack_codec import packb


def main(argv=None):
    ap = argparse.ArgumentParser(description="Swift Navigation SBP NED.")
    ap.add_argument("-p", "--port", default="/dev/ttyUSB0",
                    help="serial device or SBP capture file to read")
    ap.add_argument("--baud", type=int, default=115200)
    ap.add_argument("--csv", default="baseline_ned.csv",
                    help="CSV log path ('' disables)")
    ap.add_argument("--publish", default="",
                    help="host:port to publish msgpack points to; empty = "
                         "log only")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    sink = None
    if args.publish:
        host, port = args.publish.rsplit(":", 1)
        sink = socket.create_connection((host, int(port)))

    seq = [-1]

    def on_point(stamp, x, y, z):
        seq[0] += 1
        if not args.quiet:
            # ref: gps_pub.py:46 log line, byte-for-byte format
            print(f"position X: {x}, Y: {y}, Z:{z}", flush=True)
        if sink is not None:
            blob = packb({"topic": "/rtk_gps_pos", "seq": seq[0],
                          "stamp": stamp, "frame_id": "gps_antenna",
                          "x": x, "y": y, "z": z})
            sink.sendall(struct.pack("<I", len(blob)) + blob)

    src = open_source(args.port, baud=args.baud)
    try:
        n = publish_stream(src, on_point, csv_path=args.csv or None)
    finally:
        src.close()
        if sink is not None:
            sink.close()
    if not args.quiet:
        print(f"published {n} fixes")
    return n


if __name__ == "__main__":
    main()
