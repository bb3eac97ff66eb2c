"""ROS -> gs_tpu_torch live bridge: forward ``/Visual_Merged`` to the
trainer — port of ``gs_tpu/apps/ros_bridge.py``.

Runs INSIDE a ROS environment (it is the only module here that imports
rospy) and republishes each ``visual_merged_msg`` as the framework's
msgpack frame stream, so ``python -m gs_tpu_torch.apps.train_live``
consumes the reference's live topic unchanged (ref: train_sdu6.py:56-67
waits on /Visual_Merged; MIGRATION.md "live SLAM training" row).

Usage (on the ROS machine):
    python -m gs_tpu_torch.apps.ros_bridge --host <trainer-host> --port 6011
"""
from __future__ import annotations

import argparse

import numpy as np


def msg_to_frame(msg):
    """visual_merged_msg -> io_live.stream.Frame (same field mapping as the
    offline path, io_live/rosbag.py frames_from_visual_merged)."""
    from ..io_live.rosbag import _cloud_to_xyz, _image_to_array
    from ..io_live.stream import Frame
    tr = msg.CameraPose.transform
    return Frame(
        stamp=msg.Image.header.stamp.to_sec(),
        image=_image_to_array(msg.Image),
        K=np.asarray(msg.CameraInfo.K, np.float64).reshape(3, 3),
        qvec=np.array([tr.rotation.w, tr.rotation.x, tr.rotation.y,
                       tr.rotation.z]),
        tvec=np.array([tr.translation.x, tr.translation.y,
                       tr.translation.z]),
        pose_convention="c2w",
        points=_cloud_to_xyz(msg.Local_Map))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6011)
    parser.add_argument("--topic", default="/Visual_Merged")
    parser.add_argument("--encoding", default="jpeg",
                        choices=["jpeg", "png", "rgb8"])
    parser.add_argument("--points_every", type=int, default=30,
                        help="attach the local map every Nth frame "
                             "(ref: convert_visual_merged_msg.py:477)")
    args = parser.parse_args(argv)

    try:
        import rospy
        from gs_slam_msgs.msg import visual_merged_msg
    except ImportError as e:  # pragma: no cover - needs a ROS install
        raise SystemExit(
            f"ros_bridge needs a ROS environment ({e}); for offline bags "
            "use python -m gs_tpu_torch.apps.convert_stream --input "
            "capture.bag instead")

    from ..io_live.stream import FrameStreamClient
    client = FrameStreamClient(args.host, args.port)
    count = [0]

    def cb(msg):
        frame = msg_to_frame(msg)
        if count[0] % args.points_every != 0:
            frame = frame._replace(points=None)
        count[0] += 1
        client.send(frame, encoding=args.encoding)

    rospy.init_node("gs_tpu_bridge", anonymous=True)
    rospy.Subscriber(args.topic, visual_merged_msg, cb, queue_size=4)
    rospy.loginfo(f"forwarding {args.topic} -> "
                  f"{args.host}:{args.port}")
    rospy.spin()


if __name__ == "__main__":
    main()
