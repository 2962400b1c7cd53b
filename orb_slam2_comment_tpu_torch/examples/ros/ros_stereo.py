"""Stereo ROS node (Examples/ROS/ORB_SLAM2/src/ros_stereo.cc).

    python -m orb_slam2_comment_tpu_torch.examples.ros.ros_stereo vocabulary settings \\
        do_rectify [--device cpu]

With do_rectify=true, reads the LEFT./RIGHT. K,D,R,P blocks from the
settings YAML and rectifies online (ros_stereo.cc:71-108), with the same
sampling-grid rectification as stereo_euroc.
"""

import sys

from orb_slam2_comment_tpu_torch.examples.ros.ros_common import (
    build_system, node_args, require_ros, to_gray)


def main(argv=None):
    parsed = node_args(("vocabulary", "settings", "do_rectify"), argv)
    if parsed is None:
        return 1
    (voc, settings, do_rectify), device = parsed
    rospy, bridge = require_ros()
    system, cfg = build_system(voc, settings, "stereo", device)

    rectify = None
    if do_rectify.lower() in ("true", "1", "yes"):
        from orb_slam2_comment_tpu_torch.utils import datasets as ds
        from orb_slam2_comment_tpu_torch.utils.config import load_rectification

        rect = load_rectification(settings)
        if rect is None:
            print("ERROR: Calibration parameters to rectify stereo are missing!")
            return 1
        rect_maps = ds.stereo_rectify_maps(*rect[:8], rect[8])

        def rectify(left, right):
            return ds.remap(left, *rect_maps[0]), ds.remap(right, *rect_maps[1])

    import message_filters
    from sensor_msgs.msg import Image

    def grab(msg_l, msg_r):
        left = to_gray(bridge.imgmsg_to_cv2(msg_l, desired_encoding="passthrough"))
        right = to_gray(bridge.imgmsg_to_cv2(msg_r, desired_encoding="passthrough"))
        if rectify is not None:
            left, right = rectify(left, right)
        system.track_stereo(left, right, msg_l.header.stamp.to_sec())

    rospy.init_node("Stereo")
    sub_l = message_filters.Subscriber("/camera/left/image_raw", Image)
    sub_r = message_filters.Subscriber("/camera/right/image_raw", Image)
    sync = message_filters.ApproximateTimeSynchronizer([sub_l, sub_r], 10, 0.1)
    sync.registerCallback(grab)
    rospy.spin()
    system.shutdown()
    system.save_keyframe_trajectory_tum("KeyFrameTrajectory.txt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
