"""RGB-D ROS node (Examples/ROS/ORB_SLAM2/src/ros_rgbd.cc).

    python -m orb_slam2_comment_tpu_torch.examples.ros.ros_rgbd vocabulary settings \\
        [--device cpu]

Approximate-time-synchronizes /camera/rgb/image_raw with
/camera/depth_registered/image_raw (ros_rgbd.cc:63-70).
"""

import sys

from orb_slam2_comment_tpu_torch.examples.ros.ros_common import (
    build_system, node_args, require_ros, to_gray)


def main(argv=None):
    parsed = node_args(("vocabulary", "settings"), argv)
    if parsed is None:
        return 1
    (voc, settings), device = parsed
    rospy, bridge = require_ros()
    system, _ = build_system(voc, settings, "rgbd", device)

    import message_filters
    from sensor_msgs.msg import Image

    def grab(msg_rgb, msg_d):
        img = to_gray(bridge.imgmsg_to_cv2(msg_rgb, desired_encoding="passthrough"))
        depth = bridge.imgmsg_to_cv2(msg_d, desired_encoding="passthrough")
        system.track_rgbd(img, depth, msg_rgb.header.stamp.to_sec())

    rospy.init_node("RGBD")
    sub_rgb = message_filters.Subscriber("/camera/rgb/image_raw", Image)
    sub_d = message_filters.Subscriber("/camera/depth_registered/image_raw", Image)
    sync = message_filters.ApproximateTimeSynchronizer([sub_rgb, sub_d], 10, 0.5)
    sync.registerCallback(grab)
    rospy.spin()
    system.shutdown()
    system.save_keyframe_trajectory_tum("KeyFrameTrajectory.txt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
