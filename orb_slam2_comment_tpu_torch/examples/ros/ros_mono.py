"""Monocular ROS node (Examples/ROS/ORB_SLAM2/src/ros_mono.cc).

    python -m orb_slam2_comment_tpu_torch.examples.ros.ros_mono vocabulary settings \\
        [--device cpu]

Subscribes /camera/image_raw; on shutdown saves KeyFrameTrajectory.txt
(ros_mono.cc:55-86).
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
    system, _ = build_system(voc, settings, "monocular", device)

    from sensor_msgs.msg import Image

    def grab(msg):
        img = to_gray(bridge.imgmsg_to_cv2(msg, desired_encoding="passthrough"))
        system.track_monocular(img, msg.header.stamp.to_sec())

    rospy.init_node("Mono")
    rospy.Subscriber("/camera/image_raw", Image, grab, queue_size=1)
    rospy.spin()
    system.shutdown()
    system.save_keyframe_trajectory_tum("KeyFrameTrajectory.txt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
