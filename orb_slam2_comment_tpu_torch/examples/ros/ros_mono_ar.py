"""Monocular AR ROS node (Examples/ROS/ORB_SLAM2/src/AR/ros_mono_ar.cc):
tracks /camera/image_raw, fits a plane to the tracked map points and
republishes frames with a virtual cube on /orb_slam2/ar_image (the
reference renders the cube in a Pangolin window instead).

    python -m orb_slam2_comment_tpu_torch.examples.ros.ros_mono_ar vocabulary settings \\
        [--device cpu]
"""

import sys

import numpy as np

from orb_slam2_comment_tpu_torch.examples.ros.ros_common import (
    build_system, node_args, require_ros, to_gray)


def main(argv=None):
    parsed = node_args(("vocabulary", "settings"), argv)
    if parsed is None:
        return 1
    (voc, settings), device = parsed
    rospy, bridge = require_ros()
    system, cfg = build_system(voc, settings, "monocular", device)

    from sensor_msgs.msg import Image

    from orb_slam2_comment_tpu_torch.utils import ar

    pub = rospy.Publisher("/orb_slam2/ar_image", Image, queue_size=1)
    state = {"plane": None}
    K = (cfg.fx, cfg.fy, cfg.cx, cfg.cy)

    def grab(msg):
        img = to_gray(bridge.imgmsg_to_cv2(msg, desired_encoding="passthrough"))
        out = system.track_monocular(img, msg.header.stamp.to_sec())
        if out.state != 1 or out.Tcw is None:
            return
        assoc = system.get_tracked_map_points()
        if state["plane"] is None and len(assoc) >= 50:
            pts = system.tracker.map.pt_pos.cpu().numpy()[assoc]
            state["plane"] = ar.detect_plane(pts, np.asarray(out.Tcw))
        if state["plane"] is not None:
            nrm, org = state["plane"]
            rendered = ar.render_cube(img, np.asarray(out.Tcw), K, nrm, org, size=0.3)
            pub.publish(bridge.cv2_to_imgmsg(rendered, encoding="rgb8"))

    rospy.init_node("MonoAR")
    rospy.Subscriber("/camera/image_raw", Image, grab, queue_size=1)
    rospy.spin()
    system.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
