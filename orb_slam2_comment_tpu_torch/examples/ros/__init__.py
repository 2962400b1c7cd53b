"""The ROS nodes of the port, twins of the JAX package's `examples/ros/`
(Examples/ROS/ORB_SLAM2/src/*.cc): `python -m
orb_slam2_comment_tpu_torch.examples.ros.<node> ARGS [--device cpu]` under a
ROS1 install (rospy, cv_bridge, message_filters)."""
