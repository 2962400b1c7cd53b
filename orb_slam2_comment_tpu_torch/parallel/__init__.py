"""Distributed bundle adjustment over `torch.distributed` (the port of
`orb_slam2_comment_tpu/parallel/`)."""
