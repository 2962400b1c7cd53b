"""Command-line drivers of the port, twins of the JAX package's
`examples/`: `python -m orb_slam2_comment_tpu_torch.examples.<name> ...`."""
