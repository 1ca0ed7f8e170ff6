"""Plain-torch building blocks on NHWC tensors (the JAX package's layout).

Each function takes and returns NHWC tensors; internally it hands torch's
NCHW operators the ``permute(0, 3, 1, 2)`` view, which is a
``channels_last`` tensor when the NHWC memory is contiguous.
"""
