"""Multi-device layouts of the port (``ircolor_tpu/parallel/``): so far the
1-D H-axis spatial mesh of test mode (``parallel.spatial``)."""
