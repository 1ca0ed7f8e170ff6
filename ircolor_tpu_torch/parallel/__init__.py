"""Multi-device layouts of the port (``ircolor_tpu/parallel/``): the 1-D
H-axis spatial mesh of test mode (``parallel.spatial``) and data
parallelism over ranks (``parallel.mesh``, ``parallel.launch``)."""
