"""The benchmark of ``ircolor_tpu_torch`` on an NVIDIA H100 (README.md)."""
