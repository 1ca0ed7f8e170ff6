"""Card probes of the port, run as scripts from the root of a checkout on
a machine with an NVIDIA GPU (the kernels build there):

* ``kernel_turns.py ROOT``: one turn of a parent/change comparison (P C C
  P: the parent, the change, the change and the parent again on one card)
  of the kernel rows (``chip_smoke.py``'s phases 2, 2b, 2c and 8a, each
  checkout's own); with ``--spatial`` of phase 8b's spatial serving
  instead; with ``--sass OTHER`` the SASS of every ``csrc/conv_fwd.cu``
  kernel against OTHER's.

Nothing here runs on import.
"""
