"""Training (``ircolor_tpu/train``): LR schedule, train state, the D-then-G
step, checkpoints and the ``train_kaist`` loop."""
