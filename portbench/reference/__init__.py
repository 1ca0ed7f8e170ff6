"""The benchmark's plain reference: the networks, losses, metrics and the
test and training steps of the reference repository, in float32 PyTorch.
Nothing here imports the measured program."""
