"""The benchmark's plain reference: the models, the tilers, the training
step and the comparison, in plain PyTorch.

Nothing here imports the measured package or the JAX package: it is the
yardstick the port is held against, written from the published model
descriptions (BasicSR RRDBNet, HAT) and frozen from the port's plain
model code as it stood when the benchmark was defined.
"""
