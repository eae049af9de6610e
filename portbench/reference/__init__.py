"""The benchmark's plain reference: the model, the corruption, the
optimizer, the Dice loss and metric and the sliding window of the
reference scripts, in plain PyTorch and float32. It imports nothing of
the measured program and takes none of its outputs except to judge them."""
