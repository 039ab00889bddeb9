"""The plain float32 reference that decides ``correct``: plain PyTorch,
nothing of the program."""
