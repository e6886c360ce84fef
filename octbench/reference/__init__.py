"""The benchmark's plain reference: float32 PyTorch U-Net and ReLayNet,
their int8 graphs worked out again from the same weights and calibration
batch (BN fold, calibration, quantisation), and the training step with
Adam. Plain ``torch`` operations only; nothing here imports the program.
"""
