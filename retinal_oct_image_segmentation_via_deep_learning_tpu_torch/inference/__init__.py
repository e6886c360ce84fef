"""Int8 serving path: BN fold, calibration, quantization, the served graph."""
