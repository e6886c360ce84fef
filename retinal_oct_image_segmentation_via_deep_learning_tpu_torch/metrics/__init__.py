"""Segmentation metrics (only what the trainer's eval step needs so far)."""
