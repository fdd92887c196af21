"""Harnesses of the PyTorch port that time its kernels on the card."""
