"""Lexicographic score reductions, XOR fingerprints and the N-Queens scoring kernel (CUDA, with its plain PyTorch version)."""
