"""Kernels and their plain-torch versions, and the torch ops around them."""
