"""Math leaves and the hand-written kernels."""
