"""Weights, storage modes and device selection."""
