"""Allocator accounting and the peak-memory predictor."""
