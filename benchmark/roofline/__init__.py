"""Frozen work counts: the card's peaks, and one file a kernel function."""
