"""Streaming orchestration: frame segmentation, timing, session lifecycle."""
