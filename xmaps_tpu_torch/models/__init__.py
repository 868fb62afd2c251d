"""The end-to-end depth engine."""
