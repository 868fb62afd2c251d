"""CLI entry points: the offline evaluation apps."""
