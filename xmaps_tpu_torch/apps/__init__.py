"""CLI entry points: the replay app, the engine bench, the offline evaluation apps."""
