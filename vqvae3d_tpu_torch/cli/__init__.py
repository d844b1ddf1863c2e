"""Command-line entry points of the port (stage-1 serving)."""
