"""Command-line entry points of the port: `serve` (batched LM serving)."""
