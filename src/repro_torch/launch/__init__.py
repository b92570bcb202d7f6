"""Step builders and the serving CLI."""
