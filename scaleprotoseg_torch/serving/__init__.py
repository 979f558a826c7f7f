"""Serving: the inference forward, the streaming engine and the CLI."""
