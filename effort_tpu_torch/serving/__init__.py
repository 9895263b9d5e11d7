"""Serving: continuous batching (batcher.py) behind the HTTP server
(server.py)."""
