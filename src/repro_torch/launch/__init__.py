"""Entry points of the port: ``serve`` (continuous-batching server)."""
