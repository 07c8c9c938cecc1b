"""Entry points of the port: ``train`` (the language-model trainer),
``steps`` (its step factories) and ``serve`` (continuous-batching server)."""
