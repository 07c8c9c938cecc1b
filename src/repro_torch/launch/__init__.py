"""Entry points of the port: ``train`` (the language-model trainer),
``steps`` (its step factories), ``serve`` (continuous-batching server),
``mesh`` (mesh layouts and DeviceMeshes) and ``sharding`` (the partition
rules and their DTensor placements)."""
