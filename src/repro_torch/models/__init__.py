"""Models of the port: VGG-16 (the paper's workload), RWKV6 (the ``ssm``
family) and the dense transformer (``qwen3-0.6b``, ``llama3-8b``,
``qwen1.5-4b``, ``command-r-35b``), both served by
``launch/serve.py`` and trained by ``launch/train.py``, the shared pieces
and the model registry.  The other language-model families are not ported
yet (ROADMAP Queue 1 item 10)."""
