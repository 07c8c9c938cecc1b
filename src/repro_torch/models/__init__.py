"""Models of the port: VGG-16 (the paper's workload), RWKV6 (the ``ssm``
family), the transformer (dense: ``qwen3-0.6b``, ``llama3-8b``,
``qwen1.5-4b``, ``command-r-35b``; with the mixture of experts of
``moe.py``: ``granite-moe-3b-a800m``, ``qwen3-moe-235b-a22b``; after patch
embeddings, ``vlm.py``: ``internvl2-1b``), all served by
``launch/serve.py`` and trained by ``launch/train.py``, the shared pieces
and the model registry.  The hybrid and audio families are not ported yet
(ROADMAP Queue 1 item 10)."""
