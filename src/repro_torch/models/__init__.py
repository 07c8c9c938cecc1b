"""Models of the port: VGG-16 (the paper's workload), RWKV6 (the ``ssm``
family), the transformer (dense: ``qwen3-0.6b``, ``llama3-8b``,
``qwen1.5-4b``, ``command-r-35b``; with the mixture of experts of
``moe.py``: ``granite-moe-3b-a800m``, ``qwen3-moe-235b-a22b``; after patch
embeddings, ``vlm.py``: ``internvl2-1b``), the hybrid ``jamba.py`` (with the
Mamba block of ``mamba.py``: ``jamba-1.5-large-398b``) and the audio
encoder-decoder ``whisper.py`` (``whisper-small``), all served by
``launch/serve.py`` and trained by ``launch/train.py``, the shared pieces
and the model registry."""
