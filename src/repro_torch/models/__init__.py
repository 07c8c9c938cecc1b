"""Models of the port: VGG-16 (the paper's workload) and the shared cross
entropy.  The language-model families are not ported yet."""
