"""Link compression codecs (int8, top-k with error feedback) and the
executor's link hooks that apply them."""

from .codecs import (ErrorFeedback, compressed_bytes, int8_dequantize,
                     int8_quantize, make_link_hooks, topk_densify,
                     topk_sparsify)

__all__ = ["ErrorFeedback", "compressed_bytes", "int8_dequantize",
           "int8_quantize", "make_link_hooks", "topk_densify",
           "topk_sparsify"]
