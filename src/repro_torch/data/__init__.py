from .synthetic import classification_batches

__all__ = ["classification_batches"]
