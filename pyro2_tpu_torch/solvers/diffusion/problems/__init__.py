__all__ = ["gaussian", "test"]
