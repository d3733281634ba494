__all__ = ["bubble"]
