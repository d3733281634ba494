__all__ = ["smooth", "tophat", "test"]
