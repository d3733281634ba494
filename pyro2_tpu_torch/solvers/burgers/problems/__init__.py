__all__ = ["test", "tophat", "converge"]
