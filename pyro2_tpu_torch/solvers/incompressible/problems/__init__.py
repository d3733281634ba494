__all__ = ["shear", "converge"]
