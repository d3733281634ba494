__all__ = ["cavity", "converge", "shear"]
