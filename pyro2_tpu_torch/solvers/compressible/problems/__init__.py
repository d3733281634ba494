__all__ = ["advect", "kh", "quad", "rt", "sod"]
