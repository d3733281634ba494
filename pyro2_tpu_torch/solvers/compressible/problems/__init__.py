__all__ = ["acoustic_pulse", "advect", "kh", "quad", "rt", "sod", "test"]
