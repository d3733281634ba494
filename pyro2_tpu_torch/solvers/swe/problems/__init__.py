__all__ = ["acoustic_pulse", "advect", "dam", "kh", "logo", "quad", "test"]
