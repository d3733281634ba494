__all__ = ["acoustic_pulse", "advect", "bubble", "gresho", "hse", "kh",
           "logo", "quad", "ramp", "rt", "rt2", "rt_multimode", "sedov",
           "sod", "test"]
