__all__ = ["acoustic_pulse", "advect", "bubble", "convection", "gresho",
           "heating", "hse", "kh", "logo", "plume", "quad", "ramp", "rt",
           "rt2", "rt_multimode", "sedov", "sod", "test"]
