__all__ = ["slotted", "test"]
