from .units import Units

__all__ = ["Units"]
