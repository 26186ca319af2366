from .frame_io import InputPadder

__all__ = ["InputPadder"]
