"""Disparity evaluation of the port (``nmrf_tpu/evalx``)."""

from .evaluation import DispEvaluator, inference_on_dataset, print_csv_format

__all__ = ["DispEvaluator", "inference_on_dataset", "print_csv_format"]
