"""Pallas GPU kernels (Triton route) for the hot loops; the XLA paths they
replace stay as the reference and the CPU path."""
