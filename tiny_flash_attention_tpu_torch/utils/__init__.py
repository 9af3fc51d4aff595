"""Helpers of the port: tolerances, device choice, CUDA-event timing,
profiling and the roofline."""
