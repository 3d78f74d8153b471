"""Kernel build and loading for the port's CUDA sources."""
