"""Frozen operation and byte counts of the kernels and the model, and the
chip's peaks: the yardstick of every roofline and MFU metric."""
