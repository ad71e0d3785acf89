"""PyTorch port of the SNN library for NVIDIA Hopper.

A package beside the JAX reference (``repro``), with the same layout.  Its
public entry points run on the CUDA device unless the caller passes
``device="cpu"``; on the CPU every kernel runs as its plain PyTorch version.
"""
