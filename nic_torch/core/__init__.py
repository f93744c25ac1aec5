"""Quantization, positional encodings and metrics (port of ``nic.core``)."""
