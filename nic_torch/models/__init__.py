"""Decoder models (port of ``nic.models``)."""
