"""Artifact I/O and parameter conversion (port of ``nic.io``)."""
