"""Artifact I/O, parameter conversion, the hyperprior bitstream and the
entropy tables (port of ``nic.io``)."""
