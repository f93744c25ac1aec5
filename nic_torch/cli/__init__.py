"""Entry points mirroring ``nic.cli``."""
