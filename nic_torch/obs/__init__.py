"""Run logs and scalar records (port of ``nic.obs``)."""
